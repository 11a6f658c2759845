"""Streaming sessions on the slot-based serving core, through the PyTorch
port.

  PYTHONPATH=src python examples/serve_streams_torch.py               # H100
  PYTHONPATH=src python examples/serve_streams_torch.py --arch whisper-medium
  PYTHONPATH=src python examples/serve_streams_torch.py --device cpu  # host

The twin of ``examples/serve_streams.py``.  It shows the three things
``serve.StreamServer`` adds over the lockstep ``StreamingEngine.feed``
loop:

  * SLO tiers — firehose streams (offline target generation) fill every
    slot; interactive streams arriving later are admitted first,
    parking firehose streams mid-flight;
  * mid-flight detach and reattach — a detached stream's state row is
    pulled to the host, its slot serves other work, and ``reattach``
    restores it bitwise (emissions identical to an uninterrupted run);
  * live streams — ``submit(..., final=False)`` then ``append`` and
    ``close`` for audio that arrives while the session is attached.

Any streaming-capable arch works: the causal LSTM AM emits top-k senone
posteriors per *frame*; whisper emits one incremental-decoder position
per *chunk* (a chunk-local encoder, growing cross-attention).  Weights
are random, drawn from ``--seed``; the model is ``configs.reduced``'s
(the LSTM AM at 2x32 as in the reference's example).
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import get_arch, reduced
from repro_torch.configs.base import Segment
from repro_torch.configs.lstm_am_7khr import CONFIG
from repro_torch.models import build_model
from repro_torch.models.api import stream_feat_dim, stream_frame_sync
from repro_torch.serve import SLO_DEFAULT, StreamServer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="lstm-am",
                    help="'lstm-am' or any streaming-capable arch name "
                         "(e.g. whisper-medium)")
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--chunk", type=int, default=None,
                    help="frames a chunk (default 16 for the LSTM AM, 8 "
                         "for whisper, whose 256-frame buffers would "
                         "otherwise hold no more chunks than one 16-step "
                         "firehose window: nothing would be left in "
                         "flight to park or detach)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    if args.arch == "lstm-am":
        cfg = CONFIG.replace(
            lstm_hidden=32, feat_dim=16, n_senones=49, vocab_size=49,
            segments=(Segment((CONFIG.segments[0].pattern[0],),
                              repeat=2),))
    else:
        cfg = reduced(get_arch(args.arch))
    params = build_model(cfg, device=args.device, generator=torch.Generator()
                         .manual_seed(args.seed)).state_dict()
    if args.chunk is None:
        args.chunk = 16 if stream_frame_sync(cfg) else 8
    fd = stream_feat_dim(cfg)
    rng = np.random.default_rng(args.seed)

    def audio(n_frames):
        return (rng.normal(size=(n_frames, fd)) * 0.1).astype(np.float32)

    srv = StreamServer(cfg, params, n_slots=args.slots,
                       chunk_frames=args.chunk, k=5, tiers=SLO_DEFAULT,
                       device=args.device)

    # --- tiers: firehose fills the server, interactive preempts it.
    # whisper's cross-attention buffers cap audio a stream (max_frames);
    # the LSTM AM's O(1) state has no cap: size the demo accordingly
    n_chunks = 40 if stream_frame_sync(cfg) else 256 // args.chunk - 8
    rf = [srv.submit(audio(n_chunks * args.chunk), tier="firehose")
          for _ in range(args.slots)]
    done = srv.pump()
    ri = srv.submit(audio(args.chunk), tier="interactive")
    while ri not in done:
        done.update(srv.pump())
    print(f"interactive stream {ri} finished at sync "
          f"{done[ri].finished_sync} ({srv.stats['parked']} firehose "
          f"parked for it); occupancy now {srv.occupancy()}")

    # --- detach / reattach: pull a live stream's state row to the host
    live = [r for r in rf if r not in done]
    if live:
        rid = live[0]
        srv.detach(rid)
        print(f"stream {rid} detached mid-flight (state row held on "
              f"host); the server keeps pumping without it")
        done.update(srv.pump())        # the freed slot keeps serving
        srv.reattach(rid)
    done.update(srv.drain())

    # --- live stream: audio arrives after the session is attached
    rl = srv.submit(audio(args.chunk), final=False)
    srv.pump()                         # consumes the head, then idles
    srv.append(rl, audio(args.chunk))
    srv.close(rl)
    done.update(srv.drain())

    for rid in sorted(done):
        v, _ = done[rid].emissions()
        print(f"stream {rid:>2} ({done[rid].tier or 'default':<11}): "
              f"{v.shape[0]:>3} emissions x top-{v.shape[1]}")
    st = srv.stats
    print(f"{st['syncs']} host syncs / {st['steps']} window steps, "
          f"{st['parked']} parks, frame utilization "
          f"{srv.utilization():.0%}")
    return srv, done


if __name__ == "__main__":
    main()
