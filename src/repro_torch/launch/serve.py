"""Online serving entrypoint: both session types of the slot core.

Token LMs go through ``serve.TokenServer`` (continuous batching, one host
sync per window, with the fused ``decode_attention`` and ``topk_sample``
kernels unless ``--no-decode-kernel``); streaming-capable AMs go through
``serve.StreamServer`` (mid-flight admission, SLO tiers); bidirectional
AMs have no streaming form and use ``StreamingEngine``'s batched path.
Runs on the card by default; ``--device cpu`` runs the plain PyTorch path
on the host.  Weights are random, drawn from ``--seed``; ``--full`` keeps
the published width (without it, ``configs.reduced``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch lstm-am-7khr
  PYTHONPATH=src python -m repro_torch.launch.serve --arch lstm-am-teacher --full
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b --full
  PYTHONPATH=src python -m repro_torch.launch.serve --full --profile
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_arch, reduced
from repro_torch.kernels._dispatch import resolve_device
from repro_torch.models import build_model
from repro_torch.models.api import supports_streaming
from repro_torch.serve import (LATENCY, SLO_DEFAULT, BatchPolicy,
                               StreamingEngine, StreamServer, TokenServer)


def serve_tokens(cfg, params, *, n_requests: int = 6, max_new: int = 8,
                 policy: BatchPolicy = LATENCY, seed: int = 0,
                 decode_kernel: bool = True, device=None):
    """Token-LM decode serving on the slot core: ragged prompts, greedy
    continuous batching, one host sync per window."""
    srv = TokenServer(cfg, params, policy=policy, max_seq=128,
                      decode_kernel=decode_kernel, device=device)
    rng = np.random.default_rng(seed)
    rids = [srv.submit(rng.integers(1, cfg.vocab_size, rng.integers(3, 10)),
                       max_new=max_new) for _ in range(n_requests)]
    t0 = time.perf_counter()
    done = srv.drain()
    if srv.device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    total = sum(len(done[r].out) for r in rids)
    st = srv.stats
    print(f"[serve] {n_requests} requests, {total} tokens "
          f"in {dt:.2f}s ({total / dt:.1f} tok/s; {st['syncs']} host "
          f"syncs over {st['steps']} steps, slot occupancy "
          f"{st['active_slot_steps'] / max(st['slot_steps'], 1):.0%})")
    for r in rids:
        print(f"  req {r}: {done[r].out}")
    return done


def serve_batch(cfg, params, *, n_requests: int = 6,
                policy: BatchPolicy = LATENCY, seed: int = 0,
                topk_impl: str = "kernel", device=None):
    """Batched full-utterance AM serving — the path for bidirectional
    models, which have no streaming form."""
    eng = StreamingEngine(cfg, params, k=10, policy=policy,
                          topk_impl=topk_impl, device=device)
    rng = np.random.default_rng(seed)
    rids = [eng.submit(rng.normal(size=(int(rng.integers(24, 96)),
                                        cfg.feat_dim)).astype(np.float32))
            for _ in range(n_requests)]
    t0 = time.perf_counter()
    res = eng.run()
    dt = time.perf_counter() - t0
    frames = sum(res[r].vals.shape[0] for r in rids)
    print(f"[serve] {n_requests} utterances, {frames} frames batched "
          f"in {dt:.2f}s ({frames / dt:.0f} frames/s)")
    return res


def serve_stream(cfg, params, *, n_streams: int = 3, chunk: int = 16,
                 seed: int = 0, topk_impl: str = "kernel", device=None):
    """Streaming AM serving on the slot core: long firehose streams
    plus interactive arrivals under SLO tiers, top-k senone posteriors
    per frame, one host sync per window."""
    srv = StreamServer(cfg, params, n_slots=n_streams, chunk_frames=chunk,
                       k=10, tiers=SLO_DEFAULT, topk_impl=topk_impl,
                       device=device)
    rng = np.random.default_rng(seed)
    fire = [rng.normal(size=(int(rng.integers(8, 14)) * chunk,
                             cfg.feat_dim)).astype(np.float32)
            for _ in range(n_streams)]
    inter = [rng.normal(size=(chunk, cfg.feat_dim)).astype(np.float32)
             for _ in range(2)]
    t0 = time.perf_counter()
    rids = [srv.submit(u, tier="firehose") for u in fire]
    done = srv.pump()                  # firehose saturates the slots ...
    rids += [srv.submit(u, tier="interactive") for u in inter]
    done.update(srv.drain())           # ... interactive preempts it
    dt = time.perf_counter() - t0
    frames = sum(u.shape[0] for u in fire + inter)
    st = srv.stats
    print(f"[serve] {len(rids)} streams ({len(inter)} interactive), "
          f"{frames} frames in {dt:.2f}s ({frames / dt:.0f} frames/s; "
          f"{st['syncs']} host syncs over {st['steps']} steps, "
          f"{st['parked']} parks, utilization {srv.utilization():.0%})")
    for r in rids:
        v, _ = done[r].emissions()
        print(f"  stream {r} ({done[r].tier or 'default'}): "
              f"{v.shape[0]} emissions, finished sync "
              f"{done[r].finished_sync}")
    return done


def profile_device(fn, *, host_ops: bool = True):
    """Run ``fn()`` under ``torch.profiler`` on the card and print the
    device's busy and idle share of the wall window and the kernels that
    take the most device time.  Tracing adds host time per op, so the
    idle share read here is an upper bound; ``host_ops=False`` traces
    the device alone (less added host time, and a trace of a million
    device ops stays cheap to read).  Returns the traced wall and
    device-busy ms, the count of device ops, and for each device op's
    name its count on each stream (``streams``: a copy's name says its
    direction and whether its host memory was pinned or pageable)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    activities = [ProfilerActivity.CUDA]
    if host_ops:
        activities.append(ProfilerActivity.CPU)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    streams = {}              # device op name -> {stream id: count}
    # the raw activity records: building the profiler's per-event Python
    # objects takes minutes for a million device ops
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            name = e.name()
            n, ms = by_name.get(name, (0, 0.0))
            by_name[name] = (n + 1, ms + e.duration_ns() / 1e6)
            per = streams.setdefault(name, {})
            sid = getattr(e, "device_resource_id", lambda: -1)()
            per[sid] = per.get(sid, 0) + 1
    busy = sum(ms for _, ms in by_name.values())
    launches = sum(n for n, _ in by_name.values())
    print(f"[profile] wall {wall_ms:.1f} ms (traced), device busy "
          f"{busy:.1f} ms = {busy / wall_ms:.1%}, idle "
          f"{1 - busy / wall_ms:.1%}; {launches} device ops")
    for name, (n, ms) in sorted(by_name.items(),
                                key=lambda kv: -kv[1][1])[:10]:
        print(f"  {ms:10.2f} ms {n:8d}x  {name[:100]}")
    return {"wall_ms": wall_ms, "busy_ms": busy, "ops": launches,
            "streams": streams}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="lstm-am-7khr")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--full", action="store_true",
                    help="the published width, without reduced()")
    ap.add_argument("--max-new", type=int, default=8,
                    help="tokens generated per request (token LMs)")
    ap.add_argument("--topk-impl", default="kernel", choices=("kernel",),
                    help="top-k selection: the topk_logits kernel (its "
                         "plain version with --device cpu)")
    ap.add_argument("--decode-kernel", default=True,
                    action=argparse.BooleanOptionalAction,
                    help="token LMs: the fused decode_attention and "
                         "topk_sample kernels (their plain versions with "
                         "--device cpu); --no-decode-kernel serves the "
                         "reference's non-fused path")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="after the run, run it again under the profiler "
                         "and print the device's busy/idle share (CUDA)")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    if not args.full:
        cfg = reduced(cfg)
    device = resolve_device(args.device)
    if args.profile and device.type != "cuda":
        ap.error("--profile reads the card's trace; it needs CUDA")
    model = build_model(cfg, device=device,
                        generator=torch.Generator().manual_seed(args.seed))
    params = model.state_dict()
    kw = dict(seed=args.seed, topk_impl=args.topk_impl, device=device)
    if cfg.family != "lstm_am":
        def run():
            serve_tokens(cfg, params, n_requests=args.requests,
                         max_new=args.max_new, seed=args.seed,
                         decode_kernel=args.decode_kernel, device=device)
    elif supports_streaming(cfg):
        def run():
            serve_stream(cfg, params, n_streams=args.requests, **kw)
    else:                           # bidirectional: batch path only
        def run():
            serve_batch(cfg, params, n_requests=args.requests, **kw)
    run()
    if args.profile:
        profile_device(run)


if __name__ == "__main__":
    main()
