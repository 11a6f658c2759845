"""GTC vs BMUF on the same workload (paper §3.5 / Tables 1-2), on the card.

  PYTHONPATH=src python examples/distributed_trainers_torch.py     # H100
  PYTHONPATH=src python examples/distributed_trainers_torch.py \
      --device cpu                                                  # host

The twin of ``examples/distributed_trainers.py``, at its config: the same
reduced AM trained with (a) GTC, gradient-threshold-compressed
synchronous SGD (the 16-GPU trainer), at one worker and as
``GTCShardMap`` over 2 workers with the int8 wire, and (b) BMUF,
blockwise model-update filtering with Nesterov block momentum (the
64-GPU trainer), printing the loss curves and the GTC wire density --
the trade the paper's §5.2 quantifies as "in attempting to scale to 64
GPUs, we lose some of the gains".

All runs are the *same* Trainer.fit() loop over the same data source;
only the DistributedStrategy constructor argument differs -- the point
of the unified Trainer API.

Topology (``repro_torch.runtime.cluster``):
  python examples/distributed_trainers_torch.py --cluster host:port,N,i
      -- this process as rank i of N (start one process per rank;
         REPRO_DIST_BACKEND=gloo for ranks sharing a card or the host):
         GTCShardMap's 2 workers split over the ranks' worker mesh, the
         other two runs repeat in every rank

Differences from the reference: the initial weights are drawn from a
``torch.Generator`` seed (the reference's ``jax.random.key(0)`` cannot be
repeated); the batches come from the pipeline's public loader (the
reference calls the pipeline's private batch builder; the same batches);
``--device`` and ``--out``.
"""
import argparse

import torch

from repro_torch.core.ssl_pipeline import PipelineConfig, SSLPipeline
from repro_torch.distributed.bmuf import BMUFConfig
from repro_torch.distributed.gtc import GTCConfig
from repro_torch.launch.steps import make_loss_fn
from repro_torch.models import build_model
from repro_torch.runtime.cluster import ClusterConfig, initialize, worker_mesh
from repro_torch.train import (GTC, BMUFVmap, GTCShardMap, ListSink, Trainer,
                               epoch_source)


def run(strategy, label, *, model, cfg, init, batches, epochs=3, lr=5e-2):
    sink = ListSink()
    trainer = Trainer(strategy, {"ce": make_loss_fn(model, cfg, "ce")},
                      metrics=sink)
    state = trainer.init_state(init)
    state = trainer.fit(state, epoch_source(lambda ep: batches, epochs,
                                            lr, "ce"))
    print(f"  {label}: {int(state.step)} updates, "
          f"loss {sink.first('loss'):.3f} -> {sink.last('loss'):.3f}")
    return state, sink


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cluster", default="",
                    help="'env' or 'host:port,N,i' (see runtime.cluster)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="experiments/trainers_torch")
    args = ap.parse_args(argv)
    device = args.device
    if args.cluster:
        info = initialize(ClusterConfig.from_spec(args.cluster),
                          device=device)
        print(f"cluster: process {info.process_index}/{info.process_count}")
        device = info.device or device

    pc = PipelineConfig(n_labeled=32, n_val=8, epochs_baseline=1)
    pipe = SSLPipeline(pc, out_dir=args.out, device=device)
    cfg = pipe.student_cfg
    model = build_model(cfg, device=pipe.device,
                        generator=torch.Generator().manual_seed(0))
    init = dict(model.state_dict())
    batches = list(pipe.loader.chunked_batches(
        *pipe.rng_labeled, batch_size=pc.batch, chunk_len=pc.chunk_len,
        seed=0))
    print(f"{len(batches)} chunked batches of {pc.batch}x{pc.chunk_len}")
    common = dict(model=model, cfg=cfg, init=init, batches=batches)
    sinks = {}

    print("\n== GTC (threshold compression, error feedback) ==")
    _, sinks["gtc"] = run(GTC(GTCConfig(tau=5e-4, n_workers=1)), "gtc",
                          **common)
    dens = sinks["gtc"].last("gtc_density")
    print(f"  wire density {dens:.3f} "
          f"(bandwidth saving ~{1 / max(dens, 1e-3):.0f}x)")

    mesh = worker_mesh(2)     # widest rank mesh 2 workers divide onto
    print(f"\n== GTCShardMap (2 workers, int8 wire over a "
          f"{mesh.n}-rank mesh) ==")
    _, sinks["gtc_shardmap"] = run(
        GTCShardMap(GTCConfig(tau=5e-4, n_workers=2), mesh),
        "gtc_shardmap", **common)

    bc = BMUFConfig(n_workers=4, block_steps=2)
    print(f"\n== BMUF ({bc.n_workers} workers, block sync every "
          f"{bc.block_steps} steps) ==")
    _, sinks["bmuf"] = run(BMUFVmap(bc), "bmuf", **common)

    print("\nGTC communicates every step (a compressed int8 sum -- "
          "GTCShardMap is the worker-axis-sharded form); BMUF every "
          f"{bc.block_steps} steps (full model mean + block momentum).")
    return sinks


if __name__ == "__main__":
    main()
