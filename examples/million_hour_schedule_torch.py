"""The 1M-hour scheduled-learning recipe, end to end, on the card (paper
§3.3/§6): the PyTorch port's twin of ``examples/million_hour_schedule.py``.

  PYTHONPATH=src python examples/million_hour_schedule_torch.py
  PYTHONPATH=src python examples/million_hour_schedule_torch.py --elastic
  PYTHONPATH=src python examples/million_hour_schedule_torch.py --device cpu

Prints the paper's exact 18-sub-epoch schedule (55k hours each, labeled
interleave every 5, chunked BPTT until 15, fine-tune 16-18), then executes
the same *structure* scaled to minutes of synthetic audio with the BMUF
trainer (the paper's 64-GPU arm, its W = 4 lanes looped on one card),
reporting the baseline's and the student's FER.

``--elastic`` runs the continuous waves instead: repeated
generate -> train -> promote waves (the student becomes the next wave's
teacher through the v2 store's atomic wave supersede) under injected
worker deaths -- one BMUF lane is killed mid-wave and revived two blocks
later, the block average shrinking to the survivors and growing back at
the next sync.  ``--gen-procs N`` generates each wave's targets in N OS
processes.  The run ends with the store checksum-verified, orphans
garbage-collected, and the generation ledger fully done.
"""
import argparse

from repro_torch.core import scheduled
from repro_torch.core.ssl_pipeline import PipelineConfig, SSLPipeline


def _pipeline(out_dir, device, gen_procs=0):
    # sized so each sub-epoch's unlabeled pass fills at least one full
    # BMUF block (workers*block_steps microbatches at one lr) -- smaller
    # corpora drop every partial block at the phase boundary and the
    # student never updates
    pc = PipelineConfig(n_labeled=48, n_unlabeled=192, n_val=8,
                        epochs_baseline=2, n_sub_epochs=4,
                        labeled_every=2, chunked_until=3,
                        bmuf_workers=4, bmuf_block_steps=2,
                        gen_workers=2, gen_procs=gen_procs, prefetch=2)
    return SSLPipeline(pc, out_dir=out_dir, student_trainer="bmuf",
                       device=device)


def run_static(device, gen_procs):
    print("== scaled execution with BMUF (paper's 64-GPU arm) ==")
    pipe = _pipeline("experiments/million_hour_torch", device, gen_procs)
    base = pipe.stage_baseline()
    pipe.stage_teacher()
    targ = pipe.stage_targets()
    print(f"targets: {targ['n_shards']} manifest shards from "
          f"{targ['n_workers']} ledgered workers (wave {targ['wave']}), "
          f"{targ['storage_compression_x']}x storage compression")
    stud = pipe.stage_student()
    print(f"baseline FER {base['val_fer']:.3f} -> "
          f"BMUF student FER {stud['val_fer']:.3f} "
          f"({stud['rel_fer_reduction_pct']}% relative)")


def run_elastic(n_waves, device, gen_procs):
    print(f"== elastic waves: generate -> train -> promote x{n_waves}, "
          f"one lane killed mid-wave ==")
    pipe = _pipeline("experiments/million_hour_elastic_torch", device,
                     gen_procs)
    base = pipe.stage_baseline()
    pipe.stage_teacher()
    rep = pipe.run_waves(n_waves, kill_at=1, revive_after=2)
    for i, wv in enumerate(rep["waves"]):
        s = wv["student"]
        chaos = ", ".join(f"{e['event']} {e['worker']}@block{e['poll']}"
                          for e in s["chaos"])
        print(f"wave {i}: store wave {wv['wave']}, "
              f"FER {s['val_fer']:.3f}, "
              f"{s['resizes']['count']} resizes "
              f"({s['resizes']['seconds']:.2f}s), "
              f"final W={s['final_workers']}  [{chaos}]")
    print(f"baseline FER {base['val_fer']:.3f} -> "
          f"final student FER {rep['final_fer']:.3f} "
          f"({rep['rel_fer_reduction_pct']}% relative)")
    print(f"absorbed {rep['restarts_absorbed']} worker deaths across "
          f"{rep['resize_count']} resizes "
          f"({rep['resize_seconds']:.2f}s total)")
    print(f"final manifest: verified {rep['n_verified']} shards "
          f"(clean={rep['manifest_clean']}), "
          f"gc removed {rep['gc_removed']} orphans, "
          f"ledger done={rep['ledger_clean']}")
    if not (rep["manifest_clean"] and rep["ledger_clean"]):
        raise RuntimeError("the waves left an unclean manifest or ledger")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--elastic", action="store_true",
                    help="run the continuous waves with injected "
                         "worker kills instead of the single-pass recipe")
    ap.add_argument("--waves", type=int, default=2,
                    help="number of generate->train->promote waves "
                         "(--elastic only)")
    ap.add_argument("--gen-procs", type=int, default=0,
                    help="target generation in N OS processes")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    print("== the paper's 1M-hour schedule (structure) ==")
    print(scheduled.describe(scheduled.ScheduleConfig.paper_1m()))
    print()

    if args.elastic:
        run_elastic(args.waves, args.device, args.gen_procs)
    else:
        run_static(args.device, args.gen_procs)


if __name__ == "__main__":
    main()
