"""Quickstart on the card: the paper's SSL loop through the PyTorch port.

  PYTHONPATH=src python examples/quickstart_torch.py               # H100
  PYTHONPATH=src python examples/quickstart_torch.py --device cpu  # host

The twin of ``examples/quickstart.py``, at its config:
1. Synthesize a labeled + unlabeled far-field corpus (deterministic).
2. Train a baseline LSTM AM on the labeled split (CE).
3. Train a bidirectional teacher; generate top-k=10 logits for the
   unlabeled split into a LogitStore (no decoder, no confidence model).
4. Train the student with the distillation loss on unlabeled data.
"""
import argparse

from repro_torch.core.ssl_pipeline import PipelineConfig, SSLPipeline


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    pc = PipelineConfig(n_labeled=24, n_unlabeled=48, n_val=8,
                        epochs_baseline=2, n_sub_epochs=2,
                        labeled_every=1, chunked_until=2)
    pipe = SSLPipeline(pc, out_dir="experiments/quickstart_torch",
                       device=args.device)

    print("== 1. baseline supervised AM (paper §2) ==")
    base = pipe.stage_baseline()
    print(f"   val FER {base['val_fer']:.3f}")

    print("== 2. bidirectional teacher + sMBR (paper §3.2) ==")
    teach = pipe.stage_teacher()
    print(f"   val FER {teach['val_fer']:.3f}")

    print("== 3. top-k target generation (paper §3.2.2) ==")
    targ = pipe.stage_targets()
    print(f"   {targ['n_frames']} frames, "
          f"{targ['storage_compression_x']}x storage compression")

    print("== 4. scheduled student training (paper §3.3) ==")
    stud = pipe.stage_student()
    print(f"   val FER {stud['val_fer']:.3f} "
          f"({stud['rel_fer_reduction_pct']}% rel. reduction vs baseline)")


if __name__ == "__main__":
    main()
