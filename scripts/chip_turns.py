"""Time chosen ``chip_smoke.py`` phases of two checkouts in turns on one card.

  python scripts/chip_turns.py --parent build/parent --phases lm paged \
      --log build/turns.log

Runs the named phases (``phase_<name>`` of each checkout's
``chip_smoke.py``, after its ``phase_device`` and ``phase_build``) in the
order parent, this checkout, this checkout, parent, each in a fresh
interpreter that builds its own kernels, so the two versions are
compared on one card in one session.  Prints the card's name and power
limit, then one JSON line a run: the checkout, each phase's seconds
(host clock, the card synchronized at both ends) and each phase's
kernel launches.  The phases' own log goes to ``--log`` (default: this
output).  Unpack the parent with ``git archive`` into a directory that
``.gitignore`` lists.  Needs a CUDA card; a phase that fails fails the
run.
"""
import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

RUN = r'''
import json, sys, time
from pathlib import Path
tree = Path(sys.argv[1])
sys.path[:0] = [str(tree), str(tree / "src")]
import chip_smoke as c
import torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
c.phase_device()
c.phase_build()
out = {"tree": str(tree), "seconds": {}, "launches": {}}
for name in sys.argv[2:]:
    torch.cuda.synchronize()
    t = time.perf_counter()
    counts = getattr(c, "phase_" + name)()
    torch.cuda.synchronize()
    out["seconds"][name] = time.perf_counter() - t
    out["launches"][name] = counts
print("TURN " + json.dumps(out), flush=True)
'''


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True,
                    help="root of the parent checkout")
    ap.add_argument("--phases", nargs="+", required=True,
                    help="chip_smoke.py phase names, e.g. lm paged")
    ap.add_argument("--log", default=None)
    ap.add_argument("--timeout", type=float, default=900.0,
                    help="seconds a run may take")
    args = ap.parse_args(argv)
    parent = Path(args.parent).resolve()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    log = open(args.log, "w") if args.log else None
    try:
        for tree in (parent, ROOT, ROOT, parent):
            p = subprocess.run([sys.executable, "-c", RUN, str(tree),
                                *args.phases], cwd=str(tree),
                               capture_output=True, text=True,
                               timeout=args.timeout)
            (log or sys.stdout).write(p.stdout + p.stderr)
            turns = [ln for ln in p.stdout.splitlines()
                     if ln.startswith("TURN ")]
            if p.returncode or not turns:
                print(f"{tree}: exit {p.returncode}\n{p.stderr[-3000:]}",
                      file=sys.stderr)
                return 1
            print(turns[-1][5:], flush=True)
    finally:
        if log:
            log.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
