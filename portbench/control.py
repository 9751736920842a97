"""Runs a cell with the control or a planted fault in the port's place and
prints the numbers its check compares, one JSON line a seed.

    python3 portbench/control.py --workload <name> --seeds 1,2,3 --mode control --seconds 2

The benchmark's own runs never run this. It reads the upper readings from
which the limits in ``traffic/<mix>.json`` were set (``faults.py`` says what
each mode plants); the run that sets a lower reading is ``run.py`` itself.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--mode", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    if sys.path and Path(sys.path[0] or ".").resolve() == HERE:
        del sys.path[0]
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

    import torch

    from portbench.faults import hook
    from portbench.harness import load_cell, run_cell

    device = "cuda" if torch.cuda.is_available() else "cpu"
    cell = load_cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        out = run_cell(cell, seed, args.seconds, False, device=device,
                       driver_hook=hook(args.mode))
        print(json.dumps({"workload": args.workload, "mode": args.mode, "seed": seed,
                          "device": torch.cuda.get_device_name() if device == "cuda" else "cpu",
                          "correct": out["correct"],
                          "compared": {k: c["value"] for k, c in out["compared"].items()}}),
              flush=True)


if __name__ == "__main__":
    main()
