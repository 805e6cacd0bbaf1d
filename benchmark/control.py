"""The readings the limits of ``correct`` are set from, on the card, at a
cell's own size:

    python3 benchmark/control.py --workload <cell> --seconds <s> --seeds 1 2 3 ...

For each seed one window runs as the benchmark runs it; the plain
reference replays what the window served, and the reference again with
its weights rounded to 4 bits (the control) takes the program's place.
Each seed prints the program's disagreements with the reference (the
lower readings) and the control's (the upper ones), one JSON line each,
in one process.  The benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--bits", type=int, default=4)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from benchmark.run import _caches

    _caches()
    import torch

    from benchmark import harness

    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 1
    for seed in args.seeds:
        out = harness.run_cell(ROOT, args.workload, seed, args.seconds,
                               False, control_bits=args.bits)
        print(json.dumps({
            "seed": seed, "correct": out["correct"],
            "attempted": out["attempted"], "served": out["served"],
            "metrics": out["metrics"], "reference_s": out["reference_s"],
            "lower": {k: c["value"] for k, c in out["checks"].items()},
            "upper": {k: c["value"]
                      for k, c in out["control_checks"].items()}}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
