"""The offered-rate sweep that fixes a paced cell's rate, on the card:

    python3 benchmark/sweep.py --workload <cell> --seconds <s> --seed <n> --rates 1e6 1.5e6 ...

Each rate runs one window of the cell in this one process, with the cell's
``rate_pps`` replaced, and prints one JSON line: the tail, the window's
wall against its schedule (a window that outlasts its schedule fell
behind: its backlog grew), the records never verdicted, and ``correct``.
The highest rate whose window keeps to its schedule is the knee; the cell
offers 0.8 of it.
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
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from benchmark.run import _caches

    _caches()
    import torch

    from benchmark import harness

    if not torch.cuda.is_available():
        print("sweep: no CUDA card", file=sys.stderr)
        return 1
    for rate in args.rates:
        over = {"workload": {"params": {"rate_pps": rate}}}
        out = harness.run_cell(ROOT, args.workload, args.seed, args.seconds,
                               False, overrides=over)
        served = out["served"]
        print(json.dumps({
            "rate_pps": rate, "correct": out["correct"],
            "window_s": out["window_s"], "failed": out["failed"],
            "p50_ms": served["p50_ms"], "p95_ms": served["p95_ms"],
            "p99_ms": served["p99_ms"],
            "max_ms": served["max_ms"], "batches": served["batches"]}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
