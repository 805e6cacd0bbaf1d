"""Run one cell of the port's benchmark once, on the card this process
runs on:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

It prints, as its last line of standard output, one JSON object: whether
what the window served agrees with the plain reference (``correct``),
the records attempted and failed, the cell's end-to-end metrics
(``--trace 0``) or its per-layer metrics (``--trace 1``), the device, and
last the numbers compared, each beside its limit (``checks``), which also
end standard error.  Without a CUDA card it exits 1 and prints no
result.  Build and kernel caches live under ``.bench_cache/`` of the
checkout.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _caches() -> None:
    """Every build and kernel cache of the program at a fixed path inside
    the checkout (set before the program is imported)."""
    cache = ROOT / ".bench_cache"
    for var, sub in (("FSX_KERNEL_BUILD", "kernels"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(cache / sub)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    _caches()
    from benchmark import harness

    t_process = harness.process_start_boottime()
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
        print("benchmark: no CUDA card; nothing measured", file=sys.stderr)
        return 1
    out = harness.run_cell(ROOT, args.workload, args.seed, args.seconds,
                           bool(args.trace), device="cuda",
                           t_process=t_process)
    found = harness.forbidden_modules()
    if found:
        print(f"benchmark: the run loaded {found}: the JAX reference or JAX "
              "itself; no result", file=sys.stderr)
        return 1
    for name, c in out["checks"].items():
        print(f"check {name} = {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
