#!/usr/bin/env python3
"""Exhaustive check of ``xla_erf_inv`` against XLA:CPU's own
``erf_inv`` over every float32 in (-1, 1).

    python3 scripts/xla_erf_inv_check.py [--workers 3] [--chunk-log2 22]

``flowsentryx_tpu_torch.core.device.xla_erf_inv`` rebuilds the float32
``erf_inv`` that XLA:CPU compiles (``w = -log1p(-x*x)`` with its own
``log1p``, Giles' two polynomials in ``w - 2.5`` and ``sqrt(w) - 3``,
fused multiply-adds, a correctly rounded square root).
``core/prng.py::normal`` is ``sqrt(2) * erf_inv(u)``, so the default
``mlp`` and ``multiclass`` params rest on it.  This script runs it on
every float32 bit pattern in (-1, 1) (``0x00000000`` to ``0x3F7FFFFF``
and the same with the sign bit: 2,130,706,432 values), in chunks, next
to ``jax.jit(jax.lax.erf_inv)`` on the CPU, and counts the results whose
bits differ.  It prints one JSON line and exits 0 only when that count
is 0.  Each worker process runs jax on the CPU and torch with one
thread; with three workers a run takes about 40 minutes on an x86 host.
Result: 0 of 2,130,706,432 differ.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import os
import sys
import time

import numpy as np

_WORKER: dict = {}
ONE = 0x3F800000           # the bits of 1.0
SIGN = 0x80000000


def _init() -> None:
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")
    import torch

    torch.set_num_threads(1)
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from flowsentryx_tpu_torch.core.device import xla_erf_inv

    _WORKER["jax"] = jax.jit(jax.lax.erf_inv)
    _WORKER["port"] = xla_erf_inv
    _WORKER["torch"] = torch


def _check(job: tuple[int, int, int]) -> tuple[int, int, list[int]]:
    lo, hi, sign = job
    torch = _WORKER["torch"]
    bits = np.arange(lo, hi, dtype=np.uint32) | np.uint32(sign)
    x = bits.view(np.float32)
    want = np.asarray(_WORKER["jax"](x)).view(np.uint32)
    got = _WORKER["port"](torch.from_numpy(x)).numpy().view(np.uint32)
    bad = got != want
    return hi - lo, int(bad.sum()), bits[bad][:4].tolist()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workers", type=int, default=3)
    ap.add_argument("--chunk-log2", type=int, default=22)
    args = ap.parse_args()
    chunk = 1 << args.chunk_log2
    jobs = [(a, min(a + chunk, ONE), s) for s in (0, SIGN)
            for a in range(0, ONE, chunk)]
    t = time.perf_counter()
    values = differ = 0
    examples: list[str] = []
    with mp.get_context("spawn").Pool(args.workers,
                                      initializer=_init) as pool:
        for n, d, ex in pool.imap_unordered(_check, jobs):
            values += n
            differ += d
            examples += [f"0x{b:08x}" for b in ex]
    print(json.dumps({"values": values, "differing": differ,
                      "examples": examples[:8],
                      "wall_s": round(time.perf_counter() - t, 1)}))
    return 0 if differ == 0 and values == 2 * ONE else 1


if __name__ == "__main__":
    sys.exit(main())
