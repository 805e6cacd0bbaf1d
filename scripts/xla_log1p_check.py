#!/usr/bin/env python3
"""Exhaustive check of ``xla_log1p`` against XLA:CPU's own ``log1p``.

    python3 scripts/xla_log1p_check.py [--workers 3] [--chunk-log2 22]

``flowsentryx_tpu_torch.core.device.xla_log1p`` rebuilds the float32
``log1p`` that XLA:CPU compiles (the Cephes rational below
``sqrt(2) - 1``, its ``log`` of ``1 + x`` above, fused multiply-adds and
flush to zero).  This script runs it on every non-negative float32 bit
pattern, ``0x00000000`` to ``0x7FFFFFFF`` (2,147,483,648 values:
zero, the subnormals, every finite positive value, ``+inf`` and the
positive NaNs), in chunks, next to ``jax.jit(jnp.log1p)`` on the CPU,
and counts the results whose bits differ.  It prints one JSON line and
exits 0 only when that count is 0.

The port feeds ``log1p`` only non-negative values: the MLP families take
``log1p(|x|)``, and the int8 scorer's inputs are counts.  Each worker
process runs jax on the CPU and torch with one thread; with three
workers a run takes about 30 minutes on an x86 host (512 chunks of
2^22).  Result: 0 of 2,147,483,648 differ.
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


def _init() -> None:
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import torch

    torch.set_num_threads(1)
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from flowsentryx_tpu_torch.core.device import xla_log1p

    _WORKER["jax"] = jax.jit(jnp.log1p)
    _WORKER["port"] = xla_log1p
    _WORKER["torch"] = torch


def _check(lo_hi: tuple[int, int]) -> tuple[int, int, list[int]]:
    lo, hi = lo_hi
    torch = _WORKER["torch"]
    bits = np.arange(lo, hi, dtype=np.uint32)
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
    top = 1 << 31
    jobs = [(a, min(a + chunk, top)) for a in range(0, top, chunk)]
    t = time.perf_counter()
    values = differ = 0
    examples: list[str] = []
    ctx = mp.get_context("spawn")
    with ctx.Pool(args.workers, initializer=_init) as pool:
        for n, d, ex in pool.imap_unordered(_check, jobs):
            values += n
            differ += d
            examples += [f"0x{b:08x}" for b in ex]
    print(json.dumps({"values": values, "differing": differ,
                      "examples": examples[:8],
                      "wall_s": round(time.perf_counter() - t, 1)}))
    return 0 if differ == 0 and values == top else 1


if __name__ == "__main__":
    sys.exit(main())
