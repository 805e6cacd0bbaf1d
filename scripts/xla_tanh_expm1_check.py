#!/usr/bin/env python3
"""Exhaustive check of ``xla_tanh`` and ``xla_expm1`` against XLA:CPU's
own ``tanh`` and ``expm1`` over every float32 below 0.5 in magnitude.

    python3 scripts/xla_tanh_expm1_check.py [--workers 3] [--chunk-log2 22]

``flowsentryx_tpu_torch.core.device`` rebuilds XLA:CPU's float32
``tanh`` (Eigen's rational function, fused multiply-adds, one true
division) and ``expm1`` (``tanh(x/2) * (exp(x) + 1)`` below 0.5 in
magnitude, ``exp(x) - 1`` above, with its own ``exp``).  The compact16
decode of a log1p artifact takes ``expm1`` of ``code * in_scale``.  This
script runs both on every float32 bit pattern with ``|x| < 0.5``
(``0x00000000`` to ``0x3EFFFFFF`` and the same with the sign bit:
2,113,929,216 values, subnormals and both zeros included), in chunks,
next to ``jax.jit(jnp.tanh)`` and ``jax.jit(jnp.expm1)`` on the CPU, and
counts the results whose bits differ.  It prints one JSON line and exits
0 only when both counts are 0.  Each worker process runs jax on the CPU
and torch with one thread; with three workers a run takes about 25
minutes on an x86 host.  Result: 0 of 2,113,929,216 differ, for both.
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
HALF = 0x3F000000          # the bits of 0.5
SIGN = 0x80000000


def _init() -> None:
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import torch

    torch.set_num_threads(1)
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from flowsentryx_tpu_torch.core.device import xla_expm1, xla_tanh

    _WORKER["pairs"] = ((jax.jit(jnp.tanh), xla_tanh),
                        (jax.jit(jnp.expm1), xla_expm1))
    _WORKER["torch"] = torch


def _check(job: tuple[int, int, int]) -> tuple[int, list[int], list[int]]:
    lo, hi, sign = job
    torch = _WORKER["torch"]
    bits = np.arange(lo, hi, dtype=np.uint32) | np.uint32(sign)
    x = bits.view(np.float32)
    differ, examples = [], []
    for ref, port in _WORKER["pairs"]:
        want = np.asarray(ref(x)).view(np.uint32)
        got = port(torch.from_numpy(x)).numpy().view(np.uint32)
        bad = got != want
        differ.append(int(bad.sum()))
        examples += bits[bad][:2].tolist()
    return hi - lo, differ, examples


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workers", type=int, default=3)
    ap.add_argument("--chunk-log2", type=int, default=22)
    args = ap.parse_args()
    chunk = 1 << args.chunk_log2
    jobs = [(a, min(a + chunk, HALF), s) for s in (0, SIGN)
            for a in range(0, HALF, chunk)]
    t = time.perf_counter()
    values, differ = 0, [0, 0]
    examples: list[str] = []
    with mp.get_context("spawn").Pool(args.workers,
                                      initializer=_init) as pool:
        for n, d, ex in pool.imap_unordered(_check, jobs):
            values += n
            differ = [a + b for a, b in zip(differ, d)]
            examples += [f"0x{b:08x}" for b in ex]
    print(json.dumps({"values": values, "tanh_differing": differ[0],
                      "expm1_differing": differ[1],
                      "examples": examples[:8],
                      "wall_s": round(time.perf_counter() - t, 1)}))
    return 0 if differ == [0, 0] and values == 2 * HALF else 1


if __name__ == "__main__":
    sys.exit(main())
