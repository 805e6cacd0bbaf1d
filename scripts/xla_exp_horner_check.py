#!/usr/bin/env python3
"""Exhaustive check behind ``xla_exp``'s cheap Horner steps.

    python3 scripts/xla_exp_horner_check.py [--workers 4]

XLA:CPU's float32 ``exp`` evaluates a degree-5 polynomial in the reduced
argument ``r`` by Horner's rule with fused multiply-adds, then
``y = fma(p, r*r, r) + 1``.  ``flowsentryx_tpu_torch.core.device.xla_exp``
rounds each Horner step ``p * r + c`` through float64 (exact product,
then two roundings: to 53 bits, then to 24), which is cheaper than an
exact fused multiply-add but not correctly rounded at every step.  This
script enumerates every float32 ``r`` in [-1, 1] (2,130,706,434
values; ``|r| < 0.98`` for every input ``xla_exp`` takes) and runs both
chains:

* exact: each step rounded once (TwoSum plus round-to-odd in float64);
* cheap: each step rounded through float64.

It prints how many intermediate steps differ and how many final ``y``
differ.  ``xla_exp`` relies on the second count being 0: the cheap chain
then gives the exact ``y`` for every ``r``, so the exact result.  CPU
only, numpy only; about 3 minutes with 4 worker processes.
"""

from __future__ import annotations

import argparse
import json
import sys
from multiprocessing import Pool

import numpy as np

F32 = np.float32
# XLA's Cephes coefficients (flowsentryx_tpu_torch/core/device.py _EXP_P)
COEFFS = [np.float64(F32(c)) for c in (
    1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3, 4.1665795894e-2,
    1.6666665459e-1, 5.0000001201e-1)]
CHUNK = 1 << 22


def exact_sum(p: np.ndarray, c) -> np.ndarray:
    """f32(p + c) rounded once: TwoSum, then round to odd at 53 bits."""
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    bits = s.view(np.int64) - ((err * s) < 0).astype(np.int64)
    bits |= (err != 0).astype(np.int64)
    return bits.view(np.float64).astype(F32)


def cheap_sum(p: np.ndarray, c) -> np.ndarray:
    return (p + c).astype(F32)


def y_of(r: np.ndarray, add) -> tuple[np.ndarray, list[np.ndarray]]:
    r64 = r.astype(np.float64)
    steps = [add(r64 * COEFFS[0], COEFFS[1])]
    for c in COEFFS[2:]:
        steps.append(add(steps[-1].astype(np.float64) * r64, c))
    steps.append(add(steps[-1].astype(np.float64)
                     * (r * r).astype(np.float64), r64))
    return steps[-1] + F32(1.0), steps


def check(job: tuple[int, int, bool]) -> tuple[int, int, list[float]]:
    lo, hi, negative = job
    r = np.arange(lo, hi, dtype=np.uint32).view(F32)
    if negative:
        r = -r
    ye, se = y_of(r, exact_sum)
    yc, sc = y_of(r, cheap_sum)
    steps = sum(int((a != b).sum()) for a, b in zip(se, sc))
    bad = ye.view(np.uint32) != yc.view(np.uint32)
    return steps, int(bad.sum()), [float(v) for v in r[bad][:8]]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workers", type=int, default=4)
    args = ap.parse_args()
    one = int(np.array([1.0], F32).view(np.uint32)[0])
    jobs = [(a, min(a + CHUNK, one + 1), neg) for neg in (False, True)
            for a in range(0, one + 1, CHUNK)]
    steps = finals = 0
    examples: list[float] = []
    with Pool(args.workers) as pool:
        for s, f, ex in pool.imap_unordered(check, jobs):
            steps += s
            finals += f
            examples += ex
    print(json.dumps({"r_values": 2 * (one + 1),
                      "intermediate_steps_differing": steps,
                      "final_y_differing": finals,
                      "examples": examples[:8]}))
    return 0 if finals == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
