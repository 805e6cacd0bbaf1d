"""The declared input-range registry: what the prover may assume.

Counterpart of ``flowsentryx_tpu/ranges/seeds.py``.  Every input leaf of
a staged step variant gets a seed interval here.  The discipline is
*weakest workable assumption*: a seed narrower than the dtype must be a
contract something actually enforces --

* **wire record rows** are attacker-controlled bytes: every record word
  seeds FULL u32;
* **wire metadata rows** are written by our own encoders under
  documented contracts: ``n_valid <= max_batch``, and timestamp HI words
  bounded by the deployment horizon
  (:data:`~..core.wire.RANGE_DEPLOY_HORIZON_S`, the ``RANGE_*``
  constants the runtime clips with);
* **the table** seeds full dtype range (keys are arbitrary sources,
  state is any float);
* **the counters** are int64 here, where the reference pairs two uint32
  words and lets the pair wrap: each counts at most one unit per record,
  so over the deployment horizon at :data:`RANGE_RECORD_RATE_MAX`
  records per second it stays below :data:`RANGE_STAT_MAX` = 2^54, and
  the prover shows a step's adds cannot carry it out of int64;
* **quantized artifact scalars** seed their struct contracts
  (``in_zp``/``out_zp`` are quint8 zero-points in [0, 255]).

The port's wire buffers are int32 bit patterns of the u32 words:
:func:`wire_seed` is the reference's u32 seed, :func:`as_bit_patterns`
its image in int32.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from flowsentryx_tpu_torch.core import wire as W
from flowsentryx_tpu_torch.ranges import interval as iv
from flowsentryx_tpu_torch.ranges.interval import IVal

U32_MAX = (1 << 32) - 1

#: Records per second one engine can count, bounding every counter's
#: growth: 28x the 148.8 Mpps of minimum-size frames at 100 Gb/s.
RANGE_RECORD_RATE_MAX = 1 << 32
#: The counters' bound over the deployment horizon (2^54).
RANGE_STAT_MAX = RANGE_RECORD_RATE_MAX * W.RANGE_DEPLOY_HORIZON_S

#: Quantized-artifact integer leaves with contracts narrower than their
#: dtype (LogRegParams docstring: quint8 observers).
PARAM_LEAF_RANGES: dict[str, tuple[int, int]] = {
    "in_zp": (0, 255),
    "out_zp": (0, 255),
    "log1p": (0, 1),
}


def _obj_full(shape, lo, hi) -> IVal:
    lo_a = np.empty(shape, dtype=object)
    hi_a = np.empty(shape, dtype=object)
    lo_a[...] = lo
    hi_a[...] = hi
    return IVal(lo_a, hi_a)


def wire_seed(shape: tuple, wire: str, max_batch: int) -> IVal:
    """Per-element u32 seed of one wire buffer argument (the
    reference's, word for word).

    ``shape`` may carry leading group axes (``[N, B+1, w]`` mega groups,
    ``[C, B+1, w]`` ring slots); the per-row contract is tiled across
    them.  Record rows: full u32.  Metadata row (row B): the encoder
    contracts above."""
    words = shape[-1]
    rows = shape[-2]
    b = rows - 1
    horizon_ns = W.RANGE_DEPLOY_HORIZON_S * 10 ** 9
    horizon_us = horizon_ns // 1000
    base = _obj_full((rows, words), 0, U32_MAX)
    # metadata row: n_valid is our own encoder's min(len, B)
    base.hi[b, 0] = min(max_batch, b)
    if wire == W.WIRE_COMPACT16:
        # words 1/2: base_rel_us split u64 -- the HI word carries
        # (horizon_us >> 32), the LO word genuinely spans u32
        base.hi[b, 2] = horizon_us >> 32
    else:
        # raw48 metadata words 1/2: t0_ns split u64; record word 1 is the
        # per-record ts_ns HI word -- both bounded by the horizon
        base.hi[b, 2] = horizon_ns >> 32
        base.hi[:b, 1] = horizon_ns >> 32
    if len(shape) > 2:
        lead = tuple(shape[:-2])
        lo = np.broadcast_to(base.lo, lead + base.lo.shape)
        hi = np.broadcast_to(base.hi, lead + base.hi.shape)
        return iv.guard_cap(IVal(lo, hi))
    return iv.guard_cap(base)


def _i32(lo, hi):
    """The int32 bit patterns of the u32 values ``[lo, hi]``."""
    if hi < 1 << 31:
        return lo, hi
    if lo >= 1 << 31:
        return lo - (1 << 32), hi - (1 << 32)
    return -(1 << 31), (1 << 31) - 1


_i32_lo = np.frompyfunc(lambda lo, hi: _i32(lo, hi)[0], 2, 1)
_i32_hi = np.frompyfunc(lambda lo, hi: _i32(lo, hi)[1], 2, 1)


def as_bit_patterns(v: IVal) -> IVal:
    """A u32 seed's image in the port's int32 wire words, element by
    element (a range below 2^31 is itself; one straddling it is all of
    int32)."""
    if v.is_scalar():
        return iv.scalar(*_i32(*v.bounds()))
    return IVal(np.asarray(_i32_lo(v.lo, v.hi), dtype=object),
                np.asarray(_i32_hi(v.lo, v.hi), dtype=object))


def param_seed(name: str, dtype) -> IVal:
    """Seed of one params leaf, keyed by its field name."""
    rng = PARAM_LEAF_RANGES.get(name.split(".")[-1])
    if rng is not None and iv.is_int_dtype(dtype):
        return iv.scalar(*rng)
    return iv.top_for(dtype)


def input_seed(name: str, dtype, shape: tuple, wire: str,
               max_batch: int) -> IVal:
    """Seed of one staged input leaf by its name (``table.*``,
    ``stats.*``, ``params.*``, ``raw``/``raw[i]``)."""
    if name.startswith("stats."):
        return iv.scalar(0, RANGE_STAT_MAX)
    if name.startswith("params."):
        return param_seed(name, dtype)
    if name.startswith("raw"):
        return as_bit_patterns(wire_seed(tuple(shape), wire, max_batch))
    return iv.top_for(dtype)


def variant_seeds(inputs: dict[str, Any], wire: str,
                  max_batch: int) -> dict[str, IVal]:
    """Seeds for a staged variant's input leaves (``inputs``: leaf name
    -> ``(numpy dtype, shape)``)."""
    return {n: input_seed(n, dt, shp, wire, max_batch)
            for n, (dt, shp) in inputs.items()}
