"""The port's XLA:CPU rounding rules against the jitted reference ops.

``flowsentryx_tpu_torch.core.device`` reproduces what the reference's
compiled graphs compute: a fused multiply-add with flush-to-zero
(``fma32``), division by a constant as a multiply by its float32
reciprocal (``recip_mul``), and XLA:CPU's float32 ``exp``/``exp2``
(``xla_exp``/``xla_exp2``), ``log1p`` (``xla_log1p``) and
``jax.nn.sigmoid`` (``xla_sigmoid``).  Each is held bit for bit against
``jax.jit`` of the plain ``jnp`` expression on the same numpy inputs,
made from a seed."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from flowsentryx_tpu_torch.core.device import (
    LN2_F32, f32, fma32, recip_mul, xla_exp, xla_exp2, xla_log1p, xla_sigmoid,
)

F32 = np.float32


def _assert_bits_equal(got: torch.Tensor, want) -> None:
    got = got.numpy()
    want = np.asarray(want)
    bad = got.view(np.uint32) != want.view(np.uint32)
    assert not bad.any(), (
        f"{int(bad.sum())} of {bad.size} differ, e.g. "
        f"{got[bad][:4]} vs {want[bad][:4]}")


def _f32_range(lo: float, hi: float) -> np.ndarray:
    """Every float32 in [lo, hi] for 0 > hi > lo (bit enumeration)."""
    a, b = np.array([hi, lo], F32).view(np.uint32)
    return np.arange(a, b + 1, dtype=np.uint32).view(F32)


def test_xla_exp_matches_jitted_exp():
    """2^22 seeded inputs in [-100, 0], every float32 in the underflow
    band [-88.8, -86] (flush to zero below 2^-126), the top of the
    finite range, and the special values."""
    rng = np.random.default_rng(20261016)
    x = np.concatenate([
        rng.uniform(-100.0, 0.0, 1 << 22).astype(F32),
        _f32_range(-88.8, -86.0),
        rng.uniform(0.0, 89.0, 1 << 16).astype(F32),
        np.array([-np.inf, np.inf, np.nan, 0.0, -0.0, 88.72283, 88.72284,
                  -87.33654, -87.33655, 1e-30, -1e-30, -1e30], F32),
        # where rounding a Horner step through float64 alone misses
        np.array([4.7683713e-07, 1.9073481e-06, 2.0116274e-06, 7.629385e-06,
                  -5.3645306e-07], F32),
    ])
    _assert_bits_equal(xla_exp(torch.from_numpy(x)), jax.jit(jnp.exp)(x))


def test_xla_exp2_matches_jitted_exp2():
    rng = np.random.default_rng(7)
    x = np.concatenate([rng.uniform(-100.0, 0.0, 1 << 22).astype(F32),
                        np.arange(-1, 31, dtype=F32),
                        np.arange(-150, 129, dtype=F32)])
    _assert_bits_equal(xla_exp2(torch.from_numpy(x)), jax.jit(jnp.exp2)(x))


@pytest.mark.parametrize("s", [60.0, 7.5, 0.3])
def test_vote_decay_form_matches_jitted_graph(s):
    """``v * exp2(-dt / s) + f`` in one compiled graph: the division
    becomes a reciprocal multiply, the constants fold, the multiply-add
    fuses, and a subnormal result flushes to zero."""
    rng = np.random.default_rng(int(s * 10))
    dt = np.concatenate([
        rng.uniform(0.0, 400.0, 1 << 20),
        rng.exponential(s, 1 << 18),
        rng.uniform(0.9, 1.1, 1 << 18) * s * 126.0,   # the underflow band
        [0.0, 1e-6, 1e9, np.inf],
    ]).astype(F32)
    v = rng.uniform(0.0, 60.0, dt.size).astype(F32)
    fresh = rng.integers(0, 4, dt.size).astype(F32)
    want = jax.jit(lambda v, dt, f: v * jnp.exp2(-dt / s) + f)(v, dt, fresh)
    k = f32(f32(1.0 / f32(s)) * LN2_F32)
    got = fma32(torch.from_numpy(v), xla_exp(torch.from_numpy(dt) * -k),
                torch.from_numpy(fresh))
    _assert_bits_equal(got, want)


@pytest.mark.parametrize("w", [0.3, 3.0, 60.0, 1.0])
def test_recip_mul_matches_jitted_division(w):
    rng = np.random.default_rng(int(w * 10))
    a = np.concatenate([rng.uniform(-w, 3 * w, 1 << 20),
                        rng.uniform(0, 1e4, 1 << 16)]).astype(F32)
    want = jax.jit(lambda a: a / w)(a)
    _assert_bits_equal(recip_mul(torch.from_numpy(a), w), want)


def test_fma32_matches_jitted_multiply_add():
    """Random operands over a wide exponent range, with ``c`` near
    ``-a*b`` so results cancel into the flush-to-zero band.  Inputs are
    normal floats: XLA:CPU also reads subnormal inputs as zero, which the
    port does not emulate (none of its values are subnormal)."""
    rng = np.random.default_rng(3)
    n = 1 << 20
    a = (rng.standard_normal(n) * 2.0 ** rng.integers(-60, 60, n)).astype(F32)
    b = (rng.standard_normal(n) * 2.0 ** rng.integers(-60, 60, n)).astype(F32)
    c = np.where(rng.random(n) < 0.5,
                 -(a.astype(np.float64) * b * (1 + rng.standard_normal(n)
                                              * 1e-6)),
                 rng.standard_normal(n)).astype(F32)
    tiny = np.finfo(F32).tiny
    c = np.where(np.abs(c) < tiny, F32(0), c)
    # a * b = 2^-126 (1 - 2^-46) rounds to the normal 2^-126 and stays;
    # (1 - 2^-24) 2^-126 is tiny after rounding and flushes
    a = np.concatenate([a, np.array([1 - 2.0 ** -23, 1 - 2.0 ** -24], F32)])
    b = np.concatenate([b, np.array([2.0 ** -126 * (1 + 2.0 ** -23),
                                     2.0 ** -126], F32)])
    c = np.concatenate([c, np.zeros(2, F32)])
    want = jax.jit(lambda a, b, c: a * b + c)(a, b, c)
    got = fma32(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(c))
    _assert_bits_equal(got, want)
    flushed = (np.asarray(want) == 0) & (a.astype(np.float64) * b + c != 0)
    assert flushed.sum() > 1000


def _log_inputs(seed: int) -> dict[str, np.ndarray]:
    """Seeded float32 samples of each range where XLA's ``log1p``
    branches differ from torch's, plus the special values."""
    rng = np.random.default_rng(seed)
    n = 1 << 18
    return {
        "below_1e-3": rng.uniform(0, 1e-3, n).astype(F32),
        "unit": rng.uniform(0, 1, n).astype(F32),
        "1_to_1e3": rng.uniform(1, 1e3, n).astype(F32),
        "heavy_tail": np.exp(rng.uniform(0, 17, n)).astype(F32),
        "u32_counts": rng.integers(0, 1 << 32, n, dtype=np.uint64
                                   ).astype(F32),
        "negative": rng.uniform(-1, 0, n).astype(F32),
        "special": np.array([
            0.0, -0.0, 1e-45, -1e-45, 1e-39, 2.0 ** -126, np.inf, -np.inf,
            np.nan, -1.0, -2.0, 3e38, 0.41421354, 0.41421357, -0.41421357,
            0.29289323, 1.0, 2.0 ** 31, 2.0 ** 32], F32),
    }


@pytest.mark.parametrize("rng_name", ["below_1e-3", "unit", "1_to_1e3",
                                      "heavy_tail", "u32_counts", "negative",
                                      "special"])
def test_xla_log1p_matches_jitted_log1p(rng_name):
    """``jnp.log1p`` bit for bit (``scripts/xla_log1p_check.py`` runs
    every non-negative float32); ``torch.log1p`` does not give its bits
    on most of these ranges."""
    x = _log_inputs(5)[rng_name]
    want = jax.jit(jnp.log1p)(x)
    _assert_bits_equal(xla_log1p(torch.from_numpy(x)), want)
    if rng_name in ("unit", "heavy_tail"):
        off = torch.log1p(torch.from_numpy(x)).numpy().view(np.uint32)
        assert (off != np.asarray(want).view(np.uint32)).sum() > 100


def test_xla_sigmoid_matches_jitted_sigmoid():
    """``jax.nn.sigmoid`` over 2^20 wide-range logits, the saturation
    bands on both sides, and the special values; ``torch.sigmoid``
    differs on thousands of the same inputs."""
    rng = np.random.default_rng(8)
    x = np.concatenate([
        rng.uniform(-20, 20, 1 << 20),
        rng.standard_normal(1 << 18) * 10.0 ** rng.integers(-8, 3, 1 << 18),
        rng.uniform(-104, -80, 1 << 16), rng.uniform(14, 20, 1 << 16),
        [0.0, -0.0, np.inf, -np.inf, np.nan, -87.33655, -88.0, 88.7, 1e-40],
    ]).astype(F32)
    want = jax.jit(jax.nn.sigmoid)(x)
    _assert_bits_equal(xla_sigmoid(torch.from_numpy(x)), want)
    off = torch.sigmoid(torch.from_numpy(x)).numpy().view(np.uint32)
    assert (off != np.asarray(want).view(np.uint32)).sum() > 1000
