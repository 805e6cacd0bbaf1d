"""Device selection and the float helpers every layer shares."""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on.

    ``None`` means the card: it raises when no CUDA device is present
    rather than falling back to the CPU, so a run that asked for the
    accelerator can never silently measure the host.  Pass
    ``device="cpu"`` explicitly for the plain-PyTorch path (the tests).
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: flowsentryx_tpu_torch runs on the card by "
                "default; pass device='cpu' to run the plain versions on "
                "the host")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is unavailable")
    return dev


def f32(x: float) -> float:
    """``x`` rounded to float32, as a Python float.

    The reference's config scalars enter its f32 graphs weak-typed,
    i.e. rounded to float32 first; handing torch the already-rounded
    value makes every scalar operand exactly the reference's."""
    return float(np.float32(x))


#: The least ``|v|`` that XLA:CPU does not flush to zero: its compiled
#: code runs with flush-to-zero set, and x86 flushes a result whose
#: rounding to 24 bits (exponent unbounded) is below 2^-126, i.e. every
#: ``|v| < 2^-126 (1 - 2^-25)``.
_FTZ_BELOW = 2.0 ** -126 * (1 - 2.0 ** -25)
_F32_TINY = 2.0 ** -126


def fma32(a: torch.Tensor, b: torch.Tensor | float,
          c: torch.Tensor | float) -> torch.Tensor:
    """``a * b + c`` in float32 with ONE rounding (a fused multiply-add),
    flushed to zero where XLA:CPU flushes it.

    The reference's XLA:CPU backend contracts ``x * y + z`` inside a
    fusion into a hardware FMA, so wherever its graph does, the port
    must round once too — two separately rounded torch ops differ in
    the last bit on about a quarter of random inputs.  torch has no
    float32 FMA op, so this is computed exactly in float64: the product
    of two float32 values is exact there (48 significand bits), the sum
    is made round-to-odd from an error-free TwoSum (truncate toward
    zero, then set the last bit if inexact), and round-to-odd at 53 bits
    followed by round-to-nearest at 24 bits is correctly rounded
    (53 >= 24 + 2).  Round-to-odd is monotone and never lands on the
    even ``_FTZ_BELOW``, so the flush test on it is exact.  Eager and
    stream ordered on any device; no host sync."""
    p = a.double() * (b.double() if isinstance(b, torch.Tensor) else b)
    c64 = c.double() if isinstance(c, torch.Tensor) else c
    s = p + c64
    bb = s - p
    err = (p - (s - bb)) + (c64 - bb)   # exact (p + c) - s; NaN at inf
    trunc = s.view(torch.int64) - ((err * s) < 0).long()
    odd = (trunc | (err.abs() > 0)).view(torch.float64)
    return (odd * (odd.abs() >= _FTZ_BELOW)).float()


def recip_mul(a: torch.Tensor, c: float) -> torch.Tensor:
    """``a / c`` for a constant ``c`` as XLA:CPU compiles it: a multiply
    by the float32 reciprocal ``f32(1 / f32(c))`` (its algebraic
    simplifier rewrites division by a constant; true division differs on
    ~65 % of inputs for ``c = 60``).  The reciprocal goes in as a tensor
    on ``a``'s device, so the CPU and CUDA kernels see the same operand.
    Computing ``1 / f32(c)`` in float64 and rounding once is the float32
    quotient: double rounding of a quotient from 53 to 24 bits is
    innocuous (53 >= 2 * 24 + 2)."""
    return a * torch.full_like(a, f32(1.0 / f32(c)))


# XLA:CPU's float32 exp: the Cephes expf, each multiply-add fused.
_LOG2E = f32(1.44269504088896341)
LN2_F32 = f32(0.693147180559945309)
_EXP_C1 = 0.693359375                   # ln 2 = C1 - C2, C1 exact in 9 bits
_EXP_C2 = f32(-2.12194440e-4)
_EXP_P = tuple(f32(c) for c in (1.9875691500e-4, 1.3981999507e-3,
                                8.3334519073e-3, 4.1665795894e-2,
                                1.6666665459e-1, 5.0000001201e-1))


def xla_exp(x: torch.Tensor) -> torch.Tensor:
    """``exp(x)`` in float32, bit for bit as the reference's XLA:CPU
    build computes it, on any device:

    * ``n = floor(f32(f32(x log2e) + 0.5))``, at most 127;
    * ``r = fma(-n, C1, x)``, then ``r = fma(-n, C2, r)``;
    * ``p`` by Horner with fused multiply-adds over the six Cephes
      coefficients, ``y = fma(p, r*r, r) + 1``;
    * ``y * 2^n``, flushed to zero below 2^-126 (``x < -87.33655``
      gives 0, ``-inf`` too), infinite from ``x > 88.72283``.

    The two ``r`` steps are computed in float64 with one rounding, which
    equals the two FMAs.  ``x`` is clamped to [-88, 89] (the results
    there are already 0 and inf), so ``|n| <= 127``, and ``n*C1`` (7 + 9
    bits) and ``n*C2`` (7 + 24 bits) are exact.  For ``n != 0``,
    ``|x| > 0.34``: below 0.5, ``x`` is a multiple of 2^-25 and
    ``|x - n*C1| < 0.38``; above, a multiple of 2^-24 and
    ``|x - n*C1| < 1``; either way ``x - n*C1`` fits in 24 bits (the
    first FMA does not round).  ``(x - n*C1) - n*C2`` is a multiple of
    2^-36 below 2, exact in float64, and rounds once.

    Each Horner step (and ``fma(p, r*r, r)``) forms its exact product in
    float64 and rounds the sum twice, to 53 bits and then to 24: cheaper
    than :func:`fma32`, and not always the FMA's rounding, but exact in
    the result.  ``scripts/xla_exp_horner_check.py`` runs both chains on
    every float32 ``r`` in [-1, 1] (``|r| < 0.98`` here): 5 intermediate
    steps differ by an ULP and all 5 are absorbed, so ``y`` is equal for
    all 2,130,706,434 values.  A tiny ``fma(p, r*r, r)`` that XLA would
    flush only meets the ``+ 1``, which absorbs it.  ``y * 2^n`` is exact
    in float64 and rounds once to f32.  Subnormal inputs are not flushed (XLA:CPU
    reads them as zero); no value of the port's step is subnormal."""
    x = torch.clamp(x.float(), -88.0, 89.0)
    n = torch.clamp(torch.floor(x * _LOG2E + 0.5), max=127.0)
    n64 = n.double()
    r = ((x.double() - n64 * _EXP_C1) - n64 * _EXP_C2).float()
    # Horner, each step's exact product and sum rounded through float64
    r64 = r.double()
    p = (r64 * _EXP_P[0] + _EXP_P[1]).float()
    for c in _EXP_P[2:]:
        p = (p.double() * r64 + c).float()
    y = (p.double() * (r * r).double() + r64).float() + 1.0
    v = y.double() * ((n.long() + 1023) << 52).view(torch.float64)
    return torch.where(v < _F32_TINY, 0.0, v).float()


def xla_exp2(x: torch.Tensor) -> torch.Tensor:
    """``exp2(x)`` of a traced float32 ``x`` as XLA:CPU computes it:
    :func:`xla_exp` of ``f32(x * f32(ln 2))``, which is not always
    exact at an integer: ``exp2(13.)`` is 8192.004."""
    return xla_exp(x.float() * LN2_F32)


def xla_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid`` of a traced float32 ``x`` as XLA:CPU computes
    it: ``1 / (1 + exp(-x))`` with :func:`xla_exp` and a true division,
    a subnormal quotient (``x < -87.33``) flushed to zero
    (``torch.sigmoid`` differs on ~0.4 % of random inputs)."""
    s = 1.0 / (xla_exp(-x.float()) + 1.0)
    return torch.where(s < _F32_TINY, 0.0, s)


def _daz(x: torch.Tensor) -> torch.Tensor:
    """Subnormal inputs read as a zero of their sign, as XLA:CPU reads
    them (denormals-are-zero)."""
    return torch.where(x.abs() < _F32_TINY, x * 0.0, x)


# XLA:CPU's float32 log: the Cephes logf polynomial, split in three
# chains, each multiply-add fused (its intrinsic library, from Eigen)
_LOG_P = tuple(f32(c) for c in (
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
    1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
    3.3333331174e-1))
_LOG_Q1 = f32(-2.12194440e-4)
_LOG_Q2 = 0.693359375
_SQRTHF = f32(0.707106781186547524)
# log1p below sqrt(2) - 1: the Cephes rational approximation
_LOG1P_SMALL = f32(0.41421356237309504880)
_LOG1P_N = tuple(f32(c) for c in (
    4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
    6.5787325942061044846969e0, 2.9911919328553073277375e1,
    6.0949667980987787057556e1, 5.7112963590585538103336e1,
    2.0039553499201281259648e1))
_LOG1P_D = tuple(f32(c) for c in (
    1.5062909083469192043167e1, 8.3047565967967209469434e1,
    2.2176239823732856465394e2, 3.0909872225312059774938e2,
    2.1642788614495947685003e2, 6.0118660497603843919306e1))
#: The NaN XLA:CPU's log returns below zero (all bits set).
_NAN_BITS = -1


def _log_positive(u: torch.Tensor) -> torch.Tensor:
    """XLA:CPU's ``log`` of float32 ``u`` (inputs already DAZ-read), as
    its compiled code rounds it, each fused multiply-add one
    :func:`fma32`:

    * ``m, e = frexp(max(u, 2^-126))``, ``m`` in [0.5, 1); below
      ``sqrt(1/2)``: ``x = (m - 1) + m``, ``e -= 1``; else ``x = m - 1``;
    * ``x2 = x*x``, ``x3 = x2*x``; three chains ``fma(x, P0, P1)`` ->
      ``fma(x, ., P2)``, ``(P3, P4, P5)``, ``(P6, P7, P8)``, joined by
      ``y = fma(x3, fma(x3, y0, y1), y2)``, then
      ``y = fma(x3, y, f32(e * Q1))``;
    * ``fma(e, Q2, (x - 0.5 x2) + y)``, the ``x - 0.5 x2`` itself fused;
    * 0 gives -inf, inf gives inf, below zero or NaN gives the all-ones
      NaN."""
    bits = torch.clamp(u, min=_F32_TINY).view(torch.int32)
    m = ((bits & 0x7FFFFF) | 0x3F000000).view(torch.float32)
    e = ((bits >> 23) - 126).float()
    low = m < _SQRTHF
    x = (m - 1.0) + torch.where(low, m, 0.0)
    e = torch.where(low, e - 1.0, e)
    x2 = x * x
    x3 = x2 * x
    p = _LOG_P
    y0 = fma32(x, fma32(x, p[0], p[1]), p[2])
    y1 = fma32(x, fma32(x, p[3], p[4]), p[5])
    y2 = fma32(x, fma32(x, p[6], p[7]), p[8])
    y = fma32(x3, fma32(x3, y0, y1), y2)
    y = fma32(x3, y, e * _LOG_Q1)
    r = fma32(e, _LOG_Q2, fma32(x2, -0.5, x) + y)
    nan = torch.full_like(bits, _NAN_BITS).view(torch.float32)
    return torch.where(u == 0, float("-inf"), torch.where(
        u == float("inf"), float("inf"), torch.where(u > 0, r, nan)))


def xla_log1p(x: torch.Tensor) -> torch.Tensor:
    """``jnp.log1p`` of a traced float32 ``x``, bit for bit as XLA:CPU
    computes it, on any device.  Two branches, selected by
    ``|x| < f32(sqrt(2) - 1)``:

    * small: the Cephes rational ``x + (x^3 N(x)/D(x) - x^2/2)``: ``N``
      and ``D`` by Horner with fused multiply-adds (degree 6 each, ``D``
      monic), one true division, ``t = fma(x2, -0.5, (x*x2) * (N/D))``,
      then ``x + t``;
    * large: XLA's ``log`` (:func:`_log_positive`) of ``f32(1 + x)``.

    Subnormal inputs read as zero.  ``torch.log1p`` differs from it on
    up to a third of inputs below 1 and in the heavy tail; exhaustive
    over every non-negative float32 by ``scripts/xla_log1p_check.py``."""
    x = _daz(x.float())
    x2 = x * x
    d = x + _LOG1P_D[0]
    for c in _LOG1P_D[1:]:
        d = fma32(x, d, c)
    n = fma32(x, _LOG1P_N[0], _LOG1P_N[1])
    for c in _LOG1P_N[2:]:
        n = fma32(x, n, c)
    small = x + fma32(x2, -0.5, (x * x2) * (n / d))
    return torch.where(x.abs() < _LOG1P_SMALL, small,
                       _log_positive(x + 1.0))


U32_MASK = 0xFFFFFFFF


def u32(t: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns (or any integer tensor) -> their uint32 values
    held in int64.  torch's ``uint32`` has few kernels, so the port keeps
    u32 quantities as int32 bit patterns in memory and does its u32
    arithmetic in int64 masked to 32 bits."""
    return t.long() & U32_MASK


def as_i32(t: torch.Tensor) -> torch.Tensor:
    """uint32 values held in int64 -> int32 bit patterns (explicit
    two's-complement fold; no reliance on narrowing-cast wraparound)."""
    return torch.where(t >= 1 << 31, t - (1 << 32), t).to(torch.int32)
