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
