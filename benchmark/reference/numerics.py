"""Float32 arithmetic as the serving step rounds it, for the plain
reference (plain PyTorch; imports nothing of the program).

The step's state columns are float32, and the deployment's guarantees
(a window that closes at ``window_s``, a block that ends at its expiry,
a vote that decays with a half-life) are comparisons of those floats.
So the reference rounds each quantity once where the step's compiled
graph rounds it once: a fused multiply-add is one rounding, an ``exp``
is Cephes' float32 ``expf`` with fused steps.  These are written out
here from those definitions, not taken from the program.
"""

from __future__ import annotations

import numpy as np
import torch

U32 = 0xFFFFFFFF


def f32(x: float) -> float:
    """``x`` rounded to float32, as a Python float."""
    return float(np.float32(x))


#: Results below this magnitude are flushed to zero (flush-to-zero mode
#: judges tininess after rounding to 24 bits).
_FTZ_BELOW = 2.0 ** -126 * (1 - 2.0 ** -25)
_F32_TINY = 2.0 ** -126


def fma32(a: torch.Tensor, b, c) -> torch.Tensor:
    """``a * b + c`` in float32 with one rounding.  The product of two
    float32 values is exact in float64; the float64 sum is made
    round-to-odd (an error-free TwoSum decides the sticky bit), and
    round-to-odd at 53 bits followed by round-to-nearest at 24 is the
    correctly rounded result."""
    p = a.double() * (b.double() if isinstance(b, torch.Tensor) else b)
    c64 = c.double() if isinstance(c, torch.Tensor) else c
    s = p + c64
    bb = s - p
    err = (p - (s - bb)) + (c64 - bb)
    trunc = s.view(torch.int64) - ((err * s) < 0).long()
    odd = (trunc | (err.abs() > 0)).view(torch.float64)
    return (odd * (odd.abs() >= _FTZ_BELOW)).float()


def recip_mul(a: torch.Tensor, c: float) -> torch.Tensor:
    """``a / c`` for a constant ``c``, compiled as a multiply by the
    float32 reciprocal of ``c``."""
    return a * torch.full_like(a, f32(1.0 / f32(c)))


LOG2E = f32(1.44269504088896341)
LN2 = f32(0.693147180559945309)
_C1 = 0.693359375
_C2 = f32(-2.12194440e-4)
_P = tuple(f32(c) for c in (1.9875691500e-4, 1.3981999507e-3,
                            8.3334519073e-3, 4.1665795894e-2,
                            1.6666665459e-1, 5.0000001201e-1))


def exp32(x: torch.Tensor) -> torch.Tensor:
    """Cephes' float32 ``expf``: ``n = floor(x log2e + 1/2)``, the
    argument reduced by ``n ln 2`` in two exact steps, a degree-6
    polynomial by Horner's rule, ``y 2^n``; results below 2^-126 are 0."""
    x = torch.clamp(x.float(), -88.0, 89.0)
    n = torch.clamp(torch.floor(x * LOG2E + 0.5), max=127.0)
    n64 = n.double()
    r = ((x.double() - n64 * _C1) - n64 * _C2).float()
    r64 = r.double()
    p = (r64 * _P[0] + _P[1]).float()
    for c in _P[2:]:
        p = (p.double() * r64 + c).float()
    y = (p.double() * (r * r).double() + r64).float() + 1.0
    v = y.double() * ((n.long() + 1023) << 52).view(torch.float64)
    return torch.where(v < _F32_TINY, 0.0, v).float()


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """``a * c mod 2^32`` for uint32 values held in int64, split at 16
    bits so no partial product overflows."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & U32


def murmur_fmix32(k: torch.Tensor, salt: int = 0) -> torch.Tensor:
    """MurmurHash3's 32-bit finalizer of ``k xor salt`` (uint32 values
    held in int64)."""
    k = (k & U32) ^ (salt & U32)
    k = k ^ (k >> 16)
    k = _mul32(k, 0x85EBCA6B)
    k = k ^ (k >> 13)
    k = _mul32(k, 0xC2B2AE35)
    return k ^ (k >> 16)
