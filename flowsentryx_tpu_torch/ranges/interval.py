"""The interval domain of the ``fsx ranges`` prover.

The port's own copy of ``flowsentryx_tpu/ranges/interval.py`` (pure
numpy, op for op the same; the tests hold the two equal on drawn
intervals).

An abstract value (:class:`IVal`) is a pair of numpy *object* arrays
``(lo, hi)`` holding exact Python ints (integer/bool variables) or
floats (float variables).  Object dtype is load-bearing: interval
arithmetic on 64-bit operands routinely produces intermediates past
2^64 (that is exactly what the prover exists to catch), and an int64
carrier would wrap inside the checker itself.

Shapes are deliberately restricted to two canonical forms:

* **scalar** -- ``()``: one interval covering every element of the
  variable (the common case; a table column, a batch vector);
* **full** -- exactly the variable's shape: one interval per element
  (the wire buffers, where the metadata row and the record rows carry
  different contracts, and the verdict wire's scalar words).

Anything whose full form would exceed :data:`FULL_CAP` elements
collapses to the scalar join -- sound, merely less precise.
"""

from __future__ import annotations

import math

import numpy as np

#: Elements above which a per-element interval array collapses to its
#: scalar join.  The wire buffers ([B+1, 12] at the default batch) and
#: the device-loop's on-device ``[R, C, B+1, 4]`` slot stack are far
#: inside it; a 1M-row table column is outside (and needs no per-row
#: precision: its seed is one contract for every row).  Object arrays
#: store pointers, so even the cap costs ~16 MB transiently.
FULL_CAP = 1 << 21

_INF = float("inf")


def _as_obj(x) -> np.ndarray:
    """Normalize to an object ndarray (numpy ops on 0-d object arrays
    return bare Python scalars; every IVal re-wraps them)."""
    if isinstance(x, np.ndarray):
        return x
    a = np.empty((), dtype=object)
    a[()] = x
    return a


class IVal:
    """One abstract value: elementwise ``[lo, hi]`` (see module doc)."""

    __slots__ = ("lo", "hi")

    def __init__(self, lo, hi):
        self.lo = _as_obj(lo)  # object dtype; () or the var's shape
        self.hi = _as_obj(hi)

    def is_scalar(self) -> bool:
        return self.lo.shape == ()

    def bounds(self) -> tuple:
        """Collapsed global (lo, hi) as Python numbers."""
        return (self.lo.min() if self.lo.shape else self.lo[()],
                self.hi.max() if self.hi.shape else self.hi[()])

    def collapse(self) -> "IVal":
        lo, hi = self.bounds()
        return scalar(lo, hi)

    def __repr__(self) -> str:  # diagnostics
        lo, hi = self.bounds()
        shape = "" if self.is_scalar() else f" shape{self.lo.shape}"
        return f"IVal[{lo}, {hi}]{shape}"


def _obj(x) -> np.ndarray:
    a = np.empty((), dtype=object)
    a[()] = x
    return a


def scalar(lo, hi) -> IVal:
    return IVal(_obj(lo), _obj(hi))


def const_of(value) -> IVal:
    """Exact IVal of a concrete numpy array / scalar (jaxpr literals
    and consts).  Small arrays keep per-element precision; big ones
    collapse to their min/max."""
    a = np.asarray(value)
    if a.dtype == np.bool_:
        a = a.astype(np.int64)
    if a.size == 0:
        return scalar(0, 0)
    if a.size <= FULL_CAP and a.shape != ():
        if a.dtype.kind in "iub":
            o = np.frompyfunc(int, 1, 1)(a)
        else:
            o = np.frompyfunc(float, 1, 1)(a)
        return IVal(o, o.copy())
    if a.dtype.kind in "iub":
        return scalar(int(a.min()), int(a.max()))
    lo, hi = float(a.min()), float(a.max())
    if math.isnan(lo) or math.isnan(hi):
        return scalar(-_INF, _INF)
    return scalar(lo, hi)


def dtype_bounds(dtype) -> tuple:
    """(min, max) representable in ``dtype`` — the escape-check fence.
    Floats and complex get ``(-inf, inf)`` (never escape-checked)."""
    dt = np.dtype(dtype)
    if dt.kind == "b":
        return 0, 1
    if dt.kind in "iu":
        info = np.iinfo(dt)
        return int(info.min), int(info.max)
    return -_INF, _INF


def is_int_dtype(dtype) -> bool:
    return np.dtype(dtype).kind in "iub"


def top_for(dtype) -> IVal:
    lo, hi = dtype_bounds(dtype)
    return scalar(lo, hi)


def join(a: IVal, b: IVal) -> IVal:
    """Elementwise union (numpy broadcasting); incompatible shapes
    collapse both sides first."""
    try:
        return IVal(emin(a.lo, b.lo), emax(a.hi, b.hi))
    except ValueError:
        a, b = a.collapse(), b.collapse()
        return IVal(emin(a.lo, b.lo), emax(a.hi, b.hi))


def join_all(vals: list[IVal]) -> IVal:
    out = vals[0]
    for v in vals[1:]:
        out = join(out, v)
    return out


def equal(a: IVal, b: IVal) -> bool:
    return (a.lo.shape == b.lo.shape and bool(np.all(a.lo == b.lo))
            and bool(np.all(a.hi == b.hi)))


def guard_cap(v: IVal) -> IVal:
    """Collapse a full array past :data:`FULL_CAP` (the materialization
    fence every structural handler routes through)."""
    if v.lo.size > FULL_CAP:
        return v.collapse()
    return v


# -- exact elementwise arithmetic -------------------------------------------

def add(a: IVal, b: IVal) -> IVal:
    return IVal(a.lo + b.lo, a.hi + b.hi)


def sub(a: IVal, b: IVal) -> IVal:
    return IVal(a.lo - b.hi, a.hi - b.lo)


def neg(a: IVal) -> IVal:
    return IVal(-a.hi, -a.lo)


def emin(a, b):
    """Elementwise min that survives arbitrary-magnitude Python ints:
    numpy's ufunc degrades 0-d object results to bare scalars, and a
    bare int past 2^63 then fails the C-long coercion on the next
    call — so the all-scalar case stays in pure Python."""
    a, b = _as_obj(a), _as_obj(b)
    if a.shape == () and b.shape == ():
        return _as_obj(min(a[()], b[()]))
    return np.minimum(a, b)


def emax(a, b):
    a, b = _as_obj(a), _as_obj(b)
    if a.shape == () and b.shape == ():
        return _as_obj(max(a[()], b[()]))
    return np.maximum(a, b)


def _minmax4(p1, p2, p3, p4) -> IVal:
    lo = emin(emin(p1, p2), emin(p3, p4))
    hi = emax(emax(p1, p2), emax(p3, p4))
    return IVal(lo, hi)


def mul(a: IVal, b: IVal) -> IVal:
    return _minmax4(a.lo * b.lo, a.lo * b.hi, a.hi * b.lo, a.hi * b.hi)


_shl = np.frompyfunc(lambda x, s: x * (1 << max(int(s), 0)), 2, 1)


def shift_left(a: IVal, s: IVal) -> IVal:
    """Mathematical ``x * 2^s`` (pre-wrap; the escape check decides
    whether the dtype can hold it)."""
    return _minmax4(_shl(a.lo, s.lo), _shl(a.lo, s.hi),
                    _shl(a.hi, s.lo), _shl(a.hi, s.hi))


_ashr = np.frompyfunc(lambda x, s: int(x) >> max(int(s), 0), 2, 1)


def shift_right_arith(a: IVal, s: IVal) -> IVal:
    return _minmax4(_ashr(a.lo, s.lo), _ashr(a.lo, s.hi),
                    _ashr(a.hi, s.lo), _ashr(a.hi, s.hi))


def shift_right_logical(a: IVal, s: IVal, dtype) -> IVal:
    lo, _ = a.bounds()
    if lo < 0:
        # negative lanes reinterpret as huge unsigned values; the
        # result only narrows back to [0, 2^bits-1 >> s] — dtype-top
        # is the sound cover for a signed carrier
        return top_for(dtype)
    return shift_right_arith(a, s)


_bitlen = np.frompyfunc(lambda x: int(x).bit_length(), 1, 1)


def bit_and(a: IVal, b: IVal, dtype) -> IVal:
    alo, _ = a.bounds()
    blo, _ = b.bounds()
    if alo < 0 or blo < 0:
        return top_for(dtype)
    hi = _as_obj(emin(a.hi, b.hi))
    return IVal(hi * 0, hi)


def bit_or_xor(a: IVal, b: IVal, dtype, is_or: bool) -> IVal:
    alo, _ = a.bounds()
    blo, _ = b.bounds()
    if alo < 0 or blo < 0:
        return top_for(dtype)
    bits = _as_obj(emax(_bitlen(a.hi), _bitlen(b.hi)))
    hi = _as_obj(_shl(bits * 0 + 1, bits)) - 1
    lo = emax(a.lo, b.lo) if is_or else _as_obj(hi) * 0
    return IVal(lo, hi)


def _fd(x, y):
    if not y:
        return 0
    if isinstance(x, int) and isinstance(y, int):
        return x // y  # exact — float division rounds past 2^53
    return math.floor(x / y)


def _cd(x, y):
    if not y:
        return 0
    if isinstance(x, int) and isinstance(y, int):
        return -(-x // y)
    return math.ceil(x / y)


_floordiv = np.frompyfunc(_fd, 2, 1)
_ceildiv = np.frompyfunc(_cd, 2, 1)


def div(a: IVal, b: IVal, dtype) -> IVal:
    """Integer division (covers both trunc and floor semantics: the
    result always lies in [floor(min), ceil(max)] over the operand
    corners).  A divisor range containing 0 yields dtype-top."""
    blo, bhi = b.bounds()
    if blo <= 0 <= bhi:
        if is_int_dtype(dtype):
            return top_for(dtype)
        return scalar(-_INF, _INF)
    if not is_int_dtype(dtype):
        c = [a.lo / b.lo, a.lo / b.hi, a.hi / b.lo, a.hi / b.hi]
        return _minmax4(*c)
    lo = emin(emin(_floordiv(a.lo, b.lo), _floordiv(a.lo, b.hi)),
              emin(_floordiv(a.hi, b.lo), _floordiv(a.hi, b.hi)))
    hi = emax(emax(_ceildiv(a.lo, b.lo), _ceildiv(a.lo, b.hi)),
              emax(_ceildiv(a.hi, b.lo), _ceildiv(a.hi, b.hi)))
    return IVal(lo, hi)


def rem(a: IVal, b: IVal, dtype) -> IVal:
    """lax.rem (sign follows the dividend)."""
    blo, bhi = b.bounds()
    if blo <= 0 <= bhi or not is_int_dtype(dtype):
        return top_for(dtype)
    m = max(abs(blo), abs(bhi)) - 1
    alo, _ = a.bounds()
    return scalar(-m if alo < 0 else 0, m)


def vmin(a: IVal, b: IVal) -> IVal:
    return IVal(emin(a.lo, b.lo), emin(a.hi, b.hi))


def vmax(a: IVal, b: IVal) -> IVal:
    return IVal(emax(a.lo, b.lo), emax(a.hi, b.hi))


def clamp(lo_b: IVal, x: IVal, hi_b: IVal) -> IVal:
    return vmin(vmax(x, lo_b), hi_b)


def absolute(a: IVal) -> IVal:
    lo = emax(emax(a.lo, -a.hi), 0 * a.lo)
    hi = emax(np.abs(a.lo), np.abs(a.hi))
    return IVal(lo, hi)


def int_pow(a: IVal, y: int) -> IVal:
    c1, c2 = a.lo ** y, a.hi ** y
    lo, hi = _as_obj(emin(c1, c2)), emax(c1, c2)
    if y % 2 == 0:
        straddle = (a.lo <= 0) & (a.hi >= 0)
        lo = np.where(straddle, 0 * lo, lo)
    return IVal(lo, hi)


# -- float helpers ----------------------------------------------------------

def float_top() -> IVal:
    return scalar(-_INF, _INF)


def finite(v: IVal) -> bool:
    lo, hi = v.bounds()
    try:
        return math.isfinite(lo) and math.isfinite(hi)
    except TypeError:  # huge ints are fine
        return True


_MONOTONE_F = {
    "exp": math.exp,
    "exp2": lambda x: 2.0 ** x,
    "log1p": math.log1p,
    "expm1": math.expm1,
    "sqrt": lambda x: math.sqrt(max(x, 0.0)),
    "floor": math.floor,
    "ceil": math.ceil,
    "round_nearest_even": round,
    "round": round,
    "tanh": math.tanh,
    "erf": math.erf,
    "sin": None, "cos": None,  # non-monotone: handled as [-1, 1]
}


def float_unary(name: str, a: IVal) -> IVal:
    if name == "logistic":
        return scalar(0.0, 1.0)
    if name in ("sin", "cos"):
        return scalar(-1.0, 1.0)
    f = _MONOTONE_F.get(name)
    if f is None or not finite(a):
        if name in ("tanh", "erf"):
            return scalar(-1.0, 1.0)
        return float_top()
    lo, hi = a.bounds()
    try:
        return scalar(f(float(lo)), f(float(hi)))
    except (OverflowError, ValueError):
        return float_top()
