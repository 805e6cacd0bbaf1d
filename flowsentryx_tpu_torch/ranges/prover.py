"""Abstract interpreter over a staged step's aten graph: per-value
integer intervals, exact pre-wrap result ranges, and the escape check.

Counterpart of ``flowsentryx_tpu/ranges/prover.py``, walking the
:class:`~..audit.graph.StepTrace` the audit records instead of a jaxpr.
Every node's result interval is computed from its operands', and for
the arithmetic set (``add``, ``sub``, ``rsub``, ``mul``, ``neg``,
``abs``, ``lshift``, ``sum``, ``cumsum``, ``index_add_``,
``scatter_reduce_`` with a sum, ``index_put_`` accumulating,
``bincount``, ``_foreach_add_``, ``add_`` and every narrowing
``_to_copy``/``copy_``) the EXACT mathematical result interval is held
against the result dtype's range first.  An escape is a silent
fixed-width wrap: a :class:`~..audit.graph.Finding` naming the node,
unless the node matches an audited :data:`~.registry.WRAP_OK` entry.

Soundness posture, as the reference's: every handler over-approximates;
``view.dtype`` (a bitcast) gives the new dtype's top; an op without a
handler degrades to dtype-top and is counted in ``unmodeled``, never
trusted.  In-place writes are joined into the written value (a
non-accumulating write can only put its values there), and a read
after a write through another view joins the old value with every
write since (the recorder's ``refresh`` node).  Two refinements keep
the proof from reading a fold as an escape:

* ``where(x >= c, x - k, x)`` (and ``<``, ``<=``, ``>``) evaluates each
  arm under its own predicate: the explicit two's-complement fold of
  ``core/device.py::as_i32`` and the signed delta of
  ``core/schema.py::decode_raw``;
* an ``&`` with a non-negative operand lies in ``[0, that operand]``
  whatever the other's sign (the u32 mask over an int32 bit pattern).

An uninitialized allocation (``empty``, ``empty_like``) is the bottom of
the lattice: it carries no value of its own and takes the join of what
is written into it (the port allocates with ``empty`` only where a
permutation scatter or a kernel writes every element).  A read of a
value nothing has written degrades to dtype-top and is counted in
``unmodeled`` as ``uninitialized``.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from flowsentryx_tpu_torch.audit.graph import Finding, Node, Ref, StepTrace
from flowsentryx_tpu_torch.ranges import interval as iv
from flowsentryx_tpu_torch.ranges import registry as reg
from flowsentryx_tpu_torch.ranges.interval import IVal

#: Elements above which the prover keeps a value as one scalar interval
#: (a batch vector's per-element intervals are rarely worth their cost;
#: the wire's words are well inside).
FULL_MAX = 1 << 14

_INF = float("inf")
_BOTTOM = (_INF, -_INF)


@dataclasses.dataclass
class Analysis:
    """One graph's range-analysis result."""

    findings: list[Finding]
    wrap_matches: dict[str, int]   # WRAP_OK entry name -> nodes matched
    unmodeled: dict[str, int]      # op -> count (dtype-top'd)
    n_eqns: int
    n_checked: int                 # nodes that went through the escape check
    outputs: dict = dataclasses.field(default_factory=dict)  # leaf -> (lo, hi)
    collected: dict = dataclasses.field(default_factory=dict)  # key -> (lo, hi)

    @property
    def ok(self) -> bool:
        return not self.findings

    def to_json(self) -> dict:
        return {"ok": self.ok,
                "findings": [f.to_json() for f in self.findings],
                "wrap_ok_matches": dict(self.wrap_matches),
                "unmodeled": dict(self.unmodeled),
                "n_eqns": self.n_eqns, "n_checked": self.n_checked}


def np_dtype(name: str):
    """A torch dtype name as a numpy dtype (floats numpy lacks read as
    float32: only their being floats matters here)."""
    try:
        return np.dtype(name)
    except TypeError:
        return np.dtype(np.float32)


def bottom() -> IVal:
    return iv.scalar(*_BOTTOM)


def is_bottom(v: IVal) -> bool:
    lo, hi = v.bounds()
    try:
        return lo > hi
    except TypeError:
        return False


def _uniform(v: IVal) -> IVal:
    """A full value whose elements all agree is that one scalar."""
    if v.is_scalar() or v.lo.size == 0:
        return v
    lo0, hi0 = v.lo.flat[0], v.hi.flat[0]
    if all(x == lo0 for x in v.lo.flat) and all(x == hi0 for x in v.hi.flat):
        return iv.scalar(lo0, hi0)
    return v


def _full(v: IVal, shape: tuple) -> IVal:
    """``v`` as a full value of ``shape`` (broadcast), or collapsed when
    that would be too large."""
    n = int(np.prod(shape, dtype=np.int64)) if shape else 1
    if n > FULL_MAX or not shape:
        return v.collapse()
    try:
        return IVal(np.broadcast_to(v.lo, shape).copy(),
                    np.broadcast_to(v.hi, shape).copy())
    except ValueError:
        return v.collapse()


class _Prover:
    def __init__(self, trace: StepTrace, seeds: dict[str, IVal], entries,
                 collect=None):
        self.t = trace
        self.entries = entries
        self.collect = collect
        self.collected: dict[str, tuple] = {}
        self.env: dict[int, IVal] = {}
        self.findings: list[Finding] = []
        self.wrap_matches: dict[str, int] = {}
        self.unmodeled: dict[str, int] = {}
        self.n_checked = 0
        for name, vid in trace.inputs.items():
            self.env[vid] = self._fit(seeds.get(name) or iv.top_for(
                np_dtype(trace.values[vid].dtype)), vid)

    # -- values ----------------------------------------------------------

    def _dtype(self, vid: int):
        return np_dtype(self.t.values[vid].dtype)

    def _fit(self, val: IVal, vid: int) -> IVal:
        shape = self.t.values[vid].shape
        if not val.is_scalar() and val.lo.shape != shape:
            if val.lo.size == int(np.prod(shape, dtype=np.int64)) and \
                    np.broadcast_shapes(val.lo.shape, shape) == tuple(shape):
                # the same elements with unit axes added or dropped (an
                # [8] weight times a [1, 8] row): keep them per element
                val = IVal(np.broadcast_to(val.lo, shape),
                           np.broadcast_to(val.hi, shape))
            else:
                val = val.collapse()
        if not val.is_scalar() and val.lo.size > FULL_MAX:
            val = val.collapse()
        return _uniform(val)

    def get(self, vid: int) -> IVal:
        v = self.env.get(vid)
        if v is not None:
            return v
        c = self.t.consts.get(vid)
        if c is not None:
            try:
                arr = c.numpy()
            except TypeError:   # a dtype numpy lacks (bfloat16)
                arr = c.float().numpy()
            v = self._fit(iv.const_of(arr), vid)
        else:
            v = iv.top_for(self._dtype(vid))
        self.env[vid] = v
        return v

    def val(self, a, node: Node) -> IVal:
        """An operand's interval: a tensor's, or a Python scalar's exact
        value.  A read of a value nothing has written is dtype-top."""
        if isinstance(a, Ref):
            v = self.get(a.vid)
            if is_bottom(v):
                self._count("uninitialized")
                return iv.top_for(self._dtype(a.vid))
            return v
        if isinstance(a, bool):
            return iv.scalar(int(a), int(a))
        if isinstance(a, (int, float)):
            return iv.scalar(a, a)
        return iv.scalar(-_INF, _INF)

    def _count(self, name: str) -> None:
        self.unmodeled[name] = self.unmodeled.get(name, 0) + 1

    def set(self, vid: int, v: IVal) -> None:
        self.env[vid] = self._fit(v, vid)

    # -- the escape check ---------------------------------------------------

    def checked(self, node: Node, exact: IVal, out_vid: int, *,
                narrowing: bool = False, prim: str | None = None) -> IVal:
        dtype = self._dtype(out_vid)
        if not iv.is_int_dtype(dtype) or dtype.kind == "b":
            return exact
        self.n_checked += 1
        dmin, dmax = iv.dtype_bounds(dtype)
        lo, hi = exact.bounds()
        if lo >= dmin and hi <= dmax:
            return exact
        prim = prim or node.op.split(".")[1].rstrip("_").lstrip("_")
        ent = reg.match(self.entries, prim, node.frames)
        if ent is not None:
            self.wrap_matches[ent.name] = self.wrap_matches.get(ent.name,
                                                                0) + 1
            return iv.top_for(dtype)
        kind = "narrowing convert" if narrowing else f"{prim} result"
        self.findings.append(Finding(
            contract="range", where=node.where(), eqn=node.text(self.t),
            reason=(f"{kind} interval [{lo}, {hi}] escapes {dtype.name} "
                    f"[{dmin}, {dmax}]: a silent fixed-width wrap in the "
                    "serving graph; guard the arithmetic, widen the dtype, "
                    "or register an audited WRAP_OK entry if it cannot "
                    "wrap by construction")))
        return iv.top_for(dtype)

    def top_outs(self, node: Node, count: bool = True) -> None:
        if count:
            self._count(node.op)
        for o in node.outs:
            self.set(o, iv.top_for(self._dtype(o)))
        for new in node.writes.values():
            self.set(new, iv.top_for(self._dtype(new)))

    # -- the walk -----------------------------------------------------------

    def run(self) -> None:
        for node in self.t.nodes:
            if node.op == "refresh":
                self._refresh(node)
            elif node.op.startswith("kernel:"):
                self._kernel(node)
            else:
                try:
                    self._aten(node)
                except (ValueError, TypeError, IndexError, OverflowError,
                        ZeroDivisionError):
                    self.top_outs(node)
            key = self.collect(node) if self.collect else None
            if key is not None and node.outs:
                lo, hi = self.get(node.outs[0]).bounds()
                if key in self.collected:
                    lo = min(lo, self.collected[key][0])
                    hi = max(hi, self.collected[key][1])
                self.collected[key] = (lo, hi)

    def _refresh(self, node: Node) -> None:
        out = node.outs[0]
        dt = self.t.values[out].dtype
        vals = [self.get(v) for v in node.ins]
        if any(self.t.values[v].dtype != dt for v in node.ins):
            self.set(out, iv.top_for(self._dtype(out)))
            return
        self.set(out, iv.join_all([v.collapse() for v in vals]))

    def _kernel(self, node: Node) -> None:
        name = node.op.split(":", 1)[1]
        for new in node.writes.values():
            if name == "score_int8":
                self.set(new, iv.scalar(0.0, 1.0))
            else:
                self.set(new, iv.float_top() if not iv.is_int_dtype(
                    self._dtype(new)) else iv.top_for(self._dtype(new)))

    # -- aten handlers --------------------------------------------------------

    def _aten(self, node: Node) -> None:
        _, name, overload = (node.op.split(".") + [""])[:3]
        h = getattr(self, f"op_{name}", None)
        if h is None:
            self.top_outs(node)
            return
        h(node, overload)

    def _a(self, node: Node, i: int, key: str | None = None, default=None):
        if i < len(node.args):
            return node.args[i]
        if key is not None and key in node.kwargs:
            return node.kwargs[key]
        return default

    def _out(self, node: Node) -> int:
        return node.outs[0]

    def _float_out(self, node: Node) -> bool:
        return not iv.is_int_dtype(self._dtype(self._out(node)))

    def _arith(self, node: Node, f, *vals: IVal) -> None:
        out = self._out(node)
        if self._float_out(node):
            ok = all(iv.finite(v) for v in vals)
            self.set(out, _round_out(f(*vals), self._dtype(out)) if ok
                     else iv.float_top())
            return
        self.set(out, self.checked(node, f(*vals), out))

    # elementwise arithmetic (escape-checked)

    def op_add(self, node, ov):
        a, b = self.val(node.args[0], node), self.val(node.args[1], node)
        alpha = node.kwargs.get("alpha", 1)
        if alpha != 1:
            b = iv.mul(b, iv.scalar(alpha, alpha))
        self._arith(node, iv.add, a, b)

    def op_sub(self, node, ov):
        a, b = self.val(node.args[0], node), self.val(node.args[1], node)
        alpha = node.kwargs.get("alpha", 1)
        if alpha != 1:
            b = iv.mul(b, iv.scalar(alpha, alpha))
        self._arith(node, iv.sub, a, b)

    def op_rsub(self, node, ov):
        a, b = self.val(node.args[0], node), self.val(node.args[1], node)
        self._arith(node, iv.sub, b, a)

    def op_mul(self, node, ov):
        a, b = self.val(node.args[0], node), self.val(node.args[1], node)
        if self._dtype(self._out(node)).kind == "b":
            self.set(self._out(node), iv.bit_and(a, b, np.bool_))
            return
        self._arith(node, iv.mul, a, b)

    def op_neg(self, node, ov):
        self._arith(node, iv.neg, self.val(node.args[0], node))

    def op_abs(self, node, ov):
        self._arith(node, iv.absolute, self.val(node.args[0], node))

    def op___lshift__(self, node, ov):
        a, s = self.val(node.args[0], node), self.val(node.args[1], node)
        out = self._out(node)
        self.set(out, self.checked(node, iv.shift_left(a, s), out,
                                   prim="lshift"))


    def op___rshift__(self, node, ov):
        a, s = self.val(node.args[0], node), self.val(node.args[1], node)
        self.set(self._out(node), iv.shift_right_arith(a, s))


    def op_bitwise_and(self, node, ov):
        a, b = self.val(node.args[0], node), self.val(node.args[1], node)
        dt = self._dtype(self._out(node))
        (alo, ahi), (blo, bhi) = a.bounds(), b.bounds()
        if alo >= 0 or blo >= 0:
            if alo >= 0 and blo >= 0:
                r = iv.bit_and(a, b, dt)
            else:
                nn = a if alo >= 0 else b
                r = IVal(nn.hi * 0, nn.hi)
        else:
            r = iv.top_for(dt)
        self.set(self._out(node), r)

    def op_bitwise_or(self, node, ov):
        a, b = self.val(node.args[0], node), self.val(node.args[1], node)
        self.set(self._out(node), iv.bit_or_xor(
            a, b, self._dtype(self._out(node)), True))

    def op_bitwise_xor(self, node, ov):
        a, b = self.val(node.args[0], node), self.val(node.args[1], node)
        self.set(self._out(node), iv.bit_or_xor(
            a, b, self._dtype(self._out(node)), False))

    def op_bitwise_not(self, node, ov):
        a = self.val(node.args[0], node)
        out = self._out(node)
        if self._dtype(out).kind == "b":
            lo, hi = a.bounds()
            self.set(out, iv.scalar(1 - hi, 1 - lo))
        else:   # ~x = -x - 1, exact
            self.set(out, iv.sub(iv.neg(a), iv.scalar(1, 1)))

    def op_div(self, node, ov):
        a, b = self.val(node.args[0], node), self.val(node.args[1], node)
        out = self._out(node)
        dt = self._dtype(out)
        mode = node.kwargs.get("rounding_mode")
        if iv.is_int_dtype(dt):
            self.set(out, iv.div(a, b, dt))
        elif mode is None and iv.finite(a) and iv.finite(b):
            self.set(out, _round_out(iv.div(a, b, dt), dt))
        elif mode is not None and iv.finite(a) and iv.finite(b):
            d = iv.div(a, b, dt)
            lo, hi = d.bounds()
            self.set(out, iv.scalar(math.floor(lo), math.ceil(hi)))
        else:
            self.set(out, iv.float_top())

    def op_remainder(self, node, ov):
        a, b = self.val(node.args[0], node), self.val(node.args[1], node)
        out = self._out(node)
        dt = self._dtype(out)
        blo, bhi = b.bounds()
        if iv.is_int_dtype(dt) and blo > 0:
            self.set(out, iv.scalar(0, bhi - 1))   # Python-style mod
        else:
            self.set(out, iv.top_for(dt) if iv.is_int_dtype(dt)
                     else iv.float_top())

    def op_reciprocal(self, node, ov):
        a = self.val(node.args[0], node)
        lo, hi = a.bounds()
        out = self._out(node)
        if iv.finite(a) and (lo > 0 or hi < 0):
            self.set(out, _round_out(iv.scalar(min(1 / lo, 1 / hi),
                                               max(1 / lo, 1 / hi)),
                                     self._dtype(out)))
        else:
            self.set(out, iv.float_top())

    def op_floor(self, node, ov):
        self.set(self._out(node), iv.float_unary("floor",
                                                 self.val(node.args[0], node)))

    def op_round(self, node, ov):
        a = self.val(node.args[0], node)
        if not iv.finite(a):
            self.set(self._out(node), iv.float_top())
            return
        lo, hi = a.bounds()
        self.set(self._out(node), iv.scalar(float(math.floor(lo)),
                                            float(math.ceil(hi))))

    def op_clamp(self, node, ov):
        x = self.val(node.args[0], node)
        lo_b = self._a(node, 1, "min")
        hi_b = self._a(node, 2, "max")
        if lo_b is not None:
            x = iv.vmax(x, self.val(lo_b, node))
        if hi_b is not None:
            x = iv.vmin(x, self.val(hi_b, node))
        self.set(self._out(node), x)

    # comparisons

    def _cmp(self, node, name):
        a, b = self.val(node.args[0], node), self.val(node.args[1], node)
        alo, ahi = a.bounds()
        blo, bhi = b.bounds()
        decided = None
        if name == "lt":
            decided = True if ahi < blo else False if alo >= bhi else None
        elif name == "le":
            decided = True if ahi <= blo else False if alo > bhi else None
        elif name == "gt":
            decided = True if alo > bhi else False if ahi <= blo else None
        elif name == "ge":
            decided = True if alo >= bhi else False if ahi < blo else None
        elif name == "eq":
            decided = (True if alo == ahi == blo == bhi
                       else False if ahi < blo or alo > bhi else None)
        elif name == "ne":
            decided = (False if alo == ahi == blo == bhi
                       else True if ahi < blo or alo > bhi else None)
        self.set(self._out(node), iv.scalar(0, 1) if decided is None
                 else iv.scalar(int(decided), int(decided)))

    def op_lt(self, node, ov):
        self._cmp(node, "lt")

    def op_le(self, node, ov):
        self._cmp(node, "le")

    def op_gt(self, node, ov):
        self._cmp(node, "gt")

    def op_ge(self, node, ov):
        self._cmp(node, "ge")

    def op_eq(self, node, ov):
        self._cmp(node, "eq")

    def op_ne(self, node, ov):
        self._cmp(node, "ne")

    def op_sign(self, node, ov):
        self.set(self._out(node), iv.scalar(-1, 1) if not self._float_out(
            node) else iv.scalar(-1.0, 1.0))

    def op_relu(self, node, ov):
        x = self.val(node.args[0], node)
        self.set(self._out(node), iv.vmax(x, iv.scalar(0, 0)))

    # where, refined by its own predicate

    def _refine(self, pred, truth: bool, ref) -> IVal | None:
        """``ref``'s interval where ``pred`` is ``truth``, when ``pred``
        compares a value ``x`` with a constant and ``ref`` is ``x`` or
        ``x`` plus or minus a constant; else None."""
        if not isinstance(pred, Ref) or not isinstance(ref, Ref):
            return None
        pn = self._producer(pred.vid)
        if pn is None or len(pn.args) < 2 or not isinstance(pn.args[0], Ref) \
                or not isinstance(pn.args[1], (int, float)) \
                or isinstance(pn.args[1], bool):
            return None
        op = pn.op.split(".")[1]
        if op not in ("ge", "gt", "lt", "le"):
            return None
        x, c = pn.args[0], pn.args[1]
        exact = isinstance(c, int) and iv.is_int_dtype(self._dtype(x.vid))
        # the predicate as "x >= lo_bound" (True) or "x <= hi_bound"
        if op in ("lt", "ge"):
            at_least = (op == "ge") == truth      # x >= c, else x < c
            bound = c if at_least else (c - 1 if exact else c)
        else:
            at_least = (op == "gt") == truth      # x > c, else x <= c
            bound = (c + 1 if exact else c) if at_least else c
        xv = self.get(x.vid)
        lim = (IVal(iv.emax(xv.lo, bound), xv.hi) if at_least
               else IVal(xv.lo, iv.emin(xv.hi, bound)))
        lim = self._empty_to_bottom(lim)
        if ref.vid == x.vid:
            return lim
        rn = self._producer(ref.vid)
        if rn is not None and rn.op in ("aten.sub.Tensor", "aten.add.Tensor") \
                and isinstance(rn.args[0], Ref) and rn.args[0].vid == x.vid \
                and isinstance(rn.args[1], int) \
                and rn.kwargs.get("alpha", 1) == 1:
            k = iv.scalar(rn.args[1], rn.args[1])
            return (iv.sub if rn.op == "aten.sub.Tensor" else iv.add)(lim, k)
        return None

    @staticmethod
    def _empty_to_bottom(v: IVal) -> IVal:
        bad = v.lo > v.hi
        if isinstance(bad, np.ndarray):
            if bad.any():
                lo, hi = v.lo.copy(), v.hi.copy()
                lo[bad], hi[bad] = _INF, -_INF
                return IVal(lo, hi)
            return v
        return bottom() if bad else v

    def _producer(self, vid: int) -> Node | None:
        p = self.t.values[vid].producer
        return self.t.nodes[p] if p >= 0 else None

    def op_where(self, node, ov):
        cond, a, b = node.args[0], node.args[1], node.args[2]
        c = self.val(cond, node)
        clo, chi = c.bounds()
        va, vb = self.val(a, node), self.val(b, node)
        if clo == chi == 1:
            self.set(self._out(node), va)
            return
        if clo == chi == 0:
            self.set(self._out(node), vb)
            return
        ra = self._refine(cond, True, a)
        rb = self._refine(cond, False, b)
        va = va if ra is None else ra
        vb = vb if rb is None else rb
        self.set(self._out(node), iv.join(va, vb))

    # conversions

    def _convert(self, node, src: IVal, out: int) -> IVal:
        dt = self._dtype(out)
        if dt.kind == "b":
            lo, hi = src.bounds()
            return iv.scalar(0, 1) if not (lo == hi == 0) else iv.scalar(0, 0)
        if iv.is_int_dtype(dt):
            lo, hi = src.bounds()
            if isinstance(lo, float) or isinstance(hi, float):
                lo = math.floor(lo) if math.isfinite(lo) else -(1 << 90)
                hi = math.ceil(hi) if math.isfinite(hi) else (1 << 90)
                src = iv.scalar(int(lo), int(hi))
            return self.checked(node, src, out, narrowing=True,
                                prim="convert")
        if not iv.finite(src):
            return iv.float_top()
        return _round_out(src, dt)

    def op__to_copy(self, node, ov):
        out = self._out(node)
        self.set(out, self._convert(node, self.val(node.args[0], node), out))

    def op_copy_(self, node, ov):
        # self.copy_(src): the written value is src converted
        (new,) = node.writes.values() or node.outs
        self.set(new, self._convert(node, self.val(node.args[1], node), new))

    def op_view(self, node, ov):
        out = self._out(node)
        if ov == "dtype":   # a bitcast
            self.set(out, iv.top_for(self._dtype(out)) if iv.is_int_dtype(
                self._dtype(out)) else iv.float_top())
            return
        self._same(node)

    def _same(self, node):
        v = self.get(node.args[0].vid) if isinstance(node.args[0], Ref) \
            else self.val(node.args[0], node)
        out = self._out(node)
        shape = self.t.values[out].shape
        if not v.is_scalar():
            try:
                v = IVal(np.reshape(v.lo, shape), np.reshape(v.hi, shape))
            except ValueError:
                v = v.collapse()
        self.set(out, v)

    op__unsafe_view = op_unsqueeze = op_detach = op_clone = op_view

    def op_expand(self, node, ov):
        v = self.get(node.args[0].vid)
        out = self._out(node)
        self.set(out, v if v.is_scalar()
                 else _full(v, self.t.values[out].shape))

    def op_transpose(self, node, ov):
        v = self.get(node.args[0].vid)
        out = self._out(node)
        if not v.is_scalar():
            d0, d1 = node.args[1], node.args[2]
            v = IVal(np.swapaxes(v.lo, d0, d1), np.swapaxes(v.hi, d0, d1))
        self.set(out, v)

    def op_select(self, node, ov):
        v = self.get(node.args[0].vid)
        if not v.is_scalar():
            dim, idx = node.args[1], node.args[2]
            v = IVal(np.take(v.lo, idx, axis=dim), np.take(v.hi, idx, axis=dim))
        self.set(self._out(node), v)

    def op_slice(self, node, ov):
        v = self.get(node.args[0].vid)
        if not v.is_scalar():
            dim = self._a(node, 1, "dim", 0)
            start = self._a(node, 2, "start", None)
            end = self._a(node, 3, "end", None)
            step = self._a(node, 4, "step", 1)
            n = v.lo.shape[dim]
            start = 0 if start is None else start
            end = n if end is None else min(end, n)
            sl = [slice(None)] * v.lo.ndim
            sl[dim] = slice(start, end, step)
            v = IVal(v.lo[tuple(sl)], v.hi[tuple(sl)])
        self.set(self._out(node), v)

    def op_unbind(self, node, ov):
        v = self.get(node.args[0].vid)
        dim = self._a(node, 1, "dim", 0)
        for i, o in enumerate(node.outs):
            self.set(o, v if v.is_scalar() else IVal(
                np.take(v.lo, i, axis=dim), np.take(v.hi, i, axis=dim)))

    def _pieces(self, node, tensors, axis, stack: bool):
        out = self._out(node)
        shape = self.t.values[out].shape
        n = int(np.prod(shape, dtype=np.int64)) if shape else 1
        vals = [self.val(r, node) for r in tensors]
        if n > FULL_MAX:
            self.set(out, iv.join_all([v.collapse() for v in vals]))
            return
        los, his = [], []
        for r, v in zip(tensors, vals):
            shp = self.t.values[r.vid].shape
            f = _full(v, shp) if shp else v
            lo, hi = (f.lo, f.hi) if not f.is_scalar() else (
                np.full(shp, f.lo[()], dtype=object),
                np.full(shp, f.hi[()], dtype=object))
            los.append(lo)
            his.append(hi)
        cat = np.stack if stack else np.concatenate
        try:
            self.set(out, IVal(cat(los, axis=axis), cat(his, axis=axis)))
        except ValueError:
            self.set(out, iv.join_all([v.collapse() for v in vals]))

    def op_stack(self, node, ov):
        self._pieces(node, node.args[0], self._a(node, 1, "dim", 0), True)

    def op_cat(self, node, ov):
        ts = [r for r in node.args[0]
              if self.t.values[r.vid].shape != (0,)]
        self._pieces(node, ts, self._a(node, 1, "dim", 0), False)

    # gathers and sorts: a subset of the operand's values

    def _subset(self, node, ov):
        self.set(self._out(node), self.val(node.args[0], node).collapse())

    op_index = op_gather = _subset

    def op_sort(self, node, ov):
        x = node.args[0]
        v = self.val(x, node).collapse()
        dim = node.kwargs.get("dim", self._a(node, 2, None, -1))
        shp = self.t.values[x.vid].shape
        n = shp[dim] if shp else 1
        self.set(node.outs[0], v)
        self.set(node.outs[1], iv.scalar(0, max(n - 1, 0)))

    def _reduce_idx(self, node, ov=None):
        x = node.args[0]
        shp = self.t.values[x.vid].shape
        dim = self._a(node, 1, "dim", None)
        n = shp[dim] if shp and dim is not None else max(
            int(np.prod(shp, dtype=np.int64)), 1)
        self.set(node.outs[0], self.val(x, node).collapse())
        if len(node.outs) > 1:
            self.set(node.outs[1], iv.scalar(0, max(n - 1, 0)))

    op_max = op_min = op_cummax = _reduce_idx

    # reductions

    def op_sum(self, node, ov):
        x = node.args[0]
        v = self.val(x, node)
        shp = self.t.values[x.vid].shape
        dims = self._a(node, 1, "dim", None)
        if ov == "default" or not dims:
            dims = list(range(len(shp)))
        dims = [d % len(shp) for d in dims] if shp else []
        n = int(np.prod([shp[d] for d in dims], dtype=np.int64)) if dims \
            else 1
        out = self._out(node)
        if not dims:
            exact = v
        elif v.is_scalar():
            exact = IVal(v.lo * n, v.hi * n)
        else:
            exact = IVal(v.lo.sum(axis=tuple(dims)), v.hi.sum(axis=tuple(dims)))
        if self._float_out(node):
            # a float sum rounds at each of its n - 1 adds: one step
            # outward per add bounds it
            self.set(out, _round_sum(exact, n, self._dtype(out))
                     if iv.finite(v) else iv.float_top())
            return
        self.set(out, self.checked(node, exact, out))

    def op_cumsum(self, node, ov):
        x = node.args[0]
        v = self.val(x, node)
        dim = self._a(node, 1, "dim", 0)
        shp = self.t.values[x.vid].shape
        n = shp[dim] if shp else 1
        if v.is_scalar():
            lo, hi = v.bounds()
            exact = iv.scalar(min(lo, lo * n), max(hi, hi * n))
        else:
            exact = IVal(np.cumsum(v.lo, axis=dim), np.cumsum(v.hi, axis=dim))
        out = self._out(node)
        if self._float_out(node):
            # a float sum rounds at each of its n - 1 adds: one step
            # outward per add bounds it
            self.set(out, _round_sum(exact, n, self._dtype(out))
                     if iv.finite(v) else iv.float_top())
            return
        self.set(out, self.checked(node, exact, out))

    def op_bincount(self, node, ov):
        x = node.args[0]
        n = max(int(np.prod(self.t.values[x.vid].shape, dtype=np.int64)), 1)
        out = self._out(node)
        self.set(out, self.checked(node, iv.scalar(0, n), out))

    # in-place writes

    def _written(self, node) -> int:
        return next(iter(node.writes.values()))

    def _acc(self, node, old: IVal, upd: IVal, n_upd: int, new: int):
        """``old`` plus up to ``n_upd`` of ``upd``'s values added to one
        element, escape-checked."""
        ulo, uhi = upd.bounds()
        olo, ohi = old.bounds()
        if not iv.is_int_dtype(self._dtype(new)):
            ok = iv.finite(old) and iv.finite(upd)
            self.set(new, _round_sum(iv.scalar(olo + n_upd * min(ulo, 0),
                                               ohi + n_upd * max(uhi, 0)),
                                     n_upd + 1, self._dtype(new))
                     if ok else iv.float_top())
            return
        exact = iv.scalar(olo + n_upd * min(ulo, 0), ohi + n_upd * max(uhi, 0))
        self.set(new, self.checked(node, exact, new, prim="add"))

    def _self_old(self, node) -> IVal:
        v = self.get(node.args[0].vid)
        if is_bottom(v):
            return bottom()
        return v.collapse()

    def op_index_add_(self, node, ov):
        old = self._self_old(node)
        src = node.args[3]
        dim = node.args[1]
        n = self.t.values[src.vid].shape[dim] if self.t.values[
            src.vid].shape else 1
        upd = self.val(src, node)
        alpha = node.kwargs.get("alpha", 1)
        if alpha != 1:
            upd = iv.mul(upd, iv.scalar(alpha, alpha))
        self._acc(node, old if not is_bottom(old) else iv.scalar(0, 0), upd,
                  n, self._written(node))


    def op_scatter_reduce_(self, node, ov):
        old = self._self_old(node)
        src = node.args[3]
        red = node.args[4] if len(node.args) > 4 else node.kwargs["reduce"]
        upd = self.val(src, node)
        new = self._written(node)
        if red == "sum":
            n = max(int(np.prod(self.t.values[src.vid].shape,
                                dtype=np.int64)), 1)
            self._acc(node, old if not is_bottom(old) else iv.scalar(0, 0),
                      upd, n, new)
        elif red in ("amax", "amin", "max", "min"):
            self.set(new, iv.join(old, upd.collapse()) if not is_bottom(old)
                     else upd.collapse())
        else:
            self.top_outs(node)

    def op_scatter_(self, node, ov):
        old = self._self_old(node)
        upd = self.val(node.args[3], node).collapse()
        self.set(self._written(node), upd if is_bottom(old)
                 else iv.join(old, upd))


    def op_index_put_(self, node, ov):
        old = self._self_old(node)
        upd = self.val(node.args[2], node).collapse()
        acc = self._a(node, 3, "accumulate", False)
        new = self._written(node)
        if acc:
            n = max(int(np.prod(self.t.values[node.args[2].vid].shape,
                                dtype=np.int64)), 1) if isinstance(
                node.args[2], Ref) else 1
            self._acc(node, old if not is_bottom(old) else iv.scalar(0, 0),
                      upd, n, new)
        else:
            self.set(new, upd if is_bottom(old) else iv.join(old, upd))


    def op_add_(self, node, ov):
        new = self._written(node)
        a = self.get(node.args[0].vid)
        b = self.val(node.args[1], node)
        if iv.is_int_dtype(self._dtype(new)):
            self.set(new, self.checked(node, iv.add(a, b), new, prim="add"))
        else:
            self.set(new, iv.add(a, b) if iv.finite(a) and iv.finite(b)
                     else iv.float_top())

    def op__foreach_add_(self, node, ov):
        selfs, others = node.args[0], node.args[1]
        for s, o in zip(selfs, others):
            new = node.writes.get(s.vid)
            if new is None:
                continue
            a, b = self.get(s.vid), self.val(o, node)
            if iv.is_int_dtype(self._dtype(new)):
                self.set(new, self.checked(node, iv.add(a, b), new,
                                           prim="add"))
            else:
                self.set(new, iv.float_top())

    # factories

    def _const_fill(self, node, v):
        self.set(self._out(node), v)

    def op_zeros(self, node, ov):
        self._const_fill(node, iv.scalar(0, 0))

    op_zeros_like = op_zeros

    def op_ones(self, node, ov):
        self._const_fill(node, iv.scalar(1, 1))

    op_ones_like = op_ones

    def op_full(self, node, ov):
        self._const_fill(node, self.val(node.args[1], node))

    op_full_like = op_full

    def op_scalar_tensor(self, node, ov):
        self._const_fill(node, self.val(node.args[0], node))

    def op_empty(self, node, ov):
        self._const_fill(node, bottom())

    op_empty_like = op_empty

    def op_arange(self, node, ov):
        nums = [a for a in node.args if isinstance(a, (int, float))]
        if ov == "default":
            start, end, step = 0, nums[0], 1
        else:
            start, end = nums[0], nums[1]
            step = nums[2] if len(nums) > 2 else 1
        n = self.t.values[self._out(node)].shape[0]
        last = start + step * max(n - 1, 0)
        self._const_fill(node, iv.scalar(min(start, last), max(start, last)))


def _round_out(v: IVal, dtype) -> IVal:
    """``v`` widened to the floats of ``dtype`` around it: the largest at
    or below its lower bound and the smallest at or above its upper one.
    Rounding is monotone, so a rounded result (a conversion, or one
    arithmetic op whose exact result lies in ``v``) lies inside.  The
    bounds, computed in float64, first move out one float64 step."""
    ft = np.float64 if np.dtype(dtype) == np.float64 else np.float32
    lo, hi = v.bounds()
    try:
        lo, hi = float(lo), float(hi)
    except OverflowError:
        return iv.float_top()
    if math.isnan(lo) or math.isnan(hi):
        return iv.float_top()
    lo, hi = math.nextafter(lo, -_INF), math.nextafter(hi, _INF)
    flo, fhi = ft(lo), ft(hi)
    if float(flo) > lo:
        flo = np.nextafter(flo, ft(-_INF))
    if float(fhi) < hi:
        fhi = np.nextafter(fhi, ft(_INF))
    return iv.scalar(float(flo), float(fhi))


def _round_sum(v: IVal, n: int, dtype) -> IVal:
    """A float sum of ``n`` terms whose exact value lies in ``v``: each
    add rounds to within half a step of its result, so ``n`` relative
    steps outward bound them all."""
    lo, hi = v.bounds()
    try:
        lo, hi = float(lo), float(hi)
    except OverflowError:
        return iv.float_top()
    eps = float(np.finfo(np.float64 if np.dtype(dtype) == np.float64
                         else np.float32).eps)
    pad = (abs(lo) + abs(hi)) * eps * max(n, 1)
    return _round_out(iv.scalar(lo - pad, hi + pad), dtype)


def analyze(trace: StepTrace, seeds: dict[str, IVal], *,
            entries: tuple = reg.WRAP_OK, collect=None) -> Analysis:
    """Run the range proof over one recorded step graph.  ``seeds``
    maps input leaf names to their declared intervals
    (:mod:`.seeds`); ``entries`` is the WRAP_OK registry in force.
    ``collect(node)`` may name a node (a key) whose first result's
    interval lands in :attr:`Analysis.collected` (joined over the nodes
    with one key), as the reference's ``collect`` hook does for an
    equation."""
    pr = _Prover(trace, seeds, entries, collect)
    pr.run()
    return Analysis(findings=pr.findings, wrap_matches=pr.wrap_matches,
                    unmodeled=pr.unmodeled,
                    n_eqns=sum(1 for n in trace.nodes if n.op != "refresh"),
                    n_checked=pr.n_checked, collected=pr.collected,
                    outputs={n: pr.get(v).bounds()
                             for n, v in trace.outputs if v is not None})
