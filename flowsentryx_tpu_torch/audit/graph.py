"""The staged step graph and the contract checks over it.

Counterpart of ``flowsentryx_tpu/audit/graph.py``.  The reference
traces a variant to a ``ClosedJaxpr`` and compiles it to HLO without
running a batch; the port's counterpart has two levels:

* **The aten graph** (the jaxpr's counterpart): one call of the
  variant's step function on an all-masked input (``n_valid = 0``) over
  a scratch table and stats of the live shapes, the call
  :class:`~..ops.graph.StepGraph`'s warm-ups already make, recorded op
  by op by :class:`Recorder` (a ``TorchDispatchMode``).  Each node keeps
  its operands' and results' dtypes and shapes, which values it reads,
  writes and produces (in-place writes and writes through a view are
  tracked, so the dataflow is exact), and its user frames,
  ``(file, function)`` innermost first, walked from ``sys._getframe()``
  (the dispatch mode sees every op; ``make_fx`` keeps no stack here).
  A hand-written kernel launch is a ctypes call, invisible to the
  dispatch mode: each is recorded in op order through the launch
  counter's hook (:func:`~..ops.kernels.counting_into`) as a node
  ``kernel:<name>`` over the operands the wrapper passes it.  The
  sharded step's exchange sites (``parallel/step.py``'s
  ``_all_to_all``, ``_psum``, ``_pmax``, ``_all_gather``,
  ``_axis_index``) report their calls, with their operand sizes, to
  :func:`~..parallel.step.recording_exchanges`.
* **The captured CUDA graph** (the compiled HLO's counterpart; card
  only): :attr:`~..ops.graph.StepGraph.census`, read from the kept
  ``cudaGraph_t`` with libcuda.

Every check returns :class:`Finding`\\s naming the offending node (its
index, op and innermost user frame) or leaf, the diagnostic shape of
the reference.  Contract catalog:

* :func:`check_dtypes` -- no complex value anywhere; float64 only under
  an audited allowlist of frames (:data:`F64_OK`, kept with ``WRAP_OK``'s
  staleness discipline by :func:`audit_f64_allowlist`): the float32
  rounding emulation of ``core/device.py``.
* :func:`check_quantized_lane` -- an int8 model's step bodies launch
  ``score_int8`` (card), or its plain lane multiplies and sums in an
  integer dtype (CPU).
* :func:`check_host_sync` -- no host read (``.item()``, ``nonzero``,
  ``masked_select``, ``unique``) and no copy with a host end in the
  step; on the card, no host node and no host-ended memcpy node in the
  captured graph (:func:`check_graph_census`).
* :func:`check_in_place` -- the step returns the very table and stats
  tensors it took (the port updates them in place where the reference
  donates), with unchanged dtypes and shapes.
* :func:`check_table_copies` -- no node copies, converts or allocates a
  table-shaped buffer; writes into the table itself are in place.
* :func:`check_collectives` -- the exchange sites are the designed set.
* :func:`staging_check` -- two constructions of one batch stage the
  same static input.
"""

from __future__ import annotations

import dataclasses
import sys
from pathlib import Path
from typing import Any, Callable, Iterator

import torch
from torch.utils._python_dispatch import (
    TorchDispatchMode, _disable_current_modes,
)

#: The repository root: frames are reported relative to it.
ROOT = Path(__file__).resolve().parents[2]
_TORCH_DIR = str(Path(torch.__file__).resolve().parent)
_THIS = str(Path(__file__).resolve())


@dataclasses.dataclass
class Finding:
    """One violated contract, pinned to a node or a leaf."""

    contract: str   # dtype | quantized | transfer | donation | ...
    reason: str     # human-actionable sentence
    where: str = ""  # node path ("nodes[3]:aten._to_copy.default@file:fn")
    #                  or leaf name ("table.key_rows", "out.wire")
    eqn: str = ""   # the offending node's text (trimmed)

    def to_json(self) -> dict:
        return {k: v for k, v in dataclasses.asdict(self).items() if v}

    def __str__(self) -> str:
        loc = f" at {self.where}" if self.where else ""
        eqn = f"\n    {self.eqn}" if self.eqn else ""
        return f"[{self.contract}]{loc}: {self.reason}{eqn}"


class AuditError(RuntimeError):
    """Raised when an audited variant violates a contract (engine boot
    refuses to serve on it; ``fsx audit`` exits 1)."""

    def __init__(self, variant: str, findings: list[Finding]):
        self.variant = variant
        self.findings = findings
        lines = "\n  ".join(str(f) for f in findings)
        super().__init__(
            f"fsx audit: step variant {variant!r} violates "
            f"{len(findings)} contract(s):\n  {lines}")


# ---------------------------------------------------------------------------
# The aten graph
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Ref:
    """A tensor operand of a node: the value it held when read."""

    vid: int


@dataclasses.dataclass
class Value:
    """One tensor value of the graph (a tensor between two writes)."""

    vid: int
    dtype: str              # torch's name: "int64", "float32", "bool", ...
    shape: tuple[int, ...]
    device: str             # "cpu" | "cuda"
    storage: int            # storage key (its data pointer)
    producer: int           # node index; -1 for an input or a constant
    name: str = ""          # input leaf name, or "" for an intermediate

    @property
    def numel(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        return n


@dataclasses.dataclass
class Node:
    """One recorded op: an aten call, a kernel launch or an alias read."""

    idx: int
    op: str                  # "aten.add.Tensor", "kernel:score_int8", "refresh"
    args: tuple              # operands, tensors as :class:`Ref`
    kwargs: dict
    ins: list[int]           # values read
    outs: list[int]          # values produced, in result order
    writes: dict[int, int]   # in place: value before -> value after
    frames: tuple[tuple[str, str], ...]   # user (file, function), innermost first

    def where(self) -> str:
        at = f"@{self.frames[0][0]}:{self.frames[0][1]}" if self.frames else ""
        return f"nodes[{self.idx}]:{self.op}{at}"

    def text(self, trace: "StepTrace", limit: int = 160) -> str:
        def fmt(v):
            if isinstance(v, Ref):
                m = trace.values[v.vid]
                return f"%{v.vid}:{m.dtype}{list(m.shape)}"
            if isinstance(v, (list, tuple)):
                return "[" + ", ".join(fmt(x) for x in v) + "]"
            return repr(v)
        outs = ", ".join(fmt(Ref(o)) for o in self.outs)
        args = ", ".join([fmt(a) for a in self.args]
                         + [f"{k}={fmt(v)}" for k, v in self.kwargs.items()])
        txt = f"{outs} = {self.op}({args})"
        return txt if len(txt) <= limit else txt[:limit - 3] + "..."


@dataclasses.dataclass
class StepTrace:
    """One recorded call: the aten graph of a step variant."""

    nodes: list[Node]
    values: dict[int, Value]
    inputs: dict[str, int]          # leaf name -> value
    outputs: list[tuple[str, Any]]  # (leaf name, value id or None)
    consts: dict[int, torch.Tensor]  # small constants, by value (host copies)
    exchanges: list[tuple[str, list[int]]]  # (site, operand sizes) per call
    launches: dict[str, int]        # kernel launches in the call
    seconds: float = 0.0

    def aten_nodes(self) -> Iterator[Node]:
        return (n for n in self.nodes if n.op.startswith("aten."))


def _flat(x) -> list:
    """Leaves of an op's argument tree (lists and tuples of operands)."""
    if isinstance(x, (list, tuple)):
        out = []
        for v in x:
            out += _flat(v)
        return out
    if isinstance(x, dict):
        return _flat(list(x.values()))
    return [x]


def _map(f, x):
    if isinstance(x, (list, tuple)):
        return type(x)(_map(f, v) for v in x) if not hasattr(x, "_fields") \
            else type(x)(*(_map(f, v) for v in x))
    if isinstance(x, dict):
        return {k: _map(f, v) for k, v in x.items()}
    return f(x)


def _dtype_name(dt: torch.dtype) -> str:
    return str(dt).removeprefix("torch.")


_REL: dict[str, str | None] = {}


def _rel(fn: str) -> str | None:
    """A frame's file relative to the repository root, or None for a
    frame that is not the program's (torch, the recorder, the stdlib's
    context managers, generated code)."""
    r = _REL.get(fn, False)
    if r is not False:
        return r
    if fn.startswith(_TORCH_DIR) or fn == _THIS or \
            "/contextlib.py" in fn or fn.startswith("<"):
        r = None
    else:
        p = Path(fn)
        try:
            r = p.resolve().relative_to(ROOT).as_posix()
        except ValueError:
            r = p.as_posix()
    _REL[fn] = r
    return r


def _user_frames(f, limit: int = 40) -> tuple[tuple[str, str], ...]:
    """``(file, function)`` of the program's frames above ``f``,
    innermost first, files relative to the repository root."""
    out = []
    while f is not None and len(out) < limit:
        code = f.f_code
        r = _rel(code.co_filename)
        if r is not None:
            out.append((r, code.co_name))
        f = f.f_back
    return tuple(out)


class Recorder(TorchDispatchMode):
    """Records every aten op of a call into a :class:`StepTrace`.

    Values are tracked by tensor identity and version counter: an op
    that writes a tensor in place gives it a new value; a tensor read
    after a write through another view of its storage is first given a
    ``refresh`` node over its old value and every write into that
    storage since (the range prover joins them)."""

    def __init__(self):
        super().__init__()
        self.nodes: list[Node] = []
        self.values: dict[int, Value] = {}
        self.consts: dict[int, torch.Tensor] = {}
        self._ids: dict[int, tuple[torch.Tensor, int, int]] = {}
        self._keep: list[torch.Tensor] = []
        self._writes: dict[int, list[tuple[int, int]]] = {}  # storage -> (seq, vid)
        self._born: dict[int, int] = {}                       # vid -> seq
        self._seq = 0

    # -- values ----------------------------------------------------------

    def _new(self, t: torch.Tensor, producer: int, name: str = "") -> int:
        vid = len(self.values)
        try:
            storage = t.untyped_storage().data_ptr()
        except (RuntimeError, NotImplementedError):
            storage = -1 - vid
        self.values[vid] = Value(vid, _dtype_name(t.dtype), tuple(t.shape),
                                 t.device.type, storage, producer, name)
        self._ids[id(t)] = (t, vid, t._version)
        self._keep.append(t)
        self._seq += 1
        self._born[vid] = self._seq
        return vid

    def add_input(self, t: torch.Tensor, name: str) -> int:
        return self._new(t, -1, name)

    def _read(self, t: torch.Tensor) -> int:
        e = self._ids.get(id(t))
        if e is None or e[0] is not t:
            # a tensor made outside the call: a constant of the step
            vid = self._new(t, -1)
            if t.numel() <= 1 << 16 and not t.is_complex():
                self.consts[vid] = t.detach().to("cpu", copy=True)
            return vid
        _, vid, version = e
        if t._version == version:
            return vid
        # written through another view of its storage since it was read
        st = self.values[vid].storage
        since = [w for s, w in self._writes.get(st, ()) if s > self._born[vid]]
        node = Node(len(self.nodes), "refresh", (Ref(vid),), {},
                    [vid] + since, [], {}, ())
        self.nodes.append(node)
        new = self._new(t, node.idx)
        node.outs.append(new)
        return new

    def _ref(self, x):
        return Ref(self._read(x)) if isinstance(x, torch.Tensor) else x

    # -- ops ---------------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        schema = func._schema
        written: list[torch.Tensor] = []
        for i, a in enumerate(schema.arguments):
            ai = a.alias_info
            if ai is None or not ai.is_write:
                continue
            val = args[i] if i < len(args) else kwargs.get(a.name)
            written += [t for t in _flat(val) if isinstance(t, torch.Tensor)]
        rargs = _map(self._ref, args)
        rkwargs = _map(self._ref, kwargs)
        ins = [r.vid for r in _flat((rargs, rkwargs)) if isinstance(r, Ref)]
        out = func(*args, **kwargs)
        node = Node(len(self.nodes), str(func), rargs, rkwargs, ins, [], {},
                    _user_frames(sys._getframe(1)))
        self.nodes.append(node)
        for t in written:
            old = self._ids[id(t)][1] if id(t) in self._ids else None
            new = self._new(t, node.idx)
            if old is not None:
                node.writes[old] = new
            self._writes.setdefault(self.values[new].storage, []).append(
                (self._seq, new))
        for t in _flat(out):
            if not isinstance(t, torch.Tensor):
                continue
            e = self._ids.get(id(t))
            if e is not None and e[0] is t and e[2] == t._version and \
                    self.values[e[1]].producer == node.idx:
                node.outs.append(e[1])       # an in-place result
            else:
                node.outs.append(self._new(t, node.idx))
        return out

    def _kernel(self, name: str, out_t: torch.Tensor, operands) -> None:
        """A hand-written kernel launch (the launch counter's hook, called
        from ``kernels._count`` inside the wrapper): a node over the
        wrapper's ``operands`` that writes its ``out_t``."""
        with _disable_current_modes():
            rargs = tuple(Ref(self._read(t)) for t in operands)
            old = self._read(out_t)
            # frames from the wrapper out (0: here, 1: ``_count``)
            node = Node(len(self.nodes), f"kernel:{name}", rargs, {},
                        [r.vid for r in rargs] + [old], [], {},
                        _user_frames(sys._getframe(2)))
            self.nodes.append(node)
            # the launch writes ``out`` without bumping its version
            vid = len(self.values)
            self.values[vid] = dataclasses.replace(
                self.values[old], vid=vid, producer=node.idx, name="")
            self._ids[id(out_t)] = (out_t, vid, out_t._version)
            self._seq += 1
            self._born[vid] = self._seq
            node.writes[old] = vid
            node.outs.append(vid)


def _leaves(prefix: str, obj) -> list[tuple[str, Any]]:
    """Named leaves of a NamedTuple tree (``table.key_rows``,
    ``out.wire``); ``None`` fields and non-tensor scalars are kept as
    ``None`` leaves so a contract can name a missing output."""
    if hasattr(obj, "_fields"):
        out = []
        for f in obj._fields:
            out += _leaves(f"{prefix}.{f}" if prefix else f, getattr(obj, f))
        return out
    return [(prefix, obj)]


def trace_call(fn: Callable, args: tuple, arg_names: tuple[str, ...],
               out_names: tuple[str, ...] = ("table", "stats", "out")
               ) -> tuple[StepTrace, Any]:
    """Run ``fn(*args)`` once under the :class:`Recorder` and return
    ``(trace, result)``.  ``arg_names`` names the leading arguments'
    trees (``("table", "stats", "params")``); the rest are ``raw`` (one)
    or ``raw[i]``.  ``out_names`` names the result's trees (a step's
    ``(table, stats, out)``); a bare tensor result is ``out``."""
    import time

    from flowsentryx_tpu_torch.ops import kernels

    from flowsentryx_tpu_torch.parallel import step as pstep

    rec = Recorder()
    for i, a in enumerate(args):
        name = arg_names[i] if i < len(arg_names) else (
            "raw" if len(args) == len(arg_names) + 1
            else f"raw[{i - len(arg_names)}]")
        for leaf, t in _leaves(name, a):
            if isinstance(t, torch.Tensor):
                rec.add_input(t, leaf)
    launches = dict.fromkeys(kernels.LAUNCHES, 0)
    exchanges: list[tuple[str, list[int]]] = []
    t0 = time.perf_counter()
    with torch.no_grad(), pstep.recording_exchanges(exchanges), \
            kernels.counting_into(launches, rec._kernel), rec:
        result = fn(*args)
    seconds = time.perf_counter() - t0
    outputs = []
    trees = (result,) if isinstance(result, torch.Tensor) else result
    for tree, prefix in zip(trees, ("out",) if trees is not result
                            else out_names):
        for leaf, t in _leaves(prefix, tree):
            if isinstance(t, torch.Tensor):
                e = rec._ids.get(id(t))
                vid = e[1] if e is not None and e[0] is t else rec._new(t, -1)
                outputs.append((leaf, vid))
            else:
                outputs.append((leaf, None))
    return StepTrace(rec.nodes, rec.values, {
        v.name: v.vid for v in rec.values.values() if v.name},
        outputs, rec.consts, exchanges, launches, seconds), result


# ---------------------------------------------------------------------------
# contract 1: dtype / precision
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class F64Ok:
    """One audited float64 frame: the float32 rounding emulation."""

    name: str
    file: str
    func: str
    rationale: str

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


#: Frames whose float64 values are the float32 rounding emulation of the
#: reference's XLA:CPU graph (exact products and one rounding; see
#: ``core/device.py``).  The helpers built on them (``xla_exp2``,
#: ``xla_sigmoid``, ``xla_log``, ``xla_log1p``, ``xla_expm1``,
#: ``xla_tanh``) compute their float64 values through these two, so a
#: node matches its innermost entry.  Kept MINIMAL: every entry must
#: name an existing function and match a node of the run.
F64_OK: tuple[F64Ok, ...] = (
    F64Ok("fma32", "flowsentryx_tpu_torch/core/device.py", "fma32",
          "one-rounding float32 multiply-add: the exact product and a "
          "round-to-odd TwoSum in float64, rounded once to float32"),
    F64Ok("xla_exp", "flowsentryx_tpu_torch/core/device.py", "xla_exp",
          "XLA:CPU's expf: the range reduction and each Horner step "
          "formed exactly in float64 and rounded to float32"),
)


def match_frames(entries, frames) -> Any:
    """The entry of the innermost frame that one names (``file`` and
    ``func``), or None."""
    for fname, func in frames:
        for e in entries:
            if func == e.func and fname.endswith(e.file):
                return e
    return None


BANNED_COMPLEX = ("complex32", "complex64", "complex128")


def dtype_histogram(trace: StepTrace) -> dict[str, int]:
    """``dtype -> node-output count`` over the aten graph."""
    hist: dict[str, int] = {}
    for n in trace.aten_nodes():
        for o in n.outs:
            d = trace.values[o].dtype
            hist[d] = hist.get(d, 0) + 1
    return hist


def check_dtypes(trace: StepTrace, entries: tuple = F64_OK
                 ) -> tuple[list[Finding], dict[str, int]]:
    """No complex value anywhere; float64 only in nodes under an
    :data:`F64_OK` frame.  Returns the findings and each entry's match
    count."""
    out: list[Finding] = []
    matches: dict[str, int] = {}
    for n in trace.nodes:
        if n.op == "refresh":
            continue
        dts = {trace.values[v].dtype for v in n.ins + n.outs}
        bad = dts & set(BANNED_COMPLEX)
        if bad:
            out.append(Finding(
                contract="dtype", where=n.where(), eqn=n.text(trace),
                reason=(f"{sorted(bad)[0]} value in the step graph: the "
                        "serving plane is quantized/f32-only")))
            continue
        if "float64" in dts:
            ent = match_frames(entries, n.frames)
            if ent is None:
                out.append(Finding(
                    contract="dtype", where=n.where(), eqn=n.text(trace),
                    reason=("float64 value outside the audited float32 "
                            "rounding emulation (F64_OK): one stray "
                            "promotion doubles every buffer it touches")))
            else:
                matches[ent.name] = matches.get(ent.name, 0) + 1
    return out, matches


def audit_f64_allowlist(entries: tuple, match_counts: dict[str, int],
                        root: Path | None = None) -> list[Finding]:
    """The staleness audit of :data:`F64_OK` (``WRAP_OK``'s discipline):
    each entry names an existing function and matched a node this run."""
    import re

    root = root or ROOT
    out: list[Finding] = []
    for e in entries:
        p = root / e.file
        src = p.read_text() if p.is_file() else ""
        if not re.search(rf"^\s*def {re.escape(e.func)}\b", src, re.MULTILINE):
            out.append(Finding(
                contract="dtype", where=e.name,
                reason=(f"stale F64_OK entry: no function {e.func!r} in "
                        f"{e.file}; delete or retarget the entry")))
        elif not match_counts.get(e.name):
            out.append(Finding(
                contract="dtype", where=e.name,
                reason=(f"stale F64_OK entry: {e.name} matched no float64 "
                        "node in any staged variant this run; an unused "
                        "allowance would silently cover a future leak at "
                        f"{e.file}:{e.func}; delete it")))
    return out


# ---------------------------------------------------------------------------
# contract 1b: the quantized lane
# ---------------------------------------------------------------------------

_INT_DTYPES = ("int8", "int16", "int32", "int64", "uint8")


def check_quantized_lane(trace: StepTrace, device: str,
                         n_launches_expected: int) -> list[Finding]:
    """An int8 model's scorer really is the integer lane: on the card
    each step body (of each shard) launches ``score_int8`` exactly once;
    on the CPU the plain lane multiplies and sums in an integer dtype."""
    if device == "cuda":
        n = sum(1 for x in trace.nodes if x.op == "kernel:score_int8")
        if n != n_launches_expected:
            return [Finding(
                contract="quantized", where="kernel:score_int8",
                reason=(f"{n} score_int8 launches in the step, expected "
                        f"{n_launches_expected} (one per step body and "
                        "shard): the int8 lane was bypassed or doubled"))]
        return []
    lane = [x for x in trace.aten_nodes()
            if any(fn == "score_int8" and f.endswith("ops/kernels.py")
                   for f, fn in x.frames)]
    ops = {x.op.split(".")[1] for x in lane
           if x.outs and trace.values[x.outs[0]].dtype in _INT_DTYPES}
    if not lane or not {"mul", "sum"} <= ops:
        return [Finding(
            contract="quantized", where="score lane",
            reason=("model is configured int8 but its score lane has no "
                    "integer-domain multiply and sum: the int8 lane was "
                    "silently promoted to float"))]
    return []


# ---------------------------------------------------------------------------
# contract 3: host round-trips
# ---------------------------------------------------------------------------

#: Ops that read a device value on the host (each an unbounded sync
#: point in a step that is served as one captured graph).
HOST_SYNC_OPS = frozenset({
    "aten._local_scalar_dense.default", "aten.item.default",
    "aten.nonzero.default", "aten.nonzero_static.default",
    "aten.masked_select.default", "aten._unique2.default",
    "aten.unique_dim.default", "aten.unique_consecutive.default",
    "aten.equal.default", "aten.is_nonzero.default",
})
_COPY_OPS = ("aten._to_copy.default", "aten.copy_.default",
             "aten.to.dtype_layout", "aten._copy_from.default")


def check_host_sync(trace: StepTrace) -> list[Finding]:
    """No host read and no copy with a host end in the step."""
    out = []
    for n in trace.aten_nodes():
        if n.op in HOST_SYNC_OPS:
            out.append(Finding(
                contract="transfer", where=n.where(), eqn=n.text(trace),
                reason=(f"host read {n.op} in the step: the serving "
                        "step's only host contact is the post-step wire "
                        "fetch")))
        elif n.op in _COPY_OPS:
            devs = {trace.values[v].device for v in n.ins + n.outs}
            if len(devs) > 1:
                out.append(Finding(
                    contract="transfer", where=n.where(), eqn=n.text(trace),
                    reason=("copy with a host end in the step "
                            f"({' <-> '.join(sorted(devs))}): a blocking "
                            "transfer inside the served graph")))
    return out


def check_graph_census(census: dict | None, table_bytes: int
                       ) -> list[Finding]:
    """The captured CUDA graph (card only): no host node, no memcpy
    node with a host end, and no memcpy or memset node spanning a
    table-sized buffer."""
    if census is None:
        return []
    out = []
    if census.get("host"):
        out.append(Finding(
            contract="transfer", where="cuda graph",
            reason=f"{census['host']} host node(s) in the captured graph"))
    for k in ("memcpy_h2d", "memcpy_d2h", "memcpy_h2h"):
        if census.get(k):
            out.append(Finding(
                contract="transfer", where="cuda graph",
                reason=f"{census[k]} host-ended memcpy node(s) ({k}) in "
                       "the captured graph"))
    for k in ("max_memcpy_bytes", "max_memset_bytes"):
        if census.get(k, 0) >= table_bytes:
            out.append(Finding(
                contract="inplace", where="cuda graph",
                reason=(f"a {k.split('_')[1]} node of {census[k]} B in the "
                        f"captured graph spans a table-sized buffer (>= "
                        f"{table_bytes} B): the table must be updated in "
                        "place")))
    return out


# ---------------------------------------------------------------------------
# contract 2: in place (the port's donation)
# ---------------------------------------------------------------------------


def check_in_place(before: list[tuple[str, torch.Tensor]],
                   after: list[tuple[str, Any]]) -> tuple[list[Finding], dict]:
    """The step returns the very table and stats tensors it took: same
    object, same address, same dtype and shape (``before`` and
    ``after``: the carried leaves in and out, by name)."""
    findings: list[Finding] = []
    got = dict(after)
    proved = []
    for name, t in before:
        o = got.get(name)
        if not isinstance(o, torch.Tensor):
            findings.append(Finding(
                contract="donation", where=name,
                reason=f"carried state {name} is not returned by the step"))
            continue
        if o.dtype != t.dtype or o.shape != t.shape:
            findings.append(Finding(
                contract="retrace", where=name,
                reason=(f"carried state {name} changes through the step "
                        f"({_dtype_name(t.dtype)}{list(t.shape)} in, "
                        f"{_dtype_name(o.dtype)}{list(o.shape)} out): "
                        "feeding it back would stage a new graph every "
                        "batch")))
        if o is not t or o.data_ptr() != t.data_ptr():
            nbytes = t.numel() * t.element_size()
            findings.append(Finding(
                contract="donation", where=name,
                reason=(f"the step returns a fresh {name} "
                        f"({_dtype_name(o.dtype)}{list(o.shape)}, "
                        f"{nbytes} B) instead of updating it in place: every "
                        "batch would allocate and copy it, and a captured "
                        "graph would serve a stale address")))
        else:
            proved.append(name)
    return findings, {"checked": True, "required": [n for n, _ in before],
                      "in_place": proved}


# ---------------------------------------------------------------------------
# contract 6: table copies
# ---------------------------------------------------------------------------

_ALLOC_OR_COPY = frozenset({
    "aten.clone.default", "aten._to_copy.default", "aten.copy_.default",
    "aten.empty_like.default", "aten.zeros_like.default",
    "aten.ones_like.default", "aten.full_like.default",
    "aten.new_empty.default", "aten.new_zeros.default",
    "aten.new_full.default", "aten.empty.memory_format",
    "aten.zeros.default", "aten.full.default", "aten.contiguous.default",
    "aten.empty_strided.default", "aten.cat.default", "aten.stack.default",
})


def check_table_copies(trace: StepTrace, table_sigs: set[tuple],
                       min_rows: int) -> tuple[list[Finding], dict]:
    """No node copies, converts or allocates a table-sized buffer:

    * no copy reads a span of the table's own storage of ``min_rows``
      elements or more (``min_rows``: a shard's rows);
    * no node allocates or produces a buffer of a table leaf's shape
      and dtype (``table_sigs``: with and without the park row).

    In-place writes into the table are the update, and views of it are
    free."""
    findings: list[Finding] = []
    census = {"copies": 0, "table_types": sorted(
        f"{dt}{list(shp)}" for shp, dt in table_sigs)}
    stores = {trace.values[v].storage for k, v in trace.inputs.items()
              if k.startswith("table.")}
    for n in trace.aten_nodes():
        if n.op not in _ALLOC_OR_COPY:
            continue
        src = n.ins[1:2] if n.op == "aten.copy_.default" else n.ins
        read = [trace.values[v] for v in src
                if trace.values[v].storage in stores
                and trace.values[v].numel >= min_rows]
        made = [] if n.op == "aten.copy_.default" else [
            trace.values[v] for v in n.outs
            if (trace.values[v].shape, trace.values[v].dtype) in table_sigs]
        hit = read or made
        if hit:
            census["copies"] += 1
            findings.append(Finding(
                contract="inplace", where=n.where(), eqn=n.text(trace),
                reason=(f"{n.op} materializes a table-sized buffer "
                        f"({hit[0].dtype}{list(hit[0].shape)}): the table "
                        "must flow copy-free through every step variant "
                        "(each one is a full-table copy per batch)")))
    return findings, census


# ---------------------------------------------------------------------------
# contract 5: collectives (the exchange sites)
# ---------------------------------------------------------------------------

EXPECTED_EXCHANGES = frozenset({"all_to_all", "all_gather", "psum", "pmax",
                                "axis_index"})
REDUCTION_MAX_ELEMS = 8
MAX_ALL_TO_ALL = 2


def check_collectives(trace: StepTrace, verdict_k: int, expect_sharded: bool,
                      n_bodies: int) -> tuple[list[Finding], dict]:
    """Hold the exchange sites to the design, per step body:

    * a single-device variant calls none;
    * a sharded body calls at most :data:`MAX_ALL_TO_ALL` ``all_to_all``
      (flow partials out, verdicts back), ``all_gather`` only on
      K-sized per-shard operands (the compact wire), and ``psum`` /
      ``pmax`` only on per-shard operands of at most
      :data:`REDUCTION_MAX_ELEMS` elements.

    A megastep or ring runs ``n_bodies`` step bodies: the census is per
    body, as the reference's scan stages its body once."""
    findings: list[Finding] = []
    total: dict[str, int] = {}
    for name, sizes in trace.exchanges:
        total[name] = total.get(name, 0) + 1
        where = f"parallel/step.py:_{name}"
        if not expect_sharded:
            findings.append(Finding(
                contract="collectives", where=where,
                reason=f"exchange {name!r} in a single-device step variant"))
            continue
        if name not in EXPECTED_EXCHANGES:
            findings.append(Finding(
                contract="collectives", where=where,
                reason=f"unexpected exchange {name!r}"))
        elif name == "all_gather":
            bad = [s for s in sizes if s != verdict_k]
            if bad:
                findings.append(Finding(
                    contract="collectives", where=where,
                    reason=(f"all_gather on a {bad[0]}-element operand; only "
                            f"the [{verdict_k}]-slot compact wire may be "
                            "gathered (per-record arrays stay on their "
                            "shard)")))
        elif name in ("psum", "pmax"):
            bad = [s for s in sizes if s > REDUCTION_MAX_ELEMS]
            if bad:
                findings.append(Finding(
                    contract="collectives", where=where,
                    reason=(f"{name} over a {bad[0]}-element operand (> "
                            f"{REDUCTION_MAX_ELEMS}): cross-shard reductions "
                            "carry stat counts and clocks, never batch data")))
    per_body = {}
    for name, n in total.items():
        if n % max(n_bodies, 1):
            findings.append(Finding(
                contract="collectives", where=f"parallel/step.py:_{name}",
                reason=(f"{n} {name} calls over {n_bodies} step bodies: "
                        "the bodies do not exchange alike")))
        per_body[name] = n // max(n_bodies, 1)
    if per_body.get("all_to_all", 0) > MAX_ALL_TO_ALL:
        findings.append(Finding(
            contract="collectives", where="parallel/step.py:_all_to_all",
            reason=(f"{per_body['all_to_all']} all_to_all calls in one step "
                    f"(design: {MAX_ALL_TO_ALL}: flow partials out, verdicts "
                    "back); extra ones double-route the batch")))
    return findings, per_body


# ---------------------------------------------------------------------------
# contract 4: the retrace sentinel
# ---------------------------------------------------------------------------


def _sig(args) -> list[tuple[str, str, tuple]]:
    out = []
    for i, a in enumerate(args):
        for leaf, t in _leaves(f"arg[{i}]", a):
            if isinstance(t, torch.Tensor):
                out.append((leaf, _dtype_name(t.dtype), tuple(t.shape)))
    return out


def staging_check(make_args: Callable[[], tuple],
                  names: tuple[str, ...] = ()) -> list[Finding]:
    """Two independent constructions of one batch must stage the same
    static input (leaf count, dtype, shape): a drift means the engine
    would capture (or re-stage) a new graph per dispatch."""
    a, b = _sig(make_args()), _sig(make_args())
    diffs = [f"{x[0]}: {x[1]}{list(x[2])} vs {y[1]}{list(y[2])}"
             for x, y in zip(a, b) if x != y]
    if len(a) != len(b):
        diffs.append(f"input leaf count {len(a)} vs {len(b)}")
    if not diffs:
        return []
    return [Finding(
        contract="retrace",
        reason=("staging twice under one BatchConfig gave different static "
                "inputs: the serving loop would re-stage every batch. "
                "Differing inputs: " + "; ".join(diffs[:4])))]
