"""In-repo BPF static verifier: the kernel verifier's safety contract,
checkable with no kernel in the loop.

The fast path is hand-assembled bytecode (``bpf/progs.py``) whose only
safety net used to be the in-kernel verifier — unavailable in CI and in
any unprivileged dev container (``loader.bpf_available()`` is False
there), so a mis-assembled bounds check shipped silently until a
privileged load failed with an opaque ``EACCES``.  This module is an
abstract interpreter over the emitted instruction stream that models
register and stack state the way ``kernel/bpf/verifier.c`` does:

* **types** — scalar vs pointer (ctx, packet, packet_end, stack frame,
  map, map value, ringbuf record), with NULL-ness tracked for the
  maybe-null helper returns;
* **packet range proofs** — a packet pointer is ``data + O_v + delta``
  where ``O_v`` is an opaque non-negative offset variable (fresh after
  every variable-offset advance) and ``delta`` a known constant.  A
  compare against ``data_end`` records ``O_v + delta <= pkt_len``; a
  load/store through ``(v, d)`` at offset ``o`` size ``s`` is legal only
  under a recorded proof with ``d + o + s <= proven`` — exactly the
  discipline that makes the IPv6 extension-header walk in progs.py
  re-check after every advance;
* **stack tracking** — byte-granular initialization, plus full-slot
  "spills" for 8-byte aligned DW stores so pointer round-trips
  (``S_CTX``) and constant flags (``S_IS6``) stay precise across the
  frame;
* **map-value bounds** — value sizes come from the same ``MAP_SPECS``
  the maps are created from (and that ``bpf/contracts.py`` diffs
  against ``core/schema.py``), so a stale struct offset is caught here;
* **helper contracts** — argument types per helper id (map lookups want
  an initialized key on the stack, ``ringbuf_reserve`` wants a constant
  size, ...), acquired-reference tracking for ringbuf records;
* **CFG checks** — jump targets in range and not into the middle of a
  ``ld_imm64``, no fall-off-the-end, every instruction reachable, R0
  initialized at exit, and a complexity budget that bounds loop
  exploration the way the kernel's 1M-insn budget does.

Rejection raises :class:`StaticVerifierError` carrying the instruction
index, a disassembly of the offending slot, the abstract register file,
and *why* — the precise diagnostic the kernel's log gives only after a
privileged load attempt.  What this pass guarantees vs. the real
verifier is documented in docs/VERIFIER.md; it is deliberately
*stricter* where the kernel is lenient (e.g. any bpf-to-bpf call while
holding a ringbuf reference is refused) and makes no attempt to model
features progs.py does not use.

Entry points: :func:`check_program` (one assembled ``Program``),
:func:`check_program_cached` (content-addressed, for the loader/image
seal hooks), and the ``fsx check`` CLI surface in cli.py.

Counterpart of ``flowsentryx_tpu/bpf/verifier.py``: the same reports and
the same diagnoses.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

from flowsentryx_tpu_torch.bpf import isa
from flowsentryx_tpu_torch.bpf.asm import Program
from flowsentryx_tpu_torch.bpf.isa import Insn

U64 = (1 << 64) - 1
U32 = (1 << 32) - 1
STACK_SIZE = 512
MAX_VAR_PKT_OFF = 1 << 20  # kernel: variable adds must be sanely bounded
#: States allowed per instruction before scalar widening kicks in.
#: Precise constants are what make packet-bounds proofs work, but they
#: also make pure-arithmetic code explode: the unrolled isqrt builds its
#: result bit by bit, so tracking R0 exactly enumerates every subset-sum
#: of the bit masks — exponentially many distinct states that never
#: merge.  Once an instruction has accumulated this many states, a new
#: arrival is widened AGAINST the first recorded state of the same
#: *skeleton* (identical pointer structure, stack-initialization set and
#: spill slots): every scalar register/spill whose range DISAGREES with
#: the reference collapses to unknown, every agreeing one keeps its
#: value.  This is the poor man's version of the kernel verifier's
#: precision tracking: values every path agrees on (the constant
#: ringbuf_reserve size, the S_IS6 discriminator within a v4-only or
#: v6-only skeleton) stay precise, path-dependent arithmetic noise (the
#: isqrt accumulator, parked flag bytes) widens and converges.  Widening
#: is sound — the widened state strictly over-approximates — and cannot
#: break a packet-bounds proof that follows the mask-before-add
#: discipline, because the AND re-derives the range from the widened
#: scalar in the same basic block.
WIDEN_AT = 12

# helper ids this toolchain emits (isa.FN_*); anything else is refused
_H = isa


@dataclass(frozen=True)
class MapInfo:
    """What the verifier needs to know about one map."""

    name: str
    map_type: int
    key_size: int
    value_size: int


def default_map_infos() -> dict[str, MapInfo]:
    """MapInfo for the shipped fast path, derived from the SAME
    ``MAP_SPECS`` that map creation and image emission use (lazy import:
    progs itself calls into this module)."""
    from flowsentryx_tpu_torch.bpf import progs

    return {
        name: MapInfo(name, mtype, ks, vs)
        for name, (mtype, ks, vs, _ent) in progs.MAP_SPECS.items()
    }


# ---------------------------------------------------------------------------
# Abstract values
# ---------------------------------------------------------------------------

# Reg.kind values
UNINIT = "uninit"
SCALAR = "scalar"
CTX = "ctx"
PKT = "pkt"
PKT_END = "pkt_end"
FP = "fp"
MAP_PTR = "map_ptr"
MAP_VALUE = "map_value"
RB_MEM = "rb_mem"


@dataclass(frozen=True)
class Reg:
    """One abstract register value (immutable; states share them)."""

    kind: str = UNINIT
    umin: int = 0            # scalar range (unsigned 64-bit)
    umax: int = U64
    vid: int = 0             # pkt: opaque offset-variable id
    delta: int = 0           # pkt/fp/map_value/rb_mem: constant offset
    map: str = ""            # map_ptr/map_value: map name
    null_id: int = 0         # map_value/rb_mem: nonzero while maybe-NULL
    ref_id: int = 0          # rb_mem: acquired-reference id
    size: int = 0            # rb_mem: record size

    def show(self) -> str:
        if self.kind == UNINIT:
            return "?"
        if self.kind == SCALAR:
            if self.umin == self.umax:
                return f"{self.umin:#x}" if self.umin > 9 else str(self.umin)
            if (self.umin, self.umax) == (0, U64):
                return "scalar"
            return f"[{self.umin:#x},{self.umax:#x}]"
        if self.kind == PKT:
            return f"pkt(v{self.vid}{self.delta:+d})"
        if self.kind == MAP_VALUE:
            null = "?null" if self.null_id else ""
            return f"{self.map}_val{null}{self.delta:+d}"
        if self.kind == RB_MEM:
            null = "?null" if self.null_id else ""
            return f"rbrec[{self.size}]{null}{self.delta:+d}"
        if self.kind == FP:
            return f"fp{self.delta:+d}" if self.delta else "fp"
        if self.kind == MAP_PTR:
            return f"map({self.map})"
        return self.kind


_UNINIT = Reg()
_UNKNOWN = Reg(SCALAR, 0, U64)


def _const(v: int) -> Reg:
    v &= U64
    return Reg(SCALAR, v, v)


def _ranged(lo: int, hi: int) -> Reg:
    if lo < 0 or hi > U64 or lo > hi:
        return _UNKNOWN
    return Reg(SCALAR, lo, hi)


@dataclass
class State:
    """Abstract machine state at one instruction."""

    regs: list[Reg]                      # r0..r10 (r10 = fp, read-only)
    stack: frozenset[int] = frozenset()  # initialized byte offsets [-512,-1]
    spills: dict[int, Reg] = field(default_factory=dict)  # 8B slot -> value
    bounds: dict[int, int] = field(default_factory=dict)  # vid -> proven end
    refs: frozenset[int] = frozenset()   # live acquired-reference ids

    def clone(self) -> "State":
        return State(list(self.regs), self.stack, dict(self.spills),
                     dict(self.bounds), self.refs)

    def show(self) -> str:
        regs = " ".join(
            f"r{i}={r.show()}" for i, r in enumerate(self.regs)
            if r.kind != UNINIT
        )
        extra = []
        if self.bounds:
            extra.append("proven=" + ",".join(
                f"v{v}<={b}" for v, b in sorted(self.bounds.items())))
        if self.refs:
            extra.append(f"refs={sorted(self.refs)}")
        if self.stack:
            lo, hi = min(self.stack), max(self.stack)
            extra.append(f"stack[{lo},{hi}]:{len(self.stack)}B")
        return "  ".join([regs] + extra)


class StaticVerifierError(Exception):
    """Static rejection: instruction index, why, and the abstract state
    — the diagnostic the kernel verifier only produces under privilege."""

    def __init__(self, prog_name: str, insn_idx: int, reason: str,
                 insn_txt: str = "", state: State | None = None):
        self.prog_name = prog_name
        self.insn_idx = insn_idx
        self.reason = reason
        self.insn_txt = insn_txt
        self.state_dump = state.show() if state is not None else ""
        msg = f"{prog_name}: insn {insn_idx}: {insn_txt}: {reason}"
        if self.state_dump:
            msg += f"\n  state: {self.state_dump}"
        super().__init__(msg)


@dataclass
class VerifierReport:
    """Accepted-program summary (``fsx check`` prints this)."""

    name: str
    n_insns: int
    insns_visited: int
    states_pruned: int
    subprog_entries: list[int]
    map_names: list[str]
    #: Joined scalar ranges observed at probed instructions
    #: (``check_program(probes={idx: reg})``): idx ->
    #: {"reg", "umin", "umax", "hits"}.  The ``fsx ranges`` cross-lane
    #: containment bridge reads the MAC/band-select ranges this way —
    #: purely observational, never affects accept/reject.
    probes: dict = field(default_factory=dict)

    def to_json(self) -> dict:
        out = {
            "program": self.name, "insns": self.n_insns,
            "insns_visited": self.insns_visited,
            "states_pruned": self.states_pruned,
            "subprogs": len(self.subprog_entries),
            "maps": self.map_names,
        }
        if self.probes:
            out["probes"] = self.probes
        return out


# ---------------------------------------------------------------------------
# Disassembly (diagnostics only — not a full decoder)
# ---------------------------------------------------------------------------

_SIZE_NAME = {isa.BPF_B: "u8", isa.BPF_H: "u16", isa.BPF_W: "u32",
              isa.BPF_DW: "u64"}
_SIZE_BYTES = {isa.BPF_B: 1, isa.BPF_H: 2, isa.BPF_W: 4, isa.BPF_DW: 8}
_ALU_NAME = {isa.BPF_ADD: "+=", isa.BPF_SUB: "-=", isa.BPF_MUL: "*=",
             isa.BPF_DIV: "/=", isa.BPF_OR: "|=", isa.BPF_AND: "&=",
             isa.BPF_LSH: "<<=", isa.BPF_RSH: ">>=", isa.BPF_MOD: "%=",
             isa.BPF_XOR: "^=", isa.BPF_MOV: "=", isa.BPF_ARSH: "s>>="}
_JMP_NAME = {isa.BPF_JEQ: "==", isa.BPF_JNE: "!=", isa.BPF_JGT: ">",
             isa.BPF_JGE: ">=", isa.BPF_JLT: "<", isa.BPF_JLE: "<=",
             isa.BPF_JSGT: "s>", isa.BPF_JSGE: "s>=", isa.BPF_JSLT: "s<",
             isa.BPF_JSLE: "s<=", isa.BPF_JSET: "&"}


def _s16(v: int) -> int:
    v &= 0xFFFF
    return v - (1 << 16) if v >= (1 << 15) else v


def disasm(insn: Insn) -> str:
    """One-line rendering of an instruction slot for diagnostics."""
    op = insn.op
    cls = op & 0x07
    if cls in (isa.BPF_ALU, isa.BPF_ALU64):
        w = "" if cls == isa.BPF_ALU64 else "(u32)"
        aop = op & 0xF0
        if aop == isa.BPF_NEG:
            return f"r{insn.dst} = -r{insn.dst}{w}"
        if aop == isa.BPF_END:
            return f"r{insn.dst} = bswap{insn.imm}(r{insn.dst})"
        src = f"r{insn.src}" if op & isa.BPF_X else str(isa._s32(insn.imm))
        return f"{w}r{insn.dst} {_ALU_NAME.get(aop, '?=')} {src}"
    if cls == isa.BPF_LDX:
        sz = _SIZE_NAME.get(op & 0x18, "?")
        return f"r{insn.dst} = *({sz} *)(r{insn.src} {_s16(insn.off):+d})"
    if cls in (isa.BPF_ST, isa.BPF_STX):
        sz = _SIZE_NAME.get(op & 0x18, "?")
        if op & 0xE0 == isa.BPF_ATOMIC:
            fetch = " fetch" if insn.imm & isa.BPF_FETCH else ""
            return (f"atomic{fetch} *({sz} *)(r{insn.dst} "
                    f"{_s16(insn.off):+d}) += r{insn.src}")
        src = f"r{insn.src}" if cls == isa.BPF_STX else str(isa._s32(insn.imm))
        return f"*({sz} *)(r{insn.dst} {_s16(insn.off):+d}) = {src}"
    if cls == isa.BPF_LD:
        return f"r{insn.dst} = ld_imm64 (src={insn.src})"
    if cls in (isa.BPF_JMP, isa.BPF_JMP32):
        jop = op & 0xF0
        if jop == isa.BPF_JA:
            return f"goto {_s16(insn.off):+d}"
        if jop == isa.BPF_CALL:
            if insn.src == 1:
                return f"call subprog {isa._s32(insn.imm):+d}"
            return f"call helper#{insn.imm}"
        if jop == isa.BPF_EXIT:
            return "exit"
        src = f"r{insn.src}" if op & isa.BPF_X else str(isa._s32(insn.imm))
        return (f"if r{insn.dst} {_JMP_NAME.get(jop, '?')} {src} "
                f"goto {_s16(insn.off):+d}")
    return f"op={op:#04x}"


# ---------------------------------------------------------------------------
# The interpreter
# ---------------------------------------------------------------------------

_XDP_CTX_PTR_FIELDS = {isa.XDP_MD_DATA: PKT, isa.XDP_MD_DATA_END: PKT_END}
_XDP_CTX_SCALARS = {12, 16, 20}  # ifindex / rx_queue / egress — u32 reads

# helper arg/return contracts.  Args beyond the listed ones are ignored
# (unread by the helper); "key"/"value" check an initialized region of
# the R1 map's key/value size.
_HELPERS: dict[int, dict] = {
    _H.FN_map_lookup_elem: {"name": "map_lookup_elem",
                            "args": ["map", "key"], "ret": "map_value_or_null"},
    _H.FN_map_update_elem: {"name": "map_update_elem",
                            "args": ["map", "key", "value", "scalar"],
                            "ret": "scalar"},
    _H.FN_map_delete_elem: {"name": "map_delete_elem",
                            "args": ["map", "key"], "ret": "scalar"},
    _H.FN_ktime_get_ns: {"name": "ktime_get_ns", "args": [], "ret": "scalar"},
    _H.FN_get_smp_processor_id: {"name": "get_smp_processor_id",
                                 "args": [], "ret": "scalar"},
    _H.FN_ringbuf_reserve: {"name": "ringbuf_reserve",
                            "args": ["ringbuf", "const_size", "scalar"],
                            "ret": "rb_mem_or_null"},
    _H.FN_ringbuf_submit: {"name": "ringbuf_submit",
                           "args": ["rb_mem", "scalar"], "ret": "void"},
    _H.FN_ringbuf_discard: {"name": "ringbuf_discard",
                            "args": ["rb_mem", "scalar"], "ret": "void"},
}


class _Checker:
    def __init__(self, name: str, insns: list[Insn],
                 relocs: dict[int, str], maps: dict[str, MapInfo],
                 budget: int, probes: dict[int, int] | None = None):
        self.name = name
        self.insns = insns
        self.relocs = relocs  # slot idx -> map name
        self.maps = maps
        self.budget = budget
        self.probes = probes or {}
        #: idx -> [umin, umax, hits]: the join over every abstract
        #: state reaching the probed instruction (pre-execution)
        self.probe_acc: dict[int, list[int]] = {}
        self.visited: set[int] = set()
        self.pruned = 0
        self.steps = 0
        self.next_id = 1  # vid / null_id / ref_id allocator
        # second slots of ld_imm64 (never an entry point)
        self.wide_lo: set[int] = set()
        for i, ins in enumerate(insns):
            if ins.op == isa.BPF_LD | isa.BPF_DW | isa.BPF_IMM:
                if i + 1 >= len(insns):
                    self._die(i, None, "ld_imm64 missing second slot")
                self.wide_lo.add(i + 1)
        self.live = self._liveness()

    # -- live-register analysis ----------------------------------------
    #
    # The same pruning lever the kernel verifier uses: two states that
    # differ only in registers no path can read again are the same
    # state.  Without it, every limiter/parse path drags its dead
    # leftover r0-r5 values through the long straight-line feature-
    # derivation block and the per-insn state sets multiply.  Classic
    # backwards may-read dataflow over the CFG, one bitmask per insn.

    def _insn_rw_succ(self, i: int) -> tuple[int, int, list[int]]:
        """(reads_mask, writes_mask, successors) of insns[i]."""
        ins = self.insns[i]
        op = ins.op
        cls = op & 0x07
        R = W = 0
        if cls in (isa.BPF_ALU, isa.BPF_ALU64):
            aop = op & 0xF0
            W = 1 << ins.dst
            if aop != isa.BPF_MOV:
                R |= 1 << ins.dst
            if aop not in (isa.BPF_NEG, isa.BPF_END) and op & isa.BPF_X:
                R |= 1 << ins.src
            return R, W, [i + 1]
        if cls == isa.BPF_LD:
            return 0, 1 << ins.dst, [i + 2]
        if cls == isa.BPF_LDX:
            return 1 << ins.src, 1 << ins.dst, [i + 1]
        if cls in (isa.BPF_ST, isa.BPF_STX):
            R = 1 << ins.dst
            if cls == isa.BPF_STX:
                R |= 1 << ins.src
            if op & 0xE0 == isa.BPF_ATOMIC and ins.imm & isa.BPF_FETCH:
                W = 1 << ins.src
            return R, W, [i + 1]
        if cls in (isa.BPF_JMP, isa.BPF_JMP32):
            jop = op & 0xF0
            if jop == isa.BPF_JA:
                return 0, 0, [i + 1 + _s16(ins.off)]
            if jop == isa.BPF_EXIT:
                return 1 << 0, 0, []
            if jop == isa.BPF_CALL:
                # conservative: the callee/helper may read r1-r5;
                # r0-r5 are clobbered on return.  A local call's body
                # is verified standalone — the caller falls through.
                return 0b111110, 0b111111, [i + 1]
            R = 1 << ins.dst
            if op & isa.BPF_X:
                R |= 1 << ins.src
            return R, 0, [i + 1, i + 1 + _s16(ins.off)]
        return 0, 0, [i + 1]

    def _liveness(self) -> list[int]:
        """live-in mask per insn (bit r set: some path may read r before
        writing it).  r10 is a pointer constant — always live."""
        n = len(self.insns)
        rws: list[tuple[int, int, list[int]]] = []
        for i in range(n):
            if i in self.wide_lo:
                rws.append((0, 0, [i + 1]))
                continue
            r, w, succ = self._insn_rw_succ(i)
            rws.append((r, w, [s for s in succ if 0 <= s < n]))
        live = [0] * (n + 1)
        changed = True
        while changed:
            changed = False
            for i in range(n - 1, -1, -1):
                r, w, succ = rws[i]
                out = 0
                for s in succ:
                    out |= live[s]
                new = r | (out & ~w) | (1 << 10)
                if new != live[i]:
                    live[i] = new
                    changed = True
        return live[:n]

    # -- plumbing ------------------------------------------------------

    def _die(self, idx: int, st: State | None, reason: str) -> None:
        txt = disasm(self.insns[idx]) if idx < len(self.insns) else "<end>"
        raise StaticVerifierError(self.name, idx, reason, txt, st)

    def _fresh(self) -> int:
        self.next_id += 1
        return self.next_id

    # -- state canonicalization + pruning ------------------------------

    _DEAD = ("dead", 0, 0, 0, 0, "", 0, 0, 0, -1)

    def _canon(self, st: State, idx: int) -> tuple:
        """Hash-/compare-friendly rendering with vid/null/ref ids
        renumbered by first appearance, so states from different paths
        compare structurally.  Registers dead at ``idx`` canonicalize
        to one placeholder: their values cannot influence anything."""
        vmap: dict[int, int] = {}
        nmap: dict[int, int] = {}
        rmap: dict[int, int] = {}

        def m(table: dict[int, int], k: int) -> int:
            if k == 0:
                return 0
            return table.setdefault(k, len(table) + 1)

        live = self.live[idx]
        regs = []
        for i, r in enumerate(st.regs):
            if not live >> i & 1:
                regs.append(self._DEAD)
                continue
            regs.append((r.kind, r.umin, r.umax, m(vmap, r.vid), r.delta,
                         r.map, m(nmap, r.null_id), m(rmap, r.ref_id),
                         r.size,
                         st.bounds.get(r.vid, -1) if r.kind == PKT else -1))
        spills = tuple(sorted(
            (off, r.kind, r.umin, r.umax, m(vmap, r.vid), r.delta, r.map,
             m(nmap, r.null_id), m(rmap, r.ref_id), r.size,
             st.bounds.get(r.vid, -1) if r.kind == PKT else -1)
            for off, r in st.spills.items()))
        return (tuple(regs), frozenset(st.stack), spills, len(st.refs))

    @staticmethod
    def _subsumes(old: tuple, new: tuple) -> bool:
        """True when the already-explored ``old`` is weaker-or-equal:
        anything provable from ``new`` was provable from ``old``."""
        oregs, ostack, ospills, orefs = old
        nregs, nstack, nspills, nrefs = new
        if orefs != nrefs or not ostack <= nstack:
            return False
        nsp = {s[0]: s for s in nspills}
        for s in ospills:
            t = nsp.get(s[0])
            if t is None or not _Checker._reg_subsumes(s[1:], t[1:]):
                return False
        for o, n in zip(oregs, nregs):
            if not _Checker._reg_subsumes(o, n):
                return False
        return True

    @staticmethod
    def _reg_subsumes(o: tuple, n: tuple) -> bool:
        okind = o[0]
        if okind == UNINIT:
            return True
        if okind != n[0]:
            return False
        if okind == SCALAR:
            return o[1] <= n[1] and o[2] >= n[2]
        # pointers: structural equality on canon ids/deltas; pkt also
        # requires old's proven bound to be no stronger than new's
        if o[3:9] != n[3:9]:
            return False
        if okind == PKT:
            return o[9] <= n[9]
        return True

    # -- memory --------------------------------------------------------

    def _stack_write(self, idx: int, st: State, off: int, size: int,
                     val: Reg) -> None:
        if off < -STACK_SIZE or off + size > 0:
            self._die(idx, st, f"stack access out of frame: "
                               f"[{off},{off + size})")
        bts = set(range(off, off + size))
        st.stack = st.stack | frozenset(bts)
        # a write invalidates any spill it overlaps
        for s in [s for s in st.spills if s < off + size and s + 8 > off]:
            del st.spills[s]
        if size == 8 and off % 8 == 0:
            st.spills[off] = val
        elif val.kind not in (SCALAR, UNINIT):
            self._die(idx, st, "pointer spill must be an aligned 8-byte "
                               "store")

    def _stack_read(self, idx: int, st: State, off: int, size: int) -> Reg:
        if off < -STACK_SIZE or off + size > 0:
            self._die(idx, st, f"stack access out of frame: "
                               f"[{off},{off + size})")
        missing = [b for b in range(off, off + size) if b not in st.stack]
        if missing:
            self._die(idx, st, f"read of uninitialized stack byte "
                               f"fp{missing[0]:+d}")
        if size == 8 and off % 8 == 0 and off in st.spills:
            return st.spills[off]
        if size == 8:
            return _UNKNOWN
        return _ranged(0, (1 << (8 * size)) - 1)

    def _check_mem(self, idx: int, st: State, ptr: Reg, off: int,
                   size: int, write: bool) -> None:
        """Bounds-check one non-stack access through ``ptr``."""
        if ptr.kind == PKT:
            if ptr.null_id:
                self._die(idx, st, "packet pointer used before NULL check")
            lo = ptr.delta + off
            proven = st.bounds.get(ptr.vid, None)
            if lo < 0 or proven is None or lo + size > proven:
                have = "none" if proven is None else f"{proven}"
                self._die(idx, st,
                          f"invalid packet access: off={ptr.delta + off} "
                          f"size={size}, proven range={have} — compare "
                          f"against data_end before dereferencing")
            return
        if ptr.kind == MAP_VALUE:
            if ptr.null_id:
                self._die(idx, st, f"possible NULL map-value dereference "
                                   f"({ptr.map}): r{''} lookup result used "
                                   "before the == 0 check")
            lo = ptr.delta + off
            vs = self.maps[ptr.map].value_size
            if lo < 0 or lo + size > vs:
                self._die(idx, st,
                          f"map value access out of bounds: map "
                          f"{ptr.map!r} value_size={vs}, access "
                          f"[{lo},{lo + size})")
            return
        if ptr.kind == RB_MEM:
            if ptr.null_id:
                self._die(idx, st, "possible NULL ringbuf record "
                                   "dereference (reserve result unchecked)")
            if ptr.ref_id not in st.refs:
                self._die(idx, st, "ringbuf record used after "
                                   "submit/discard")
            lo = ptr.delta + off
            if lo < 0 or lo + size > ptr.size:
                self._die(idx, st,
                          f"ringbuf record access out of bounds: "
                          f"reserved {ptr.size}, access [{lo},{lo + size})")
            return
        if ptr.kind == CTX and not write:
            return  # offsets validated by the caller
        verb = "write to" if write else "read through"
        self._die(idx, st, f"invalid {verb} {ptr.show()!r}")

    # -- helper-call argument checking ---------------------------------

    def _helper_mem_arg(self, idx: int, st: State, reg: Reg, size: int,
                        what: str) -> None:
        """An initialized readable region of ``size`` bytes."""
        if reg.kind == FP:
            off = reg.delta
            if off < -STACK_SIZE or off + size > 0:
                self._die(idx, st, f"{what}: stack region "
                                   f"[{off},{off + size}) out of frame")
            missing = [b for b in range(off, off + size)
                       if b not in st.stack]
            if missing:
                self._die(idx, st,
                          f"{what}: uninitialized stack byte "
                          f"fp{missing[0]:+d} (helper would read "
                          f"{size} bytes at fp{off:+d})")
            return
        if reg.kind == MAP_VALUE and not reg.null_id:
            vs = self.maps[reg.map].value_size
            if reg.delta < 0 or reg.delta + size > vs:
                self._die(idx, st, f"{what}: map value region out of "
                                   f"bounds ({reg.delta}+{size} > {vs})")
            return
        self._die(idx, st, f"{what}: expected pointer to initialized "
                           f"memory, got {reg.show()!r}")

    def _call_helper(self, idx: int, st: State, hid: int) -> None:
        spec = _HELPERS.get(hid)
        if spec is None:
            self._die(idx, st, f"unknown/unsupported helper id {hid}")
        args = [st.regs[i + 1] for i in range(5)]
        map_arg: MapInfo | None = None
        for i, kind in enumerate(spec["args"]):
            a = args[i]
            nm = f"{spec['name']} arg{i + 1}"
            if kind in ("map", "ringbuf"):
                if a.kind != MAP_PTR:
                    self._die(idx, st, f"{nm}: expected map pointer, got "
                                       f"{a.show()!r}")
                map_arg = self.maps[a.map]
                if kind == "ringbuf" and map_arg.map_type != 27:
                    self._die(idx, st, f"{nm}: map {a.map!r} is not a "
                                       "ringbuf")
                if kind == "map" and map_arg.map_type == 27:
                    self._die(idx, st, f"{nm}: ringbuf map {a.map!r} has "
                                       "no lookup/update interface")
            elif kind == "key":
                assert map_arg is not None
                self._helper_mem_arg(idx, st, a, map_arg.key_size, nm)
            elif kind == "value":
                assert map_arg is not None
                self._helper_mem_arg(idx, st, a, map_arg.value_size, nm)
            elif kind == "const_size":
                if a.kind != SCALAR or a.umin != a.umax:
                    self._die(idx, st, f"{nm}: expected constant size, "
                                       f"got {a.show()!r}")
                if a.umin == 0 or a.umin > (1 << 30):
                    self._die(idx, st, f"{nm}: bad reserve size {a.umin}")
            elif kind == "rb_mem":
                if a.kind != RB_MEM or a.null_id or a.delta != 0:
                    self._die(idx, st, f"{nm}: expected the reserved "
                                       f"ringbuf record pointer, got "
                                       f"{a.show()!r}")
                if a.ref_id not in st.refs:
                    self._die(idx, st, f"{nm}: ringbuf record already "
                                       "submitted/discarded")
                st.refs = st.refs - {a.ref_id}
                # the reference is gone: every alias dies — register
                # AND spilled (a reload of a scrubbed spill yields an
                # unknown scalar, whose dereference then rejects, the
                # same invalidation the kernel's release_reference does)
                st.regs = [
                    _UNINIT if (r.kind == RB_MEM and r.ref_id == a.ref_id)
                    else r for r in st.regs]
                st.spills = {
                    o: r for o, r in st.spills.items()
                    if not (r.kind == RB_MEM and r.ref_id == a.ref_id)}
            elif kind == "scalar":
                if a.kind not in (SCALAR, UNINIT):
                    self._die(idx, st, f"{nm}: pointer passed where a "
                                       f"scalar is expected: {a.show()!r}")
        # returns + clobbers
        ret = spec["ret"]
        if ret == "map_value_or_null":
            assert map_arg is not None
            r0 = Reg(MAP_VALUE, map=map_arg.name, null_id=self._fresh())
        elif ret == "rb_mem_or_null":
            rid = self._fresh()
            st.refs = st.refs | {rid}
            r0 = Reg(RB_MEM, size=st.regs[2].umin, ref_id=rid,
                     null_id=self._fresh())
        elif ret == "scalar":
            r0 = _UNKNOWN
        else:  # void
            r0 = _UNINIT
        st.regs[0] = r0
        for i in range(1, 6):
            st.regs[i] = _UNINIT

    # -- ALU -----------------------------------------------------------

    def _alu(self, idx: int, st: State, insn: Insn, is64: bool) -> None:
        op = insn.op & 0xF0
        dst = st.regs[insn.dst]
        if insn.dst >= 10:
            self._die(idx, st, "write to frame pointer r10")
        if op == isa.BPF_END:
            if dst.kind != SCALAR:
                self._die(idx, st, f"byte swap of {dst.show()!r}")
            bits = insn.imm
            st.regs[insn.dst] = (_ranged(0, (1 << bits) - 1)
                                 if bits in (16, 32) else _UNKNOWN)
            return
        if op == isa.BPF_NEG:
            if dst.kind != SCALAR:
                self._die(idx, st, f"negation of {dst.show()!r}")
            st.regs[insn.dst] = (_UNKNOWN if is64
                                 else _ranged(0, U32))
            return
        if insn.op & isa.BPF_X:
            src = st.regs[insn.src]
            if src.kind == UNINIT:
                self._die(idx, st, f"read of uninitialized r{insn.src}")
        else:
            src = _const(isa._s32(insn.imm) & U64 if is64
                         else insn.imm & U32)
        if op != isa.BPF_MOV and dst.kind == UNINIT:
            self._die(idx, st, f"read of uninitialized r{insn.dst}")

        if op == isa.BPF_MOV:
            if not is64:
                if src.kind != SCALAR:
                    self._die(idx, st, f"32-bit move of {src.show()!r} "
                                       "truncates a pointer")
                src = (_ranged(src.umin, src.umax)
                       if src.umax <= U32 else _ranged(0, U32))
            st.regs[insn.dst] = src
            return

        dptr = dst.kind not in (SCALAR, UNINIT)
        sptr = src.kind not in (SCALAR, UNINIT)
        if dptr or sptr:
            self._alu_ptr(idx, st, insn, op, is64, dst, src)
            return
        st.regs[insn.dst] = self._alu_scalar(idx, st, op, is64, dst, src)

    def _alu_ptr(self, idx: int, st: State, insn: Insn, op: int,
                 is64: bool, dst: Reg, src: Reg) -> None:
        if not is64:
            self._die(idx, st, "32-bit arithmetic on a pointer")
        if op == isa.BPF_SUB and dst.kind not in (SCALAR,) \
                and src.kind not in (SCALAR, UNINIT):
            # ptr - ptr -> opaque scalar (r9 = data_end - data)
            st.regs[insn.dst] = _UNKNOWN
            return
        if op == isa.BPF_ADD:
            ptr, sc = (dst, src) if dst.kind not in (SCALAR,) else (src, dst)
            if ptr.kind not in (SCALAR,) and sc.kind == SCALAR:
                st.regs[insn.dst] = self._ptr_add(idx, st, ptr, sc)
                return
            self._die(idx, st, "addition of two pointers")
        if op == isa.BPF_SUB and dst.kind not in (SCALAR,) \
                and src.kind == SCALAR:
            if src.umin != src.umax:
                self._die(idx, st, "variable subtraction from a pointer")
            neg = _const((-src.umin) & U64)
            st.regs[insn.dst] = self._ptr_add(idx, st, dst, neg)
            return
        self._die(idx, st, f"unsupported pointer arithmetic: "
                           f"{disasm(insn)}")

    def _ptr_add(self, idx: int, st: State, ptr: Reg, sc: Reg) -> Reg:
        if ptr.kind in (PKT_END, MAP_PTR, CTX):
            self._die(idx, st, f"arithmetic on {ptr.show()!r}")
        if sc.umin == sc.umax:
            v = sc.umin
            d = v - (1 << 64) if v >= (1 << 63) else v  # signed delta
            return replace(ptr, delta=ptr.delta + d)
        if ptr.kind != PKT:
            self._die(idx, st, f"variable offset into {ptr.show()!r}")
        if sc.umax > MAX_VAR_PKT_OFF:
            self._die(idx, st,
                      f"variable packet advance unbounded (umax="
                      f"{sc.umax:#x}); mask/shift the scalar first")
        # fresh offset variable: the bound must be re-proven
        return Reg(PKT, vid=self._fresh(), delta=0)

    def _alu_scalar(self, idx: int, st: State, op: int, is64: bool,
                    dst: Reg, src: Reg) -> Reg:
        a0, a1, b0, b1 = dst.umin, dst.umax, src.umin, src.umax
        konst = b0 == b1
        out = _UNKNOWN
        if op == isa.BPF_ADD:
            if a1 + b1 <= U64:
                out = _ranged(a0 + b0, a1 + b1)
        elif op == isa.BPF_SUB:
            if b1 <= a0:
                out = _ranged(a0 - b1, a1 - b0)
        elif op == isa.BPF_AND:
            out = _ranged(0, min(a1, b1))
        elif op in (isa.BPF_OR, isa.BPF_XOR):
            bits = max(a1.bit_length(), b1.bit_length())
            lo = max(a0, b0) if op == isa.BPF_OR else 0
            out = _ranged(lo, (1 << bits) - 1) if bits < 64 else _UNKNOWN
        elif op == isa.BPF_LSH:
            if konst and b0 < 64 and (a1 << b0) <= U64:
                out = _ranged(a0 << b0, a1 << b0)
        elif op == isa.BPF_RSH:
            if konst and b0 < 64:
                out = _ranged(a0 >> b0, a1 >> b0)
            else:
                out = _ranged(0, a1)
        elif op == isa.BPF_ARSH:
            if konst and b0 < 64 and a1 < (1 << 63):
                out = _ranged(a0 >> b0, a1 >> b0)
        elif op == isa.BPF_MUL:
            if a1 * b1 <= U64:
                out = _ranged(a0 * b0, a1 * b1)
        elif op == isa.BPF_DIV:
            if konst and b0 == 0:
                self._die(idx, st, "division by zero constant")
            out = _ranged(a0 // b1, a1 // b0) if b0 > 0 else _ranged(0, a1)
        elif op == isa.BPF_MOD:
            if konst and b0 == 0:
                self._die(idx, st, "modulo by zero constant")
            out = _ranged(0, min(a1, b1 - 1)) if b0 > 0 else _ranged(0, a1)
        else:
            self._die(idx, st, f"unsupported ALU op {op:#04x}")
        if not is64:
            out = (out if out.umax <= U32 else _ranged(0, U32))
        # Widening: keep constants (any magnitude) and sub-32-bit ranges
        # precise — everything a packet-bounds proof can legally use —
        # and collapse wider non-constant ranges to unknown.  Without
        # this, the unrolled isqrt loop's per-path ranges never converge
        # and state exploration goes exponential (the same pressure the
        # kernel's 1M-insn budget exists for).
        if out.umin != out.umax and out.umax > U32:
            out = _UNKNOWN
        return out

    # -- conditional jumps ---------------------------------------------

    @staticmethod
    def _cmp_decide(op: int, a: Reg, b: Reg) -> bool | None:
        """True/False when the unsigned compare is decided by ranges."""
        if a.kind != SCALAR or b.kind != SCALAR:
            return None
        if op == isa.BPF_JEQ:
            if a.umin == a.umax == b.umin == b.umax:
                return a.umin == b.umin
            if a.umax < b.umin or a.umin > b.umax:
                return False
        elif op == isa.BPF_JNE:
            if a.umin == a.umax == b.umin == b.umax:
                return a.umin != b.umin
            if a.umax < b.umin or a.umin > b.umax:
                return True
        elif op == isa.BPF_JGT:
            if a.umin > b.umax:
                return True
            if a.umax <= b.umin:
                return False
        elif op == isa.BPF_JGE:
            if a.umin >= b.umax:
                return True
            if a.umax < b.umin:
                return False
        elif op == isa.BPF_JLT:
            if a.umax < b.umin:
                return True
            if a.umin >= b.umax:
                return False
        elif op == isa.BPF_JLE:
            if a.umax <= b.umin:
                return True
            if a.umin > b.umax:
                return False
        return None

    def _branch(self, idx: int, st: State, insn: Insn,
                is32: bool) -> list[tuple[int, State]]:
        op = insn.op & 0xF0
        tgt = idx + 1 + _s16(insn.off)
        if not 0 <= tgt < len(self.insns) or tgt in self.wide_lo:
            self._die(idx, st, f"jump target {tgt} out of range / into "
                               "a ld_imm64 pair")
        dst = st.regs[insn.dst]
        if dst.kind == UNINIT:
            self._die(idx, st, f"branch on uninitialized r{insn.dst}")
        if insn.op & isa.BPF_X:
            src = st.regs[insn.src]
            if src.kind == UNINIT:
                self._die(idx, st, f"branch on uninitialized r{insn.src}")
        else:
            src = _const(isa._s32(insn.imm) & U64)

        # pointer NULL check: ptr ==/!= 0
        for maybe, other in ((dst, src), (src, dst)):
            if maybe.kind in (MAP_VALUE, RB_MEM) and maybe.null_id \
                    and other.kind == SCALAR and other.umin == other.umax == 0 \
                    and op in (isa.BPF_JEQ, isa.BPF_JNE):
                nid = maybe.null_id
                null_st, ok_st = st.clone(), st.clone()
                for s, is_null in ((null_st, True), (ok_st, False)):
                    s.regs = [self._null_resolve(r, nid, is_null)
                              for r in s.regs]
                    s.spills = {o: self._null_resolve(r, nid, is_null)
                                for o, r in s.spills.items()}
                    if is_null:
                        # a NULL reserve never acquired the reference
                        dead = {r.ref_id for r in st.regs
                                if r.kind == RB_MEM and r.null_id == nid}
                        s.refs = s.refs - frozenset(dead)
                if op == isa.BPF_JEQ:
                    return [(tgt, null_st), (idx + 1, ok_st)]
                return [(tgt, ok_st), (idx + 1, null_st)]

        # non-null pointer vs 0: decided
        if dst.kind in (MAP_VALUE, RB_MEM, PKT, FP, CTX, MAP_PTR) \
                and not dst.null_id and src.kind == SCALAR \
                and src.umin == src.umax == 0 \
                and op in (isa.BPF_JEQ, isa.BPF_JNE):
            taken = op == isa.BPF_JNE
            return [(tgt if taken else idx + 1, st)]

        # packet pointer vs data_end: record the proven range
        pe = {dst.kind, src.kind} == {PKT, PKT_END}
        if pe and not is32:
            ptr_is_dst = dst.kind == PKT
            ptr = dst if ptr_is_dst else src
            # which branch proves ptr <= end?
            proof = {  # (op, ptr_is_dst) -> branch with the proof
                (isa.BPF_JGT, True): "fall", (isa.BPF_JGE, True): "fall",
                (isa.BPF_JLE, True): "take", (isa.BPF_JLT, True): "take",
                (isa.BPF_JGT, False): "take", (isa.BPF_JGE, False): "take",
                (isa.BPF_JLE, False): "fall", (isa.BPF_JLT, False): "fall",
            }.get((op, ptr_is_dst))
            take_st, fall_st = st.clone(), st.clone()
            if proof is not None and ptr.delta >= 0:
                pst = take_st if proof == "take" else fall_st
                pst.bounds[ptr.vid] = max(pst.bounds.get(ptr.vid, 0),
                                          ptr.delta)
            return [(tgt, take_st), (idx + 1, fall_st)]

        if dst.kind != SCALAR or src.kind != SCALAR:
            # unmodeled pointer compare: sound to take both branches
            # with no refinement
            return [(tgt, st.clone()), (idx + 1, st.clone())]

        if not is32:
            decided = self._cmp_decide(op, dst, src)
            if decided is not None:
                return [(tgt if decided else idx + 1, st)]
        outs = []
        # equality against a constant pins the register on that branch
        take_st, fall_st = st.clone(), st.clone()
        if src.umin == src.umax and not is32:
            if op == isa.BPF_JEQ:
                take_st.regs[insn.dst] = _const(src.umin)
            elif op == isa.BPF_JNE:
                fall_st.regs[insn.dst] = _const(src.umin)
        outs.append((tgt, take_st))
        outs.append((idx + 1, fall_st))
        return outs

    @staticmethod
    def _null_resolve(r: Reg, nid: int, is_null: bool) -> Reg:
        if r.kind in (MAP_VALUE, RB_MEM) and r.null_id == nid:
            return _const(0) if is_null else replace(r, null_id=0)
        return r

    # -- one instruction ------------------------------------------------

    def _step(self, idx: int, st: State) -> list[tuple[int, State]]:
        """Execute insns[idx] on ``st`` (mutating it); returns successor
        (idx, state) pairs.  Empty list = clean program exit."""
        insn = self.insns[idx]
        op = insn.op
        cls = op & 0x07
        # reg fields are 4-bit nibbles on the wire: a corrupt image can
        # carry 11-15, which must reject, not IndexError (pseudo src
        # values — PSEUDO_MAP_FD, the local-call marker — are all <= 10)
        if insn.dst > 10 or insn.src > 10:
            self._die(idx, st, f"invalid register number "
                               f"(dst=r{insn.dst}, src=r{insn.src})")

        if cls in (isa.BPF_ALU, isa.BPF_ALU64):
            self._alu(idx, st, insn, cls == isa.BPF_ALU64)
            return [(idx + 1, st)]

        if cls == isa.BPF_LD:
            if op != isa.BPF_LD | isa.BPF_DW | isa.BPF_IMM:
                self._die(idx, st, "legacy BPF_LD_ABS/IND unsupported")
            if insn.src == 0:
                lo = insn.imm & U32
                hi = self.insns[idx + 1].imm & U32
                st.regs[insn.dst] = _const(lo | (hi << 32))
            elif insn.src == isa.PSEUDO_MAP_FD:
                name = self.relocs.get(idx)
                if name is None or name not in self.maps:
                    self._die(idx, st, f"map load at slot {idx} has no "
                                       "relocation entry / unknown map")
                st.regs[insn.dst] = Reg(MAP_PTR, map=name)
            else:
                self._die(idx, st, f"unsupported ld_imm64 src "
                                   f"{insn.src}")
            return [(idx + 2, st)]

        if cls == isa.BPF_LDX:
            size = _SIZE_BYTES[op & 0x18]
            src = st.regs[insn.src]
            off = _s16(insn.off)
            if insn.dst == 10:
                self._die(idx, st, "write to frame pointer r10")
            if src.kind == UNINIT:
                self._die(idx, st, f"load through uninitialized "
                                   f"r{insn.src}")
            if src.kind == FP:
                st.regs[insn.dst] = self._stack_read(
                    idx, st, src.delta + off, size)
            elif src.kind == CTX:
                o = src.delta + off
                if o in _XDP_CTX_PTR_FIELDS and size == 4:
                    kind = _XDP_CTX_PTR_FIELDS[o]
                    st.regs[insn.dst] = (
                        Reg(PKT, vid=self._fresh()) if kind == PKT
                        else Reg(PKT_END))
                elif o in _XDP_CTX_SCALARS and size == 4:
                    st.regs[insn.dst] = _ranged(0, U32)
                else:
                    self._die(idx, st, f"invalid xdp_md access: off={o} "
                                       f"size={size}")
            else:
                self._check_mem(idx, st, src, off, size, write=False)
                st.regs[insn.dst] = (_UNKNOWN if size == 8
                                     else _ranged(0, (1 << 8 * size) - 1))
            return [(idx + 1, st)]

        if cls in (isa.BPF_ST, isa.BPF_STX):
            size = _SIZE_BYTES[op & 0x18]
            dst = st.regs[insn.dst]
            off = _s16(insn.off)
            if dst.kind == UNINIT:
                self._die(idx, st, f"store through uninitialized "
                                   f"r{insn.dst}")
            if op & 0xE0 == isa.BPF_ATOMIC:
                if cls != isa.BPF_STX or size not in (4, 8):
                    self._die(idx, st, "malformed atomic op")
                aop = insn.imm & ~isa.BPF_FETCH
                if aop != isa.ATOMIC_ADD:
                    self._die(idx, st, f"unsupported atomic op "
                                       f"imm={insn.imm:#x}")
                src = st.regs[insn.src]
                if src.kind != SCALAR:
                    self._die(idx, st, f"atomic add of {src.show()!r}")
                if dst.kind == FP:
                    self._stack_read(idx, st, dst.delta + off, size)
                    # the add mutates the slot: the tracked spill value
                    # is stale (an unknown-scalar write keeps the init
                    # bytes but drops the precise value)
                    self._stack_write(idx, st, dst.delta + off, size,
                                      _UNKNOWN)
                else:
                    self._check_mem(idx, st, dst, off, size, write=True)
                if insn.imm & isa.BPF_FETCH:
                    if insn.src == 10:
                        self._die(idx, st, "write to frame pointer r10")
                    st.regs[insn.src] = (_UNKNOWN if size == 8
                                         else _ranged(0, U32))
                return [(idx + 1, st)]
            if cls == isa.BPF_STX:
                val = st.regs[insn.src]
                if val.kind == UNINIT:
                    self._die(idx, st, f"store of uninitialized "
                                       f"r{insn.src}")
            else:
                val = _const(isa._s32(insn.imm) & U64)
            if dst.kind == FP:
                self._stack_write(idx, st, dst.delta + off, size, val)
            elif dst.kind == CTX:
                self._die(idx, st, "write to ctx is not allowed")
            else:
                if val.kind not in (SCALAR,):
                    self._die(idx, st, f"pointer leak: storing "
                                       f"{val.show()!r} to {dst.show()!r}")
                self._check_mem(idx, st, dst, off, size, write=True)
            return [(idx + 1, st)]

        if cls in (isa.BPF_JMP, isa.BPF_JMP32):
            jop = op & 0xF0
            if jop == isa.BPF_JA:
                if cls == isa.BPF_JMP32:
                    self._die(idx, st, "JMP32 JA unsupported")
                tgt = idx + 1 + _s16(insn.off)
                if not 0 <= tgt < len(self.insns) or tgt in self.wide_lo:
                    self._die(idx, st, f"jump target {tgt} out of range "
                                       "/ into a ld_imm64 pair")
                return [(tgt, st)]
            if jop == isa.BPF_EXIT:
                r0 = st.regs[0]
                if r0.kind == UNINIT:
                    self._die(idx, st, "R0 not initialized at exit")
                if st.refs:
                    self._die(idx, st,
                              f"reference leak: {len(st.refs)} ringbuf "
                              "record(s) reserved but never "
                              "submitted/discarded on this path")
                return []
            if jop == isa.BPF_CALL:
                if insn.src == 1:  # bpf-to-bpf
                    tgt = idx + 1 + isa._s32(insn.imm)
                    if not 0 <= tgt < len(self.insns):
                        self._die(idx, st, f"call target {tgt} out of "
                                           "range")
                    if st.refs:
                        self._die(idx, st,
                                  "bpf-to-bpf call while holding a "
                                  "ringbuf reference (progs.py contract: "
                                  "reserve after all subprog calls)")
                    for i in range(1, 6):
                        if st.regs[i].kind not in (SCALAR, UNINIT):
                            self._die(idx, st,
                                      f"pointer argument r{i} to local "
                                      "call (modular verification "
                                      "supports scalar args only)")
                    st.regs[0] = _UNKNOWN
                    for i in range(1, 6):
                        st.regs[i] = _UNINIT
                    return [(idx + 1, st)]
                self._call_helper(idx, st, insn.imm)
                return [(idx + 1, st)]
            return self._branch(idx, st, insn, cls == isa.BPF_JMP32)

        self._die(idx, st, f"unknown instruction class {cls}")
        raise AssertionError  # _die always raises

    # -- exploration ----------------------------------------------------

    @staticmethod
    def _skeleton(canon: tuple) -> tuple:
        """The canon with scalar ranges erased: pointer structure, stack
        initialization, spill slots — everything widening preserves."""
        regs, stack, spills, nrefs = canon
        rskel = tuple(
            r[:1] + r[3:] if r[0] == SCALAR else r for r in regs)
        sskel = tuple(
            s[:2] + s[4:] if s[1] == SCALAR else s for s in spills)
        return (rskel, stack, sskel, nrefs)

    @staticmethod
    def _widen_against(st: State, canon: tuple, ref: tuple) -> State:
        """Collapse every scalar register/spill whose range disagrees
        with the same-skeleton reference state to unknown (see
        WIDEN_AT); agreeing scalars keep their values."""
        regs, _, spills, _ = canon
        rregs, _, rspills, _ = ref
        st = st.clone()
        for i, (a, b) in enumerate(zip(regs, rregs)):
            if a[0] == SCALAR and (a[1], a[2]) != (b[1], b[2]):
                st.regs[i] = _UNKNOWN
        ref_sp = {s[0]: s for s in rspills}
        for off, r in st.spills.items():
            b = ref_sp.get(off)
            if r.kind == SCALAR and b is not None and b[1] == SCALAR \
                    and (r.umin, r.umax) != (b[2], b[3]):
                st.spills[off] = _UNKNOWN
        return st

    def run(self, entry: int, entry_state: State) -> None:
        seen: dict[int, list[tuple]] = {}
        skels: dict[int, dict[tuple, tuple]] = {}
        work: list[tuple[int, State]] = [(entry, entry_state)]
        while work:
            idx, st = work.pop()
            if idx >= len(self.insns):
                self._die(len(self.insns) - 1, st,
                          "control flow falls off the end of the program")
            if idx in self.wide_lo:
                self._die(idx, st, "jump into the middle of a ld_imm64")
            if idx in self.probes:
                r = st.regs[self.probes[idx]]
                if r.kind == SCALAR:
                    acc = self.probe_acc.setdefault(
                        idx, [r.umin, r.umax, 0])
                    acc[0] = min(acc[0], r.umin)
                    acc[1] = max(acc[1], r.umax)
                    acc[2] += 1
            self.steps += 1
            if self.steps > self.budget:
                self._die(idx, st,
                          f"complexity budget exceeded ({self.budget} "
                          "instruction states); simplify control flow")
            canon = self._canon(st, idx)
            bucket = seen.setdefault(idx, [])
            if any(self._subsumes(old, canon) for old in bucket):
                self.pruned += 1
                continue
            skel = self._skeleton(canon)
            ref = skels.setdefault(idx, {}).setdefault(skel, canon)
            if len(bucket) >= WIDEN_AT and ref is not canon:
                st = self._widen_against(st, canon, ref)
                canon = self._canon(st, idx)
                if any(self._subsumes(old, canon) for old in bucket):
                    self.pruned += 1
                    continue
            if len(bucket) < 256:
                bucket.append(canon)
            self.visited.add(idx)
            if self.insns[idx].op == isa.BPF_LD | isa.BPF_DW | isa.BPF_IMM:
                self.visited.add(idx + 1)
            work.extend(self._step(idx, st.clone()))


def _entry_state(main: bool) -> State:
    regs = [_UNINIT] * 11
    regs[10] = Reg(FP)
    if main:
        regs[1] = Reg(CTX)
    else:
        # bpf-to-bpf callee: r1-r5 are caller args (scalar-only per the
        # call-site check), r0/r6-r9 start uninitialized in the new frame
        for i in range(1, 6):
            regs[i] = _UNKNOWN
    return State(regs)


def check_program(prog: Program | list[Insn],
                  maps: dict[str, MapInfo] | None = None,
                  *, name: str | None = None,
                  budget: int = 1_000_000,
                  probes: dict[int, int] | None = None,
                  entry_main: bool = True) -> VerifierReport:
    """Statically verify one program; raises :class:`StaticVerifierError`
    with an instruction-level diagnostic on the first violation.

    ``probes`` maps instruction index -> register number: the report's
    ``probes`` field then carries the joined (umin, umax) of that
    register over every abstract state REACHING that instruction —
    observational only (the ``fsx ranges`` containment bridge).

    ``entry_main=False`` verifies instruction 0 under the bpf-to-bpf
    CALLEE contract (r1-r5 unknown scalars, no ctx) — for standalone
    subprogram extracts like ``progs.build_ml_scorer``, whose entry is
    a local-call target in the shipped programs."""
    if isinstance(prog, Program):
        insns = prog.insns
        relocs = {r.slot: r.map_name for r in prog.relocs}
        name = name or prog.name
    else:
        insns, relocs, name = list(prog), {}, name or "prog"
    if not insns:
        raise StaticVerifierError(name, 0, "empty program")
    if maps is None:
        maps = default_map_infos()
    missing = sorted(set(relocs.values()) - set(maps))
    if missing:
        raise StaticVerifierError(name, 0,
                                  f"program references unknown maps "
                                  f"{missing}")

    ck = _Checker(name, insns, relocs, maps, budget, probes=probes)
    # subprograms: every local-call target verifies standalone
    entries = [0]
    for i, ins in enumerate(insns):
        if ins.op == isa.BPF_JMP | isa.BPF_CALL and ins.src == 1:
            tgt = i + 1 + isa._s32(ins.imm)
            if tgt not in entries:
                entries.append(tgt)
    for e in entries:
        ck.run(e, _entry_state(main=entry_main and e == 0))
    unreachable = sorted(set(range(len(insns))) - ck.visited)
    if unreachable:
        ck._die(unreachable[0], None,
                f"unreachable instruction ({len(unreachable)} total)")
    return VerifierReport(
        name=name, n_insns=len(insns), insns_visited=ck.steps,
        states_pruned=ck.pruned, subprog_entries=entries[1:],
        map_names=sorted(set(relocs.values())),
        probes={
            idx: {"reg": probes[idx], "umin": acc[0], "umax": acc[1],
                  "hits": acc[2]}
            for idx, acc in sorted(ck.probe_acc.items())
        } if probes else {},
    )


# ---------------------------------------------------------------------------
# Content-addressed cache: the loader/image hooks verify each distinct
# program once per process, not once per emit/load call.
# ---------------------------------------------------------------------------

_CACHE: dict[tuple, VerifierReport] = {}


def check_program_cached(prog: Program,
                         maps: dict[str, MapInfo] | None = None,
                         *, budget: int = 1_000_000) -> VerifierReport:
    key = (
        b"".join(i.pack() for i in prog.insns),
        tuple(sorted((r.slot, r.map_name) for r in prog.relocs)),
        tuple(sorted(maps.items())) if maps is not None else None,
        budget,
    )
    rep = _CACHE.get(key)
    if rep is None:
        rep = check_program(prog, maps, budget=budget)
        _CACHE[key] = rep
    return rep
