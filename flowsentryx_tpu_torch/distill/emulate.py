"""Concrete SIMD emulator for the emitted scorer bytecode.

Counterpart of ``flowsentryx_tpu/distill/emulate.py``.

The parity acceptance bar ("the emulated kernel-tier verdict is
bit-exact with the served int8 lane on ≥ 10k vectors") needs the ACTUAL
instruction stream executed, not a Python re-statement of its intent —
a re-statement would happily agree with itself while the bytecode
diverged.  A scalar Python interpreter runs the ~9.7k-instruction
scorer at ~1M insn/s, which prices 10k vectors out of tier-1; so this
module interprets the instructions ONCE with every vector riding a
separate *lane*: registers hold ``[L]`` uint64 numpy arrays, each ALU
instruction becomes one vectorized numpy op, and 10k lanes cost the
same instruction walk as one.

Lane coherence is the contract that makes this sound: a data-dependent
branch whose condition differs across lanes has no single successor and
raises :class:`EmulationError` — which is precisely why
``fn_ml_score``'s rank loop and band compare are emitted branch-free
(``bpf/progs.py``); its only branches (lookup NULL, ``valid == 0``) are
uniform by construction.  ``lanes=1`` degrades to a plain scalar
interpreter for anything else.

Scope: the verifier-checked subset the distiller emits — ALU64/ALU32,
MEM load/store through frame or map-value pointers at constant offsets,
``ld_imm64``/pseudo-map-fd, ``map_lookup_elem`` on single-entry ARRAY
maps, bpf-to-bpf calls, conditional jumps, exit.  Unknown opcodes raise
rather than guess.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from flowsentryx_tpu_torch.bpf import isa
from flowsentryx_tpu_torch.bpf.asm import Program
from flowsentryx_tpu_torch.bpf.isa import Insn

U64 = np.uint64
_MASK32 = np.uint64(0xFFFFFFFF)


class EmulationError(Exception):
    """The program left the emulator's modeled subset (or diverged
    across lanes)."""


@dataclass(frozen=True)
class _Ptr:
    """A uniform (lane-invariant) pointer: frame slot base or map value."""

    region: str   # "fp<depth>" or a map name
    off: int

    def bump(self, delta: int) -> "_Ptr":
        return _Ptr(self.region, self.off + delta)


def _s16(v: int) -> int:
    v &= 0xFFFF
    return v - (1 << 16) if v >= (1 << 15) else v


def _imm64(v: int) -> np.uint64:
    return np.uint64(v & ((1 << 64) - 1))


class VectorEmulator:
    """One program + map contents; ``run`` executes with fresh state."""

    def __init__(self, prog: Program | list[Insn],
                 relocs: dict[int, str] | None = None,
                 maps: dict[str, bytes] | None = None,
                 max_steps: int = 1 << 20):
        if isinstance(prog, Program):
            self.insns = prog.insns
            self.relocs = {r.slot: r.map_name for r in prog.relocs}
        else:
            self.insns = list(prog)
            self.relocs = dict(relocs or {})
        self.maps = {k: bytes(v) for k, v in (maps or {}).items()}
        self.max_steps = max_steps

    # -- memory ---------------------------------------------------------

    def _load(self, frames: list[dict], ptr: _Ptr, off: int, size: int):
        off += ptr.off
        if ptr.region.startswith("fp"):
            stack = frames[int(ptr.region[2:])]
            slot = stack.get(off)
            if slot is None or slot[0] != size:
                raise EmulationError(
                    f"frame load [{off},{off + size}) does not match a "
                    f"stored slot (have {sorted(stack)})")
            return slot[1]
        blob = self.maps.get(ptr.region)
        if blob is None:
            raise EmulationError(f"load from unknown map {ptr.region!r}")
        if off < 0 or off + size > len(blob):
            raise EmulationError(
                f"map {ptr.region!r} load out of bounds: "
                f"[{off},{off + size}) of {len(blob)}")
        return np.uint64(int.from_bytes(blob[off:off + size], "little"))

    @staticmethod
    def _store(frames: list[dict], ptr: _Ptr, off: int, size: int,
               val) -> None:
        if not ptr.region.startswith("fp"):
            raise EmulationError("stores are modeled for the frame only")
        mask = _imm64((1 << (8 * size)) - 1)
        frames[int(ptr.region[2:])][ptr.off + off] = (size, val & mask)

    # -- ALU ------------------------------------------------------------

    @staticmethod
    def _alu(op: int, a, b, is64: bool):
        with np.errstate(over="ignore"):
            if op == isa.BPF_MOV:
                r = b
            elif op == isa.BPF_ADD:
                r = a + b
            elif op == isa.BPF_SUB:
                r = a - b
            elif op == isa.BPF_MUL:
                r = a * b
            elif op == isa.BPF_OR:
                r = a | b
            elif op == isa.BPF_AND:
                r = a & b
            elif op == isa.BPF_XOR:
                r = a ^ b
            elif op == isa.BPF_LSH:
                r = np.left_shift(a, b & np.uint64(63))
            elif op == isa.BPF_RSH:
                r = np.right_shift(a, b & np.uint64(63))
            elif op == isa.BPF_ARSH:
                r = np.right_shift(
                    a.astype(np.int64) if hasattr(a, "astype")
                    else np.int64(a), (b & np.uint64(63)).astype(np.int64)
                    if hasattr(b, "astype") else np.int64(b)).astype(U64)
            elif op == isa.BPF_DIV:
                if not np.all(np.asarray(b) != 0):
                    raise EmulationError("division by zero")
                r = a // b
            elif op == isa.BPF_MOD:
                if not np.all(np.asarray(b) != 0):
                    raise EmulationError("modulo by zero")
                r = a % b
            else:
                raise EmulationError(f"unsupported ALU op {op:#04x}")
        if not is64:
            r = r & _MASK32
        return r

    _JMP_UNSIGNED = {
        isa.BPF_JEQ: np.equal, isa.BPF_JNE: np.not_equal,
        isa.BPF_JGT: np.greater, isa.BPF_JGE: np.greater_equal,
        isa.BPF_JLT: np.less, isa.BPF_JLE: np.less_equal,
    }
    _JMP_SIGNED = {
        isa.BPF_JSGT: np.greater, isa.BPF_JSGE: np.greater_equal,
        isa.BPF_JSLT: np.less, isa.BPF_JSLE: np.less_equal,
    }

    def _branch_taken(self, jop: int, a, b) -> bool:
        if isinstance(a, _Ptr) or isinstance(b, _Ptr):
            # the only pointer compare the scorer emits is the NULL
            # check, and an emulated lookup never returns NULL
            if jop == isa.BPF_JEQ:
                return False
            if jop == isa.BPF_JNE:
                return True
            raise EmulationError("unsupported pointer compare")
        if jop == isa.BPF_JSET:
            cond = (a & b) != 0
        elif jop in self._JMP_UNSIGNED:
            cond = self._JMP_UNSIGNED[jop](a, b)
        elif jop in self._JMP_SIGNED:
            cond = self._JMP_SIGNED[jop](
                np.asarray(a).astype(np.int64),
                np.asarray(b).astype(np.int64))
        else:
            raise EmulationError(f"unsupported jump op {jop:#04x}")
        t = bool(np.all(cond))
        if not t and bool(np.any(cond)):
            raise EmulationError(
                "divergent branch: condition differs across lanes (the "
                "emitted scorer must stay branch-free on lane data)")
        return t

    # -- the run loop ----------------------------------------------------

    def run(self, entry_regs: dict[int, object]) -> np.ndarray:
        """Execute from slot 0 with ``entry_regs`` preset (lane arrays
        or ints); returns r0 at top-level exit as a uint64 array."""
        regs: list[object] = [None] * 11
        frames: list[dict] = [{}]
        regs[10] = _Ptr("fp0", 0)
        for i, v in entry_regs.items():
            regs[i] = np.asarray(v, U64)
        call_stack: list[tuple[int, list[object]]] = []
        idx = 0
        steps = 0
        while True:
            steps += 1
            if steps > self.max_steps:
                raise EmulationError(f"step budget {self.max_steps} "
                                     "exceeded")
            if not 0 <= idx < len(self.insns):
                raise EmulationError(f"pc {idx} out of program")
            ins = self.insns[idx]
            op = ins.op
            cls = op & 0x07

            if cls in (isa.BPF_ALU, isa.BPF_ALU64):
                is64 = cls == isa.BPF_ALU64
                aop = op & 0xF0
                if aop == isa.BPF_NEG:
                    with np.errstate(over="ignore"):
                        r = (np.uint64(0) - regs[ins.dst])
                    regs[ins.dst] = r if is64 else r & _MASK32
                    idx += 1
                    continue
                if aop == isa.BPF_END:
                    raise EmulationError("byte swap not modeled")
                b = (regs[ins.src] if op & isa.BPF_X
                     else _imm64(isa._s32(ins.imm)) if is64
                     else np.uint64(ins.imm & 0xFFFFFFFF))
                a = regs[ins.dst]
                if isinstance(a, _Ptr) or isinstance(b, _Ptr):
                    # constant pointer arithmetic only (frame/map offsets)
                    if aop == isa.BPF_MOV:
                        regs[ins.dst] = b
                    elif aop == isa.BPF_ADD and isinstance(a, _Ptr):
                        regs[ins.dst] = a.bump(int(np.int64(np.uint64(b))))
                    else:
                        raise EmulationError(
                            f"unsupported pointer ALU at {idx}")
                    idx += 1
                    continue
                if a is None and aop != isa.BPF_MOV:
                    raise EmulationError(f"read of uninit r{ins.dst} "
                                         f"at {idx}")
                regs[ins.dst] = self._alu(aop, a, b, is64)
                idx += 1
                continue

            if cls == isa.BPF_LD:  # ld_imm64
                if op != isa.BPF_LD | isa.BPF_DW | isa.BPF_IMM:
                    raise EmulationError("legacy LD unsupported")
                if ins.src == isa.PSEUDO_MAP_FD:
                    name = self.relocs.get(idx)
                    if name is None:
                        raise EmulationError(f"map load at {idx} has no "
                                             "relocation")
                    regs[ins.dst] = _Ptr(name, 0)
                else:
                    lo = ins.imm & 0xFFFFFFFF
                    hi = self.insns[idx + 1].imm & 0xFFFFFFFF
                    regs[ins.dst] = np.uint64(lo | (hi << 32))
                idx += 2
                continue

            if cls == isa.BPF_LDX:
                size = {isa.BPF_B: 1, isa.BPF_H: 2, isa.BPF_W: 4,
                        isa.BPF_DW: 8}[op & 0x18]
                src = regs[ins.src]
                if not isinstance(src, _Ptr):
                    raise EmulationError(f"load through non-pointer at "
                                         f"{idx}")
                regs[ins.dst] = self._load(frames, src, _s16(ins.off), size)
                idx += 1
                continue

            if cls in (isa.BPF_ST, isa.BPF_STX):
                if op & 0xE0 == isa.BPF_ATOMIC:
                    raise EmulationError("atomics not modeled")
                size = {isa.BPF_B: 1, isa.BPF_H: 2, isa.BPF_W: 4,
                        isa.BPF_DW: 8}[op & 0x18]
                dst = regs[ins.dst]
                if not isinstance(dst, _Ptr):
                    raise EmulationError(f"store through non-pointer at "
                                         f"{idx}")
                val = (regs[ins.src] if cls == isa.BPF_STX
                       else _imm64(isa._s32(ins.imm)))
                if isinstance(val, _Ptr):
                    raise EmulationError("pointer spill not modeled")
                self._store(frames, dst, _s16(ins.off), size, val)
                idx += 1
                continue

            if cls == isa.BPF_JMP:
                jop = op & 0xF0
                if jop == isa.BPF_JA:
                    idx += 1 + _s16(ins.off)
                    continue
                if jop == isa.BPF_EXIT:
                    if call_stack:
                        ret, saved = call_stack.pop()
                        frames.pop()
                        regs[6:10] = saved  # callee-saved restore
                        regs[10] = _Ptr(f"fp{len(frames) - 1}", 0)
                        for i in range(1, 6):
                            regs[i] = None
                        idx = ret
                        continue
                    r0 = regs[0]
                    if r0 is None or isinstance(r0, _Ptr):
                        raise EmulationError("bad r0 at exit")
                    return np.asarray(r0, U64)
                if jop == isa.BPF_CALL:
                    if ins.src == 1:  # bpf-to-bpf
                        call_stack.append((idx + 1, regs[6:10]))
                        frames.append({})
                        regs[10] = _Ptr(f"fp{len(frames) - 1}", 0)
                        idx = idx + 1 + isa._s32(ins.imm)
                        continue
                    if ins.imm == isa.FN_map_lookup_elem:
                        mp, key_ptr = regs[1], regs[2]
                        if not (isinstance(mp, _Ptr)
                                and isinstance(key_ptr, _Ptr)):
                            raise EmulationError("bad lookup args")
                        key = self._load(frames, key_ptr, 0, 4)
                        k = np.asarray(key)
                        if k.size and np.unique(k).size != 1:
                            raise EmulationError("divergent lookup key")
                        if int(k.flat[0]) != 0:
                            raise EmulationError(
                                "only key 0 of a 1-entry ARRAY map is "
                                "modeled")
                        regs[0] = _Ptr(mp.region, 0)
                        for i in range(1, 6):
                            regs[i] = None
                        idx += 1
                        continue
                    raise EmulationError(f"helper #{ins.imm} not modeled")
                b = (regs[ins.src] if op & isa.BPF_X
                     else _imm64(isa._s32(ins.imm)))
                if self._branch_taken(jop, regs[ins.dst], b):
                    idx += 1 + _s16(ins.off)
                else:
                    idx += 1
                continue

            raise EmulationError(f"unsupported instruction class {cls} "
                                 f"at {idx}")


# ---------------------------------------------------------------------------
# The scorer entry point
# ---------------------------------------------------------------------------


_SCORER_CACHE: dict = {}


def _scorer() -> Program:
    prog = _SCORER_CACHE.get("prog")
    if prog is None:
        from flowsentryx_tpu_torch.bpf import progs

        prog = _SCORER_CACHE["prog"] = progs.build_ml_scorer()
    return prog


def emulate_scorer(blob: bytes, feat: np.ndarray) -> np.ndarray:
    """Run ``fn_ml_score``'s real instruction stream over ``[N, 8]``
    u32 features against a packed model ``blob``; returns ``[N]`` uint8
    ``schema.ML_BAND_*`` codes.  All N vectors ride as lanes of one
    instruction walk (module docstring)."""
    feat = np.asarray(feat)
    if feat.ndim != 2 or feat.shape[1] != 8:
        raise ValueError(f"want [N, 8] features, got {feat.shape}")
    f = feat.astype(np.uint64)
    # the call contract of fn_ml_score: feat[2p] | feat[2p+1] << 32 in r1+p
    entry = {1 + p: f[:, 2 * p] | (f[:, 2 * p + 1] << np.uint64(32))
             for p in range(4)}
    em = VectorEmulator(_scorer(), maps={"ml_model_map": blob})
    return em.run(entry).astype(np.uint8)
