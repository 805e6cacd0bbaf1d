"""BPF macro assembler: labels, forward jumps, symbolic map references.

Programs are built as a linear instruction stream with named labels;
``assemble()`` resolves jump offsets (slot-relative, per the ISA) and
returns the instruction list plus a relocation table mapping map names
to the ld_imm64 slots whose imm must be patched with the map fd at load
time (loader.py) or sealed into a program image (image.py).

This is the middle of the in-repo toolchain replacing clang -target bpf
(see package docstring).

Counterpart of ``flowsentryx_tpu/bpf/asm.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from flowsentryx_tpu_torch.bpf import isa
from flowsentryx_tpu_torch.bpf.isa import Insn


@dataclass
class _PendingJump:
    """A jump whose offset awaits label resolution."""

    insn: Insn  # off field ignored
    target: str
    patch_imm: bool = False  # BPF-to-BPF call: delta goes in imm, not off


@dataclass
class MapReloc:
    """Slot index of a ld_imm64 whose imm needs the fd of `map_name`."""

    slot: int
    map_name: str


@dataclass
class Program:
    insns: list[Insn]
    relocs: list[MapReloc]
    name: str = "prog"

    def pack(self, map_fds: dict[str, int] | None = None) -> bytes:
        """Serialize; map_fds patches relocations (required when the
        program references maps and will be loaded directly)."""
        out = list(self.insns)
        for r in self.relocs:
            fd = (map_fds or {}).get(r.map_name)
            if fd is None:
                raise KeyError(f"no fd for map {r.map_name!r}")
            base = out[r.slot]
            out[r.slot] = Insn(base.op, base.dst, isa.PSEUDO_MAP_FD, 0, fd)
        return b"".join(i.pack() for i in out)

    @property
    def map_names(self) -> list[str]:
        seen: list[str] = []
        for r in self.relocs:
            if r.map_name not in seen:
                seen.append(r.map_name)
        return seen


@dataclass
class Asm:
    """Incremental program builder.

    Usage::

        a = Asm("fsx")
        a += isa.mov64_imm(isa.R0, 2)
        a.jmp_imm(isa.BPF_JEQ, isa.R0, 0, "drop")
        ...
        a.label("drop")
        ...
        prog = a.assemble()
    """

    name: str = "prog"
    _items: list[object] = field(default_factory=list)  # Insn|_PendingJump|str

    def __iadd__(self, insns: list[Insn]) -> "Asm":
        self._items.extend(insns)
        return self

    def label(self, name: str) -> None:
        self._items.append(("label", name))

    # ---- label-targeted control flow ----

    def jmp_imm(self, op: int, dst: int, imm: int, target: str) -> None:
        self._items.append(
            _PendingJump(Insn(isa.BPF_JMP | op | isa.BPF_K, dst, 0, 0,
                              isa._s32(imm)), target)
        )

    def jmp_reg(self, op: int, dst: int, src: int, target: str) -> None:
        self._items.append(
            _PendingJump(Insn(isa.BPF_JMP | op | isa.BPF_X, dst, src, 0), target)
        )

    def ja(self, target: str) -> None:
        self._items.append(_PendingJump(Insn(isa.BPF_JMP | isa.BPF_JA), target))

    def call_local(self, target: str) -> None:
        """BPF-to-BPF call (src_reg=BPF_PSEUDO_CALL=1, imm=slot delta).
        Callee gets r1-r5 as args, returns r0; r6-r9 are callee-saved by
        the kernel's frame management."""
        self._items.append(
            _PendingJump(Insn(isa.BPF_JMP | isa.BPF_CALL, 0, 1), target,
                         patch_imm=True)
        )

    # ---- symbolic map load ----

    def ld_map(self, dst: int, map_name: str) -> None:
        self._items.append(("map", dst, map_name))

    # ---- assembly ----

    def assemble(self) -> Program:
        # Pass 1: slot positions for labels (ld_imm64 and map loads are
        # 2 slots; everything else 1).
        labels: dict[str, int] = {}
        slot = 0
        for it in self._items:
            if isinstance(it, tuple) and it[0] == "label":
                if it[1] in labels:
                    raise ValueError(f"duplicate label {it[1]!r}")
                labels[it[1]] = slot
            elif isinstance(it, tuple) and it[0] == "map":
                slot += 2
            else:
                slot += 1

        # Pass 2: emit with resolved offsets.
        insns: list[Insn] = []
        relocs: list[MapReloc] = []
        for it in self._items:
            if isinstance(it, tuple) and it[0] == "label":
                continue
            if isinstance(it, tuple) and it[0] == "map":
                _, dst, map_name = it
                relocs.append(MapReloc(len(insns), map_name))
                insns.append(Insn(isa.BPF_LD | isa.BPF_DW | isa.BPF_IMM,
                                  dst, isa.PSEUDO_MAP_FD, 0, 0))
                insns.append(Insn(0))
                continue
            if isinstance(it, _PendingJump):
                if it.target not in labels:
                    raise ValueError(f"undefined label {it.target!r}")
                off = labels[it.target] - (len(insns) + 1)
                b = it.insn
                if it.patch_imm:
                    insns.append(Insn(b.op, b.dst, b.src, 0, off))
                    continue
                if not -(1 << 15) <= off < (1 << 15):
                    raise ValueError(f"jump to {it.target!r} out of s16 range")
                insns.append(Insn(b.op, b.dst, b.src, off, b.imm))
                continue
            assert isinstance(it, Insn)
            insns.append(it)
        return Program(insns, relocs, self.name)
