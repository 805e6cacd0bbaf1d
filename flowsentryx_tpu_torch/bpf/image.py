"""FSXPROG program image: the assembler→daemon hand-off format.

A self-contained binary image of the assembled fsx program: map specs,
relocation table, instructions.  The C++ daemon (daemon/fsx_bpf.hpp)
loads it with raw bpf(2) syscalls — create maps, patch fds into the
ld_imm64 relocation slots, PROG_LOAD — exactly the handshake libbpf
performs on an ELF .o, minus the ELF/BTF container (which needs no
compiler here; see docs/BPF_BUILD.md for the clang path on NIC hosts).

Layout (little-endian):
    u64 magic 'FSXPROG1'  u32 version  u32 n_maps  u32 n_relocs  u32 n_insns
    maps[n_maps]:   char name[16], u32 map_type, u32 key_size,
                    u32 value_size, u32 max_entries
    relocs[n_relocs]: u32 insn_slot, u32 map_idx
    insns:          n_insns * 8 bytes

Regenerate with:  python -m flowsentryx_tpu_torch.bpf.image [out.img]

Counterpart of ``flowsentryx_tpu/bpf/image.py``: the sealed images are
byte-equal to ``kern/build/*.img``.
"""

from __future__ import annotations

import os
import struct
import sys
from dataclasses import dataclass

from flowsentryx_tpu_torch.bpf import progs
from flowsentryx_tpu_torch.bpf.asm import Program

MAGIC = int.from_bytes(b"FSXPROG1", "little")
VERSION = 1
_HDR = struct.Struct("<QIIII")
_MAP = struct.Struct("<16sIIII")
_REL = struct.Struct("<II")


@dataclass(frozen=True)
class ImageMap:
    name: str
    map_type: int
    key_size: int
    value_size: int
    max_entries: int


def emit(prog: Program | None = None,
         sizes: progs.MapSizes = progs.MapSizes(),
         compact: bool = False, ml: bool = False) -> bytes:
    """Serialize the fsx program (or a custom one) to an image blob.
    ``compact`` assembles the 16 B kernel-quantized emit variant
    (progs.build(compact=True)); the daemon must then be started with
    --compact so ring record sizes agree.  ``ml`` embeds the in-kernel
    classifier stage + ml_model_map (docs/DISTILL.md); the stage is
    inert until ``fsx distill --pin`` pushes a model blob.

    The program is statically verified before the image is sealed
    (``bpf/verifier.py``; one cached pass per distinct program per
    process) — a daemon must never be handed bytecode the kernel
    verifier would reject at attach time, in an environment where the
    rejection cannot be reproduced.  ``FSX_SKIP_STATIC_VERIFY=1``
    skips the pass.
    """
    prog = prog or progs.build(compact=compact, ml=ml)
    if os.environ.get("FSX_SKIP_STATIC_VERIFY") != "1":
        from flowsentryx_tpu_torch.bpf import verifier

        verifier.check_program_cached(prog)
    names = prog.map_names
    specs = []
    for name in names:
        mtype, ks, vs, ent = progs.MAP_SPECS[name]
        n = progs.max_entries_for(ent, sizes)
        specs.append(ImageMap(name, mtype, ks, vs, n))
    out = [_HDR.pack(MAGIC, VERSION, len(specs), len(prog.relocs),
                     len(prog.insns))]
    for m in specs:
        out.append(_MAP.pack(m.name.encode()[:15].ljust(16, b"\0"),
                             m.map_type, m.key_size, m.value_size,
                             m.max_entries))
    idx = {n: i for i, n in enumerate(names)}
    for r in prog.relocs:
        out.append(_REL.pack(r.slot, idx[r.map_name]))
    for insn in prog.insns:
        out.append(insn.pack())
    return b"".join(out)


def parse(blob: bytes) -> tuple[list[ImageMap], list[tuple[int, int]], bytes]:
    """Inverse of emit (used by tests to cross-check the C++ reader).
    Raises ValueError (never struct.error) on a truncated/corrupt blob."""
    if len(blob) < _HDR.size:
        raise ValueError("truncated FSXPROG image")
    magic, ver, n_maps, n_relocs, n_insns = _HDR.unpack_from(blob, 0)
    if magic != MAGIC or ver != VERSION:
        raise ValueError("bad FSXPROG image")
    off = _HDR.size
    if len(blob) < off + n_maps * _MAP.size + n_relocs * _REL.size:
        raise ValueError("truncated FSXPROG image")
    maps = []
    for _ in range(n_maps):
        nm, mt, ks, vs, me = _MAP.unpack_from(blob, off)
        maps.append(ImageMap(nm.rstrip(b"\0").decode(), mt, ks, vs, me))
        off += _MAP.size
    relocs = []
    for _ in range(n_relocs):
        slot, mi = _REL.unpack_from(blob, off)
        if mi >= n_maps:
            raise ValueError(f"FSXPROG relocation references map "
                             f"#{mi} of {n_maps}")
        relocs.append((slot, mi))
        off += _REL.size
    insns = blob[off: off + 8 * n_insns]
    if len(insns) != 8 * n_insns:
        raise ValueError("truncated FSXPROG image")
    return maps, relocs, insns


def to_program(blob: bytes, name: str = "image",
               ) -> tuple[Program, list[ImageMap]]:
    """Decode an image back to an assemblable :class:`Program` plus its
    embedded map specs — the full inverse of :func:`emit`, shared by
    ``fsx check --image`` and the verifier tests so the instruction
    wire decode lives in exactly one place."""
    from flowsentryx_tpu_torch.bpf.asm import MapReloc
    from flowsentryx_tpu_torch.bpf.isa import Insn

    maps, relocs, insn_bytes = parse(blob)
    # "<BBhi": off and imm are signed on the Insn (pack masks them), so
    # decode sign-extended for a lossless emit -> to_program roundtrip
    insns = [Insn(op, sd & 0x0F, sd >> 4, off, imm)
             for op, sd, off, imm in struct.iter_unpack("<BBhi",
                                                        insn_bytes)]
    prog = Program(insns, [MapReloc(slot, maps[mi].name)
                           for slot, mi in relocs], name=name)
    return prog, maps


def main(argv: list[str]) -> int:
    import pathlib

    # Flags may appear anywhere; the first non-flag argument is the
    # output path (so `... --track-ips=64` is never mistaken for a path).
    out = None
    kw = {}
    compact = False
    ml = False
    for a in argv[1:]:
        if a.startswith("--track-ips="):
            kw["max_track_ips"] = int(a.split("=")[1])
        elif a.startswith("--ring-bytes="):
            kw["ring_bytes"] = int(a.split("=")[1])
        elif a == "--compact":
            compact = True
        elif a == "--ml":
            ml = True
        elif a.startswith("--"):
            print(f"unknown flag: {a}", file=sys.stderr)
            return 2
        elif out is not None:
            print(f"multiple output paths: {out!r} and {a!r}", file=sys.stderr)
            return 2
        else:
            out = a
    out = out or "kern/build/fsx_prog.img"
    blob = emit(sizes=progs.MapSizes(**kw), compact=compact, ml=ml)
    pathlib.Path(out).parent.mkdir(parents=True, exist_ok=True)
    pathlib.Path(out).write_bytes(blob)
    print(f"wrote {out}: {len(blob)} bytes")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
