"""BPF instruction-set encodings (kernel uapi, linux/bpf.h).

Every eBPF instruction is 8 bytes: ``op:8 dst_reg:4 src_reg:4 off:16
imm:32`` (little-endian), except ``BPF_LD|BPF_DW|BPF_IMM`` which takes a
second 8-byte slot carrying the upper 32 bits of a 64-bit immediate.
These encodings are a stable kernel ABI; the values below are the uapi
constants, re-derived from the instruction-class layout (3 low bits =
class, etc.), not copied from any header.

The original system compiles its programs with clang -target bpf; this
module is the bottom of the in-repo replacement toolchain (see package
docstring).

Counterpart of ``flowsentryx_tpu/bpf/isa.py``.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

# ---- instruction classes (low 3 bits of op) ----
BPF_LD = 0x00
BPF_LDX = 0x01
BPF_ST = 0x02
BPF_STX = 0x03
BPF_ALU = 0x04
BPF_JMP = 0x05
BPF_JMP32 = 0x06
BPF_ALU64 = 0x07

# ---- size modifiers (bits 3-4) for load/store ----
BPF_W = 0x00  # 4 bytes
BPF_H = 0x08  # 2 bytes
BPF_B = 0x10  # 1 byte
BPF_DW = 0x18  # 8 bytes

# ---- mode modifiers (bits 5-7) for load/store ----
BPF_IMM = 0x00
BPF_MEM = 0x60
BPF_ATOMIC = 0xC0

# ---- ALU/JMP source (bit 3) ----
BPF_K = 0x00  # immediate
BPF_X = 0x08  # register

# ---- ALU ops (high 4 bits) ----
BPF_ADD = 0x00
BPF_SUB = 0x10
BPF_MUL = 0x20
BPF_DIV = 0x30
BPF_OR = 0x40
BPF_AND = 0x50
BPF_LSH = 0x60
BPF_RSH = 0x70
BPF_NEG = 0x80
BPF_MOD = 0x90
BPF_XOR = 0xA0
BPF_MOV = 0xB0
BPF_ARSH = 0xC0
BPF_END = 0xD0

# ---- JMP ops (high 4 bits) ----
BPF_JA = 0x00
BPF_JEQ = 0x10
BPF_JGT = 0x20
BPF_JGE = 0x30
BPF_JSET = 0x40
BPF_JNE = 0x50
BPF_JSGT = 0x60
BPF_JSGE = 0x70
BPF_CALL = 0x80
BPF_EXIT = 0x90
BPF_JLT = 0xA0
BPF_JLE = 0xB0
BPF_JSLT = 0xC0
BPF_JSLE = 0xD0

# ---- atomic op immediates (stored in imm field of BPF_ATOMIC) ----
BPF_FETCH = 0x01
ATOMIC_ADD = BPF_ADD  # imm=0x00: atomic add; |BPF_FETCH for fetch-add

# ---- registers ----
R0, R1, R2, R3, R4, R5, R6, R7, R8, R9, R10 = range(11)

# ---- pseudo src_reg values for BPF_LD|BPF_DW|BPF_IMM ----
PSEUDO_MAP_FD = 1  # imm = map fd; verifier rewrites to map pointer
PSEUDO_MAP_VALUE = 2  # imm = map fd, next_imm = offset into value

# ---- helper function ids (kernel uapi enum bpf_func_id; stable ABI) ----
FN_map_lookup_elem = 1
FN_map_update_elem = 2
FN_map_delete_elem = 3
FN_ktime_get_ns = 5
FN_trace_printk = 6
FN_get_smp_processor_id = 8
FN_xdp_adjust_head = 44
FN_ringbuf_output = 130
FN_ringbuf_reserve = 131
FN_ringbuf_submit = 132
FN_ringbuf_discard = 133

# ---- XDP return codes ----
XDP_ABORTED = 0
XDP_DROP = 1
XDP_PASS = 2
XDP_TX = 3
XDP_REDIRECT = 4

# ---- struct xdp_md field offsets (uapi, 6 x u32) ----
XDP_MD_DATA = 0
XDP_MD_DATA_END = 4
XDP_MD_DATA_META = 8


@dataclass(frozen=True)
class Insn:
    """One 8-byte BPF instruction slot."""

    op: int
    dst: int = 0
    src: int = 0
    off: int = 0
    imm: int = 0

    def pack(self) -> bytes:
        imm = self.imm & 0xFFFFFFFF
        off = self.off & 0xFFFF
        return struct.pack(
            "<BBHI", self.op & 0xFF, (self.src << 4 | self.dst) & 0xFF, off, imm
        )


def _s32(v: int) -> int:
    v &= 0xFFFFFFFF
    return v - (1 << 32) if v >= (1 << 31) else v


# ---- encoders: each returns a list[Insn] so ld_imm64 composes ----

def mov64(dst: int, src: int) -> list[Insn]:
    return [Insn(BPF_ALU64 | BPF_MOV | BPF_X, dst, src)]


def mov64_imm(dst: int, imm: int) -> list[Insn]:
    return [Insn(BPF_ALU64 | BPF_MOV | BPF_K, dst, imm=_s32(imm))]


def mov32(dst: int, src: int) -> list[Insn]:
    """32-bit move: zero-extends dst's upper half (ALU class)."""
    return [Insn(BPF_ALU | BPF_MOV | BPF_X, dst, src)]


def mov32_imm(dst: int, imm: int) -> list[Insn]:
    return [Insn(BPF_ALU | BPF_MOV | BPF_K, dst, imm=_s32(imm))]


def alu64(op: int, dst: int, src: int) -> list[Insn]:
    return [Insn(BPF_ALU64 | op | BPF_X, dst, src)]


def alu64_imm(op: int, dst: int, imm: int) -> list[Insn]:
    return [Insn(BPF_ALU64 | op | BPF_K, dst, imm=_s32(imm))]


def alu32(op: int, dst: int, src: int) -> list[Insn]:
    return [Insn(BPF_ALU | op | BPF_X, dst, src)]


def alu32_imm(op: int, dst: int, imm: int) -> list[Insn]:
    return [Insn(BPF_ALU | op | BPF_K, dst, imm=_s32(imm))]


def neg64(dst: int) -> list[Insn]:
    return [Insn(BPF_ALU64 | BPF_NEG, dst)]


def endian_be(dst: int, bits: int) -> list[Insn]:
    """bpf_htobe / to-big-endian byte swap (imm = 16/32/64)."""
    return [Insn(BPF_ALU | BPF_END | BPF_X, dst, imm=bits)]


def ld_imm64(dst: int, imm: int) -> list[Insn]:
    lo = imm & 0xFFFFFFFF
    hi = (imm >> 32) & 0xFFFFFFFF
    return [
        Insn(BPF_LD | BPF_DW | BPF_IMM, dst, 0, 0, _s32(lo)),
        Insn(0, 0, 0, 0, _s32(hi)),
    ]


def ld_map_fd(dst: int, map_fd: int) -> list[Insn]:
    """Load a map pointer (verifier rewrites PSEUDO_MAP_FD)."""
    return [
        Insn(BPF_LD | BPF_DW | BPF_IMM, dst, PSEUDO_MAP_FD, 0, map_fd),
        Insn(0, 0, 0, 0, 0),
    ]


def ldx(size: int, dst: int, src: int, off: int) -> list[Insn]:
    return [Insn(BPF_LDX | size | BPF_MEM, dst, src, off)]


def stx(size: int, dst: int, off: int, src: int) -> list[Insn]:
    return [Insn(BPF_STX | size | BPF_MEM, dst, src, off)]


def st_imm(size: int, dst: int, off: int, imm: int) -> list[Insn]:
    return [Insn(BPF_ST | size | BPF_MEM, dst, 0, off, _s32(imm))]


def atomic_add64(dst: int, off: int, src: int, fetch: bool = False) -> list[Insn]:
    """*(u64 *)(dst + off) += src; with fetch, src = old value.

    Plain atomic add is supported by every eBPF kernel; the FETCH form
    needs kernel >= 5.12 (this image runs 6.18).
    """
    imm = ATOMIC_ADD | (BPF_FETCH if fetch else 0)
    return [Insn(BPF_STX | BPF_DW | BPF_ATOMIC, dst, src, off, imm)]


def jmp(op: int, dst: int, src: int, off: int) -> list[Insn]:
    return [Insn(BPF_JMP | op | BPF_X, dst, src, off)]


def jmp_imm(op: int, dst: int, imm: int, off: int) -> list[Insn]:
    return [Insn(BPF_JMP | op | BPF_K, dst, 0, off, _s32(imm))]


def ja(off: int) -> list[Insn]:
    return [Insn(BPF_JMP | BPF_JA, 0, 0, off)]


def call(fn: int) -> list[Insn]:
    return [Insn(BPF_JMP | BPF_CALL, 0, 0, 0, fn)]


def exit_() -> list[Insn]:
    return [Insn(BPF_JMP | BPF_EXIT)]
