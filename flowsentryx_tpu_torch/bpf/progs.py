"""The fsx XDP fast path, hand-assembled to BPF bytecode.

Instruction-level implementation of the same semantics as
``kern/fsx_kern.c`` (which this image cannot compile — no clang with a
BPF target exists here; see docs/BPF_BUILD.md): parse → blacklist gate →
per-IP rate limit (all three limiters) → streaming feature extraction →
ringbuf egress → per-CPU stats.  The C source remains the reference
implementation for NIC deployments built where clang exists; this
module produces a loadable program NOW, verified by the real in-kernel
verifier and exercised by BPF_PROG_TEST_RUN in the test suite
(SURVEY.md §4's no-NIC plan).

Parity contracts (tested in tests/test_bpf.py):
* parse semantics mirror kern/parsing.h:225-266 (Eth → IPv4/IPv6 →
  TCP/UDP/ICMP, cursor bounds-checks before every dereference — the
  discipline the reference recorded at TODO.md:264-268);
* limiter arithmetic mirrors kern/fsx_compute.h:64-142 (integer-only,
  window reset seeds with the current packet);
* feature estimators mirror kern/fsx_kern.c:97-185 (mean/var/IAT in
  integer space, IATs in microseconds, emit every packet while the flow
  is young then every 16th);
* struct offsets match the generated kern/fsx_schema.h (single source
  of truth: flowsentryx_tpu_torch.core.schema / core.config).

Register allocation in the main function:
  r6 = config ptr        r7 = now (ktime ns)
  r8 = per-CPU stats ptr r9 = packet byte count
Packet fields (saddr/dport/l4/tcp_flags) and derived features live in
the stack frame; layout constants below.

Counterpart of ``flowsentryx_tpu/bpf/progs.py``: the same instructions
and relocations, byte for byte.
"""

from __future__ import annotations

from dataclasses import dataclass

from flowsentryx_tpu_torch.bpf import loader
from flowsentryx_tpu_torch.core import wire as schema
from flowsentryx_tpu_torch.bpf.asm import Asm, Program
from flowsentryx_tpu_torch.bpf.isa import (
    BPF_ADD, BPF_AND, BPF_ARSH, BPF_B, BPF_DIV, BPF_DW, BPF_H, BPF_JEQ,
    BPF_JGE, BPF_JGT, BPF_JLE, BPF_JLT, BPF_JNE, BPF_LSH, BPF_MOD, BPF_MUL,
    BPF_OR, BPF_RSH, BPF_SUB, BPF_W, BPF_XOR,
    FN_ktime_get_ns, FN_map_delete_elem, FN_map_lookup_elem,
    FN_map_update_elem, FN_ringbuf_reserve, FN_ringbuf_submit,
    R0, R1, R2, R3, R4, R5, R6, R7, R8, R9, R10,
    XDP_DROP, XDP_MD_DATA, XDP_MD_DATA_END, XDP_PASS,
    alu64, alu64_imm, atomic_add64, call, endian_be, exit_,
    ld_imm64, ldx, mov32, mov64, mov64_imm, mov32_imm, neg64, st_imm, stx,
)

# ---- struct offsets (must match kern/fsx_schema.h; asserted by
# tests/test_bpf.py against the generated header via gcc) ----

# struct fsx_config (core.config.FsxConfig.KERNEL_CONFIG_FIELDS)
CFG_LIMITER_KIND = 0
CFG_VALID = 4
CFG_PPS_THRESHOLD = 8
CFG_BPS_THRESHOLD = 16
CFG_WINDOW_NS = 24
CFG_BLOCK_NS = 32
CFG_BUCKET_RATE_PPS = 40
CFG_BUCKET_BURST = 48
CFG_BUCKET_RATE_BPS = 56
CFG_BUCKET_BURST_BYTES = 64
CFG_RULE_COUNT = 72     # 0 = skip the firewall-rule lookups
CFG_HASH_SALT = 80      # user-plane salt; BPF maps hash internally
CFG_SIZE = 88

# struct fsx_ip_state
IPS_WIN_START_NS = 0
IPS_WIN_PPS = 8
IPS_WIN_BPS = 16
IPS_PREV_PPS = 24
IPS_PREV_BPS = 32
IPS_TOKENS_MILLI = 40
IPS_TOK_TS_NS = 48
IPS_TOK_BYTES = 56
IPS_SIZE = 64

# struct fsx_flow_stats
FS_PKT_COUNT = 0
FS_BYTE_SUM = 8
FS_BYTE_SQ_SUM = 16
FS_FIRST_TS_NS = 24
FS_LAST_TS_NS = 32
FS_IAT_SUM_NS = 40
FS_IAT_SQ_SUM_US2 = 48
FS_IAT_MAX_NS = 56
FS_DST_PORT = 64
FS_SIZE = 66

# struct fsx_flow_record (core.schema.FLOW_RECORD_DTYPE)
REC_TS_NS = 0
REC_SADDR = 8
REC_PKT_LEN = 12
REC_IP_PROTO = 14
REC_FLAGS = 15
REC_FEAT = 16
REC_SIZE = 48

# struct fsx_stats (per-CPU)
ST_ALLOWED = 0
ST_DROPPED_BLACKLIST = 8
ST_DROPPED_RATE = 16
ST_DROPPED_ML = 24
ST_DROPPED_RULE = 32
ST_ML_PASS = 40
ST_ML_ESCALATED = 48
ST_SIZE = 56

# struct fsx_ml_model (the kernel-distilled classifier's hot-swap map
# value; layout owned by core.schema.ML_MODEL_*, diffed by fsx check)
MLM_VALID = 0
MLM_FLAGS = 4
MLM_ACC_DROP = 8
MLM_ACC_PASS = 16
MLM_W = 24
MLM_QBASE = 56
MLM_BOUNDS = 88
MLM_SIZE = 8248

# flags (core.schema.FLAG_*)
FLAG_IPV6, FLAG_TCP_SYN, FLAG_TCP, FLAG_UDP, FLAG_ICMP = 1, 2, 4, 8, 16
FSX_TCP_SYN = 0x02  # tcp header flags byte (kern/parsing.h:187)

IPPROTO_ICMP, IPPROTO_TCP, IPPROTO_UDP, IPPROTO_ICMPV6 = 1, 6, 17, 58
#: IPv6 extension headers the parser walks through to reach L4 (an
#: attacker must not hide a SYN flood behind one hop-by-hop header).
#: FRAGMENT (44) is deliberately NOT walked: a non-first fragment
#: carries no L4 header at all, so the walk stops and the packet is
#: classified by its L3 facts alone.
IPPROTO_HOPOPTS, IPPROTO_ROUTING, IPPROTO_DSTOPTS = 0, 43, 60
IPV6_EXT_WALK_DEPTH = 4  # bounded unroll; real chains are 1-2 deep

# ---- stack frame layout (r10-relative; eBPF allows [-512, 0)) ----
S_KEY = -4          # u32: zero key, then saddr key for hash maps
S_FKEY = -8         # u32: flow key saddr ^ (dport << 16)
S_VAL64 = -16       # u64: blacklist-until / variance scratch
S_IPS_ZERO = -80    # 64B: fsx_ip_state insert template    [-80, -16)
S_FS_ZERO = -152    # 72B (>=66): fsx_flow_stats template  [-152, -80)
S_SADDR = -160      # u64 slot: folded source address
S_DPORT = -168      # u64 slot: dport, network byte order
S_L4 = -176         # u64 slot: l4 protocol
S_TCPFLAGS = -184   # u64 slot: tcp flags byte
S_IS6 = -192        # u64 slot: ipv6 indicator (== FLAG_IPV6 when set)
S_FEAT = -232       # 8 x u32: derived features            [-232, -200)
S_CTX = -240        # u64 slot: ctx pointer
S_N = -248          # u64 slot: flow pkt_count snapshot (n)
S_CW1 = -252        # u32: compact record word1 (feat 0-3, minifloat)
S_CW2 = -256        # u32: compact record word2 (feat 4-7, minifloat)
S_CW3 = -260        # u32: compact record word3 (len8|flags|ts16)
S_SADDR6 = -288     # 16B: full IPv6 source (exact-blacklist key)
#                     [-288, -272); only initialized/read on v6 paths
S_MLBLK = -296      # u64 slot: cfg->block_ns snapshot (ml=True builds
#                     only; cfg in r6 is dead by the time the ML drop
#                     band needs a blacklist TTL)

COMPACT_REC_SIZE = 16  # struct fsx_compact_record


@dataclass(frozen=True)
class MapSizes:
    """Deploy-scale defaults; tests shrink these (a 1M-entry LRU hash
    preallocates ~100 MB of kernel memory per map)."""

    max_track_ips: int = 1 << 20  # FSX_MAX_TRACK_IPS
    ring_bytes: int = 1 << 22  # FSX_RING_SIZE


MAP_SPECS = {
    # name -> (map_type, key_size, value_size, max_entries selector)
    "config_map": (loader.MAP_TYPE_ARRAY, 4, CFG_SIZE, "one"),
    "blacklist_map": (loader.MAP_TYPE_LRU_HASH, 4, 8, "ips"),
    # exact 128-bit v6 blacklist (kern/fsx_kern.c blacklist_v6;
    # reference parity with src/fsx_struct.h:9's __u128 key)
    "blacklist_v6": (loader.MAP_TYPE_LRU_HASH, 16, 8, "ips"),
    "ip_state_map": (loader.MAP_TYPE_LRU_HASH, 4, IPS_SIZE, "ips"),
    "flow_stats_map": (loader.MAP_TYPE_LRU_HASH, 4, FS_SIZE, "ips"),
    "stats_map": (loader.MAP_TYPE_PERCPU_ARRAY, 4, ST_SIZE, "one"),
    "feature_ring": (loader.MAP_TYPE_RINGBUF, 0, 0, "ring"),
    # stateless firewall rules (kern/fsx_kern.c rule_map): key packs
    # (proto << 16) | dport host-order, 0 = wildcard; value = action
    "rule_map": (loader.MAP_TYPE_HASH, 4, 8, "rules"),
    # kernel-distilled int8 classifier (fsx distill): weights, exact
    # quantization boundaries and band thresholds, hot-swapped live.
    # Only referenced by the ml=True program variants, so non-ml images
    # never carry it (map_names follows the relocation table).
    "ml_model_map": (loader.MAP_TYPE_ARRAY, 4, MLM_SIZE, "one"),
}


def max_entries_for(selector: str, sizes: MapSizes) -> int:
    """Resolve a MAP_SPECS size selector — the ONE copy image emission
    and live map creation both use (a literal dict in each would have
    to be extended in lockstep for every new map kind)."""
    return {"one": 1, "ips": sizes.max_track_ips,
            "ring": sizes.ring_bytes,
            "rules": schema.MAX_RULES}[selector]


def create_maps(sizes: MapSizes = MapSizes()) -> dict[str, loader.Map]:
    """Create the eight-map kernel/user seam (kern/fsx_kern.c maps)."""
    out = {}
    for name, (mtype, ks, vs, ent) in MAP_SPECS.items():
        out[name] = loader.map_create(mtype, ks, vs,
                                      max_entries_for(ent, sizes), name)
    return out


def _sat_u32(a: Asm, reg: int, tmp: int, label: str) -> None:
    """reg = min(reg, 0xFFFFFFFF)  (fsx_compute.h:33-36)."""
    a += mov64(tmp, reg)
    a += alu64_imm(BPF_RSH, tmp, 32)
    a.jmp_imm(BPF_JEQ, tmp, 0, label)
    a += mov32_imm(reg, -1)  # 0xFFFFFFFF zero-extended
    a.label(label)


def _emit_isqrt_fn(a: Asm) -> None:
    """BPF-to-BPF function: r0 = isqrt(r1), fully unrolled.

    Mirrors fsx_compute.h:39-60 (binary-restoring integer sqrt; the C
    version's bounded loops become straight-line code here — the
    simplest shape for the verifier).  Uses r0-r3 only.
    """
    a.label("fn_isqrt")
    a += mov64_imm(R0, 0)  # r = 0
    a += mov64_imm(R2, 1)
    a += alu64_imm(BPF_LSH, R2, 62)  # bit = 1 << 62
    # while (bit > x) bit >>= 2  — 32 bounded steps
    for i in range(32):
        a.jmp_reg(BPF_JLE, R2, R1, f"isq_main_{i}")
        a += alu64_imm(BPF_RSH, R2, 2)
        a.label(f"isq_main_{i}")
    # 32 restoring steps
    for i in range(32):
        a.jmp_imm(BPF_JEQ, R2, 0, "isq_done")
        a += mov64(R3, R0)
        a += alu64(BPF_ADD, R3, R2)  # r3 = r + bit
        a += alu64_imm(BPF_RSH, R0, 1)  # r >>= 1
        a.jmp_reg(BPF_JLT, R1, R3, f"isq_skip_{i}")
        a += alu64(BPF_SUB, R1, R3)  # x -= r + bit
        a += alu64(BPF_ADD, R0, R2)  # r += bit
        a.label(f"isq_skip_{i}")
        a += alu64_imm(BPF_RSH, R2, 2)  # bit >>= 2
    a.label("isq_done")
    a += exit_()


def _bool_nonzero(a: Asm, dst: int, src: int) -> None:
    """dst = (src != 0) ? 1 : 0, branch-free: top bit of src|-src."""
    a += mov64(dst, src)
    a += neg64(dst)
    a += alu64(BPF_OR, dst, src)
    a += alu64_imm(BPF_RSH, dst, 63)


def _emit_minifloat_inline(a: Asm) -> None:
    """Inline BRANCH-FREE e5m3 minifloat: r0 = mf(r1), r1 u32-valued.

    Mirrors fsx_compute.h fsx_minifloat8 (itself in lockstep with
    schema.quantize_feat_minifloat, tests/test_kern.py).  Branch-free
    on purpose: the quantizer runs 8× per emitted record AFTER the two
    isqrt calls, and a branchy version multiplies the verifier's
    surviving-state count past the 1M-insn analysis budget (observed);
    straight-line ALU costs ~45 insns and exactly one state.
    Clobbers r0, r2-r5; preserves r1.
    """
    # big = (f >= 8)  →  R3
    a += mov64(R2, R1)
    a += alu64_imm(BPF_RSH, R2, 3)
    _bool_nonzero(a, R3, R2)
    # bit length: t=R2, bl=R4
    a += mov64(R2, R1)
    a += mov64_imm(R4, 0)
    for s in (16, 8, 4, 2, 1):
        a += mov64(R5, R2)
        a += alu64_imm(BPF_RSH, R5, s)
        _bool_nonzero(a, R0, R5)           # m = (t >= 2^s)
        a += mov64(R5, R0)
        if s > 1:
            a += alu64_imm(BPF_LSH, R5, s.bit_length() - 1)  # m*s
        a += alu64(BPF_ADD, R4, R5)        # bl += m*s
        a += alu64(BPF_RSH, R2, R5)        # t >>= m*s
    a += alu64(BPF_ADD, R4, R2)            # residual top bit
    # e = (bl - 4) * big   (zero when f < 8; bl-4 may be "negative"
    # as u64 then, but the multiply by big==0 erases it)
    a += alu64_imm(BPF_SUB, R4, 4)
    a += alu64(BPF_MUL, R4, R3)
    # m0 = (e != 0) → R5 ; sh = (e-1)*m0 → R2
    _bool_nonzero(a, R5, R4)
    a += mov64(R2, R4)
    a += alu64_imm(BPF_SUB, R2, 1)
    a += alu64(BPF_MUL, R2, R5)
    # r = ((f >> sh) + m0) >> m0   (mantissa in [8,16]; = f when e==0)
    a += mov64(R0, R1)
    a += alu64(BPF_RSH, R0, R2)
    a += alu64(BPF_ADD, R0, R5)
    a += alu64(BPF_RSH, R0, R5)
    # carry: c = (r == 16); e += c; r -= 8c
    a += mov64(R2, R0)
    a += alu64_imm(BPF_XOR, R2, 16)
    _bool_nonzero(a, R5, R2)               # (r != 16)
    a += mov64_imm(R2, 1)
    a += alu64(BPF_SUB, R2, R5)            # c = (r == 16)
    a += alu64(BPF_ADD, R4, R2)
    a += alu64_imm(BPF_LSH, R2, 3)
    a += alu64(BPF_SUB, R0, R2)
    # q_big = 8*e + r ; q = big ? q_big : f
    a += alu64_imm(BPF_LSH, R4, 3)
    a += alu64(BPF_ADD, R4, R0)
    a += alu64(BPF_MUL, R4, R3)
    a += mov64_imm(R2, 1)
    a += alu64(BPF_SUB, R2, R3)
    a += alu64(BPF_MUL, R2, R1)
    a += alu64(BPF_ADD, R4, R2)
    a += mov64(R0, R4)


def _emit_ml_score_fn(a: Asm) -> None:
    """BPF-to-BPF function: r0 = band(features), branch-free scoring.

    Args: r1-r4 carry the 8 u32 features packed two per register
    (``feat[2p] | feat[2p+1] << 32`` in ``r1+p``) — local calls may pass
    scalars only, and five arg registers cannot carry eight features
    unpacked.  Returns ``schema.ML_BAND_*`` in r0.

    The scorer is the distilled int8 logreg lane (models/logreg.py
    ``classify_batch_int8_matmul``) folded into integer-only eBPF:

    * ``q_i = qbase[i] + |{r : x_i > bounds_m1[i*255 + r]}|`` — each
      boundary is the exact u32 preimage of one quantization step of
      the engine's f32 input observer (distill/plan.py bisects the real
      device chain), so the rank IS the observer, bit for bit.  The
      rank loop is fully unrolled and BRANCH-FREE (``(b - x) >> 63``
      sign extraction): 255 boundaries x 8 features of straight-line
      ALU cost exactly one verifier state, where a compare/jump tree
      would multiply path counts past any budget — the same shape
      argument as the inline minifloat quantizer above.
    * ``s = sum w[i] * q_i`` in two's-complement u64 (weights are s32
      widened from int8; sign-extended with LSH/ARSH).
    * band = ``1 + (s >=s acc_drop) - (s <=s acc_pass)`` — branch-free
      signed compares (both differences are < 2^32 in magnitude, so the
      sign bit is exact).  The thresholds pre-fold the input zero-point
      and the whole requant->sigmoid->quant tail (monotone in s, so the
      distiller inverts it exactly on the host).

    Everything model-dependent lives in ``ml_model_map`` — pushing a
    new blob hot-swaps the model with no program reload.  An all-zero
    value (``valid == 0``: no model pushed yet) returns BAND_DISABLED
    and the caller behaves exactly like the pre-ML program.

    Emulation contract: distill/emulate.py executes THIS instruction
    stream (lock-step over vector lanes); data-dependent branches would
    break lane coherence, which is the second reason the body is
    branch-free up to the uniform valid/NULL checks.
    """
    a.label("fn_ml_score")
    # park the packed args: the map lookup clobbers r1-r5
    a += stx(BPF_DW, R10, -8, R1)
    a += stx(BPF_DW, R10, -16, R2)
    a += stx(BPF_DW, R10, -24, R3)
    a += stx(BPF_DW, R10, -32, R4)
    a += st_imm(BPF_W, R10, -40, 0)  # key = 0
    a.ld_map(R1, "ml_model_map")
    a += mov64(R2, R10)
    a += alu64_imm(BPF_ADD, R2, -40)
    a += call(FN_map_lookup_elem)
    a.jmp_imm(BPF_JEQ, R0, 0, "ml_fn_off")  # verifier NULL check
    a += mov64(R7, R0)  # r7 = model (callee-owned; frames save r6-r9)
    a += ldx(BPF_W, R1, R7, MLM_VALID)
    a.jmp_imm(BPF_JEQ, R1, 0, "ml_fn_off")  # no model pushed: stage off
    a += mov64_imm(R6, 0)  # r6 = s = sum w[i] * q_i
    for i in range(schema.NUM_FEATURES):
        # x_i from the packed arg pair
        a += ldx(BPF_DW, R2, R10, -8 - 8 * (i // 2))
        if i % 2:
            a += alu64_imm(BPF_RSH, R2, 32)
        else:
            a += mov32(R2, R2)  # zero-extend the low word
        # rank: q = qbase[i] + sum over boundaries of (x > b_m1)
        a += ldx(BPF_W, R3, R7, MLM_QBASE + 4 * i)
        for r in range(schema.ML_BOUNDS_PER_FEATURE):
            off = MLM_BOUNDS + 4 * (schema.ML_BOUNDS_PER_FEATURE * i + r)
            a += ldx(BPF_W, R4, R7, off)
            a += alu64(BPF_SUB, R4, R2)   # b_m1 - x: wraps iff x > b_m1
            a += alu64_imm(BPF_RSH, R4, 63)
            a += alu64(BPF_ADD, R3, R4)
        # s += w[i] * q   (w sign-extended s32)
        a += ldx(BPF_W, R4, R7, MLM_W + 4 * i)
        a += alu64_imm(BPF_LSH, R4, 32)
        a += alu64_imm(BPF_ARSH, R4, 32)
        a += alu64(BPF_MUL, R4, R3)
        a += alu64(BPF_ADD, R6, R4)
    # band = ESCALATE + (s >=s acc_drop) - (s <=s acc_pass), branch-free
    a += ldx(BPF_DW, R1, R7, MLM_ACC_DROP)
    a += mov64(R2, R6)
    a += alu64(BPF_SUB, R2, R1)
    a += alu64_imm(BPF_RSH, R2, 63)
    a += alu64_imm(BPF_XOR, R2, 1)   # (s - acc_drop) >=s 0
    a += ldx(BPF_DW, R1, R7, MLM_ACC_PASS)
    a += alu64(BPF_SUB, R1, R6)
    a += alu64_imm(BPF_RSH, R1, 63)
    a += alu64_imm(BPF_XOR, R1, 1)   # (acc_pass - s) >=s 0
    a += mov64_imm(R0, schema.ML_BAND_ESCALATE)
    a += alu64(BPF_ADD, R0, R2)
    a += alu64(BPF_SUB, R0, R1)
    a += exit_()
    a.label("ml_fn_off")
    a += mov64_imm(R0, schema.ML_BAND_DISABLED)
    a += exit_()


def build_ml_scorer() -> Program:
    """The fn_ml_score instruction stream as a standalone Program — the
    exact bytes the XDP variants embed (tests assert this), consumed by
    the distill emulator (entry contract: r1-r4 = packed features)."""
    a = Asm("fsx_ml_scorer")
    _emit_ml_score_fn(a)
    return a.assemble()


def build(compact: bool = False, ml: bool = False) -> Program:  # noqa: C901 — one linear hot path, kept whole
    """Assemble the full fsx fast path (see module docstring)."""
    a = Asm("fsx")

    # ---- prologue ----------------------------------------------------
    a += stx(BPF_DW, R10, S_CTX, R1)
    a += call(FN_ktime_get_ns)
    a += mov64(R7, R0)

    # ---- stats + config lookups (fsx_kern.c:202-214) -----------------
    a += st_imm(BPF_W, R10, S_KEY, 0)
    a.ld_map(R1, "stats_map")
    a += mov64(R2, R10)
    a += alu64_imm(BPF_ADD, R2, S_KEY)
    a += call(FN_map_lookup_elem)
    a.jmp_imm(BPF_JEQ, R0, 0, "pass_quiet")  # verifier NULL check
    a += mov64(R8, R0)  # r8 = stats (this CPU's slot)

    a.ld_map(R1, "config_map")
    a += mov64(R2, R10)
    a += alu64_imm(BPF_ADD, R2, S_KEY)
    a += call(FN_map_lookup_elem)
    a.jmp_imm(BPF_JEQ, R0, 0, "pass_quiet")
    a += mov64(R6, R0)  # r6 = cfg
    # fail open until a config is pushed (valid flag, fsx_kern.c:206-214)
    a += ldx(BPF_W, R1, R6, CFG_VALID)
    a.jmp_imm(BPF_JEQ, R1, 0, "pass_quiet")
    if ml:
        # Snapshot the blacklist TTL while cfg is live: r6 is reused for
        # the flow-stats pointer past the limiter, and the ML drop band
        # (which fires after feature derivation) blacklists with it.
        a += ldx(BPF_DW, R1, R6, CFG_BLOCK_NS)
        a += stx(BPF_DW, R10, S_MLBLK, R1)

    # ---- parse (kern/parsing.h:225-266) ------------------------------
    a += ldx(BPF_DW, R1, R10, S_CTX)
    a += ldx(BPF_W, R2, R1, XDP_MD_DATA)
    a += ldx(BPF_W, R3, R1, XDP_MD_DATA_END)
    a += mov64(R9, R3)
    a += alu64(BPF_SUB, R9, R2)  # r9 = packet byte count

    # defaults: dport = 0, tcp_flags = 0 (parsing.h:232-234)
    a += st_imm(BPF_DW, R10, S_DPORT, 0)
    a += st_imm(BPF_DW, R10, S_TCPFLAGS, 0)

    # eth bounds, then h_proto (parsing.h:90-108).  Network-order u16
    # read as LE: ETH_P_IP 0x0800 -> 0x0008, ETH_P_IPV6 0x86DD -> 0xDD86.
    a += mov64(R4, R2)
    a += alu64_imm(BPF_ADD, R4, 14)
    a.jmp_reg(BPF_JGT, R4, R3, "drop")  # truncated eth → -1 → DROP
    a += ldx(BPF_H, R5, R2, 12)
    a.jmp_imm(BPF_JEQ, R5, 0x0008, "ip4")
    a.jmp_imm(BPF_JEQ, R5, 0xDD86, "ip6")
    a.ja("pass_quiet")  # non-IP passes, uncounted (fsx_kern.c:219-220)

    # ---- IPv4 (parsing.h:113-137): honors variable IHL ---------------
    a.label("ip4")
    a += mov64(R4, R2)
    a += alu64_imm(BPF_ADD, R4, 14)  # r4 = ip header start
    a += mov64(R5, R4)
    a += alu64_imm(BPF_ADD, R5, 20)
    a.jmp_reg(BPF_JGT, R5, R3, "drop")  # sizeof(iphdr) bounds
    a += ldx(BPF_B, R5, R4, 0)  # version<<4 | ihl
    a += alu64_imm(BPF_AND, R5, 0x0F)
    a += alu64_imm(BPF_LSH, R5, 2)  # hdrsize = ihl * 4
    a.jmp_imm(BPF_JLT, R5, 20, "drop")  # hdrsize < 20 → malformed
    a += alu64(BPF_ADD, R5, R4)  # r5 = l4 start
    a.jmp_reg(BPF_JGT, R5, R3, "drop")  # variable-IHL bounds
    a += ldx(BPF_B, R1, R4, 9)  # protocol
    a += stx(BPF_DW, R10, S_L4, R1)
    a += ldx(BPF_W, R1, R4, 12)  # saddr, wire order (as the C keeps it)
    a += stx(BPF_DW, R10, S_SADDR, R1)
    a += st_imm(BPF_DW, R10, S_IS6, 0)
    a.ja("l4")

    # ---- IPv6 (parsing.h:141-161): fixed header, fold saddr ----------
    a.label("ip6")
    a += mov64(R4, R2)
    a += alu64_imm(BPF_ADD, R4, 14)
    a += mov64(R5, R4)
    a += alu64_imm(BPF_ADD, R5, 40)
    a.jmp_reg(BPF_JGT, R5, R3, "drop")
    a += ldx(BPF_B, R1, R4, 6)  # nexthdr
    a += stx(BPF_DW, R10, S_L4, R1)
    # full 128-bit source → stack (exact-blacklist key, parsing.h
    # fsx_pkt.saddr6) while folding (parsing.h:82-85, XOR of the words)
    a += ldx(BPF_W, R1, R4, 8)
    a += stx(BPF_W, R10, S_SADDR6 + 0, R1)
    a += ldx(BPF_W, R0, R4, 12)
    a += stx(BPF_W, R10, S_SADDR6 + 4, R0)
    a += alu64(BPF_XOR, R1, R0)
    a += ldx(BPF_W, R0, R4, 16)
    a += stx(BPF_W, R10, S_SADDR6 + 8, R0)
    a += alu64(BPF_XOR, R1, R0)
    a += ldx(BPF_W, R0, R4, 20)
    a += stx(BPF_W, R10, S_SADDR6 + 12, R0)
    a += alu64(BPF_XOR, R1, R0)
    a += stx(BPF_DW, R10, S_SADDR, R1)
    a += st_imm(BPF_DW, R10, S_IS6, 1)
    # r5 = l4 start (after the fixed 40 B header); walk up to
    # IPV6_EXT_WALK_DEPTH extension headers so L4 classification (and
    # the SYN/port features built on it) cannot be evaded by a
    # hop-by-hop/routing/dstopts prefix.  Each hop advances the cursor
    # by a VARIABLE amount read from the packet — (hdr_ext_len + 1) * 8
    # — which invalidates any prior bounds proof, so every hop re-checks
    # its fixed 8-byte window against data_end before the loads and the
    # L4 parsers re-check their own headers after the final advance.
    # This mask-bound-advance-recheck shape is exactly what the static
    # verifier (bpf/verifier.py) proves; a missing re-check here is the
    # canonical rejection in tests/test_verifier.py.
    for i in range(IPV6_EXT_WALK_DEPTH):
        a += ldx(BPF_DW, R1, R10, S_L4)  # current next-header value
        a.jmp_imm(BPF_JEQ, R1, IPPROTO_HOPOPTS, f"ext{i}_walk")
        a.jmp_imm(BPF_JEQ, R1, IPPROTO_ROUTING, f"ext{i}_walk")
        a.jmp_imm(BPF_JEQ, R1, IPPROTO_DSTOPTS, f"ext{i}_walk")
        a.ja("l4")  # not an extension header: r5 is the L4 start
        a.label(f"ext{i}_walk")
        a += mov64(R4, R5)
        a += alu64_imm(BPF_ADD, R4, 8)
        a.jmp_reg(BPF_JGT, R4, R3, "drop")  # truncated ext hdr → drop
        a += ldx(BPF_B, R1, R5, 0)  # next header
        a += stx(BPF_DW, R10, S_L4, R1)
        a += ldx(BPF_B, R1, R5, 1)  # hdr_ext_len (8 B units past the 1st)
        a += alu64_imm(BPF_ADD, R1, 1)
        a += alu64_imm(BPF_LSH, R1, 3)  # advance = (len + 1) * 8 ≤ 2048
        a += alu64(BPF_ADD, R5, R1)  # variable advance: proof reset
    # depth exhausted with another ext header pending: fall to the L4
    # dispatch, which finds no match and classifies on L3 facts

    # ---- L4 dispatch (parsing.h:249-264); r5 = l4 start, r3 = end ----
    a.label("l4")
    a += ldx(BPF_DW, R1, R10, S_L4)
    a.jmp_imm(BPF_JEQ, R1, IPPROTO_TCP, "tcp")
    a.jmp_imm(BPF_JEQ, R1, IPPROTO_UDP, "udp")
    a.jmp_imm(BPF_JEQ, R1, IPPROTO_ICMP, "icmp")
    a.jmp_imm(BPF_JEQ, R1, IPPROTO_ICMPV6, "icmp")  # same 8 B fixed hdr
    a.ja("parsed")  # other L4: L3 info is enough (parsing.h:262-263)

    a.label("tcp")  # parsing.h:165-184
    a += mov64(R4, R5)
    a += alu64_imm(BPF_ADD, R4, 20)
    a.jmp_reg(BPF_JGT, R4, R3, "drop")
    a += ldx(BPF_H, R1, R5, 2)  # dest port, network order
    a += stx(BPF_DW, R10, S_DPORT, R1)
    a += ldx(BPF_B, R1, R5, 13)  # flags byte (layout-stable)
    a += stx(BPF_DW, R10, S_TCPFLAGS, R1)
    a.ja("parsed")

    a.label("udp")  # parsing.h:191-208
    a += mov64(R4, R5)
    a += alu64_imm(BPF_ADD, R4, 8)
    a.jmp_reg(BPF_JGT, R4, R3, "drop")
    a += ldx(BPF_H, R1, R5, 2)
    a += stx(BPF_DW, R10, S_DPORT, R1)
    a.ja("parsed")

    a.label("icmp")  # parsing.h:211-220 (v4) / :232-247 (v6, same size)
    a += mov64(R4, R5)
    a += alu64_imm(BPF_ADD, R4, 8)  # sizeof(icmphdr) == sizeof(icmp6hdr)
    a.jmp_reg(BPF_JGT, R4, R3, "drop")

    # ---- stateless firewall rules (kern/fsx_kern.c rule gate; the
    # reference's planned "basic firewall", README.md:70-74): exact
    # (proto, dport), then (proto, *), then (*, dport) — before any
    # per-IP state is touched.  Gated on cfg->rule_count, so rule-less
    # deployments pay one load + one jump.  Each lookup clobbers
    # r1-r5, so every key recomputes from the S_L4/S_DPORT slots. ------
    a.label("parsed")
    a += ldx(BPF_DW, R1, R6, CFG_RULE_COUNT)
    a.jmp_imm(BPF_JEQ, R1, 0, "bl_gate")

    def _rule_key(with_proto: bool, with_port: bool) -> None:
        # build the u32 key in the low half of S_VAL64
        nonlocal a
        if with_port:
            # host-order dport from the BE u16 on the stack
            a += ldx(BPF_DW, R1, R10, S_DPORT)
            a += mov64(R2, R1)
            a += alu64_imm(BPF_AND, R1, 0xFF)
            a += alu64_imm(BPF_LSH, R1, 8)
            a += alu64_imm(BPF_RSH, R2, 8)
            a += alu64_imm(BPF_AND, R2, 0xFF)
            a += alu64(BPF_OR, R1, R2)
        else:
            a += mov64_imm(R1, 0)
        if with_proto:
            a += ldx(BPF_DW, R2, R10, S_L4)
            a += alu64_imm(BPF_LSH, R2, 16)
            a += alu64(BPF_OR, R1, R2)
        a += stx(BPF_W, R10, S_VAL64, R1)
        a.ld_map(R1, "rule_map")
        a += mov64(R2, R10)
        a += alu64_imm(BPF_ADD, R2, S_VAL64)
        a += call(FN_map_lookup_elem)

    _rule_key(True, True)
    a.jmp_imm(BPF_JNE, R0, 0, "rule_hit")
    _rule_key(True, False)
    a.jmp_imm(BPF_JNE, R0, 0, "rule_hit")
    _rule_key(False, True)
    a.jmp_imm(BPF_JEQ, R0, 0, "bl_gate")
    a.label("rule_hit")
    a += ldx(BPF_DW, R1, R0, 0)
    a.jmp_imm(BPF_JNE, R1, 1, "bl_gate")  # FSX_RULE_DROP
    a += ldx(BPF_DW, R1, R8, ST_DROPPED_RULE)
    a += alu64_imm(BPF_ADD, R1, 1)
    a += stx(BPF_DW, R8, ST_DROPPED_RULE, R1)
    a.ja("drop_counted")

    # ---- blacklist gate with TTL expiry (fsx_kern.c:222-233).
    # v6 checks the EXACT 128-bit map first (reference blacklist_v6
    # parity, src/fsx_kern.c:159-166); both then fall through to the
    # folded map, which carries the engine's ML verdicts. ----------
    a.label("bl_gate")
    a += ldx(BPF_DW, R1, R10, S_IS6)
    a.jmp_imm(BPF_JEQ, R1, 0, "bl_fold")  # v4: no exact-v6 gate
    a.ld_map(R1, "blacklist_v6")
    a += mov64(R2, R10)
    a += alu64_imm(BPF_ADD, R2, S_SADDR6)
    a += call(FN_map_lookup_elem)
    a.jmp_imm(BPF_JEQ, R0, 0, "bl_fold")
    a += ldx(BPF_DW, R1, R0, 0)  # *until
    a.jmp_reg(BPF_JGE, R7, R1, "bl6_expired")
    a += ldx(BPF_DW, R1, R8, ST_DROPPED_BLACKLIST)
    a += alu64_imm(BPF_ADD, R1, 1)
    a += stx(BPF_DW, R8, ST_DROPPED_BLACKLIST, R1)
    a.ja("drop_counted")
    a.label("bl6_expired")  # TTL passed: delete, continue
    a.ld_map(R1, "blacklist_v6")
    a += mov64(R2, R10)
    a += alu64_imm(BPF_ADD, R2, S_SADDR6)
    a += call(FN_map_delete_elem)

    a.label("bl_fold")
    a += ldx(BPF_DW, R1, R10, S_SADDR)
    a += stx(BPF_W, R10, S_KEY, R1)
    a.ld_map(R1, "blacklist_map")
    a += mov64(R2, R10)
    a += alu64_imm(BPF_ADD, R2, S_KEY)
    a += call(FN_map_lookup_elem)
    a.jmp_imm(BPF_JEQ, R0, 0, "ratelimit")
    a += ldx(BPF_DW, R1, R0, 0)  # *until
    a.jmp_reg(BPF_JGE, R7, R1, "bl_expired")
    # still blocked: dropped_blacklist++ (per-CPU slot: plain add), DROP
    a += ldx(BPF_DW, R1, R8, ST_DROPPED_BLACKLIST)
    a += alu64_imm(BPF_ADD, R1, 1)
    a += stx(BPF_DW, R8, ST_DROPPED_BLACKLIST, R1)
    a.ja("drop_counted")
    a.label("bl_expired")  # TTL passed: delete, continue
    a.ld_map(R1, "blacklist_map")
    a += mov64(R2, R10)
    a += alu64_imm(BPF_ADD, R2, S_KEY)
    a += call(FN_map_delete_elem)

    # ---- per-IP rate limit (fsx_kern.c:235-269) ----------------------
    a.label("ratelimit")
    a.ld_map(R1, "ip_state_map")
    a += mov64(R2, R10)
    a += alu64_imm(BPF_ADD, R2, S_KEY)
    a += call(FN_map_lookup_elem)
    a.jmp_imm(BPF_JNE, R0, 0, "limiter")
    # miss: insert {win_start_ns = now, rest 0}, then re-lookup
    a += mov64_imm(R1, 0)
    for off in range(8, IPS_SIZE, 8):
        a += stx(BPF_DW, R10, S_IPS_ZERO + off, R1)
    a += stx(BPF_DW, R10, S_IPS_ZERO + IPS_WIN_START_NS, R7)
    a.ld_map(R1, "ip_state_map")
    a += mov64(R2, R10)
    a += alu64_imm(BPF_ADD, R2, S_KEY)
    a += mov64(R3, R10)
    a += alu64_imm(BPF_ADD, R3, S_IPS_ZERO)
    a += mov64_imm(R4, 0)  # BPF_ANY
    a += call(FN_map_update_elem)
    a.ld_map(R1, "ip_state_map")
    a += mov64(R2, R10)
    a += alu64_imm(BPF_ADD, R2, S_KEY)
    a += call(FN_map_lookup_elem)
    a.jmp_imm(BPF_JEQ, R0, 0, "features")  # table churn: fail open

    # r0 = st.  Dispatch on cfg->limiter_kind (fsx_kern.c:249-258).
    a.label("limiter")
    a += mov64(R2, R0)  # r2 = st (limiters are call-free: r0-r5 free)
    a += ldx(BPF_W, R1, R6, CFG_LIMITER_KIND)
    a.jmp_imm(BPF_JEQ, R1, 1, "lim_sliding")
    a.jmp_imm(BPF_JEQ, R1, 2, "lim_token")

    # -- fixed window (fsx_compute.h:64-78) --
    a += ldx(BPF_DW, R1, R2, IPS_WIN_START_NS)
    a += mov64(R3, R7)
    a += alu64(BPF_SUB, R3, R1)  # now - win_start
    a += ldx(BPF_DW, R4, R6, CFG_WINDOW_NS)
    a.jmp_reg(BPF_JLT, R3, R4, "fw_accum")
    # rollover: seed with THIS packet (the reference seeded 0 — the
    # §7.5 first-packet bug, not replicated)
    a += stx(BPF_DW, R2, IPS_WIN_START_NS, R7)
    a += mov64_imm(R1, 1)
    a += stx(BPF_DW, R2, IPS_WIN_PPS, R1)
    a += stx(BPF_DW, R2, IPS_WIN_BPS, R9)
    a.ja("fw_check")
    a.label("fw_accum")
    a += mov64_imm(R1, 1)
    a += atomic_add64(R2, IPS_WIN_PPS, R1)
    a += mov64(R1, R9)
    a += atomic_add64(R2, IPS_WIN_BPS, R1)
    a.label("fw_check")
    a += ldx(BPF_DW, R1, R2, IPS_WIN_PPS)
    a += ldx(BPF_DW, R3, R6, CFG_PPS_THRESHOLD)
    a.jmp_reg(BPF_JGT, R1, R3, "over")
    a += ldx(BPF_DW, R1, R2, IPS_WIN_BPS)
    a += ldx(BPF_DW, R3, R6, CFG_BPS_THRESHOLD)
    a.jmp_reg(BPF_JGT, R1, R3, "over")
    a.ja("features")

    # -- two-bucket sliding window (fsx_compute.h:82-113) --
    a.label("lim_sliding")
    a += ldx(BPF_DW, R1, R2, IPS_WIN_START_NS)
    a += mov64(R3, R7)
    a += alu64(BPF_SUB, R3, R1)  # elapsed
    a += ldx(BPF_DW, R4, R6, CFG_WINDOW_NS)
    a += mov64(R5, R4)
    a += alu64_imm(BPF_LSH, R5, 1)  # 2 * window
    a.jmp_reg(BPF_JGE, R3, R5, "sw_stale")
    a.jmp_reg(BPF_JGE, R3, R4, "sw_roll")
    a += mov64_imm(R1, 1)  # in-window accumulate
    a += atomic_add64(R2, IPS_WIN_PPS, R1)
    a += mov64(R1, R9)
    a += atomic_add64(R2, IPS_WIN_BPS, R1)
    a.ja("sw_est")
    a.label("sw_stale")  # >= 2 windows idle: zero prev, snap to grid
    a += mov64_imm(R1, 0)
    a += stx(BPF_DW, R2, IPS_PREV_PPS, R1)
    a += stx(BPF_DW, R2, IPS_PREV_BPS, R1)
    a += mov64(R1, R7)
    a += alu64(BPF_MOD, R1, R4)  # now % window
    a += mov64(R3, R7)
    a += alu64(BPF_SUB, R3, R1)
    a += stx(BPF_DW, R2, IPS_WIN_START_NS, R3)
    a += mov64_imm(R1, 1)
    a += stx(BPF_DW, R2, IPS_WIN_PPS, R1)
    a += stx(BPF_DW, R2, IPS_WIN_BPS, R9)
    a.ja("sw_est")
    a.label("sw_roll")  # one window passed: cur → prev
    a += ldx(BPF_DW, R1, R2, IPS_WIN_PPS)
    a += stx(BPF_DW, R2, IPS_PREV_PPS, R1)
    a += ldx(BPF_DW, R1, R2, IPS_WIN_BPS)
    a += stx(BPF_DW, R2, IPS_PREV_BPS, R1)
    a += ldx(BPF_DW, R1, R2, IPS_WIN_START_NS)
    a += alu64(BPF_ADD, R1, R4)
    a += stx(BPF_DW, R2, IPS_WIN_START_NS, R1)
    a += mov64_imm(R1, 1)
    a += stx(BPF_DW, R2, IPS_WIN_PPS, R1)
    a += stx(BPF_DW, R2, IPS_WIN_BPS, R9)
    a.label("sw_est")
    # overlap = 1024 - min(((now - win_start) << 10) / window, 1024)
    a += ldx(BPF_DW, R1, R2, IPS_WIN_START_NS)
    a += mov64(R3, R7)
    a += alu64(BPF_SUB, R3, R1)
    a += alu64_imm(BPF_LSH, R3, 10)
    a += alu64(BPF_DIV, R3, R4)  # frac (1/1024 fixed point)
    a += mov64_imm(R5, 0)
    a.jmp_imm(BPF_JGT, R3, 1024, "sw_havefrac")
    a += mov64_imm(R5, 1024)
    a += alu64(BPF_SUB, R5, R3)  # overlap
    a.label("sw_havefrac")
    a += ldx(BPF_DW, R1, R2, IPS_PREV_PPS)
    a += alu64(BPF_MUL, R1, R5)
    a += alu64_imm(BPF_RSH, R1, 10)
    a += ldx(BPF_DW, R3, R2, IPS_WIN_PPS)
    a += alu64(BPF_ADD, R1, R3)  # est_pps
    a += ldx(BPF_DW, R3, R6, CFG_PPS_THRESHOLD)
    a.jmp_reg(BPF_JGT, R1, R3, "over")
    a += ldx(BPF_DW, R1, R2, IPS_PREV_BPS)
    a += alu64(BPF_MUL, R1, R5)
    a += alu64_imm(BPF_RSH, R1, 10)
    a += ldx(BPF_DW, R3, R2, IPS_WIN_BPS)
    a += alu64(BPF_ADD, R1, R3)  # est_bps
    a += ldx(BPF_DW, R3, R6, CFG_BPS_THRESHOLD)
    a.jmp_reg(BPF_JGT, R1, R3, "over")
    a.ja("features")

    # -- dual-dimension token bucket (fsx_compute.h twin): packet
    # milli-tokens AND byte tokens off one refill timestamp; a packet
    # passes only when BOTH have credit, a refused packet spends from
    # neither (refilled balances still stored).  burst_bytes == 0
    # disables the byte dimension (runtime config, so a runtime jump). --
    a.label("lim_token")
    a += ldx(BPF_DW, R1, R2, IPS_TOK_TS_NS)
    a += mov64(R3, R7)
    a += alu64(BPF_SUB, R3, R1)  # elapsed_ns
    a += ld_imm64(R4, 1_000_000_000_000)  # 1000 s clamp
    a.jmp_reg(BPF_JLE, R3, R4, "tb_clamped")
    a += mov64(R3, R4)
    a.label("tb_clamped")
    a += mov64(R0, R3)  # save clamped elapsed for the byte refill
    a += ldx(BPF_DW, R4, R6, CFG_BUCKET_RATE_PPS)
    a += alu64(BPF_MUL, R3, R4)
    a += ld_imm64(R4, 1_000_000)
    a += alu64(BPF_DIV, R3, R4)  # refill_milli
    a += ldx(BPF_DW, R1, R2, IPS_TOKENS_MILLI)
    a += alu64(BPF_ADD, R3, R1)  # tokens
    a += ldx(BPF_DW, R4, R6, CFG_BUCKET_BURST)
    a += alu64_imm(BPF_MUL, R4, 1000)  # burst_milli
    a.jmp_reg(BPF_JLE, R3, R4, "tb_capped")
    a += mov64(R3, R4)
    a.label("tb_capped")
    # byte bucket: R0 = elapsed -> refill_bytes; R5 = byte balance;
    # R4 = burst_bytes (kept live through the spend decision).  The
    # refill arithmetic (MUL + two DIVs) is skipped entirely when the
    # dimension is off — the packet-only config pays ~2 extra insns.
    a += ldx(BPF_DW, R4, R6, CFG_BUCKET_BURST_BYTES)
    a += ldx(BPF_DW, R5, R2, IPS_TOK_BYTES)
    a.jmp_imm(BPF_JEQ, R4, 0, "tb_bdone")  # byte dimension off
    a += alu64_imm(BPF_DIV, R0, 1000)  # elapsed_us (<= 1e9)
    a += ldx(BPF_DW, R1, R6, CFG_BUCKET_RATE_BPS)
    a += alu64(BPF_MUL, R0, R1)
    a += ld_imm64(R1, 1_000_000)
    a += alu64(BPF_DIV, R0, R1)  # refill_bytes
    a += alu64(BPF_ADD, R5, R0)
    a.jmp_reg(BPF_JLE, R5, R4, "tb_bdone")
    a += mov64(R5, R4)
    a.label("tb_bdone")
    a += stx(BPF_DW, R2, IPS_TOK_TS_NS, R7)
    a.jmp_imm(BPF_JLT, R3, 1000, "tb_over")     # pkt dimension broke
    a.jmp_imm(BPF_JEQ, R4, 0, "tb_spend_pkt")   # byte dimension off
    a.jmp_reg(BPF_JLT, R5, R9, "tb_over")       # byte credit < pkt_len
    a += alu64(BPF_SUB, R5, R9)                 # spend bytes
    a.label("tb_spend_pkt")
    a += alu64_imm(BPF_SUB, R3, 1000)           # spend a packet token
    a += stx(BPF_DW, R2, IPS_TOKENS_MILLI, R3)
    a += stx(BPF_DW, R2, IPS_TOK_BYTES, R5)
    a.ja("features")
    a.label("tb_over")  # refused: store refilled balances, spend none
    a += stx(BPF_DW, R2, IPS_TOKENS_MILLI, R3)
    a += stx(BPF_DW, R2, IPS_TOK_BYTES, R5)
    a.ja("over")

    # ---- over threshold: blacklist + drop (fsx_kern.c:260-268).
    # v6 sources insert into the EXACT map (the full source is on the
    # stack right now) — never the fold, which could block an innocent
    # colliding source. ------------------------------------------------
    a.label("over")
    a += ldx(BPF_DW, R1, R6, CFG_BLOCK_NS)
    a += alu64(BPF_ADD, R1, R7)  # until = now + block_ns
    a += stx(BPF_DW, R10, S_VAL64, R1)
    a += ldx(BPF_DW, R1, R10, S_IS6)
    a.jmp_imm(BPF_JEQ, R1, 0, "over_v4")
    a.ld_map(R1, "blacklist_v6")
    a += mov64(R2, R10)
    a += alu64_imm(BPF_ADD, R2, S_SADDR6)
    a += mov64(R3, R10)
    a += alu64_imm(BPF_ADD, R3, S_VAL64)
    a += mov64_imm(R4, 0)  # BPF_ANY
    a += call(FN_map_update_elem)
    a.ja("over_counted")
    a.label("over_v4")
    a.ld_map(R1, "blacklist_map")
    a += mov64(R2, R10)
    a += alu64_imm(BPF_ADD, R2, S_KEY)
    a += mov64(R3, R10)
    a += alu64_imm(BPF_ADD, R3, S_VAL64)
    a += mov64_imm(R4, 0)  # BPF_ANY
    a += call(FN_map_update_elem)
    a.label("over_counted")
    a += ldx(BPF_DW, R1, R8, ST_DROPPED_RATE)
    a += alu64_imm(BPF_ADD, R1, 1)
    a += stx(BPF_DW, R8, ST_DROPPED_RATE, R1)
    a.ja("drop_counted")

    # ---- streaming feature extraction (fsx_kern.c:97-185) ------------
    # cfg (r6) is dead past the limiter; r6 is reused for the flow-stats
    # pointer so it survives the BPF-to-BPF isqrt calls (r6-r9 are the
    # only callee-saved registers).
    a.label("features")
    # fkey = saddr ^ (dport << 16); 32-bit store truncates as in C
    a += ldx(BPF_DW, R1, R10, S_SADDR)
    a += ldx(BPF_DW, R2, R10, S_DPORT)
    a += alu64_imm(BPF_LSH, R2, 16)
    a += alu64(BPF_XOR, R1, R2)
    a += stx(BPF_W, R10, S_FKEY, R1)
    a.ld_map(R1, "flow_stats_map")
    a += mov64(R2, R10)
    a += alu64_imm(BPF_ADD, R2, S_FKEY)
    a += call(FN_map_lookup_elem)
    a.jmp_imm(BPF_JNE, R0, 0, "fs_have")
    # miss: insert zeroed stats {first_ts_ns = now, dst_port = htons}
    a += mov64_imm(R1, 0)
    for off in range(0, 72, 8):
        a += stx(BPF_DW, R10, S_FS_ZERO + off, R1)
    a += stx(BPF_DW, R10, S_FS_ZERO + FS_FIRST_TS_NS, R7)
    a += ldx(BPF_DW, R1, R10, S_DPORT)
    a += endian_be(R1, 16)  # fsx_htons: wire → host order
    a += stx(BPF_H, R10, S_FS_ZERO + FS_DST_PORT, R1)
    a.ld_map(R1, "flow_stats_map")
    a += mov64(R2, R10)
    a += alu64_imm(BPF_ADD, R2, S_FKEY)
    a += mov64(R3, R10)
    a += alu64_imm(BPF_ADD, R3, S_FS_ZERO)
    a += mov64_imm(R4, 0)
    a += call(FN_map_update_elem)
    a.ld_map(R1, "flow_stats_map")
    a += mov64(R2, R10)
    a += alu64_imm(BPF_ADD, R2, S_FKEY)
    a += call(FN_map_lookup_elem)
    a.jmp_imm(BPF_JEQ, R0, 0, "allowed")  # churn: fail open
    a.label("fs_have")
    a += mov64(R6, R0)  # r6 = fs (callee-saved across isqrt calls)

    # IAT update, guarded against the cross-CPU ordering race
    # (fsx_kern.c:114-135): only when pkt_count > 0 AND now > last_ts.
    a += ldx(BPF_DW, R1, R6, FS_PKT_COUNT)
    a.jmp_imm(BPF_JEQ, R1, 0, "fs_count")
    a += ldx(BPF_DW, R3, R6, FS_LAST_TS_NS)
    a.jmp_reg(BPF_JGE, R3, R7, "fs_count")
    a += mov64(R4, R7)
    a += alu64(BPF_SUB, R4, R3)  # iat (ns)
    a += mov64(R1, R4)
    a += atomic_add64(R6, FS_IAT_SUM_NS, R1)
    a += mov64(R5, R4)
    a += alu64_imm(BPF_DIV, R5, 1000)  # iat_us
    # clamp to 2^21 us before squaring (headroom analysis at
    # fsx_kern.c:122-127)
    a += ld_imm64(R1, 1 << 21)
    a.jmp_reg(BPF_JLE, R5, R1, "iat_clamped")
    a += mov64(R5, R1)
    a.label("iat_clamped")
    a += alu64(BPF_MUL, R5, R5)
    a += mov64(R1, R5)
    a += atomic_add64(R6, FS_IAT_SQ_SUM_US2, R1)
    a += ldx(BPF_DW, R1, R6, FS_IAT_MAX_NS)
    a.jmp_reg(BPF_JLE, R4, R1, "fs_count")
    a += stx(BPF_DW, R6, FS_IAT_MAX_NS, R4)  # benign race: a lost max
    a.label("fs_count")
    # n_now = fetch_add(pkt_count, 1) + 1  (BPF_FETCH needs kernel >=
    # 5.12 — same floor as the C build, see kern/fsx_compute.h note)
    a += mov64_imm(R1, 1)
    a += atomic_add64(R6, FS_PKT_COUNT, R1, fetch=True)
    a += alu64_imm(BPF_ADD, R1, 1)
    a += mov64(R5, R1)  # r5 = n_now
    a += mov64(R1, R9)
    a += atomic_add64(R6, FS_BYTE_SUM, R1)
    a += mov64(R1, R9)
    a += alu64(BPF_MUL, R1, R9)
    a += atomic_add64(R6, FS_BYTE_SQ_SUM, R1)
    a += stx(BPF_DW, R6, FS_LAST_TS_NS, R7)

    # Emit every packet while the flow is young, then every 16th
    # (fsx_kern.c:141-144): skip when n_now > 16 && (n_now & 15) != 0.
    a.jmp_imm(BPF_JLE, R5, 16, "derive")
    a += alu64_imm(BPF_AND, R5, 15)
    a.jmp_imm(BPF_JNE, R5, 0, "allowed")

    # ---- derive the 8 features into the frame (fsx_kern.c:150-183).
    # n is snapshotted once (C reads it into a local); isqrt calls all
    # happen BEFORE ringbuf_reserve, so no ringbuf reference is ever
    # held across a BPF-to-BPF call.
    a.label("derive")
    a += ldx(BPF_DW, R5, R6, FS_PKT_COUNT)  # n (reloaded, as in C)
    a += stx(BPF_DW, R10, S_N, R5)
    a += ldx(BPF_DW, R1, R6, FS_BYTE_SUM)
    a += alu64(BPF_DIV, R1, R5)  # mean
    a += mov64(R3, R1)
    _sat_u32(a, R1, R4, "f_mean_sat")  # feat1 = sat(mean)
    a += stx(BPF_W, R10, S_FEAT + 4, R1)
    a += ldx(BPF_DW, R1, R6, FS_BYTE_SQ_SUM)
    a += alu64(BPF_DIV, R1, R5)
    a += alu64(BPF_MUL, R3, R3)  # mean^2
    a += mov64_imm(R4, 0)
    a.jmp_reg(BPF_JLE, R1, R3, "f_var_zero")
    a += mov64(R4, R1)
    a += alu64(BPF_SUB, R4, R3)  # var = byte_sq_sum/n - mean^2
    a.label("f_var_zero")
    a += mov64(R1, R4)
    a.call_local("fn_isqrt")  # feat2 = isqrt(var)
    a += stx(BPF_W, R10, S_FEAT + 8, R0)
    # flow-age features (slots 3/4, schema.FEATURE_NAMES; the C twin's
    # dur_ms / pps_x1000 at fsx_kern.c derive block):
    #   feat3 = sat(dur_ns / 1e6)
    #   feat4 = dur_us ? sat(n * 1e9 / dur_us) : 0
    a += ldx(BPF_DW, R1, R6, FS_LAST_TS_NS)
    a += ldx(BPF_DW, R3, R6, FS_FIRST_TS_NS)
    a += alu64(BPF_SUB, R1, R3)  # dur_ns
    a += mov64(R4, R1)
    a += ld_imm64(R3, 1_000_000)
    a += alu64(BPF_DIV, R1, R3)  # dur_ms
    _sat_u32(a, R1, R3, "f_dur_sat")
    a += stx(BPF_W, R10, S_FEAT + 12, R1)
    a += alu64_imm(BPF_DIV, R4, 1000)  # dur_us
    a += mov64_imm(R1, 0)
    a.jmp_imm(BPF_JEQ, R4, 0, "f_pps_done")  # single-stamp flow: unknown
    a += ldx(BPF_DW, R1, R10, S_N)
    a += ld_imm64(R3, 1_000_000_000)
    a += alu64(BPF_MUL, R1, R3)
    a += alu64(BPF_DIV, R1, R4)  # pps_x1000
    _sat_u32(a, R1, R3, "f_pps_sat")
    a.label("f_pps_done")
    a += stx(BPF_W, R10, S_FEAT + 16, R1)
    # iat_n = max(n - 1, 1)
    a += ldx(BPF_DW, R4, R10, S_N)
    a += alu64_imm(BPF_SUB, R4, 1)
    a.jmp_imm(BPF_JGE, R4, 1, "f_iatn_ok")
    a += mov64_imm(R4, 1)
    a.label("f_iatn_ok")
    # iat_mean_us = (iat_sum_ns / iat_n) / 1000; feat5 = sat(...)
    a += ldx(BPF_DW, R1, R6, FS_IAT_SUM_NS)
    a += alu64(BPF_DIV, R1, R4)
    a += alu64_imm(BPF_DIV, R1, 1000)
    a += mov64(R3, R1)  # iat_mean_us
    _sat_u32(a, R1, R5, "f_iatmean_sat")
    a += stx(BPF_W, R10, S_FEAT + 20, R1)
    # iat_var = max(iat_sq_sum_us2 / iat_n - iat_mean_us^2, 0)
    a += ldx(BPF_DW, R1, R6, FS_IAT_SQ_SUM_US2)
    a += alu64(BPF_DIV, R1, R4)
    a += alu64(BPF_MUL, R3, R3)
    a += mov64_imm(R4, 0)
    a.jmp_reg(BPF_JLE, R1, R3, "f_iatvar_zero")
    a += mov64(R4, R1)
    a += alu64(BPF_SUB, R4, R3)
    a.label("f_iatvar_zero")
    a += mov64(R1, R4)
    a.call_local("fn_isqrt")  # feat6 = isqrt(iat_var)
    a += stx(BPF_W, R10, S_FEAT + 24, R0)
    # feat7 = sat(iat_max_ns / 1000)
    a += ldx(BPF_DW, R1, R6, FS_IAT_MAX_NS)
    a += alu64_imm(BPF_DIV, R1, 1000)
    _sat_u32(a, R1, R3, "f_iatmax_sat")
    a += stx(BPF_W, R10, S_FEAT + 28, R1)
    # feat0 = dst_port (host order, stored at flow creation)
    a += ldx(BPF_H, R1, R6, FS_DST_PORT)
    a += stx(BPF_W, R10, S_FEAT + 0, R1)

    # flags byte: ipv6 | tcp | udp | icmp | tcp_syn (fsx_kern.c:170-174)
    # — computed into R3 BEFORE any ringbuf reserve (shared by both
    # emit variants; the compact one folds it into word 3)
    a += ldx(BPF_DW, R3, R10, S_IS6)  # FLAG_IPV6 == 1 == is6
    a += ldx(BPF_DW, R1, R10, S_L4)
    a.jmp_imm(BPF_JNE, R1, IPPROTO_TCP, "fl_chk_udp")
    a += alu64_imm(BPF_OR, R3, FLAG_TCP)
    a += ldx(BPF_DW, R4, R10, S_TCPFLAGS)
    a += alu64_imm(BPF_AND, R4, FSX_TCP_SYN)
    a.jmp_imm(BPF_JEQ, R4, 0, "fl_done")
    a += alu64_imm(BPF_OR, R3, FLAG_TCP_SYN)
    a.ja("fl_done")
    a.label("fl_chk_udp")
    a.jmp_imm(BPF_JNE, R1, IPPROTO_UDP, "fl_chk_icmp")
    a += alu64_imm(BPF_OR, R3, FLAG_UDP)
    a.ja("fl_done")
    a.label("fl_chk_icmp")
    a.jmp_imm(BPF_JEQ, R1, IPPROTO_ICMP, "fl_icmp")
    a.jmp_imm(BPF_JNE, R1, IPPROTO_ICMPV6, "fl_done")
    a.label("fl_icmp")
    a += alu64_imm(BPF_OR, R3, FLAG_ICMP)
    a.label("fl_done")

    if ml:
        # ---- in-kernel ML stage (two-tier escalation protocol; the
        # fsx distill tentpole).  Runs on exactly the records the
        # pre-ML program would have emitted — features are fresh here —
        # and splits them into three bands:
        #   DROP      confident attack: blacklist (exact v6 / folded
        #             v4, TTL = cfg->block_ns) + dropped_ml++ + XDP_DROP
        #   PASS      confident benign: ml_pass++, ringbuf emit
        #             SUPPRESSED (the line-rate win: the engine never
        #             sees traffic the kernel is sure about), XDP_PASS
        #   ESCALATE  uncertain: ml_escalated++, record emitted
        #             unchanged — the engine decides
        #   DISABLED  no model in ml_model_map: plain emit, no counters
        #             (bit-identical behavior to the ml=False program)
        a += stx(BPF_DW, R10, S_VAL64, R3)  # park flags across the call
        for p, reg in enumerate((R1, R2, R3, R4)):
            a += ldx(BPF_W, reg, R10, S_FEAT + 8 * p + 4)
            a += alu64_imm(BPF_LSH, reg, 32)
            a += ldx(BPF_W, R5, R10, S_FEAT + 8 * p)
            a += alu64(BPF_OR, reg, R5)
        a.call_local("fn_ml_score")
        a.jmp_imm(BPF_JEQ, R0, schema.ML_BAND_DROP, "ml_drop")
        a.jmp_imm(BPF_JEQ, R0, schema.ML_BAND_PASS, "ml_passq")
        a.jmp_imm(BPF_JNE, R0, schema.ML_BAND_ESCALATE, "ml_emit")
        a += ldx(BPF_DW, R1, R8, ST_ML_ESCALATED)
        a += alu64_imm(BPF_ADD, R1, 1)
        a += stx(BPF_DW, R8, ST_ML_ESCALATED, R1)
        a.label("ml_emit")
        a += ldx(BPF_DW, R3, R10, S_VAL64)  # un-park flags for the emit

    if not compact:
        # ---- 48 B ringbuf emit (fsx_kern.c:146-184) ------------------
        a += stx(BPF_DW, R10, S_VAL64, R3)  # park flags across reserve
        a.ld_map(R1, "feature_ring")
        a += mov64_imm(R2, REC_SIZE)
        a += mov64_imm(R3, 0)
        a += call(FN_ringbuf_reserve)
        a.jmp_imm(BPF_JEQ, R0, 0, "allowed")  # ring full: fail open
        a += mov64(R2, R0)  # r2 = rec
        a += stx(BPF_DW, R2, REC_TS_NS, R7)
        a += ldx(BPF_DW, R1, R10, S_SADDR)
        a += stx(BPF_W, R2, REC_SADDR, R1)
        a += stx(BPF_H, R2, REC_PKT_LEN, R9)
        a += ldx(BPF_DW, R1, R10, S_L4)
        a += stx(BPF_B, R2, REC_IP_PROTO, R1)
        a += ldx(BPF_DW, R3, R10, S_VAL64)
        a += stx(BPF_B, R2, REC_FLAGS, R3)
        # copy the 8 derived features
        for i in range(8):
            a += ldx(BPF_W, R1, R10, S_FEAT + 4 * i)
            a += stx(BPF_W, R2, REC_FEAT + 4 * i, R1)
        a += mov64(R1, R2)
        a += mov64_imm(R2, 0)
        a += call(FN_ringbuf_submit)
    else:
        # ---- 16 B compact emit (fsx_kern.c FSX_EMIT_COMPACT twin) ----
        # word 3 first (uses flags in R3 + len in R9 + ts in R7), all
        # BEFORE reserve — a BPF-to-BPF call (fn_minifloat) must never
        # execute while a ringbuf reference is held.
        a += alu64_imm(BPF_AND, R3, 0x1F)
        a += alu64_imm(BPF_LSH, R3, 11)
        a += mov64(R1, R9)              # len8, round-to-nearest, sat
        a += alu64_imm(BPF_ADD, R1, 4)
        a += alu64_imm(BPF_RSH, R1, 3)
        a.jmp_imm(BPF_JLE, R1, 2047, "cw3_len_ok")
        a += mov64_imm(R1, 2047)
        a.label("cw3_len_ok")
        a += alu64(BPF_OR, R3, R1)
        a += mov64(R1, R7)              # ts16 = (now/1000) & 0xFFFF
        a += alu64_imm(BPF_DIV, R1, 1000)
        a += alu64_imm(BPF_AND, R1, 0xFFFF)
        a += alu64_imm(BPF_LSH, R1, 16)
        a += alu64(BPF_OR, R3, R1)
        a += stx(BPF_W, R10, S_CW3, R3)
        # words 1/2: four minifloat-quantized features each (R6 is free
        # after the derive block; the inline quantizer clobbers r0,r2-r5)
        for word_slot, base in ((S_CW1, 0), (S_CW2, 16)):
            a += mov64_imm(R6, 0)
            for i in range(4):
                a += ldx(BPF_W, R1, R10, S_FEAT + base + 4 * i)
                _emit_minifloat_inline(a)
                if i:
                    a += alu64_imm(BPF_LSH, R0, 8 * i)
                a += alu64(BPF_OR, R6, R0)
            a += stx(BPF_W, R10, word_slot, R6)
        a.ld_map(R1, "feature_ring")
        a += mov64_imm(R2, COMPACT_REC_SIZE)
        a += mov64_imm(R3, 0)
        a += call(FN_ringbuf_reserve)
        a.jmp_imm(BPF_JEQ, R0, 0, "allowed")  # ring full: fail open
        a += mov64(R2, R0)
        a += ldx(BPF_DW, R1, R10, S_SADDR)
        a += stx(BPF_W, R2, 0, R1)
        a += ldx(BPF_W, R1, R10, S_CW1)
        a += stx(BPF_W, R2, 4, R1)
        a += ldx(BPF_W, R1, R10, S_CW2)
        a += stx(BPF_W, R2, 8, R1)
        a += ldx(BPF_W, R1, R10, S_CW3)
        a += stx(BPF_W, R2, 12, R1)
        a += mov64(R1, R2)
        a += mov64_imm(R2, 0)
        a += call(FN_ringbuf_submit)

    # ---- exits -------------------------------------------------------
    a.label("allowed")  # fsx_kern.c:275-276
    a += ldx(BPF_DW, R1, R8, ST_ALLOWED)
    a += alu64_imm(BPF_ADD, R1, 1)
    a += stx(BPF_DW, R8, ST_ALLOWED, R1)
    a += mov64_imm(R0, XDP_PASS)
    a += exit_()

    a.label("pass_quiet")  # no config / non-IP: pass, uncounted
    a += mov64_imm(R0, XDP_PASS)
    a += exit_()

    a.label("drop")  # malformed: drop, uncounted (fsx_kern.c:217-218)
    a += mov64_imm(R0, XDP_DROP)
    a += exit_()

    a.label("drop_counted")  # blacklist / rate-limit / ML-band drop
    a += mov64_imm(R0, XDP_DROP)
    a += exit_()

    if ml:
        # ---- ML band exits (see the fl_done stage above) -------------
        a.label("ml_passq")  # confident benign: pass, emit suppressed
        a += ldx(BPF_DW, R1, R8, ST_ML_PASS)
        a += alu64_imm(BPF_ADD, R1, 1)
        a += stx(BPF_DW, R8, ST_ML_PASS, R1)
        a.ja("allowed")
        # confident attack: blacklist so the NEXT packets of this source
        # drop at the line-rate gate (classification runs only at emit
        # cadence; the blacklist is what makes the drop line-rate), then
        # count + drop this one.  v6 sources insert into the EXACT map —
        # the full source is still on the stack — mirroring "over".
        a.label("ml_drop")
        a += ldx(BPF_DW, R1, R10, S_MLBLK)
        a += alu64(BPF_ADD, R1, R7)  # until = now + block_ns
        a += stx(BPF_DW, R10, S_VAL64, R1)
        a += ldx(BPF_DW, R1, R10, S_IS6)
        a.jmp_imm(BPF_JEQ, R1, 0, "mld_v4")
        a.ld_map(R1, "blacklist_v6")
        a += mov64(R2, R10)
        a += alu64_imm(BPF_ADD, R2, S_SADDR6)
        a += mov64(R3, R10)
        a += alu64_imm(BPF_ADD, R3, S_VAL64)
        a += mov64_imm(R4, 0)  # BPF_ANY
        a += call(FN_map_update_elem)
        a.ja("mld_count")
        a.label("mld_v4")
        a.ld_map(R1, "blacklist_map")
        a += mov64(R2, R10)
        a += alu64_imm(BPF_ADD, R2, S_KEY)
        a += mov64(R3, R10)
        a += alu64_imm(BPF_ADD, R3, S_VAL64)
        a += mov64_imm(R4, 0)  # BPF_ANY
        a += call(FN_map_update_elem)
        a.label("mld_count")
        a += ldx(BPF_DW, R1, R8, ST_DROPPED_ML)
        a += alu64_imm(BPF_ADD, R1, 1)
        a += stx(BPF_DW, R8, ST_DROPPED_ML, R1)
        a.ja("drop_counted")

    # ---- subfunctions -----------------------------------------------
    _emit_isqrt_fn(a)
    if ml:
        _emit_ml_score_fn(a)

    return a.assemble()


def load(sizes: MapSizes = MapSizes(), compact: bool = False,
         ml: bool = False) -> tuple[int, dict[str, loader.Map]]:
    """Create maps, load the program through the verifier; returns
    (prog_fd, maps).  Caller owns the fds."""
    maps = create_maps(sizes)
    prog = build(compact=compact, ml=ml)
    fd = loader.prog_load(prog, map_fds={k: m.fd for k, m in maps.items()})
    return fd, maps
