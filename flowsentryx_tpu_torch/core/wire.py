"""The host side of the wires and of the shared-memory transport, in
numpy alone.

Counterpart of the host (numpy) half of ``flowsentryx_tpu/core/schema.py``:
the flow-record layout, the raw48 and compact16 encoders, the kernel's
16-byte compact-emit record, and the shared-memory ring and sealed-batch
queue layout that the C++ daemon (``kern/fsx_schema.h``) and the ingest
workers share.  Every constant here is the contract with another process
and must equal the reference's value (``tests/test_torch_shm.py``).

It also holds the kernel plane's structs (the eBPF maps' values, the
rule key, the verdict codes and :func:`struct_layouts`, which
:mod:`.codegen` renders into ``kern/fsx_schema.h``).

This module imports numpy only — no ``torch`` — so the spawned ingest
workers (:mod:`flowsentryx_tpu_torch.ingest.worker`) pack batches without
paying torch's import at boot, and the eBPF plane
(:mod:`flowsentryx_tpu_torch.bpf`) and the pinned-map reads of ``fsx
status``/``monitor`` run without torch.  :mod:`.schema` re-exports every
name.
"""

from __future__ import annotations

import enum
from typing import NamedTuple

import numpy as np

# ---------------------------------------------------------------------------
# Flow record
# ---------------------------------------------------------------------------

NUM_FEATURES: int = 8

FLAG_IPV6 = 1 << 0
FLAG_TCP_SYN = 1 << 1
FLAG_TCP = 1 << 2
FLAG_UDP = 1 << 3
FLAG_ICMP = 1 << 4

#: One feature-ring entry (packed, 48 bytes) — the same layout as the
#: reference's ``FLOW_RECORD_DTYPE`` and the kernel's C struct.
FLOW_RECORD_DTYPE = np.dtype(
    [
        ("ts_ns", "<u8"),
        ("saddr", "<u4"),
        ("pkt_len", "<u2"),
        ("ip_proto", "u1"),
        ("flags", "u1"),
        ("feat", "<u4", (NUM_FEATURES,)),
    ]
)
FLOW_RECORD_SIZE = FLOW_RECORD_DTYPE.itemsize  # 48

# ---------------------------------------------------------------------------
# The raw48 wire
# ---------------------------------------------------------------------------

#: Wire formats of the host -> device hop.
WIRE_RAW48 = "raw48"
WIRE_COMPACT16 = "compact16"

#: 32-bit words per flow record (48 B / 4).
RECORD_WORDS = FLOW_RECORD_SIZE // 4
#: The u16 ``pkt_len`` in raw word 3, bits 0-15.
RANGE_PKT_LEN_MAX = 0xFFFF


def encode_raw(buf: np.ndarray, batch_size: int, t0_ns: int) -> np.ndarray:
    """Records -> the raw48 wire ``[B+1, 12]`` uint32: the 48-byte
    records verbatim as 12 little-endian words, row ``B`` the metadata
    row ``(n_valid, t0 lo, t0 hi, 0, ...)``."""
    n = min(len(buf), batch_size)
    out = np.zeros((batch_size + 1, RECORD_WORDS), np.uint32)
    if n:
        out[:n] = buf[:n].view(np.uint32).reshape(n, RECORD_WORDS)
    out[batch_size, 0] = n
    out[batch_size, 1] = t0_ns & 0xFFFFFFFF
    out[batch_size, 2] = (t0_ns >> 32) & 0xFFFFFFFF
    return out


# ---------------------------------------------------------------------------
# The compact16 wire
# ---------------------------------------------------------------------------

COMPACT_RECORD_WORDS = 4
COMPACT_RECORD_SIZE = COMPACT_RECORD_WORDS * 4  # 16

RANGE_FEAT_Q8_MAX = 255
RANGE_FLAGS_MAX = 0x1F
RANGE_LEN8_MAX = 0x7FF
RANGE_DT_US_MAX = 0xFFFF
#: The declared deployment horizon, seconds: the metadata row's
#: timestamp HI word stays below ``horizon >> 32`` (in µs on compact16,
#: ns on raw48) — the premise sealed-slot validation checks.
RANGE_DEPLOY_HORIZON_S = 1 << 22


# ---------------------------------------------------------------------------
# The kernel tier's model map (the distilled classifier, ``fsx distill``)
# ---------------------------------------------------------------------------
# ``struct fsx_ml_model``: the packed plan the XDP scorer bands packets
# with (:mod:`flowsentryx_tpu_torch.distill.plan`).  The accumulator
# thresholds fold the input zero point in, so the kernel compares the raw
# weighted rank sum.

ML_BOUNDS_PER_FEATURE = 255  # one boundary per reachable quant step
ML_MODEL_VALID_OFFSET = 0
ML_MODEL_FLAGS_OFFSET = 4
ML_MODEL_ACC_DROP_OFFSET = 8
ML_MODEL_ACC_PASS_OFFSET = 16
ML_MODEL_W_OFFSET = 24
ML_MODEL_QBASE_OFFSET = 56
ML_MODEL_BOUNDS_OFFSET = 88
ML_MODEL_SIZE = ML_MODEL_BOUNDS_OFFSET + 4 * 8 * ML_BOUNDS_PER_FEATURE  # 8248

#: The kernel scorer's band codes (``FSX_ML_BAND_*`` in C).
ML_BAND_PASS = 0       # confident benign: XDP_PASS, emit suppressed
ML_BAND_ESCALATE = 1   # uncertain: emit the record, the engine decides
ML_BAND_DROP = 2       # confident attack: blacklist + XDP_DROP
ML_BAND_DISABLED = 3   # no model pushed: behave exactly pre-ML


def quantize_feat_model(
    feat: np.ndarray, in_scale: float, in_zp: int, log1p: bool
) -> np.ndarray:
    """u32 -> u8 with the classifier's own input quantizer (host, numpy;
    round half to even)."""
    x = feat.astype(np.float32)
    if log1p:
        x = np.log1p(x)
    q = np.rint(x / np.float32(in_scale)) + in_zp
    return np.clip(q, 0, RANGE_FEAT_Q8_MAX).astype(np.uint32)


def _minifloat_ref(feat: np.ndarray) -> np.ndarray:
    """Reference e5m3 encoder: values <= 8 verbatim; above,
    ``q = 8·e + m̂`` with ``feat ≈ (8 + m̂)·2^(e-1)``."""
    f = feat.astype(np.uint64)
    bl = np.zeros(f.shape, np.int64)
    tmp = f.copy()
    for s in (32, 16, 8, 4, 2, 1):
        big = tmp >= (np.uint64(1) << np.uint64(s))
        bl = np.where(big, bl + s, bl)
        tmp = np.where(big, tmp >> np.uint64(s), tmp)
    bl += (tmp > 0)
    e = np.maximum(bl - 4, 0).astype(np.uint64)
    safe = np.maximum(e, np.uint64(1)) - np.uint64(1)
    r = np.where(e > 0, (f >> safe) + np.uint64(1), f * 2) >> 1
    e = np.where(r == 16, e + 1, e)
    r = np.where(r == 16, np.uint64(8), r)
    q = np.where(bl <= 3, f, (e + np.uint64(1)) * 8 + (r - 8))
    return np.minimum(q, RANGE_FEAT_Q8_MAX).astype(np.uint32)


_MINIFLOAT_LUT: np.ndarray | None = None


def _minifloat_lut() -> np.ndarray:
    """``[0, 2^16)`` maps f directly, ``[2^16, 2^16 + 2^20)`` maps
    ``f >> 12`` (the rounding bit sits at or above bit 12 there)."""
    global _MINIFLOAT_LUT
    if _MINIFLOAT_LUT is None:
        lo = _minifloat_ref(np.arange(1 << 16, dtype=np.uint64))
        hi = _minifloat_ref(np.arange(1 << 20, dtype=np.uint64) << 12)
        _MINIFLOAT_LUT = np.concatenate([lo, hi]).astype(np.uint8)
    return _MINIFLOAT_LUT


def _minifloat_q8(f: np.ndarray) -> np.ndarray:
    f = np.asarray(f).astype(np.uint64)
    big = f >= np.uint64(1 << 32)
    safe = np.minimum(f, np.uint64((1 << 32) - 1))
    idx = np.where(safe < np.uint64(1 << 16), safe,
                   (safe >> np.uint64(12)) + np.uint64(1 << 16))
    out = _minifloat_lut()[idx]
    if big.any():
        out = out.copy()
        out[big] = _minifloat_ref(f[big]).astype(np.uint8)
    return out


def quantize_feat_minifloat(feat: np.ndarray) -> np.ndarray:
    """u32 -> u8 e5m3, round to nearest."""
    return _minifloat_q8(np.asarray(feat)).astype(np.uint32)


def model_quant_args(params) -> dict:
    """Wire-quantizer kwargs for ``model`` mode from a params object
    carrying ``in_scale``/``in_zp``/``log1p``."""
    return dict(
        feat_mode="model",
        in_scale=float(np.asarray(params.in_scale)),
        in_zp=int(np.asarray(params.in_zp)),
        log1p=bool(int(np.asarray(getattr(params, "log1p", 0)))),
    )


def wire_quant_for(params) -> dict:
    """The model's own input observer when the artifact has one
    (bit-exact), else the model-independent minifloat."""
    if hasattr(params, "in_scale"):
        return model_quant_args(params)
    return dict(feat_mode="minifloat")


def compact_pack(
    rec: np.ndarray,
    base_ns: int,
    *,
    feat_mode: str = "minifloat",
    in_scale: float = 1.0,
    in_zp: int = 0,
    log1p: bool = False,
) -> np.ndarray:
    """Flow records -> ``[n, 4]`` compact words (host, numpy)."""
    n = len(rec)
    out = np.empty((n, COMPACT_RECORD_WORDS), np.uint32)
    if feat_mode == "model":
        q8 = quantize_feat_model(
            rec["feat"], in_scale, in_zp, log1p).astype(np.uint8)
    elif feat_mode == "minifloat":
        q8 = _minifloat_q8(rec["feat"])
    else:
        raise ValueError(f"unknown feat_mode {feat_mode!r}")
    out[:, 0] = rec["saddr"]
    # [n, 8] u8 viewed as [n, 2] u32 is the little-endian byte pack
    qw = np.ascontiguousarray(q8).view(np.uint32)
    out[:, 1] = qw[:, 0]
    out[:, 2] = qw[:, 1]
    len8 = np.minimum((rec["pkt_len"].astype(np.uint32) + 4) >> 3,
                      RANGE_LEN8_MAX)
    dt = rec["ts_ns"].astype(np.int64) - np.int64(base_ns)
    dt_us = np.clip(dt // 1000, 0, RANGE_DT_US_MAX).astype(np.uint32)
    out[:, 3] = (len8
                 | (rec["flags"].astype(np.uint32) & RANGE_FLAGS_MAX) << 11
                 | dt_us << 16)
    return out


def encode_compact(
    buf: np.ndarray,
    batch_size: int,
    t0_ns: int,
    *,
    feat_mode: str = "minifloat",
    in_scale: float = 1.0,
    in_zp: int = 0,
    log1p: bool = False,
) -> np.ndarray:
    """Records -> the compact wire ``[B+1, 4]`` uint32; row ``B`` is the
    metadata row ``(n_valid, base_rel_us lo, base_rel_us hi, 0)``."""
    n = min(len(buf), batch_size)
    out = np.zeros((batch_size + 1, COMPACT_RECORD_WORDS), np.uint32)
    base_ns = int(t0_ns)
    if n:
        rec = buf[:n]
        base_ns = int(rec["ts_ns"].min())
        out[:n] = compact_pack(rec, base_ns, feat_mode=feat_mode,
                               in_scale=in_scale, in_zp=in_zp, log1p=log1p)
    base_rel_us = max(0, (base_ns - int(t0_ns))) // 1000
    out[batch_size, 0] = n
    out[batch_size, 1] = base_rel_us & 0xFFFFFFFF
    out[batch_size, 2] = (base_rel_us >> 32) & 0xFFFFFFFF
    return out


#: One KERNEL-emitted compact record (``struct fsx_compact_record``): the
#: four words of a compact wire row, except that word 3's ts field is the
#: kernel's ``(ktime_ns / 1000) & 0xFFFF`` — a wrapped µs stamp the host
#: unwraps (:func:`unwrap_kernel_ts16`) and rebases per batch.
COMPACT_RECORD_DTYPE = np.dtype(
    [("w0", "<u4"), ("w1", "<u4"), ("w2", "<u4"), ("w3", "<u4")]
)
assert COMPACT_RECORD_DTYPE.itemsize == COMPACT_RECORD_SIZE


def unwrap_kernel_ts16(w3: np.ndarray, now_ns: int) -> np.ndarray:
    """Absolute kernel-clock timestamps (ns, u64) from the wrapped 16-bit
    µs stamps of kernel-emitted compact records: the latest time at or
    before ``now_ns`` whose µs count has those low 16 bits.  Valid while
    records are drained within 65.5 ms of emission; a staler record lands
    a multiple of 65.5 ms late (bounded skew, never corruption)."""
    now_us = np.uint64(now_ns // 1000)
    ts16 = (w3 >> np.uint32(16)).astype(np.uint64)
    return (now_us
            - ((now_us - ts16) & np.uint64(RANGE_DT_US_MAX))
            ) * np.uint64(1000)


# ---------------------------------------------------------------------------
# Shared-memory rings (daemon <-> engine) and sealed-batch queues
# (ingest worker -> engine)
# ---------------------------------------------------------------------------

#: Magic of the mmap'd SPSC ring segments the C++ daemon and the engine
#: share: a 192-byte header (magic / capacity / record size on the first
#: cache line, the producer cursor ``head`` and the consumer cursor
#: ``tail`` on their own lines) followed by ``capacity`` fixed-size
#: records.  Cursors are monotonically increasing record counts.
SHM_MAGIC = 0x46535852494E4731  # "FSXRING1"
SHM_HDR_SIZE = 192
SHM_CAPACITY_OFFSET = 8         # u64: record slots, power of two
SHM_RECORD_SIZE_OFFSET = 16     # u64: bytes per record
SHM_HEAD_OFFSET = 64            # u64: producer cursor (records written)
SHM_TAIL_OFFSET = 128           # u64: consumer cursor (records read)

#: A sealed-batch queue reuses the ring geometry with ``capacity``
#: batch SLOTS, plus a control block of u64 fields, each with one
#: writer: HBEAT (worker, CLOCK_MONOTONIC ns, its liveness), FIRST_TS
#: (worker, the first record's timestamp; 0 = none yet), T0 (engine,
#: the agreed epoch), STOP (engine, drain and exit), WSTATE (worker,
#: lifecycle), EMIT_DROP (worker, batches given up at shutdown),
#: SPIN_US / IDLE_US (creator, the worker's idle backoff).
SHM_BATCHQ_MAGIC = 0x4653584241545131  # "FSXBATQ1"
SHM_HBEAT_OFFSET = 24
SHM_FIRST_TS_OFFSET = 32
SHM_T0_OFFSET = 40
SHM_STOP_OFFSET = 48
SHM_WSTATE_OFFSET = 56
SHM_EMIT_DROP_OFFSET = 72
SHM_SPIN_US_OFFSET = 136
SHM_IDLE_US_OFFSET = 144

WSTATE_SPAWNING = 0
WSTATE_RUNNING = 1
WSTATE_DONE = 2
WSTATE_FAILED = 3

#: Each queue slot: an 8-word header, then one ``[max_batch+1, words]``
#: wire buffer.  Header words: seq lo/hi (1-based per worker), records,
#: wire id, seal time lo/hi (CLOCK_MONOTONIC ns), fill duration µs, 0.
BATCHQ_SLOT_HDR_WORDS = 8
BATCHQ_SEQ_LO_WORD = 0
BATCHQ_SEQ_HI_WORD = 1
BATCHQ_N_RECORDS_WORD = 2
BATCHQ_WIRE_ID_WORD = 3
BATCHQ_SEAL_NS_LO_WORD = 4
BATCHQ_SEAL_NS_HI_WORD = 5
BATCHQ_FILL_DUR_US_WORD = 6
BATCHQ_RESERVED_WORD = 7
WIRE_ID_RAW48 = 0
WIRE_ID_COMPACT16 = 1


#: Cluster gossip mailbox (``cluster/mailbox.py``): the ring header
#: geometry with verdict-wire slots.  Header: magic, slots, slot bytes
#: (u64 each); each slot is a 4-word u32 header (seq lo/hi, entry count,
#: 0) and one ``[2K+4]`` compact verdict wire.
SHM_GOSSIP_MAGIC = 0x465358474F535331   # "FSXGOSS1"
GOSSIP_SLOT_HDR_WORDS = 4

#: Live shard-handoff mailbox (``cluster/rebalance.py``): the gossip
#: mailbox's SPSC geometry with row payloads.  Each slot is a 4-word u32
#: header (seq lo/hi, row count, slot kind) and ``rows_per_slot`` packed
#: table rows of ``1 + NUM_TABLE_COLS`` u32 words (the key, then the f32
#: state columns bit-cast); ``row_words`` rides the file header's 4th
#: u64.  The stream ends with one SEAL slot carrying the total row count
#: (u64 split) and a CRC32 of the shipped bytes in ship order.
SHM_HANDOFF_MAGIC = 0x4653584844464631  # "FSXHDFF1"
HANDOFF_SLOT_HDR_WORDS = 4
HANDOFF_KIND_ROWS = 0
HANDOFF_KIND_SEAL = 1

#: Engine-side handoff phase acks, written to ``STATUS_HANDOFF_OFFSET``
#: as ``handoff_id * 8 + HP_*``.
HP_SHIPPED = 1     # donor: span rows published and sealed
HP_STAGED = 2      # recipient: stream verified and spooled crash-safe
HP_DROPPED = 3     # donor: observed the flip, span rows dropped
HP_INSERTED = 4    # recipient: observed the flip, staged rows inserted

#: Multi-host gossip datagram (``cluster/transport.py``): a 9-word u32
#: header, then the same ``[2K+4]``-word compact verdict wire the shm
#: mailboxes carry (564 B at K=64, under any MTU).  The u64 sequence and
#: the u64 epoch wall stamp are split across two u32 words each, as in
#: the gossip mailbox's slot header.
NET_PKT_MAGIC = 0x4653584E              # "FSXN"
NET_MAGIC_WORD = 0
NET_KIND_WORD = 1
NET_HOST_WORD = 2                       # sender host id
NET_RANK_WORD = 3                       # sender rank (or NET_RANK_BEACON)
NET_SEQ_LO_WORD = 4                     # u64 per-peer wire seq, lo half
NET_SEQ_HI_WORD = 5
NET_COUNT_WORD = 6                      # verdicts in the wire payload
NET_T0_WALL_LO_WORD = 7                 # sender's epoch wall stamp, lo half
NET_T0_WALL_HI_WORD = 8
NET_PKT_HDR_WORDS = 9
#: Datagram kinds: a verdict wire, the peer-discovery handshake (HELLO,
#: retried with backoff; WELCOME answers) and the supervisors'
#: federation liveness beacon.
NET_KIND_WIRE = 1
NET_KIND_HELLO = 2
NET_KIND_WELCOME = 3
NET_KIND_BEACON = 4
#: The rank word of a supervisor beacon (no engine endpoint).
NET_RANK_BEACON = 0xFFFFFFFF

#: Cross-host epoch-skew bound (seconds) on rebased verdict wires: after
#: the tx-epoch -> rx-epoch rebase, a wire's ``now`` word must land
#: within this of the receiver's own clock.  Honest skew (NTP, transit,
#: tick batching) sums to well under a second, so 60 s trips only on a
#: lying epoch (a pre-reboot stamp, a host without clock discipline);
#: such wires are dropped and counted.  A default block lasts 10 s, so a
#: verdict 60 s out of frame has expired anyway.
RANGE_EPOCH_SKEW_S = 60

#: State columns of one table row and their names (``schema.TableCol``
#: in order; the checkpoint's ``table_<name>`` members), for the
#: numpy-only handoff and checkpoint readers.
TABLE_COLUMN_NAMES = (
    "last_seen", "win_start", "win_pps", "win_bps", "prev_pps", "prev_bps",
    "tokens", "tok_ts", "tok_bytes", "rec_seen", "ml_votes",
    "blocked_until")
NUM_TABLE_COLS = len(TABLE_COLUMN_NAMES)

#: Per-engine cluster status block (supervisor <-> engine lifecycle).
#: One writer side per field, split by writer onto cache lines: the
#: engine writes the line at 64.., the supervisor the line at 128...
SHM_STATUS_MAGIC = 0x4653585354415431   # "FSXSTAT1"
SHM_STATUS_SIZE = 192
STATUS_RANK_OFFSET = 8                  # u64, creator-written geometry
# engine-written line
STATUS_HBEAT_OFFSET = 64                # u64 CLOCK_MONOTONIC ns
STATUS_STATE_OFFSET = 72                # u64 CSTATE_*
STATUS_BATCHES_OFFSET = 80              # u64 batches served
STATUS_RECORDS_OFFSET = 88              # u64 records served
STATUS_PID_OFFSET = 96                  # u64 engine process id
#: The engine's handoff ack, ``handoff_id * 8 + HP_*`` (0: none).
STATUS_HANDOFF_OFFSET = 104
#: The last shard-assignment generation the engine converged on (the
#: supervisor lifts a fence once every live rank's ack matches).
STATUS_LAYOUT_ACK_OFFSET = 112
# supervisor-written line
STATUS_STOP_OFFSET = 128                # u64 drain-and-exit request
STATUS_GEN_OFFSET = 136                 # u64 restart generation
STATUS_T0_OFFSET = 144                  # u64 shared cluster epoch (ns)
STATUS_T0_WALL_OFFSET = 152             # u64 CLOCK_REALTIME ns at t0
#: The current shard-assignment generation, stamped on every rank after
#: the matching ``layout.json`` is published (the flip rule).
STATUS_LAYOUT_GEN_OFFSET = 160
#: The active handoff id: nonzero fences the moving shards (producers
#: route none of their new records until the flip or the abort).
STATUS_FENCE_OFFSET = 168

CSTATE_SPAWNING = 1
CSTATE_SERVING = 2
CSTATE_DONE = 3
CSTATE_FAILED = 4
#: Local serving finished, gossip still quiescing: every publish of
#: the engine happened before this store, so a peer that reads DRAINING
#: and an empty mailbox has merged everything the engine will say.
CSTATE_DRAINING = 5


def wire_id_of(wire: str) -> int:
    return WIRE_ID_COMPACT16 if wire == WIRE_COMPACT16 else WIRE_ID_RAW48


def shard_ring_path(base: str, shard: int, n_shards: int) -> str:
    """Feature-ring path of one shard — the naming contract with
    ``fsxd --shards N``.  One shard keeps the unsuffixed path, so one
    worker can front an unsharded daemon."""
    return str(base) if n_shards <= 1 else f"{base}.{shard}"


def shard_of(saddr, n_shards: int):
    """Shard of a folded source address: the IP-hash affinity both
    producers use (a Fibonacci hash, ``fsx_shard_of`` in the daemon), so
    a flow's records stay on one shard, in order."""
    h = (np.asarray(saddr, np.uint64) * np.uint64(2654435761)) >> np.uint64(16)
    return (h % np.uint64(n_shards)).astype(np.uint32)


#: One verdict-ring entry (engine -> daemon): a newly blocked source and
#: its expiry on the kernel clock.
VERDICT_RECORD_DTYPE = np.dtype(
    [
        ("saddr", "<u4"),      # folded source address
        ("_pad", "<u4"),
        ("until_ns", "<u8"),   # blacklist expiry, kernel clock ns
    ]
)
VERDICT_RECORD_SIZE = VERDICT_RECORD_DTYPE.itemsize  # 16


class Verdict(enum.IntEnum):
    """Per-record verdict codes (``FSX_VERDICT_*`` in the generated
    header; :mod:`.schema` re-exports it)."""

    PASS = 0
    DROP_BLACKLIST = 1
    DROP_RATE = 2
    DROP_ML = 3


# ---------------------------------------------------------------------------
# The kernel plane's structs (the eBPF programs' maps and the generated
# header; :mod:`flowsentryx_tpu_torch.bpf` and :mod:`.codegen` read them)
# ---------------------------------------------------------------------------

#: The eight features, in wire order (the kernel derives each from its
#: per-flow statistics; slots 3 and 4 are flow age and rate).
FEATURE_NAMES: tuple[str, ...] = (
    "destination_port",
    "packet_length_mean",
    "packet_length_std",
    "flow_duration_ms",
    "flow_pps_x1000",
    "fwd_iat_mean",
    "fwd_iat_std",
    "fwd_iat_max",
)

#: ``struct fsx_flow_stats``: the kernel's streaming per-flow sums, in
#: integer ns and byte units (the IAT sum of squares in µs², so that a
#: flow's worst-case gaps cannot wrap a u64).
FLOW_STATS_FIELDS: tuple[tuple[str, str], ...] = (
    ("pkt_count", "u64"),
    ("byte_sum", "u64"),
    ("byte_sq_sum", "u64"),
    ("first_ts_ns", "u64"),
    ("last_ts_ns", "u64"),
    ("iat_sum_ns", "u64"),
    ("iat_sq_sum_us2", "u64"),
    ("iat_max_ns", "u64"),
    ("dst_port", "u16"),
)

#: ``struct fsx_ip_state``: the kernel's per-source limiter state
#: (fixed and sliding windows, packet and byte token buckets; tokens
#: x1000), distinct from the device table's float columns.
IP_STATE_FIELDS: tuple[tuple[str, str], ...] = (
    ("win_start_ns", "u64"),
    ("win_pps", "u64"),
    ("win_bps", "u64"),
    ("prev_pps", "u64"),
    ("prev_bps", "u64"),
    ("tokens_milli", "u64"),
    ("tok_ts_ns", "u64"),
    ("tok_bytes", "u64"),
)

#: ``struct fsx_stats``: the kernel's global counters (a per-CPU array
#: map that readers sum over CPUs).  ``ml_pass`` and ``ml_escalated``
#: count the distilled scorer's confident-benign and uncertain bands.
KERNEL_STATS_FIELDS: tuple[tuple[str, str], ...] = (
    ("allowed", "u64"),
    ("dropped_blacklist", "u64"),
    ("dropped_rate", "u64"),
    ("dropped_ml", "u64"),
    ("dropped_rule", "u64"),
    ("ml_pass", "u64"),
    ("ml_escalated", "u64"),
)

_TYPE_SIZES = {"u64": 8, "u32": 4, "u16": 2, "u8": 1}


class FieldLayout(NamedTuple):
    """One field of a packed struct: byte offset, element size, count."""

    name: str
    offset: int
    size: int       # size of ONE element
    count: int = 1  # > 1 for array fields


class StructLayout(NamedTuple):
    """A packed struct: total size and per-field offsets."""

    name: str
    size: int
    fields: tuple[FieldLayout, ...]

    def offset_of(self, field: str) -> int:
        for f in self.fields:
            if f.name == field:
                return f.offset
        raise KeyError(f"{self.name} has no field {field!r}")


def _layout_from_fields(
    cname: str, fields: tuple[tuple[str, str], ...]
) -> StructLayout:
    out, off = [], 0
    for name, tp in fields:
        size = _TYPE_SIZES[tp]
        out.append(FieldLayout(name, off, size))
        off += size
    return StructLayout(cname, off, tuple(out))


def _layout_from_dtype(cname: str, dt: np.dtype) -> StructLayout:
    out = []
    for name in dt.names:
        ft, off = dt.fields[name][:2]
        if ft.subdtype is not None:
            base, shape = ft.subdtype
            out.append(FieldLayout(name, off, base.itemsize, shape[0]))
        else:
            out.append(FieldLayout(name, off, ft.itemsize))
    return StructLayout(cname, dt.itemsize, tuple(out))


def struct_layouts() -> dict[str, StructLayout]:
    """Every packed struct of the kernel/user/device seam, keyed by its
    C name: the layouts codegen writes into ``kern/fsx_schema.h``, the
    eBPF programs bake into immediates and the decoders read.  ``fsx
    check`` diffs every layer against this one definition."""
    from flowsentryx_tpu_torch.core.config import FsxConfig

    shm_hdr = StructLayout(
        "fsx_shm_ring_hdr", SHM_HDR_SIZE, (
            FieldLayout("magic", 0, 8),
            FieldLayout("capacity", SHM_CAPACITY_OFFSET, 8),
            FieldLayout("record_size", SHM_RECORD_SIZE_OFFSET, 8),
            FieldLayout("_meta_pad", 24, 8, 5),
            FieldLayout("head", SHM_HEAD_OFFSET, 8),
            FieldLayout("_head_pad", SHM_HEAD_OFFSET + 8, 8, 7),
            FieldLayout("tail", SHM_TAIL_OFFSET, 8),
            FieldLayout("_tail_pad", SHM_TAIL_OFFSET + 8, 8, 7),
        ))
    ml_model = StructLayout(
        "fsx_ml_model", ML_MODEL_SIZE, (
            FieldLayout("valid", ML_MODEL_VALID_OFFSET, 4),
            FieldLayout("_reserved", ML_MODEL_FLAGS_OFFSET, 4),
            FieldLayout("acc_drop", ML_MODEL_ACC_DROP_OFFSET, 8),
            FieldLayout("acc_pass", ML_MODEL_ACC_PASS_OFFSET, 8),
            FieldLayout("w", ML_MODEL_W_OFFSET, 4, NUM_FEATURES),
            FieldLayout("qbase", ML_MODEL_QBASE_OFFSET, 4, NUM_FEATURES),
            FieldLayout("bounds_m1", ML_MODEL_BOUNDS_OFFSET, 4,
                        NUM_FEATURES * ML_BOUNDS_PER_FEATURE),
        ))
    return {
        "fsx_config": _layout_from_fields(
            "fsx_config",
            tuple((n, t) for n, t, _ in FsxConfig.KERNEL_CONFIG_FIELDS)),
        "fsx_ml_model": ml_model,
        "fsx_ip_state": _layout_from_fields("fsx_ip_state",
                                            IP_STATE_FIELDS),
        "fsx_flow_stats": _layout_from_fields("fsx_flow_stats",
                                              FLOW_STATS_FIELDS),
        "fsx_stats": _layout_from_fields("fsx_stats",
                                         KERNEL_STATS_FIELDS),
        "fsx_flow_record": _layout_from_dtype("fsx_flow_record",
                                              FLOW_RECORD_DTYPE),
        "fsx_compact_record": _layout_from_dtype("fsx_compact_record",
                                                 COMPACT_RECORD_DTYPE),
        "fsx_verdict_record": _layout_from_dtype("fsx_verdict_record",
                                                 VERDICT_RECORD_DTYPE),
        "fsx_shm_ring_hdr": shm_hdr,
    }


#: Kernel rule map capacity (exact and wildcard (proto, dport) entries).
MAX_RULES = 1024
#: Rule action codes (the rule map's value).
RULE_DROP = 1


def pack_rule_key(proto: int, dport: int) -> int:
    """Rule-map key: ``(l4_proto << 16) | dport`` in HOST order, 0 the
    wildcard in either position, as the kernel computes it per packet."""
    return ((proto & 0xFF) << 16) | (dport & 0xFFFF)
