"""Shared schemas of the port: verdicts, device state, and the device
side of both wires (the host side and the shared-memory layout live in
:mod:`.wire`, numpy only, and are re-exported here).

Counterpart of ``flowsentryx_tpu/core/schema.py`` (the serving path's
subset, and through :mod:`.wire` the kernel plane's structs:
``FEATURE_NAMES``, the ``*_FIELDS`` tuples, :func:`struct_layouts`,
``MAX_RULES``, ``RULE_*``, :func:`pack_rule_key`), kept as this package's
own copy — the port imports
nothing of the reference.  Three representation choices differ from the
reference and are converted at the boundary
(:func:`table_from_numpy`/:func:`table_to_numpy`,
:func:`stats_from_numpy`/:func:`stats_to_numpy`):

* uint32 quantities (keys, wire words) live in memory as **int32 bit
  patterns**; u32 arithmetic runs in int64 masked to 32 bits
  (:func:`~flowsentryx_tpu_torch.core.device.u32`).
* the state table carries ONE extra "park" row past ``capacity``: the
  reference's ``mode="drop"`` scatters route losing lanes out of bounds,
  torch's ``index_put_`` cannot, so losers write the park row instead.
* each :class:`GlobalStats` counter is one 0-d int64 tensor instead of
  the reference's ``[2]`` uint32 ``(lo, hi)`` pair.
"""

from __future__ import annotations

import enum
from typing import NamedTuple

import numpy as np
import torch

from flowsentryx_tpu_torch.core.device import (
    f32, fma32, u32, xla_exp2, xla_expm1,
)
# the host half of the wires and the shm layout (numpy only), re-exported
from flowsentryx_tpu_torch.core.wire import (  # noqa: F401
    BATCHQ_FILL_DUR_US_WORD, BATCHQ_N_RECORDS_WORD, BATCHQ_RESERVED_WORD,
    BATCHQ_SEAL_NS_HI_WORD, BATCHQ_SEAL_NS_LO_WORD, BATCHQ_SEQ_HI_WORD,
    BATCHQ_SEQ_LO_WORD, BATCHQ_SLOT_HDR_WORDS, BATCHQ_WIRE_ID_WORD,
    FEATURE_NAMES, FLOW_STATS_FIELDS, IP_STATE_FIELDS, KERNEL_STATS_FIELDS,
    MAX_RULES, RULE_DROP, FieldLayout, StructLayout, Verdict,
    pack_rule_key, struct_layouts,
    COMPACT_RECORD_DTYPE, COMPACT_RECORD_SIZE, COMPACT_RECORD_WORDS,
    FLAG_ICMP, FLAG_IPV6, FLAG_TCP, FLAG_TCP_SYN, FLAG_UDP,
    FLOW_RECORD_DTYPE, FLOW_RECORD_SIZE, ML_BAND_DISABLED, ML_BAND_DROP,
    ML_BAND_ESCALATE, ML_BAND_PASS, ML_BOUNDS_PER_FEATURE,
    ML_MODEL_ACC_DROP_OFFSET, ML_MODEL_ACC_PASS_OFFSET,
    ML_MODEL_BOUNDS_OFFSET, ML_MODEL_FLAGS_OFFSET, ML_MODEL_QBASE_OFFSET,
    ML_MODEL_SIZE, ML_MODEL_VALID_OFFSET, ML_MODEL_W_OFFSET,
    NET_COUNT_WORD, NET_HOST_WORD, NET_KIND_BEACON, NET_KIND_HELLO,
    NET_KIND_WELCOME, NET_KIND_WIRE, NET_KIND_WORD, NET_MAGIC_WORD,
    NET_PKT_HDR_WORDS, NET_PKT_MAGIC, NET_RANK_BEACON, NET_RANK_WORD,
    NET_SEQ_HI_WORD, NET_SEQ_LO_WORD, NET_T0_WALL_HI_WORD,
    NET_T0_WALL_LO_WORD, NUM_FEATURES, RANGE_DEPLOY_HORIZON_S,
    RANGE_DT_US_MAX, RANGE_EPOCH_SKEW_S, RANGE_FEAT_Q8_MAX,
    RANGE_FLAGS_MAX, RANGE_LEN8_MAX, RANGE_PKT_LEN_MAX, RECORD_WORDS,
    SHM_BATCHQ_MAGIC, SHM_CAPACITY_OFFSET, SHM_EMIT_DROP_OFFSET,
    SHM_FIRST_TS_OFFSET, SHM_HBEAT_OFFSET, SHM_HDR_SIZE, SHM_HEAD_OFFSET,
    SHM_IDLE_US_OFFSET, SHM_MAGIC, SHM_RECORD_SIZE_OFFSET,
    SHM_SPIN_US_OFFSET, SHM_STOP_OFFSET, SHM_T0_OFFSET, SHM_TAIL_OFFSET,
    SHM_WSTATE_OFFSET, VERDICT_RECORD_DTYPE, VERDICT_RECORD_SIZE,
    WIRE_COMPACT16, WIRE_ID_COMPACT16, WIRE_ID_RAW48, WIRE_RAW48,
    WSTATE_DONE, WSTATE_FAILED, WSTATE_RUNNING, WSTATE_SPAWNING,
    _minifloat_lut, _minifloat_q8, _minifloat_ref, compact_pack,
    encode_compact, encode_raw, model_quant_args, quantize_feat_minifloat,
    quantize_feat_model, shard_of, shard_ring_path, unwrap_kernel_ts16,
    wire_id_of, wire_quant_for,
)

# ---------------------------------------------------------------------------
# Feature vector and verdicts
# ---------------------------------------------------------------------------


class Feature(enum.IntEnum):
    """Index of each feature within the 8-wide vector."""

    DST_PORT = 0
    PKT_LEN_MEAN = 1
    PKT_LEN_STD = 2
    FLOW_DUR_MS = 3
    FLOW_PPS_X1000 = 4
    FWD_IAT_MEAN = 5
    FWD_IAT_STD = 6
    FWD_IAT_MAX = 7


# ---------------------------------------------------------------------------
# Device-side state
# ---------------------------------------------------------------------------


class TableCol(enum.IntEnum):
    """Column of each per-flow f32 quantity in ``IpTableState.state``."""

    LAST_SEEN = 0
    WIN_START = 1
    WIN_PPS = 2
    WIN_BPS = 3
    PREV_PPS = 4
    PREV_BPS = 5
    TOKENS = 6
    TOK_TS = 7
    TOK_BYTES = 8
    REC_SEEN = 9
    ML_VOTES = 10
    BLOCKED_UNTIL = 11


NUM_TABLE_COLS = len(TableCol)


class IpTableState(NamedTuple):
    """Per-IP state table resident on the device, updated in place.

    ``key_rows``/``state_rows`` hold ``capacity + 1`` rows: row
    ``capacity`` is the park row that scatter losers write (module
    docstring) and that no reader ever looks at.  Use the ``key`` and
    ``state`` views for the table proper."""

    key_rows: torch.Tensor    # [capacity + 1] int32 (u32 bit patterns)
    state_rows: torch.Tensor  # [capacity + 1, NUM_TABLE_COLS] float32

    @property
    def capacity(self) -> int:
        return self.key_rows.shape[0] - 1

    @property
    def key(self) -> torch.Tensor:
        return self.key_rows[:-1]

    @property
    def state(self) -> torch.Tensor:
        return self.state_rows[:-1]

    @property
    def last_seen(self) -> torch.Tensor:
        return self.state[:, TableCol.LAST_SEEN]

    @property
    def park(self) -> int:
        """Row index of the park row."""
        return self.key_rows.shape[0] - 1

    @staticmethod
    def at(local: torch.Tensor) -> torch.Tensor:
        """Row indices of ``key_rows``/``state_rows`` for table slots
        (the identity here; a :class:`TableShard` adds its offset)."""
        return local

    def shard(self, row0: int, rows: int) -> "TableShard":
        """Rows ``[row0, row0 + rows)`` as a table of their own, in place."""
        return TableShard(self.key_rows, self.state_rows, row0, rows)


class TableShard(NamedTuple):
    """One shard of a row-sharded table: slots ``0..rows-1`` are rows
    ``row0..row0+rows-1`` of the one table, written in place.  It has no
    park row of its own: losers write the table's (:attr:`park`), never
    row ``rows``, which is the next shard's first.  Readers use the
    ``key``/``state`` views and writers index ``key_rows``/``state_rows``
    with :meth:`at`, as for :class:`IpTableState`."""

    key_rows: torch.Tensor    # the whole table's, park row included
    state_rows: torch.Tensor
    row0: int
    rows: int

    @property
    def capacity(self) -> int:
        return self.rows

    @property
    def key(self) -> torch.Tensor:
        return self.key_rows[self.row0:self.row0 + self.rows]

    @property
    def state(self) -> torch.Tensor:
        return self.state_rows[self.row0:self.row0 + self.rows]

    @property
    def last_seen(self) -> torch.Tensor:
        return self.state[:, TableCol.LAST_SEEN]

    @property
    def park(self) -> int:
        return self.key_rows.shape[0] - 1

    def at(self, local: torch.Tensor) -> torch.Tensor:
        return local + self.row0


def make_table(capacity: int, device: str | torch.device = "cpu"
               ) -> IpTableState:
    """Fresh, empty state table with ``capacity`` slots (power of two)."""
    if capacity <= 0 or capacity & (capacity - 1):
        raise ValueError(f"capacity must be a power of two, got {capacity}")
    return IpTableState(
        key_rows=torch.zeros(capacity + 1, dtype=torch.int32, device=device),
        state_rows=torch.zeros(capacity + 1, NUM_TABLE_COLS,
                               dtype=torch.float32, device=device),
    )


def table_from_numpy(key: np.ndarray, state: np.ndarray,
                     device: str | torch.device = "cpu") -> IpTableState:
    """Reference table arrays (``[N]`` uint32 key, ``[N, 12]`` f32
    state) -> the port's table on ``device``."""
    key = np.ascontiguousarray(key, np.uint32)
    state = np.ascontiguousarray(state, np.float32)
    t = make_table(key.shape[0], device)
    t.key.copy_(torch.from_numpy(key.view(np.int32)))
    t.state.copy_(torch.from_numpy(state))
    return t


def table_to_numpy(table: IpTableState) -> tuple[np.ndarray, np.ndarray]:
    """The port's table -> reference layout (``[N]`` uint32, ``[N, 12]``
    f32), park row dropped."""
    return (table.key.cpu().numpy().view(np.uint32).copy(),
            table.state.cpu().numpy().copy())


class GlobalStats(NamedTuple):
    """Global counters, each one 0-d int64 tensor updated in place (the
    reference pairs two uint32 words per counter because its backend
    has no 64-bit integers; torch does)."""

    allowed: torch.Tensor
    dropped_blacklist: torch.Tensor
    dropped_rate: torch.Tensor
    dropped_ml: torch.Tensor
    batches: torch.Tensor
    evicted: torch.Tensor

    def to_dict(self) -> dict:
        d = {f: stat_value(getattr(self, f)) for f in self._fields}
        d["dropped"] = (d["dropped_blacklist"] + d["dropped_rate"]
                        + d["dropped_ml"])
        return d


def make_stats(device: str | torch.device = "cpu") -> GlobalStats:
    return GlobalStats(*(torch.zeros((), dtype=torch.int64, device=device)
                         for _ in GlobalStats._fields))


def stat_value(field: torch.Tensor) -> int:
    """Host-side read of one counter as a Python int."""
    return int(field.item())


def stats_from_numpy(pairs: dict, device: str | torch.device = "cpu"
                     ) -> GlobalStats:
    """Reference counters (``{field: [lo, hi] uint32}``) -> the port's."""
    return GlobalStats(*(
        torch.tensor(int(np.asarray(pairs[f])[0])
                     + (int(np.asarray(pairs[f])[1]) << 32),
                     dtype=torch.int64, device=device)
        for f in GlobalStats._fields))


def stats_to_numpy(stats: GlobalStats) -> dict:
    """The port's counters -> the reference's ``(lo, hi)`` uint32 pairs."""
    out = {}
    for f in GlobalStats._fields:
        v = stat_value(getattr(stats, f))
        out[f] = np.array([v & 0xFFFFFFFF, (v >> 32) & 0xFFFFFFFF], np.uint32)
    return out


class FeatureBatch(NamedTuple):
    """One decoded micro-batch (SoA, padded to the static batch size)."""

    key: torch.Tensor      # [B] int64 holding the uint32 source key
    feat: torch.Tensor     # [B, 8] float32
    pkt_len: torch.Tensor  # [B] float32 bytes
    ts: torch.Tensor       # [B] float32 seconds (engine-epoch relative)
    valid: torch.Tensor    # [B] bool


# ---------------------------------------------------------------------------
# The raw48 wire
# ---------------------------------------------------------------------------

_NS = f32(1e-9)
_TS_HI_NS = f32(4.294967296)   # 2^32 ns in seconds


def decode_raw(raw: torch.Tensor) -> FeatureBatch:
    """Device-side decode of the raw48 wire (``raw``: ``[B+1, 12]`` int32
    bit patterns of the uint32 words).

    Words 4-11 (features) and the ``pkt_len`` field are u32 and convert
    to f32 as unsigned (a feature word of 2^31 or more stays positive).
    The timestamp ``dhi * 4.294967296 + (lo * 1e-9 - t0_lo * 1e-9)``,
    ``dhi`` the wrapped u32 difference of the high words read as int32,
    rounds as the reference's XLA:CPU build does: ``t0_lo * 1e-9`` is
    rounded, ``lo * 1e-9`` fuses into the subtraction, and the
    ``dhi`` term fuses into the final add (:func:`fma32`)."""
    words = u32(raw[:-1])
    meta = u32(raw[-1])
    n = meta[0]
    t0_lo = meta[1].float()
    dhi = (words[:, 1] - meta[2]) & 0xFFFFFFFF
    dhi = torch.where(dhi >= 1 << 31, dhi - (1 << 32), dhi).float()
    inner = fma32(words[:, 0].float(), _NS, -(t0_lo * _NS))
    b = words.shape[0]
    return FeatureBatch(
        key=words[:, 2],
        feat=words[:, 4:12].float(),
        pkt_len=(words[:, 3] & RANGE_PKT_LEN_MAX).float(),
        ts=fma32(dhi, _TS_HI_NS, inner),
        valid=torch.arange(b, device=raw.device) < n,
    )


# ---------------------------------------------------------------------------
# The compact16 wire
# ---------------------------------------------------------------------------

_TS_HI_S = f32(4294.967296)   # 2^32 µs in seconds
_US = f32(1e-6)


def feature_table(device, *, feat_mode: str = "minifloat",
                  in_scale: float = 1.0, in_zp: int = 0,
                  log1p: bool = False) -> torch.Tensor:
    """The decoded float32 feature of each of the 256 compact16 codes:
    model mode ``(q - zp) * scale`` (and XLA's ``expm1`` of it for a
    log1p artifact), or the minifloat ``q < 8 ? q : (8 + q%8) *
    exp2(q//8 - 1)`` with XLA's ``exp2``.  A feature depends on its code
    alone, so the decode is one gather from this table, the same bits as
    computing each feature (the table is that computation on every
    code)."""
    q = torch.arange(256, device=device)
    if feat_mode == "model":
        feat = (q.float() - f32(in_zp)) * f32(in_scale)
        return xla_expm1(feat) if log1p else feat
    if feat_mode == "minifloat":
        e = torch.div(q, 8, rounding_mode="floor") - 1
        big = (8.0 + (q % 8).float()) * xla_exp2(e.float())
        return torch.where(q < 8, q.float(), big)
    raise ValueError(f"unknown feat_mode {feat_mode!r}")


def decode_compact(
    raw: torch.Tensor,
    *,
    feat_mode: str = "minifloat",
    in_scale: float = 1.0,
    in_zp: int = 0,
    log1p: bool = False,
    table: torch.Tensor | None = None,
) -> FeatureBatch:
    """Device-side decode of the compact wire (``raw``: ``[B+1, 4]``
    int32 bit patterns of the uint32 words).  ``table`` is the
    :func:`feature_table` of these quantizer arguments, built once by
    the caller (None builds it here).

    The timestamp recombination ``hi·2^32·1e-6 + lo·1e-6 + dt·1e-6``
    rounds exactly as the reference's XLA:CPU build does, which fuses
    each multiply into the following add (:func:`fma32`)."""
    if table is None:
        table = feature_table(raw.device, feat_mode=feat_mode,
                              in_scale=in_scale, in_zp=in_zp, log1p=log1p)
    words = u32(raw[:-1])
    meta = u32(raw[-1])
    n = meta[0]
    base = fma32(meta[2].float(), _TS_HI_S, meta[1].float() * _US)
    w1, w2, w3 = words[:, 1], words[:, 2], words[:, 3]
    q8 = RANGE_FEAT_Q8_MAX
    q = torch.stack(
        [
            w1 & q8, (w1 >> 8) & q8, (w1 >> 16) & q8, w1 >> 24,
            w2 & q8, (w2 >> 8) & q8, (w2 >> 16) & q8, w2 >> 24,
        ],
        dim=1,
    )
    b = words.shape[0]
    return FeatureBatch(
        key=words[:, 0],
        feat=table[q],
        pkt_len=((w3 & RANGE_LEN8_MAX) << 3).float(),
        ts=fma32((w3 >> 16).float(), _US, base),
        valid=torch.arange(b, device=raw.device) < n,
    )


def wire_to_tensor(raw: np.ndarray) -> torch.Tensor:
    """A host uint32 wire buffer -> an int32 bit-pattern tensor sharing
    its memory (zero-copy view)."""
    return torch.from_numpy(np.ascontiguousarray(raw).view(np.int32))

