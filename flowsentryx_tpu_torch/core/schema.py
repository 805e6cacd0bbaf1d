"""Shared schemas of the port: record layout, verdicts, device state,
and the compact16 wire.

Counterpart of ``flowsentryx_tpu/core/schema.py`` (the subset the
serving path needs), kept as this package's own copy — the port imports
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

from flowsentryx_tpu_torch.core.device import f32, fma32, u32, xla_exp2

# ---------------------------------------------------------------------------
# Feature vector and flow record
# ---------------------------------------------------------------------------

NUM_FEATURES: int = 8


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


FLAG_TCP_SYN = 1 << 1
FLAG_TCP = 1 << 2

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


class Verdict(enum.IntEnum):
    PASS = 0
    DROP_BLACKLIST = 1
    DROP_RATE = 2
    DROP_ML = 3


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
# The compact16 wire
# ---------------------------------------------------------------------------

COMPACT_RECORD_WORDS = 4

RANGE_FEAT_Q8_MAX = 255
RANGE_FLAGS_MAX = 0x1F
RANGE_LEN8_MAX = 0x7FF
RANGE_DT_US_MAX = 0xFFFF


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


_TS_HI_S = f32(4294.967296)   # 2^32 µs in seconds
_US = f32(1e-6)


def decode_compact(
    raw: torch.Tensor,
    *,
    feat_mode: str = "minifloat",
    in_scale: float = 1.0,
    in_zp: int = 0,
    log1p: bool = False,
) -> FeatureBatch:
    """Device-side decode of the compact wire (``raw``: ``[B+1, 4]``
    int32 bit patterns of the uint32 words).

    The timestamp recombination ``hi·2^32·1e-6 + lo·1e-6 + dt·1e-6``
    rounds exactly as the reference's XLA:CPU build does, which fuses
    each multiply into the following add (:func:`fma32`)."""
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
    if feat_mode == "model":
        feat = (q.float() - f32(in_zp)) * f32(in_scale)
        if log1p:
            feat = torch.expm1(feat)
    elif feat_mode == "minifloat":
        e = torch.div(q, 8, rounding_mode="floor") - 1
        m = q % 8
        big = (8.0 + m.float()) * xla_exp2(e.float())
        feat = torch.where(q < 8, q.float(), big)
    else:
        raise ValueError(f"unknown feat_mode {feat_mode!r}")
    b = words.shape[0]
    return FeatureBatch(
        key=words[:, 0],
        feat=feat,
        pkt_len=((w3 & RANGE_LEN8_MAX) << 3).float(),
        ts=fma32((w3 >> 16).float(), _US, base),
        valid=torch.arange(b, device=raw.device) < n,
    )


def wire_to_tensor(raw: np.ndarray) -> torch.Tensor:
    """A host uint32 wire buffer -> an int32 bit-pattern tensor sharing
    its memory (zero-copy view)."""
    return torch.from_numpy(np.ascontiguousarray(raw).view(np.int32))

