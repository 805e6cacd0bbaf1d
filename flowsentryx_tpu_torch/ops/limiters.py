"""Rate limiters as vectorized state transitions over per-flow deltas.

Counterpart of ``flowsentryx_tpu/ops/limiters.py``: fixed window,
sliding window and a dual (packets, bytes) token bucket, each a pure
function of ``(state slice, deltas, now)``.  Config scalars enter as
float32-rounded constants (:func:`~flowsentryx_tpu_torch.core.device.f32`)
and each ``x * y + z`` the reference's compiled graph fuses is one
:func:`~flowsentryx_tpu_torch.core.device.fma32`, so every state column
rounds exactly as the reference's.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from flowsentryx_tpu_torch.core.config import LimiterConfig, LimiterKind
from flowsentryx_tpu_torch.core.device import f32, fma32, recip_mul


class WindowState(NamedTuple):
    win_start: torch.Tensor
    win_pps: torch.Tensor
    win_bps: torch.Tensor
    prev_pps: torch.Tensor
    prev_bps: torch.Tensor


class BucketState(NamedTuple):
    tokens: torch.Tensor
    tok_ts: torch.Tensor
    tok_bytes: torch.Tensor


class LimiterDecision(NamedTuple):
    window: WindowState
    bucket: BucketState
    over_limit: torch.Tensor  # [R] bool


def fixed_window(cfg: LimiterConfig, st: WindowState, d_pkts, d_bytes, now
                 ) -> tuple[WindowState, torch.Tensor]:
    """A window past its edge reopens seeded with this batch's delta."""
    expired = now - st.win_start >= f32(cfg.window_s)
    pps = torch.where(expired, d_pkts, st.win_pps + d_pkts)
    bps = torch.where(expired, d_bytes, st.win_bps + d_bytes)
    start = torch.where(expired, now, st.win_start)
    over = (pps > f32(cfg.pps_threshold)) | (bps > f32(cfg.bps_threshold))
    return WindowState(start, pps, bps, st.prev_pps, st.prev_bps), over


def _py_mod(x: torch.Tensor, m: float) -> torch.Tensor:
    """Python-style float modulus (sign of the divisor), written out as
    the reference's ``jnp.mod`` computes it."""
    r = torch.fmod(x, m)
    return torch.where((r != 0) & ((r < 0) != (m < 0)), r + m, r)


def sliding_window(cfg: LimiterConfig, st: WindowState, d_pkts, d_bytes, now
                   ) -> tuple[WindowState, torch.Tensor]:
    """Two-bucket sliding estimate ``prev * overlap + cur``."""
    w = f32(cfg.window_s)
    w2 = f32(2 * cfg.window_s)
    elapsed = now - st.win_start
    rolled_one = (elapsed >= w) & (elapsed < w2)
    rolled_many = elapsed >= w2
    zero = torch.zeros_like(st.prev_pps)
    prev_pps = torch.where(rolled_one, st.win_pps,
                           torch.where(rolled_many, zero, st.prev_pps))
    prev_bps = torch.where(rolled_one, st.win_bps,
                           torch.where(rolled_many, zero, st.prev_bps))
    rolled = rolled_one | rolled_many
    now_b = torch.broadcast_to(now, st.win_start.shape)
    start = torch.where(
        rolled_many, now_b - _py_mod(now_b, w),
        torch.where(rolled_one, st.win_start + w, st.win_start))
    pps = torch.where(rolled, d_pkts, st.win_pps + d_pkts)
    bps = torch.where(rolled, d_bytes, st.win_bps + d_bytes)
    frac = torch.clamp(recip_mul(now - start, cfg.window_s), 0.0, 1.0)
    overlap = 1.0 - frac
    est_pps = fma32(prev_pps, overlap, pps)
    est_bps = fma32(prev_bps, overlap, bps)
    over = ((est_pps > f32(cfg.pps_threshold))
            | (est_bps > f32(cfg.bps_threshold)))
    return WindowState(start, pps, bps, prev_pps, prev_bps), over


def token_bucket(cfg: LimiterConfig, st: BucketState, d_pkts, d_bytes, now,
                 is_new: torch.Tensor | None = None
                 ) -> tuple[BucketState, torch.Tensor]:
    """Dual-dimension bucket (packets + bytes, one refill stamp);
    freshly claimed slots start full."""
    elapsed = now - st.tok_ts
    burst = f32(cfg.bucket_burst)
    tokens = torch.clamp(fma32(elapsed, f32(cfg.bucket_rate_pps), st.tokens),
                         max=burst)
    if is_new is not None:
        tokens = torch.where(is_new, torch.full_like(tokens, burst), tokens)
    over = tokens < d_pkts
    tokens = torch.clamp(tokens - d_pkts, min=0.0)
    if cfg.bucket_burst_bytes > 0:
        bburst = f32(cfg.bucket_burst_bytes)
        btokens = torch.clamp(
            fma32(elapsed, f32(cfg.bucket_rate_bps), st.tok_bytes),
            max=bburst)
        if is_new is not None:
            btokens = torch.where(is_new, torch.full_like(btokens, bburst),
                                  btokens)
        over = over | (btokens < d_bytes)
        btokens = torch.clamp(btokens - d_bytes, min=0.0)
    else:
        btokens = st.tok_bytes
    tok_ts = torch.broadcast_to(now, st.tok_ts.shape)
    return BucketState(tokens, tok_ts, btokens), over


def apply_limiter(cfg: LimiterConfig, window: WindowState,
                  bucket: BucketState, d_pkts, d_bytes, now,
                  is_new: torch.Tensor | None = None) -> LimiterDecision:
    if cfg.kind is LimiterKind.FIXED_WINDOW:
        window, over = fixed_window(cfg, window, d_pkts, d_bytes, now)
    elif cfg.kind is LimiterKind.SLIDING_WINDOW:
        window, over = sliding_window(cfg, window, d_pkts, d_bytes, now)
    elif cfg.kind is LimiterKind.TOKEN_BUCKET:
        bucket, over = token_bucket(cfg, bucket, d_pkts, d_bytes, now, is_new)
    else:  # pragma: no cover
        raise ValueError(f"unknown limiter kind {cfg.kind}")
    return LimiterDecision(window, bucket, over)
