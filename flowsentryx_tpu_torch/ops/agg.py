"""Per-flow aggregation of a micro-batch: one stable sort + segment ops.

Counterpart of ``flowsentryx_tpu/ops/agg.py``.  Segment reductions are
``index_add_`` / ``scatter_reduce`` where the order cannot matter:
counts, and on the compact16 wire the byte sums too (``pkt_len`` in
multiples of 8 up to 16376 per record, so a 2048-record flow stays below
2^27 and every partial sum is exact in float32), so the sums are the
same in any order, the atomic, unordered order of CUDA's ``index_add_``
included.  Segment maxima are order-independent by nature.

On the raw48 wire ``pkt_len`` goes up to 65535 and one flow's bytes can
pass 2^24, where the f32 sum depends on its order.  The reference's
``segment_sum`` adds the sorted lanes one after another (an XLA:CPU
scatter-add), so the raw48 step sums bytes in that order
(:func:`segment_sum_seq_plain`, and the CUDA kernel
``ops/kernels.py::segment_sum_seq`` on the card).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

#: Sentinel sorted past every real key (255.255.255.255).
INVALID_KEY = 0xFFFFFFFF


class FlowAgg(NamedTuple):
    rep_key: torch.Tensor    # [B] int64 uint32 values, INVALID_KEY padded
    rep_pkts: torch.Tensor   # [B] f32
    rep_bytes: torch.Tensor  # [B] f32
    rep_ts: torch.Tensor     # [B] f32
    rep_valid: torch.Tensor  # [B] bool
    inv: torch.Tensor        # [B] int64: packet -> segment index


class KeySegments(NamedTuple):
    order: torch.Tensor
    sorted_key: torch.Tensor
    heads: torch.Tensor
    seg: torch.Tensor
    inv: torch.Tensor


def run_heads(sorted_vals: torch.Tensor) -> torch.Tensor:
    """True at each run start of a sorted vector."""
    heads = torch.ones_like(sorted_vals, dtype=torch.bool)
    heads[1:] = sorted_vals[1:] != sorted_vals[:-1]
    return heads


def segment_by_key(k: torch.Tensor) -> KeySegments:
    """Group equal keys into contiguous segments via one stable sort."""
    sk, order = torch.sort(k, stable=True)
    heads = run_heads(sk)
    seg = torch.cumsum(heads, 0) - 1
    inv = torch.empty_like(seg).scatter_(0, order, seg)
    return KeySegments(order=order, sorted_key=sk, heads=heads, seg=seg,
                       inv=inv)


def segment_sum(v: torch.Tensor, seg: torch.Tensor, n: int) -> torch.Tensor:
    """Exact-integer float sums per segment (module docstring)."""
    return torch.zeros(n, dtype=v.dtype, device=v.device).index_add_(
        0, seg, v)


def segment_sum_seq_plain(v: torch.Tensor, seg: torch.Tensor, n: int
                          ) -> torch.Tensor:
    """``[n]`` f32 sums of ``v`` per segment, each segment added left to
    right from 0 in f32 (``seg`` non-decreasing).  One pass per position
    within a segment: pass ``j`` adds the ``j``-th lane of every segment
    at once (distinct targets), so each add rounds once, in lane order.
    Reads the longest segment's length on the host."""
    out = torch.zeros(n, dtype=torch.float32, device=v.device)
    b = v.shape[0]
    if b == 0:
        return out
    lane = torch.arange(b, device=v.device)
    start = torch.cummax(torch.where(run_heads(seg), lane, 0), 0).values
    pos = lane - start
    by_pos = torch.sort(pos, stable=True).indices
    ends = torch.bincount(pos).cumsum(0).tolist()
    lo = 0
    for hi in ends:
        sl = by_pos[lo:hi]
        idx = seg[sl]
        out[idx] = out[idx] + v[sl].float()
        lo = hi
    return out


def segment_max(v: torch.Tensor, seg: torch.Tensor, n: int,
                empty) -> torch.Tensor:
    """Per-segment max; segments with no element read ``empty`` (the
    reference's segment_max identity: -inf, or the dtype's minimum)."""
    out = torch.full((n,), empty, dtype=v.dtype, device=v.device)
    return out.scatter_reduce_(0, seg, v, "amax", include_self=False)


def segment_sum_cols(v: torch.Tensor, seg: torch.Tensor, n: int
                     ) -> torch.Tensor:
    """:func:`segment_sum` of each column of ``[B, C]`` in one pass."""
    return torch.zeros(n, v.shape[1], dtype=v.dtype,
                       device=v.device).index_add_(0, seg, v)


def segment_max_cols(v: torch.Tensor, seg: torch.Tensor, n: int,
                     empty) -> torch.Tensor:
    """:func:`segment_max` of each column of ``[B, C]`` in one pass."""
    out = torch.full((n, v.shape[1]), empty, dtype=v.dtype, device=v.device)
    idx = seg[:, None].expand(-1, v.shape[1])
    return out.scatter_reduce_(0, idx, v, "amax", include_self=False)


def aggregate(key: torch.Tensor, pkt_len: torch.Tensor, ts: torch.Tensor,
              valid: torch.Tensor, byte_sum=segment_sum) -> FlowAgg:
    """Group a ``[B]`` packet batch by source key (uint32 values in
    int64).  Key 0 (the empty-slot sentinel) is remapped to 0xFFFFFFFE
    so a spoofed 0.0.0.0 is tracked like any other source.  ``byte_sum``
    sums the sorted byte lanes per segment: pass the lane-order sum
    (``kernels.segment_sum_seq``) where a flow's bytes can pass 2^24."""
    b = key.shape[0]
    key = torch.where(key == 0, torch.full_like(key, 0xFFFFFFFE), key)
    k = torch.where(valid, key, torch.full_like(key, INVALID_KEY))
    ks = segment_by_key(k)
    order, sk, seg = ks.order, ks.sorted_key, ks.seg
    sv = valid[order]
    pkts = segment_sum(sv.float(), seg, b)
    bytes_ = byte_sum(torch.where(sv, pkt_len[order], 0.0), seg, b)
    ts_max = segment_max(
        torch.where(sv, ts[order], float("-inf")), seg, b, float("-inf"))
    rep_key = segment_max(sk, seg, b, 0)
    rep_valid = pkts > 0
    rep_key = torch.where(rep_valid, rep_key,
                          torch.full_like(rep_key, INVALID_KEY))
    ts_max = torch.where(rep_valid, ts_max, 0.0)
    return FlowAgg(rep_key=rep_key, rep_pkts=pkts, rep_bytes=bytes_,
                   rep_ts=ts_max, rep_valid=rep_valid, inv=ks.inv)
