"""The fused per-micro-batch serving step.

Counterpart of ``flowsentryx_tpu/ops/fused.py`` (single device, the
single-sort pipeline): decode (compact16 or raw48) -> the eviction sweep
when ``evict_ttl_s > 0`` -> score -> per-packet probe -> ONE sort ->
segment reductions -> blacklist/limiter/ML-vote core -> state scatter ->
stats fold -> compact verdict wire; and the megastep ladder
(``ops/fused.py:521-542,769-879`` there): N sealed batches in one
dispatch with their wires merged into one.

What changes from the reference, and why:

* **In place.**  The reference returns new table/stats pytrees and
  relies on buffer donation; here the table rows and the counters are
  updated in place (``index_put_`` on the winner lanes, ``_foreach_add_``
  on the counters) and the same objects are returned.
* **The sort.**  ``lax.sort((slot_pri, key, iota), num_keys=2)`` is one
  stable ``torch.sort`` of the int64 composite ``slot_pri << 32 | key``
  (``slot_pri <= 2 * capacity < 2^30``, so the composite stays positive).
* **Dropped scatters.**  ``mode="drop"`` scatters route their losing
  lanes to the table's park row (:class:`~..core.schema.IpTableState`).
* **Segment reductions** are ``index_add_``/``scatter_reduce``; every
  summed quantity on the compact16 wire is an exact small integer in
  float32 (see :mod:`.agg`), so the sums do not depend on order.  The
  raw48 step sums bytes in the reference's lane order instead
  (``segment_sum_seq``, a CUDA kernel on the card).
* **The eviction window offset** is read from the device counter
  ``stats.batches`` inside the step, so a captured graph sweeps a new
  window at every replay.
* **No host sync.**  Nothing in the step reads a device value on the
  host (no ``.item()``/``.cpu()``), so the engine serves it as a
  captured CUDA graph (:mod:`.graph`).
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from flowsentryx_tpu_torch.core import schema
from flowsentryx_tpu_torch.core.config import FsxConfig
from flowsentryx_tpu_torch.core.device import (
    LN2_F32, U32_MASK, as_i32, f32, fma32, u32, xla_exp,
)
from flowsentryx_tpu_torch.core.schema import (
    GlobalStats, IpTableState, TableCol, Verdict,
)
from flowsentryx_tpu_torch.ops import agg, hashtable, kernels, limiters

_INT32_MIN = -(1 << 31)


class StepOutput(NamedTuple):
    verdict: torch.Tensor       # [B] uint8 Verdict codes
    score: Any                  # [B] f32 when built with emit_score, else None
    block_key: torch.Tensor     # [B] int32 bit patterns, INVALID_KEY padded
    block_until: torch.Tensor   # [B] f32
    now: torch.Tensor           # [] f32 newest valid timestamp
    #: records fail-opened because their flow overflowed owner routing:
    #: a [] int64 tensor from the sharded step (``parallel/step.py``),
    #: the constant 0 on one shard
    route_drop: Any = 0
    wire: Any = None            # [2K+4] int32 bit patterns, None if K == 0


#: Internal flow-verdict sentinel: failed the ML vote but carried
#: malicious-scoring records (translated per record).
ML_RECORD_GATE = 100


def resolve_record_verdicts(flow_verdict: torch.Tensor, inv: torch.Tensor,
                            mal: torch.Tensor, valid: torch.Tensor
                            ) -> torch.Tensor:
    per_pkt = flow_verdict[inv]
    gated = per_pkt == ML_RECORD_GATE
    per_pkt = torch.where(
        gated, torch.where(mal, int(Verdict.DROP_ML), int(Verdict.PASS)),
        per_pkt)
    return torch.where(valid, per_pkt, int(Verdict.PASS))


class FlowDecision(NamedTuple):
    flow_verdict: torch.Tensor      # [R] int64
    new_blocked_until: torch.Tensor  # [R] f32
    newly_blocked: torch.Tensor     # [R] bool
    tracked: torch.Tensor           # [R] bool


def flow_step(
    cfg: FsxConfig,
    table: IpTableState | schema.TableShard,
    fa: agg.FlowAgg,
    flow_mask: torch.Tensor,
    ml_count: torch.Tensor,
    now: torch.Tensor,
) -> tuple[IpTableState | schema.TableShard, FlowDecision]:
    """Slot assignment, then :func:`_flow_core`, over aggregated flows:
    the two-stage composition the sharded step runs on each owner's
    shard (``flow_mask``: the flows this call owns).  ``ml_count`` is the
    per-flow count of records scored malicious."""
    asg = hashtable.assign_slots(table.key, table.last_seen, fa.rep_key,
                                 fa.rep_valid & flow_mask, now, cfg.table)
    return table, _flow_core(cfg, table, fa, asg, flow_mask, ml_count)


def _flow_core(
    cfg: FsxConfig,
    table: IpTableState | schema.TableShard,
    fa: agg.FlowAgg,
    asg: hashtable.SlotAssignment,
    flow_mask: torch.Tensor | None,
    ml_count: torch.Tensor,
) -> FlowDecision:
    """Blacklist gate, limiter, ML vote, verdicts, and the in-place
    state scatter (tracked flows only; everyone else writes the park
    row).  ``flow_mask`` (None: every flow) restricts the flows that may
    take an ML verdict.  The reference's core also takes the batch
    clock, which it never reads."""
    lim = cfg.limiter
    mdl = cfg.model
    C = TableCol
    n = table.capacity
    # untracked lanes may carry garbage slots (empty segments read the
    # segment-max identity); their rows never reach an output
    gslot = table.at(asg.slot.clamp(0, n))
    rows = torch.where(asg.inserted[:, None], 0.0, table.state_rows[gslot])

    win = limiters.WindowState(
        win_start=rows[:, C.WIN_START], win_pps=rows[:, C.WIN_PPS],
        win_bps=rows[:, C.WIN_BPS], prev_pps=rows[:, C.PREV_PPS],
        prev_bps=rows[:, C.PREV_BPS])
    bucket = limiters.BucketState(
        tokens=rows[:, C.TOKENS], tok_ts=rows[:, C.TOK_TS],
        tok_bytes=rows[:, C.TOK_BYTES])
    blocked_until = rows[:, C.BLOCKED_UNTIL]
    rec_seen = rows[:, C.REC_SEEN]
    ml_votes = rows[:, C.ML_VOTES]
    last_seen = rows[:, C.LAST_SEEN]

    eligible = fa.rep_valid if flow_mask is None else fa.rep_valid & flow_mask
    already_blocked = asg.tracked & (blocked_until > fa.rep_ts)
    dec = limiters.apply_limiter(lim, win, bucket, fa.rep_pkts,
                                 fa.rep_bytes, fa.rep_ts,
                                 is_new=asg.inserted)
    over_rate = asg.tracked & dec.over_limit & ~already_blocked

    ml_hit = ml_count > 0
    mature = rec_seen >= mdl.vote_k
    fresh = torch.where(mature, ml_count, 0.0)
    if mdl.vote_decay_s > 0:
        # half-life decay ``votes * exp2(-dt / s) + fresh``, rounded as
        # the reference's compiled graph rounds it: ``/ s`` becomes a
        # multiply by f32(1/s), exp2(x) is exp(x * f32(ln 2)), the two
        # constants fold into one, and the multiply-add fuses
        dt = torch.clamp(fa.rep_ts - last_seen, min=0.0)
        k = f32(f32(1.0 / f32(mdl.vote_decay_s)) * LN2_F32)
        votes = fma32(ml_votes, xla_exp(dt * -k), fresh)
    else:
        votes = ml_votes + fresh
    votes_new = torch.clamp(votes, max=f32(1e6))
    burst = (fa.rep_pkts > mdl.vote_k) & (ml_count >= mdl.vote_m)
    vote_ok = torch.where(asg.tracked, (votes_new >= mdl.vote_m) | burst,
                          burst)
    over_ml = eligible & ml_hit & vote_ok & ~already_blocked & ~over_rate
    ml_drop_only = (eligible & ml_hit & ~vote_ok & ~already_blocked
                    & ~over_rate)

    new_blocked_until = torch.where(
        over_rate, fa.rep_ts + f32(lim.block_s),
        torch.where(over_ml, fa.rep_ts + f32(mdl.ml_block_s), blocked_until))
    flow_verdict = torch.where(
        already_blocked, int(Verdict.DROP_BLACKLIST),
        torch.where(over_rate, int(Verdict.DROP_RATE),
                    torch.where(over_ml, int(Verdict.DROP_ML),
                                torch.where(ml_drop_only, ML_RECORD_GATE,
                                            int(Verdict.PASS)))))

    new_rows = torch.stack(
        [
            fa.rep_ts,
            dec.window.win_start,
            dec.window.win_pps,
            dec.window.win_bps,
            dec.window.prev_pps,
            dec.window.prev_bps,
            dec.bucket.tokens,
            dec.bucket.tok_ts,
            dec.bucket.tok_bytes,
            rec_seen + fa.rep_pkts,
            torch.where(over_ml, 0.0, votes_new),
            new_blocked_until,
        ],
        dim=1,
    )
    safe_slot = torch.where(asg.tracked, table.at(asg.slot), table.park)
    table.key_rows.index_put_((safe_slot,), as_i32(fa.rep_key))
    table.state_rows.index_put_((safe_slot,), new_rows)
    return FlowDecision(flow_verdict=flow_verdict,
                        new_blocked_until=new_blocked_until,
                        newly_blocked=over_rate | over_ml,
                        tracked=asg.tracked)


STAT_VERDICT_ORDER = (
    Verdict.PASS, Verdict.DROP_BLACKLIST, Verdict.DROP_RATE, Verdict.DROP_ML,
)


def count_verdicts(verdict: torch.Tensor, valid: torch.Tensor
                   ) -> torch.Tensor:
    """``[4]`` int64 packet counts in :data:`STAT_VERDICT_ORDER`."""
    # STAT_VERDICT_ORDER is codes 0..3: arange is a device fill, where a
    # torch.tensor([...]) would be a blocking host-to-device copy
    codes = torch.arange(len(STAT_VERDICT_ORDER), device=verdict.device)
    hit = (verdict.long()[:, None] == codes[None, :]) & valid[:, None]
    return hit.sum(dim=0)


def update_stats_from_counts(stats: GlobalStats, counts: torch.Tensor
                             ) -> GlobalStats:
    """Fold ``[4]`` verdict counts plus one batch into the counters, in
    place.  ``batches`` bumps only for a non-empty batch (an all-masked
    warm dispatch changes nothing)."""
    delta = torch.cat([counts, (counts.sum() > 0).long()[None]])
    torch._foreach_add_(list(stats[:5]), list(delta.unbind(0)))
    return stats


VERDICT_WIRE_SCALARS = 4


def verdict_wire_words(k_max: int) -> int:
    return 2 * k_max + VERDICT_WIRE_SCALARS


def compact_blocklist(block_key: torch.Tensor, block_until: torch.Tensor,
                      k_max: int
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Order-preserving compaction of a padded block array into
    ``([k_max] keys, [k_max] untils, [] true count)``; entries past
    ``k_max`` park at slot ``k_max`` (dropped) while the count keeps
    them, which is how overflow is detected."""
    nb = block_key != agg.INVALID_KEY
    pos = torch.cumsum(nb, 0) - 1
    idx = torch.where(nb & (pos < k_max), pos, k_max)
    ck = torch.full((k_max + 1,), agg.INVALID_KEY, dtype=block_key.dtype,
                    device=block_key.device).scatter_(0, idx, block_key)
    cu = torch.zeros(k_max + 1, dtype=block_until.dtype,
                     device=block_until.device).scatter_(0, idx, block_until)
    return ck[:k_max], cu[:k_max], nb.sum()


def pack_verdict_wire(block_key: torch.Tensor, block_until: torch.Tensor,
                      now: torch.Tensor, route_drop: int, k_max: int
                      ) -> torch.Tensor:
    """The ``[2*k_max + 4]`` verdict wire as int32 bit patterns: keys,
    expiries (f32 bits), count, overflow flag, route_drop, now (f32
    bits)."""
    ck, cu, count = compact_blocklist(block_key, block_until, k_max)
    scalars = torch.stack([
        count,
        (count > k_max).long(),
        torch.full_like(count, route_drop),
        now.reshape(1).view(torch.int32)[0].long(),
    ])
    return torch.cat([as_i32(ck), cu.view(torch.int32), as_i32(scalars)])


def merge_verdict_wires(wires: torch.Tensor) -> torch.Tensor:
    """Fold a ``[N, 2K+4]`` stack of per-chunk verdict wires (a
    megastep's outputs) into ONE wire, so a group dispatch still costs a
    single O(K) readback.

    Counts and route_drop sum, ``now`` takes the f32 max, and the
    ``N*K`` key/until slots re-compact in chunk order with
    :func:`compact_blocklist` (last wins per key downstream).  The
    merged overflow flag derives from the summed TRUE counts: any lost
    entry, a chunk's own overflow or more than K in all, implies a total
    above K, so the flag is exact."""
    k = (wires.shape[1] - VERDICT_WIRE_SCALARS) // 2
    keys = u32(wires[:, :k].reshape(-1))
    untils = wires[:, k:2 * k].reshape(-1).view(torch.float32)
    count = u32(wires[:, 2 * k]).sum()
    rd = u32(wires[:, 2 * k + 2]).sum()
    now = wires[:, 2 * k + 3].view(torch.float32).max()
    ck, cu, _ = compact_blocklist(keys, untils, k)
    scalars = torch.stack([
        count, (count > k).long(), rd,
        now.reshape(1).view(torch.int32)[0].long(),
    ])
    return torch.cat([as_i32(ck), cu.view(torch.int32), as_i32(scalars)])


def evict_window(capacity: int, evict_every: int) -> int:
    """Rows swept per batch: one full pass every ``evict_every`` batches
    (a ragged last window re-sweeps a few tail rows).  The reference's
    sizing rule: pick ``evict_every`` so one pass takes about ``ttl/4``
    at the batch rate."""
    return -(-capacity // evict_every)


def evict_idle_epoch(tcfg, table: IpTableState, stats: GlobalStats,
                     now: torch.Tensor) -> torch.Tensor:
    """One rolling-sweep step, in place: free the rows of this batch's
    window idle longer than ``evict_ttl_s`` (a still-valid blacklist
    entry survives), and return the ``[]`` int64 count freed.

    The window starts at ``(batches mod 2^32) % evict_every * window``,
    clamped so a ragged last window stays in bounds: the reference's u32
    counter wraps, so the offset reads the low 32 bits of the port's
    int64 ``batches``, on the device (a captured graph must not replay
    one offset).  The window is read with a gather and only victims are
    written; the other lanes write the park row.  A warm or all-masked
    batch has ``now == 0`` and frees nothing.  Callers gate on
    ``evict_ttl_s > 0`` statically.  On a :class:`~..core.schema
    .TableShard` the window spans the shard's own rows."""
    C = TableCol
    cap = table.capacity
    chunk = evict_window(cap, tcfg.evict_every)
    off = (stats.batches & U32_MASK) % tcfg.evict_every * chunk
    off = torch.clamp(off, max=cap - chunk)
    idx = table.at(off + torch.arange(chunk, device=now.device))
    keys = table.key_rows[idx]
    rows = table.state_rows[idx]
    idle = now - rows[:, C.LAST_SEEN] > f32(tcfg.evict_ttl_s)
    live_block = rows[:, C.BLOCKED_UNTIL] > now
    victim = (keys != hashtable.EMPTY_KEY) & idle & ~live_block
    vidx = torch.where(victim, idx, table.park)
    table.key_rows.index_put_((vidx,), torch.zeros_like(keys))
    table.state_rows.index_put_((vidx,), torch.zeros_like(rows))
    return victim.sum()


def make_step(
    cfg: FsxConfig,
    classify_batch: Callable[[Any, torch.Tensor], torch.Tensor],
    emit_score: bool = False,
    ordered_bytes: bool = False,
) -> Callable[..., tuple[IpTableState, GlobalStats, StepOutput]]:
    """``step(table, stats, params, batch) -> (table, stats, out)`` over a
    decoded :class:`~..core.schema.FeatureBatch`; table and stats are
    updated in place and returned.  ``ordered_bytes`` sums each flow's
    bytes in lane order (the raw48 wire, where the sum can pass 2^24)."""
    k_max = cfg.batch.verdict_k
    threshold = f32(cfg.model.threshold)
    evict = cfg.table.evict_ttl_s > 0

    def step(table: IpTableState, stats: GlobalStats, params: Any,
             batch: schema.FeatureBatch):
        b = batch.key.shape[0]
        n = table.capacity
        valid = batch.valid
        now = torch.where(valid, batch.ts, 0.0).max()
        # the sweep opens the step, so freed rows are claimable by this
        # batch's inserts; absent from the graph when disabled
        n_evicted = (evict_idle_epoch(cfg.table, table, stats, now)
                     if evict else None)
        score = classify_batch(params, batch.feat)
        mal = (score > threshold) & valid

        key = torch.where(batch.key == 0, 0xFFFFFFFE, batch.key)
        key = torch.where(valid, key, agg.INVALID_KEY)

        pr = hashtable.probe_slots(table.key, table.last_seen, key, valid,
                                   now, cfg.table)
        slot, found, usable = pr.slot, pr.found, pr.usable

        # the one sort: (slot-priority, key) as a single int64 key
        slot_pri = torch.where(usable, slot * 2 + (~found).long(), 2 * n)
        comp, order = torch.sort((slot_pri << 32) | key, stable=True)
        sp_s = comp >> 32
        key_s = comp & 0xFFFFFFFF

        key_head = agg.run_heads(key_s)
        seg = torch.cumsum(key_head, 0) - 1
        inv = torch.empty_like(seg).scatter_(0, order, seg)
        sv = valid[order]

        # exact-integer f32 sums: packets, malicious-scored records, and
        # bytes unless they are summed in lane order
        byte_lanes = torch.where(sv, batch.pkt_len[order], 0.0)
        cols = [sv.float(), mal[order].float()]
        if not ordered_bytes:
            cols.append(byte_lanes)
        sums = agg.segment_sum_cols(torch.stack(cols, dim=1), seg, b)
        pkts, ml_count = sums[:, 0], sums[:, 1]
        bytes_ = (kernels.segment_sum_seq(byte_lanes, seg, b)
                  if ordered_bytes else sums[:, 2])
        ts_max = agg.segment_max(
            torch.where(sv, batch.ts[order], float("-inf")), seg, b,
            float("-inf"))
        slot_head = torch.ones_like(key_head)
        slot_head[1:] = (sp_s[1:] >> 1) != (sp_s[:-1] >> 1)
        maxes = agg.segment_max_cols(torch.stack([
            slot[order], found[order].long(), usable[order].long(),
            (key_head & slot_head).long(),
        ], dim=1), seg, b, _INT32_MIN)
        rep_slot = maxes[:, 0]
        rep_found = maxes[:, 1] > 0
        rep_usable = maxes[:, 2] > 0
        rep_winner = maxes[:, 3] > 0
        rep_key = agg.segment_max(key_s, seg, b, 0)
        rep_valid = pkts > 0
        rep_key = torch.where(rep_valid, rep_key, agg.INVALID_KEY)
        ts_max = torch.where(rep_valid, ts_max, 0.0)

        fa = agg.FlowAgg(rep_key=rep_key, rep_pkts=pkts, rep_bytes=bytes_,
                         rep_ts=ts_max, rep_valid=rep_valid, inv=inv)
        asg = hashtable.SlotAssignment(
            slot=rep_slot,
            found=rep_found & rep_winner,
            inserted=rep_usable & ~rep_found & rep_winner,
            tracked=rep_usable & rep_winner,
        )
        dec = _flow_core(cfg, table, fa, asg, None, ml_count)

        verdict = resolve_record_verdicts(dec.flow_verdict, inv, mal, valid)
        update_stats_from_counts(stats, count_verdicts(verdict, valid))
        if n_evicted is not None:
            stats.evicted.add_(n_evicted)

        block_key = torch.where(dec.newly_blocked, rep_key, agg.INVALID_KEY)
        block_until = torch.where(dec.newly_blocked, dec.new_blocked_until,
                                  0.0)
        out = StepOutput(
            verdict=verdict.to(torch.uint8),
            score=score if emit_score else None,
            block_key=as_i32(block_key),
            block_until=block_until,
            now=now,
            wire=(pack_verdict_wire(block_key, block_until, now, 0, k_max)
                  if k_max else None),
        )
        return table, stats, out

    return step


def make_compact_step(
    cfg: FsxConfig,
    classify_batch: Callable[[Any, torch.Tensor], torch.Tensor],
    emit_score: bool = False,
    **quant,
) -> Callable[..., tuple[IpTableState, GlobalStats, StepOutput]]:
    """The fused step over the compact16 wire: ``step(table, stats,
    params, raw)`` with ``raw`` the ``[B+1, 4]`` int32 bit patterns of a
    sealed batch (``**quant``: :func:`~..core.schema.model_quant_args`
    for model mode, else minifloat)."""
    base = make_step(cfg, classify_batch, emit_score=emit_score)
    #: The 256-entry feature table per device, built at the first call
    #: (on the card: in the first eager warm-up, before any capture,
    #: which then holds it by address).
    tables: dict = {}

    def step(table, stats, params, raw):
        ft = tables.get(raw.device)
        if ft is None:
            ft = tables[raw.device] = schema.feature_table(raw.device,
                                                           **quant)
        return base(table, stats, params,
                    schema.decode_compact(raw, table=ft, **quant))

    return step


def make_raw_step(
    cfg: FsxConfig,
    classify_batch: Callable[[Any, torch.Tensor], torch.Tensor],
    emit_score: bool = False,
) -> Callable[..., tuple[IpTableState, GlobalStats, StepOutput]]:
    """The fused step over the raw48 wire: ``step(table, stats, params,
    raw)`` with ``raw`` the ``[B+1, 12]`` int32 bit patterns of a sealed
    batch (:func:`~..core.schema.decode_raw`), bytes summed in lane
    order."""
    base = make_step(cfg, classify_batch, emit_score=emit_score,
                     ordered_bytes=True)

    def step(table, stats, params, raw):
        return base(table, stats, params, schema.decode_raw(raw))

    return step


def pow2_group_sizes(mega_n: int) -> tuple[int, ...]:
    """The adaptive coalescing ladder: every power-of-two group size in
    ``[2, mega_n]``, LARGEST first (the dispatch loop picks the first
    size the backlog fills, so order encodes preference).  Any backlog
    ``b`` then dispatches in at most ``popcount(b)`` groups and singles,
    with one captured graph per rung."""
    sizes: list[int] = []
    g = 2
    while g <= mega_n:
        sizes.append(g)
        g *= 2
    return tuple(reversed(sizes))


def rung_for_volume(volume: int, sizes: tuple[int, ...]) -> int:
    """The ladder's rung-selection policy: the largest rung of ``sizes``
    (largest first, :func:`pow2_group_sizes` order) that ``volume``
    sealed batches fill, else 1 (a single)."""
    return next((s for s in sizes if s <= volume), 1)


def wrap_megastep(base, n_chunks: int):
    """``mega(table, stats, params, raws)``: ``base`` run over the
    ``n_chunks`` leading slices of a ``[N, B+1, 4]`` stacked wire group,
    in order, updating table and stats in place (the reference's
    ``lax.scan`` carry).  ``outs`` fields are stacked ``[N, B]``
    (``now``, and a sharded step's ``route_drop``: ``[N]``), except
    ``outs.wire``, the N chunks' verdict wires merged into ONE by
    :func:`merge_verdict_wires`.

    On the CPU this is the plain loop; on the card the same function is
    what :class:`~.graph.StepGraph` captures, one graph per rung."""

    def mega(table, stats, params, raws):
        if raws.shape[0] != n_chunks:
            raise ValueError(
                f"mega-step built for {n_chunks} chunks, got a "
                f"[{raws.shape[0]}, ...] group (its captured graph has "
                "that many chunks baked in)")
        outs = [base(table, stats, params, raw)[2] for raw in raws.unbind(0)]

        def stacked(field):
            vals = [getattr(o, field) for o in outs]
            return (torch.stack(vals) if isinstance(vals[0], torch.Tensor)
                    else vals[0])

        wires = stacked("wire")
        out = StepOutput(
            verdict=stacked("verdict"), score=stacked("score"),
            block_key=stacked("block_key"),
            block_until=stacked("block_until"), now=stacked("now"),
            route_drop=stacked("route_drop"),
            wire=None if wires is None else merge_verdict_wires(wires))
        return table, stats, out

    return mega


def make_compact_megastep(cfg: FsxConfig, classify_batch, n_chunks: int,
                          **quant):
    """N micro-batches in ONE dispatch over a ``[N, B+1, 4]`` stacked
    compact16 group (counterpart of the reference's
    ``make_jitted_compact_megastep``; on the card the dispatch is one
    CUDA graph replay, :mod:`.graph`)."""
    return wrap_megastep(make_compact_step(cfg, classify_batch, **quant),
                         n_chunks)


def make_compact_megastep_family(cfg: FsxConfig, classify_batch,
                                 sizes: tuple[int, ...], **quant) -> dict:
    """One megastep per group size, sharing one base step (``{n: mega}``,
    keys sorted descending): the adaptive ladder's rungs."""
    base = make_compact_step(cfg, classify_batch, **quant)
    return {n: wrap_megastep(base, n) for n in sorted(sizes, reverse=True)}


def block_record(out) -> torch.Tensor:
    """A step's (megastep's, drain-ring round's) block arrays and clock as ONE flat int32
    buffer: every ``block_key``, every ``block_until`` (f32 bits), every
    ``now`` (f32 bits), and a sharded step's ``route_drop`` words last.
    The engine keeps one copy per in-flight dispatch
    and reads it when that dispatch's wire overflowed (or when there is
    no wire); :func:`split_block_record` undoes it on the host, after the
    caller has cut the ``route_drop`` words off."""
    parts = [out.block_key.reshape(-1),
             out.block_until.reshape(-1).view(torch.int32),
             out.now.reshape(-1).view(torch.int32)]
    rd = getattr(out, "route_drop", None)
    if isinstance(rd, torch.Tensor):
        parts.append(rd.reshape(-1).to(torch.int32))
    return torch.cat(parts)


def split_block_record(rec, n_chunks: int, n_now: int | None = None):
    """Host side of :func:`block_record` (numpy int32 ``rec`` of
    ``n_chunks`` chunks and ``n_now`` clocks, default one per chunk; a
    drain-ring round carries one) -> ``(keys u32, untils f32, nows
    f32)``."""
    n_now = n_chunks if n_now is None else n_now
    b = (rec.shape[0] - n_now) // (2 * n_chunks)
    keys = rec[:n_chunks * b].view("<u4")
    untils = rec[n_chunks * b:2 * n_chunks * b].view("<f4")
    return keys, untils, rec[2 * n_chunks * b:].view("<f4")
