"""The IP-hash-sharded serving step: owner-routed flows over n table
shards.

Counterpart of ``flowsentryx_tpu/parallel/step.py``.  Per batch, as the
reference's ``shard_map`` body runs it on each of n devices:

* **Local slice work.**  Shard ``d`` scores and aggregates its own
  ``B/n`` slice of the batch (the scorer, ``score_int8`` on the card,
  launches once per shard), counts each local flow's malicious records,
  and sweeps its own eviction window (``evict_window(capacity / n)``
  rows of its own rows, gated by the one batch counter).
* **Routing.**  A flow's owner is the top ``log2 n`` bits of
  ``hash_u32(key, salt)`` (its slot inside the owner's shard comes from
  the low bits, so ownership never migrates).  Each shard sends at most
  ``C = min(B/n, max(64, ceil(2(B/n)/n)))`` flows to each owner, ranked
  within each owner's run by a stable sort; the rest fail open: they
  PASS this batch, skip their table update and are counted in
  ``route_drop``.
* **Owner side.**  Each owner merges the partials it received (a flow
  whose records fell in several slices sends several), in source-shard
  order, and runs ``flow_step`` (slot assignment, then the limiter / ML
  core) on its own shard; the verdicts go back to the sources, which
  resolve them per record.
* **One count fold** (verdict counts, route drops, evictions), and the
  verdict wire compacted twice: each owner's newly-blocked flows to K
  slots, then the n owners' K slots to one wire ``[ck, cu, total,
  total > K, route_drop, now]``.

What changes from the reference, and why:

* **One shard body, run two ways.**  The body is three stages, each
  run for one shard id ``d`` (:class:`_Body`: the local slice, the
  owner, the resolve), with the exchanges between them.
  :func:`make_sharded_step` runs the n shards of a one-process mesh
  (n shards of one device, :mod:`.mesh`) as a Python loop over ``d``,
  and its collectives are tensor ops over the per-shard values, in
  shard order: the ``all_to_all`` of the ``[n_src, n_dst, C]`` send
  buffers is a transpose, the ``psum`` of the counts an exact sum, the
  ``pmax`` of the clock an exact max, the ``all_gather`` of the K-slot
  compactions a concatenation.  Its shards are row ranges of one table:
  shard ``d`` is :class:`~..core.schema.TableShard` rows ``[d*N/n,
  (d+1)*N/n)``, and a scatter loser writes the table's one park row,
  never the next shard's first row; the report's ``table_summary`` is
  one launch over the whole table.  :func:`make_process_step` runs the
  body once, for ``d = rank``, on a process mesh (one process per
  shard), over this rank's own ``N/n`` rows (and a park row of its own),
  and its exchanges are ``torch.distributed`` collectives
  (:mod:`.exchange`).  Each exchange is one call of a named site per
  step either way, reported to this thread's record
  (:func:`recording_exchanges`), so ``fsx audit`` counts the step's
  exchanges by call as the reference counts its collectives.
* **Sums in the reference's order.**  The packet and vote counts are
  exact small integers in float32, so their order does not matter.
  Bytes on the raw48 wire (``pkt_len`` up to 65,535) can pass 2^24,
  where the float32 sum depends on its order: the local aggregate and
  the owner's merge then add in the reference's lane order
  (``segment_sum_seq``, a CUDA kernel on the card).  On the compact16
  wire every byte count is a multiple of 8 up to 16,376, exact in
  float32 below 2^27: a flow of at most 8,192 records.
* **In place** and with no host sync, as every step of the port: the
  table and stats are updated in place and returned, and the step is
  captured as one CUDA graph (:mod:`..ops.graph`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

from flowsentryx_tpu_torch.core import schema
from flowsentryx_tpu_torch.core.config import FsxConfig
from flowsentryx_tpu_torch.core.device import as_i32, f32
from flowsentryx_tpu_torch.core.schema import IpTableState, Verdict
from flowsentryx_tpu_torch.ops import agg, fused, hashtable, kernels
from flowsentryx_tpu_torch.parallel import exchange, layout
# the exchange record lives with the process mesh's collectives
from flowsentryx_tpu_torch.parallel.exchange import (  # noqa: F401
    _note, recording_exchanges,
)
from flowsentryx_tpu_torch.parallel.mesh import Mesh

#: Re-export (the reference's historical home of the placement).
shard_table = layout.shard_table


# -- the exchange sites: one call each per step, over every shard's value --

def _axis_index(n_dev: int) -> range:
    """The shard ids (the reference's ``axis_index``)."""
    _note("axis_index")
    return range(n_dev)


def _all_to_all(*per_src):
    """Each buffer's ``n_src`` values ``[n_dst, C, ...]`` ->
    ``[n_dst, n_src, C, ...]`` (one exchange for all the buffers)."""
    _note("all_to_all", *per_src)
    out = tuple(torch.stack(list(b)).transpose(0, 1) for b in per_src)
    return out if len(out) > 1 else out[0]


def _psum(parts):
    """The exact sum of the shards' values."""
    _note("psum", parts)
    return torch.stack(list(parts)).sum(0)


def _pmax(parts):
    """The max of the shards' values."""
    _note("pmax", parts)
    return torch.stack(list(parts)).max()


def _all_gather(parts):
    """The shards' values, concatenated in shard order."""
    _note("all_gather", parts)
    return torch.cat(list(parts))


def make_sharded_table(cfg: FsxConfig, mesh: Mesh) -> IpTableState:
    """Fresh empty table of ``cfg.table.capacity`` rows, row-sharded."""
    return shard_table(schema.make_table(cfg.table.capacity, mesh.device),
                       mesh)


def routing_capacity(local_b: int, n_dev: int) -> int:
    """``C``: flows each shard may send each owner per batch, twice the
    uniform-hash share, floored at 64 so small batches do not route at
    capacity 1."""
    return min(local_b, max(64, -(-2 * local_b // n_dev)))


def block_rows(batch: int, n_dev: int) -> int:
    """Length of a sharded step's ``block_key``: ``n_dev`` owners, each
    with ``n_dev * C`` received flows."""
    local_b = batch // n_dev
    return n_dev * n_dev * routing_capacity(local_b, n_dev)


class _Slice(NamedTuple):
    """One shard's slice of the batch after its local work."""

    score: torch.Tensor     # [B/n] f32
    fa: agg.FlowAgg         # its local flows
    mal: torch.Tensor       # [B/n] bool: scored malicious
    valid: torch.Tensor     # [B/n] bool
    owner: torch.Tensor     # [B/n] owner shard of each local flow
    rank: torch.Tensor      # [B/n] its rank within the owner's run
    routed: torch.Tensor    # [B/n] bool: rank < C
    send_key: torch.Tensor  # [n, C] flow keys to each owner
    send_val: torch.Tensor  # [n, C, 4] pkts, bytes, ts, malicious count


class _Body:
    """The shard body of the sharded step, in its three stages, each run
    for one shard id ``d``: :meth:`local` (score, aggregate and route
    shard ``d``'s slice), :meth:`owner` (merge what owner ``d`` received
    and run the flow core on its rows) and :meth:`resolve` (shard ``d``'s
    records' verdicts and counts).  The one-process step runs each stage
    for every ``d`` in turn; the process step runs each once, for its
    rank.  Between the stages lie the exchanges."""

    def __init__(self, cfg: FsxConfig, classify_batch, n_dev: int,
                 ordered_bytes: bool):
        if cfg.table.capacity % n_dev:
            raise ValueError("table capacity must divide by device count")
        self.cfg = cfg
        self.classify_batch = classify_batch
        self.n_dev = n_dev
        self.k_bits = n_dev.bit_length() - 1   # n_dev = 2**k_bits
        self.local_cap = cfg.table.capacity // n_dev
        self.local_cfg = dataclasses.replace(cfg, table=dataclasses.replace(
            cfg.table, capacity=self.local_cap))
        self.threshold = f32(cfg.model.threshold)
        self.byte_sum = (kernels.segment_sum_seq if ordered_bytes
                         else agg.segment_sum)

    def geometry(self, batch) -> tuple[int, int]:
        """``(B/n, C)`` of this batch, refused unless ``n`` divides it."""
        b = batch.key.shape[0]
        if b % self.n_dev:
            raise ValueError(
                f"batch size {b} must divide by the {self.n_dev}-device "
                "mesh (pad the batch; decode_records already pads to a "
                "static size)")
        local_b = b // self.n_dev
        return local_b, routing_capacity(local_b, self.n_dev)

    def local(self, params, batch, d: int, local_b: int, C: int
              ) -> tuple[_Slice, torch.Tensor]:
        """Shard ``d``'s slice: scored, aggregated, counted and routed;
        with its clock (the slice's latest valid stamp)."""
        n_dev, cfg = self.n_dev, self.cfg
        rn = n_dev * C
        idx = torch.arange(local_b, device=batch.key.device)
        sl = slice(d * local_b, (d + 1) * local_b)
        valid_l, ts_l = batch.valid[sl], batch.ts[sl]
        score_l = self.classify_batch(params, batch.feat[sl])
        fa = agg.aggregate(batch.key[sl], batch.pkt_len[sl], ts_l,
                           valid_l, byte_sum=self.byte_sum)
        mal_l = (score_l > self.threshold) & valid_l
        # per local flow, its COUNT of malicious records (the owner sums
        # the partials: a flow over several slices votes with its whole
        # record count)
        ml_l = torch.zeros(local_b, device=idx.device).index_add_(
            0, fa.inv, mal_l.float())
        now_l = torch.where(valid_l, ts_l, 0.0).max()
        h1 = hashtable.hash_u32(fa.rep_key, cfg.table.salt)
        owner = (h1 >> (32 - self.k_bits) if self.k_bits
                 else torch.zeros_like(h1))
        # rank within each owner's run: one stable sort by owner and a
        # running max of the run starts
        ko = agg.segment_by_key(torch.where(fa.rep_valid, owner, n_dev))
        run_start = torch.cummax(torch.where(ko.heads, idx, 0), 0).values
        rank = torch.empty_like(idx).scatter_(0, ko.order, idx - run_start)
        routed = fa.rep_valid & (rank < C)
        flat = torch.where(routed, owner * C + rank, rn)   # park tail
        send_key = torch.full((rn + 1,), agg.INVALID_KEY,
                              dtype=torch.int64, device=idx.device)
        send_key[flat] = torch.where(routed, fa.rep_key, agg.INVALID_KEY)
        vals = torch.stack([fa.rep_pkts, fa.rep_bytes, fa.rep_ts, ml_l],
                           dim=1)
        send_val = torch.zeros(rn + 1, 4, device=idx.device)
        send_val[flat] = torch.where(routed[:, None], vals, 0.0)
        return _Slice(score_l, fa, mal_l, valid_l, owner, rank, routed,
                      send_key[:rn].view(n_dev, C),
                      send_val[:rn].view(n_dev, C, 4)), now_l

    def owner(self, shard, recv_key: torch.Tensor, recv_val: torch.Tensor,
              now: torch.Tensor, C: int):
        """Owner ``shard`` merges the partials it received (``[n_src, C]``
        keys and ``[n_src, C, 4]`` values, in source order) and runs the
        flow core on its rows: ``(verdicts back [n_src, C], block keys,
        block untils)``."""
        rn = self.n_dev * C
        byte_sum = self.byte_sum
        rk = recv_key.reshape(rn)
        ks = agg.segment_by_key(rk)
        seg, sk = ks.seg, ks.sorted_key
        fvalid = sk != agg.INVALID_KEY
        v = torch.where(fvalid[:, None], recv_val.reshape(rn, 4)[ks.order],
                        0.0)
        m_pkts = agg.segment_sum(v[:, 0], seg, rn)
        m_bytes = byte_sum(v[:, 1].contiguous(), seg, rn)
        m_ts = agg.segment_max(
            torch.where(fvalid, v[:, 2], float("-inf")), seg, rn,
            float("-inf"))
        m_ml = agg.segment_sum(v[:, 3], seg, rn)
        m_key = agg.segment_max(sk, seg, rn, 0)
        m_valid = m_pkts > 0
        m_key = torch.where(m_valid, m_key, agg.INVALID_KEY)
        m_ts = torch.where(m_valid, m_ts, 0.0)
        mfa = agg.FlowAgg(rep_key=m_key, rep_pkts=m_pkts, rep_bytes=m_bytes,
                          rep_ts=m_ts, rep_valid=m_valid, inv=ks.inv)
        _, dec = fused.flow_step(self.local_cfg, shard, mfa, m_valid, m_ml,
                                 now)
        return (dec.flow_verdict[ks.inv].view(self.n_dev, C),
                torch.where(dec.newly_blocked, m_key, agg.INVALID_KEY),
                torch.where(dec.newly_blocked, dec.new_blocked_until, 0.0))

    def resolve(self, sl: _Slice, back: torch.Tensor, C: int,
                n_evicted: torch.Tensor | None):
        """Shard ``sl``'s records' verdicts from its flows' verdicts
        (``back`` ``[n_owner, C]``), and its counts: the four verdict
        counts, its route drops and (with the sweep) its evictions, which
        ride the one count fold."""
        n_dev = self.n_dev
        rep_verdict = torch.where(
            sl.routed, back[sl.owner.clamp(0, n_dev - 1),
                            sl.rank.clamp(0, C - 1)],
            int(Verdict.PASS))   # overflow: fail open this batch
        verdict_l = fused.resolve_record_verdicts(
            rep_verdict, sl.fa.inv, sl.mal, sl.valid)
        overflow = sl.fa.rep_valid & ~sl.routed
        route_drop_l = (sl.valid & overflow[sl.fa.inv]).sum()
        counts = torch.cat(
            [fused.count_verdicts(verdict_l, sl.valid), route_drop_l[None]]
            + ([n_evicted[None]] if n_evicted is not None else []))
        return verdict_l, counts


def _fold_counts(stats, counts: torch.Tensor, evict: bool) -> torch.Tensor:
    """Fold the summed counts into the stats in place; the route drops."""
    fused.update_stats_from_counts(stats, counts[:4])
    if evict:
        stats.evicted.add_(counts[5])
    return counts[4]


def _wire(ck, cu, total, k_max: int, route_drop, now) -> torch.Tensor:
    """The ``[2K+4]`` verdict wire: the folded K slots, the true total,
    its overflow flag, the route drops and the clock's bits."""
    scalars = torch.stack([
        total, (total > k_max).long(), route_drop,
        now.reshape(1).view(torch.int32)[0].long()])
    return torch.cat([as_i32(ck), cu.view(torch.int32), as_i32(scalars)])


def make_sharded_step(
    cfg: FsxConfig,
    classify_batch: Callable[[Any, torch.Tensor], torch.Tensor],
    mesh: Mesh,
    emit_score: bool = False,
    ordered_bytes: bool = False,
):
    """``step(table, stats, params, batch) -> (table, stats, out)`` over a
    decoded :class:`~..core.schema.FeatureBatch`, the signature of the
    single-shard :func:`~..ops.fused.make_step` (the engine swaps one
    for the other by mesh size).  ``table`` is :func:`make_sharded_table`'s;
    ``out.verdict``/``out.score`` are ``[B]`` in batch order,
    ``out.block_key``/``out.block_until`` ``[n * n * C]`` in owner order,
    ``out.route_drop`` a ``[]`` count.  ``ordered_bytes`` sums bytes in
    lane order (the raw48 wire)."""
    n_dev = mesh.size
    body = _Body(cfg, classify_batch, n_dev, ordered_bytes)
    local_cap = body.local_cap
    k_max = cfg.batch.verdict_k
    evict = cfg.table.evict_ttl_s > 0

    def step(table, stats, params, batch):
        local_b, C = body.geometry(batch)
        shards = [table.shard(d * local_cap, local_cap)
                  for d in range(n_dev)]

        # --- each shard's slice: score, aggregate, route -------------------
        src, nows = [], []
        for d in _axis_index(n_dev):
            sl, now_l = body.local(params, batch, d, local_b, C)
            src.append(sl)
            nows.append(now_l)
        now = _pmax(nows)     # the batch clock

        # the sweep: each shard its own window of its own rows, before
        # any of this batch's inserts claims a slot
        n_evicted = ([fused.evict_idle_epoch(cfg.table, sh, stats, now)
                      for sh in shards] if evict else None)

        # --- the all_to_all: [n_src, n_dst, C] -> [n_dst, n_src, C] -------
        recv_key, recv_val = _all_to_all([s.send_key for s in src],
                                         [s.send_val for s in src])

        # --- each owner: merge the partials, run the flow core -------------
        back, blk_keys, blk_untils = [], [], []
        for o in range(n_dev):
            b_o, k_o, u_o = body.owner(shards[o], recv_key[o], recv_val[o],
                                       now, C)
            back.append(b_o)
            blk_keys.append(k_o)
            blk_untils.append(u_o)

        # --- the verdicts back to their sources: [n_dst, n_src, C] --------
        back = _all_to_all(back)
        verdicts, counts = [], []
        for d, sl in enumerate(src):
            verdict_l, counts_l = body.resolve(
                sl, back[d], C, n_evicted[d] if evict else None)
            verdicts.append(verdict_l)
            counts.append(counts_l)

        # --- the one count fold --------------------------------------------
        route_drop = _fold_counts(stats, _psum(counts), evict)

        block_key = torch.cat(blk_keys)
        block_until = torch.cat(blk_untils)
        wire = None
        if k_max:
            # each owner compacts its own newly-blocked flows (a flow
            # blocks only on its owner: no key twice), then the n K-slot
            # buffers compact into one wire; the overflow flag comes from
            # the true total, so it is exact
            parts = [fused.compact_blocklist(k, u, k_max)
                     for k, u in zip(blk_keys, blk_untils)]
            total = _psum([p[2] for p in parts])
            ck, cu, _ = fused.compact_blocklist(
                _all_gather([p[0] for p in parts]),
                _all_gather([p[1] for p in parts]), k_max)
            wire = _wire(ck, cu, total, k_max, route_drop, now)
        out = fused.StepOutput(
            verdict=torch.cat(verdicts).to(torch.uint8),
            score=torch.cat([s.score for s in src]) if emit_score else None,
            block_key=as_i32(block_key),
            block_until=block_until,
            now=now,
            route_drop=route_drop,
            wire=wire,
        )
        return table, stats, out

    return step


def make_process_table(cfg: FsxConfig, mesh: Mesh) -> IpTableState:
    """This rank's shard of a fresh table on a process mesh: its
    ``capacity / n`` rows (and a park row of its own) on its device."""
    if cfg.table.capacity % mesh.size:
        raise ValueError("table capacity must divide by device count")
    return schema.make_table(cfg.table.capacity // mesh.size, mesh.device)


def make_process_step(
    cfg: FsxConfig,
    classify_batch: Callable[[Any, torch.Tensor], torch.Tensor],
    mesh: Mesh,
    emit_score: bool = False,
    ordered_bytes: bool = False,
):
    """The sharded step on a process mesh (:mod:`.mesh`): this rank runs
    the shard body once, for ``d = rank``, on its own shard
    (:func:`make_process_table`), and the exchanges are collectives
    (:mod:`.exchange`).  ``step(table, stats, params, batch) -> (table,
    stats, out)`` over the whole decoded batch, which every rank holds
    (the reference's replicated placement).  ``out.wire``, ``out.now``,
    ``out.route_drop`` and the stats come out the same on every rank;
    ``out.verdict``/``out.score`` are this rank's ``[B/n]`` slice and
    ``out.block_key``/``out.block_until`` its owner's ``[n * C]``, the
    rank-``d`` pieces of the one-process step's outputs."""
    if not mesh.is_process:
        raise ValueError("make_process_step needs a process mesh "
                         "(init_distributed, then make_mesh())")
    body = _Body(cfg, classify_batch, mesh.size, ordered_bytes)
    k_max = cfg.batch.verdict_k
    evict = cfg.table.evict_ttl_s > 0

    def step(table, stats, params, batch):
        local_b, C = body.geometry(batch)
        d = exchange.axis_index(mesh)
        sl, now_l = body.local(params, batch, d, local_b, C)
        now = exchange.pmax(mesh, now_l)
        n_evicted = (fused.evict_idle_epoch(cfg.table, table, stats, now)
                     if evict else None)
        recv_key, recv_val = exchange.all_to_all(mesh, sl.send_key,
                                                 sl.send_val)
        back, blk_key, blk_until = body.owner(table, recv_key, recv_val,
                                              now, C)
        back = exchange.all_to_all(mesh, back)
        verdict_l, counts = body.resolve(sl, back, C, n_evicted)
        route_drop = _fold_counts(stats, exchange.psum(mesh, counts), evict)
        wire = None
        if k_max:
            lk, lu, lcount = fused.compact_blocklist(blk_key, blk_until,
                                                     k_max)
            total = exchange.psum(mesh, lcount)
            ck, cu, _ = fused.compact_blocklist(
                exchange.all_gather(mesh, lk),
                exchange.all_gather(mesh, lu), k_max)
            wire = _wire(ck, cu, total, k_max, route_drop, now)
        out = fused.StepOutput(
            verdict=verdict_l.to(torch.uint8),
            score=sl.score if emit_score else None,
            block_key=as_i32(blk_key),
            block_until=blk_until,
            now=now,
            route_drop=route_drop,
            wire=wire,
        )
        return table, stats, out

    return step


def _make_sharded_wire_step(cfg, classify_batch, mesh, decode,
                            emit_score=False, ordered_bytes=False):
    """A wire buffer, decoded on the device, into the sharded step."""
    base = make_sharded_step(cfg, classify_batch, mesh,
                             emit_score=emit_score,
                             ordered_bytes=ordered_bytes)

    def step(table, stats, params, raw):
        return base(table, stats, params, decode(raw))

    return step


def make_sharded_raw_step(cfg: FsxConfig, classify_batch, mesh: Mesh,
                          emit_score: bool = False):
    """The sharded step over the raw48 wire (``[B+1, 12]`` int32), the
    twin of :func:`~..ops.fused.make_raw_step`: bytes summed in lane
    order."""
    return _make_sharded_wire_step(cfg, classify_batch, mesh,
                                   schema.decode_raw, emit_score=emit_score,
                                   ordered_bytes=True)


def make_sharded_compact_step(cfg: FsxConfig, classify_batch, mesh: Mesh,
                              emit_score: bool = False, **quant):
    """The sharded step over the compact16 wire (``[B+1, 4]`` int32), the
    twin of :func:`~..ops.fused.make_compact_step` (``**quant``: the
    wire quantizer's kwargs).  The 256-entry feature table is built per
    device at the first call (before any capture)."""
    tables: dict = {}

    def decode(raw):
        ft = tables.get(raw.device)
        if ft is None:
            ft = tables[raw.device] = schema.feature_table(raw.device,
                                                           **quant)
        return schema.decode_compact(raw, table=ft, **quant)

    return _make_sharded_wire_step(cfg, classify_batch, mesh, decode,
                                   emit_score=emit_score)


def make_process_raw_step(cfg: FsxConfig, classify_batch, mesh: Mesh,
                          emit_score: bool = False):
    """The process step over the raw48 wire, the process-mesh twin of
    :func:`make_sharded_raw_step`: bytes summed in lane order."""
    base = make_process_step(cfg, classify_batch, mesh,
                             emit_score=emit_score, ordered_bytes=True)

    def step(table, stats, params, raw):
        return base(table, stats, params, schema.decode_raw(raw))

    return step


def make_process_compact_step(cfg: FsxConfig, classify_batch, mesh: Mesh,
                              emit_score: bool = False, **quant):
    """The process step over the compact16 wire, the process-mesh twin
    of :func:`make_sharded_compact_step`; the feature table is built once,
    on this rank's device."""
    base = make_process_step(cfg, classify_batch, mesh,
                             emit_score=emit_score)
    ft = schema.feature_table(mesh.device, **quant)

    def step(table, stats, params, raw):
        return base(table, stats, params,
                    schema.decode_compact(raw, table=ft, **quant))

    return step


def make_sharded_compact_megastep(cfg: FsxConfig, classify_batch,
                                  mesh: Mesh, n_chunks: int, **quant):
    """N sharded steps in one dispatch over a ``[N, B+1, 4]`` group, the
    twin of :func:`~..ops.fused.make_compact_megastep`; outs stack to
    ``[N, ...]`` (``route_drop`` ``[N]``) and the wires merge into one."""
    return fused.wrap_megastep(
        make_sharded_compact_step(cfg, classify_batch, mesh, **quant),
        n_chunks)


def make_sharded_compact_megastep_family(cfg: FsxConfig, classify_batch,
                                         mesh: Mesh, sizes: tuple[int, ...],
                                         **quant) -> dict:
    """One sharded megastep per group size over one base step (``{n:
    mega}``, sizes descending): the sharded ladder's rungs."""
    base = make_sharded_compact_step(cfg, classify_batch, mesh, **quant)
    return {n: fused.wrap_megastep(base, n)
            for n in sorted(sizes, reverse=True)}
