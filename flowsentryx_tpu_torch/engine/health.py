"""The health ladder: HEALTHY / DEGRADED / FAILED.

Counterpart of ``flowsentryx_tpu/engine/health.py``, copied.  Health is
a pure function of counters the engine report already carries:

* **HEALTHY** — every shard served, nothing dropped or quarantined,
  watchdog quiet;
* **DEGRADED(reasons)** — serving goes on but something fail-opened:
  dead or stalled ingest shards, emit drops, sequence gaps, quarantined
  or corrupt slots, gossip or transport drops, a watchdog soft trip, a
  restore that fell back to ``.prev``; each reason is a ``name:count``
  string;
* **FAILED** — every ingest shard is dead, the watchdog hard-tripped,
  or (the port's) a rank of a process mesh was lost.

``cluster_health`` and ``worst`` fold several engines' ladders
(worst-of).  Standard library only.
"""

from __future__ import annotations

HEALTHY = "healthy"
DEGRADED = "degraded"
FAILED = "failed"

#: Ladder order for worst-of aggregation.
_RANK = {HEALTHY: 0, DEGRADED: 1, FAILED: 2}


def engine_health(
    ingest: dict | None = None,
    gossip: dict | None = None,
    watchdog: dict | None = None,
    restore_fallbacks: int = 0,
    rebalance: dict | None = None,
    elastic: dict | None = None,
    mesh: dict | None = None,
) -> dict:
    """Derive one engine's health from its report blocks (module
    docstring).  Every argument is the corresponding
    ``EngineReport``/``ingest_stats`` dict (or None when that plane is
    off); the return is ``{"state": ..., "reasons": [...]}``."""
    reasons: list[str] = []
    failed = False
    if ingest:
        dead = ingest.get("dead_workers") or []
        n_workers = int(ingest.get("n_workers") or 0)
        if dead:
            reasons.append(f"ingest_shards_dead:{len(dead)}")
            if n_workers and len(dead) == n_workers:
                # nothing left serving this span: the kernel limiter
                # stands alone for every flow the engine owned
                failed = True
        stalled = [k for k, w in (ingest.get("workers") or {}).items()
                   if w.get("stalled")]
        if stalled:
            reasons.append(f"ingest_shards_stalled:{len(stalled)}")
        gaps = sum(w.get("seq_gaps", 0)
                   for w in (ingest.get("workers") or {}).values())
        if gaps:
            reasons.append(f"ingest_seq_gaps:{gaps}")
        drops = int(ingest.get("dropped_emit_batches") or 0)
        if drops:
            reasons.append(f"ingest_emit_drops:{drops}")
        tail = int(ingest.get("dropped_tail_batches") or 0)
        if tail:
            reasons.append(f"ingest_tail_drops:{tail}")
        quarantined = int(ingest.get("quarantined_batches") or 0)
        if quarantined:
            reasons.append(f"quarantined_batches:{quarantined}")
        bad = int(ingest.get("bad_wire_slots") or 0)
        if bad:
            reasons.append(f"bad_wire_slots:{bad}")
    if gossip:
        tx = int(gossip.get("tx_dropped") or 0)
        if tx:
            reasons.append(f"gossip_tx_dropped:{tx}")
        rx = int(gossip.get("rx_seq_gaps") or 0)
        if rx:
            reasons.append(f"gossip_rx_seq_gaps:{rx}")
        net = gossip.get("net")
        if net:
            # the multi-host transport's fail-open accounting
            # (cluster/transport.py): every one of these means a
            # verdict wire was dropped, delayed past the reorder
            # window, or refused for a lying epoch — serving
            # continues (DEGRADED, never FAILED: the local span is
            # still mitigated; remote convergence is what degraded)
            for key, name in (("tx_drop", "net_tx_drop"),
                              ("rx_gap", "net_rx_gap"),
                              ("rx_dup", "net_rx_dup"),
                              ("reorder_evict", "net_reorder_evict"),
                              ("epoch_skew_dropped",
                               "net_epoch_skew_dropped")):
                v = int(net.get(key) or 0)
                if v:
                    reasons.append(f"{name}:{v}")
            if int(net.get("epoch_skew_dropped") or 0):
                # the gauge behind the drops: how far out of frame
                # the worst wire was (seconds) — names the lying
                # epoch's magnitude for the operator
                reasons.append(
                    f"net_epoch_skew_max:{net.get('epoch_skew_max')}")
    if watchdog:
        trips = int(watchdog.get("soft_trips") or 0)
        if trips:
            reasons.append(f"watchdog_soft_trips:{trips}")
        if watchdog.get("hard_tripped"):
            failed = True
    if restore_fallbacks:
        reasons.append(f"restore_fallbacks:{restore_fallbacks}")
    if rebalance:
        # live-handoff loss accounting (cluster/rebalance.py): each
        # of these means rows or a stream went somewhere other than
        # the happy path — DEGRADED, never FAILED (the span is still
        # served by whoever owned it; conservation is the chaos
        # campaign's invariant, these are the operator's breadcrumbs)
        for key, name in (
                ("adopt_dropped", "rebalance_adopt_dropped"),
                ("staged_discarded", "rebalance_staged_discarded"),
                ("streams_refused", "rebalance_streams_refused"),
                ("foreign_dropped", "rebalance_foreign_dropped")):
            v = int(rebalance.get(key) or 0)
            if v:
                reasons.append(f"{name}:{v}")
    if elastic:
        # autoscaler friction (cluster/elastic.py): suppressed plans
        # mean the fleet WANTED to reshape and could not (cooldown or
        # clamp) — visible so an operator can raise max_engines
        # instead of discovering the clamp in a postmortem
        v = int(elastic.get("suppressed") or 0)
        if v:
            reasons.append(f"elastic_plans_suppressed:{v}")
        v = int(elastic.get("aborts") or 0)
        if v:
            reasons.append(f"elastic_handoff_aborts:{v}")
    if mesh and mesh.get("peer_lost"):
        # a rank of the process mesh died or stopped answering: its
        # shard's flows have no owner, so nothing is served
        reasons.append("mesh_peer_lost:1")
        failed = True
    state = FAILED if failed else (DEGRADED if reasons else HEALTHY)
    return {"state": state, "reasons": reasons}


def worst(*states: str) -> str:
    """Worst-of fold over ladder states (unknown reads as DEGRADED:
    a rank whose health cannot be read is not healthy)."""
    return max((s if s in _RANK else DEGRADED for s in states),
               key=lambda s: _RANK[s], default=HEALTHY)


def cluster_health(per_rank: dict, failed_ranks: list,
                   stalled_ranks: list,
                   dead_hosts: list | None = None) -> dict:
    """Supervisor-side aggregation: worst-of every rank's reported
    health, with supervisor-observed terminal states layered on top
    (a rank parked as failed is FAILED even if its last report said
    healthy — the report predates the park).  ``dead_hosts`` is the
    federation beacon's verdict (multi-host fleets): a silent peer
    HOST means whole IP spans are down to that host's kernel tier —
    the fleet is FAILED until it returns."""
    states = [h.get("state", DEGRADED) for h in per_rank.values()]
    reasons: list[str] = []
    for r, h in sorted(per_rank.items()):
        for reason in h.get("reasons", []):
            reasons.append(f"r{r}:{reason}")
    state = worst(*states) if states else HEALTHY
    if failed_ranks:
        state = FAILED
        reasons.append(
            f"ranks_failed:{','.join(str(r) for r in failed_ranks)}")
    elif stalled_ranks:
        state = worst(state, DEGRADED)
        reasons.append(
            f"ranks_stalled:{','.join(str(r) for r in stalled_ranks)}")
    if dead_hosts:
        state = FAILED
        reasons.append(
            f"hosts_dead:{','.join(str(h) for h in dead_hosts)}")
    return {
        "state": state,
        "reasons": reasons,
        "per_rank": {str(r): h for r, h in sorted(per_rank.items())},
    }
