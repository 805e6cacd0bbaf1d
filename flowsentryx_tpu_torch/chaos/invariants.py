"""The named invariant catalog the chaos campaign judges faults by.

Counterpart of ``flowsentryx_tpu/chaos/invariants.py``, whole: the
catalog below names the reference's invariants, the port's included
and the ones whose faults it does not run yet.

Every fault scenario yields :class:`InvariantResult` rows; a campaign
passes only when every scenario invariant holds AND every planted
regression is caught (its target invariant FAILS under the plant).
The names are the contract — the reference's ``docs/CHAOS.md``
catalogs them, the artifact records them per run, and the planted
negatives reference them by name — so a rename is an interface change,
not a cleanup.

Catalog (one line each; the scenario docstrings carry the detail):

* ``no_silent_verdict_loss`` — every record offered to the stack is
  accounted: served, quarantined, or counted lost — never vanished.
* ``counters_conserved`` — restart/aggregation accounting sums each
  rank's latest generation exactly once.
* ``recovery_within_bound`` — a killed rank is re-serving (or
  terminally parked) within the scenario's stated bound.
* ``fail_open_holds`` — the surviving shards/ranks keep serving
  through a peer's death; nothing cascades.
* ``corrupt_ckpt_refused`` — a corrupt/truncated checkpoint can never
  be silently loaded (named error, CRC catches clean-decode flips).
* ``ckpt_fallback_to_prev`` — restore falls back to the retained
  ``.prev`` generation, loudly, and the restored state IS that
  generation's.
* ``crash_loop_parks`` — a rank dying instantly parks as failed
  within its sliding-window budget instead of respawning unboundedly.
* ``respawn_backoff_spacing`` — consecutive crash-loop deaths are
  spaced by at least the exponential backoff ladder.
* ``bad_slot_skipped_counted`` — a corrupt sealed-slot header is
  skipped and counted without killing the drain.
* ``poison_quarantined`` — an out-of-range sealed batch is
  quarantined (counted + spooled), never dispatched, never a crash.
* ``seq_gap_counted`` — sequence corruption surfaces in the gap
  counters, never as reordered flow updates.
* ``gossip_drop_counted_never_blocks`` — a stalled/flooded mailbox
  drops-and-counts; the publisher never blocks the sink path.
* ``gossip_delivered_converges`` — every wire that WAS delivered
  merges last-wins; drops + merges account every publish.
* ``clock_jump_counted_finite`` — non-monotone latency stamps are
  counted as negatives; percentiles stay finite and ordered.
* ``watchdog_trips_within_bound`` — a wedged pipe dumps stacks and
  fails loudly within 2x the stall bound, instead of hanging.
* ``health_degraded_reasons`` — the health ladder reports DEGRADED
  with the exact reasons the injected faults imply.
* ``sink_crash_atomicity`` — no backpressure waiter can observe
  (pending drained, crash unset) for a crashed group.
* ``net_partition_fail_open`` — a partitioned publisher keeps
  serving: publish and pump stay non-blocking, nothing cascades, and
  pre-cut state stays converged.
* ``net_heal_converges`` — after a partition heals, the canonical
  blacklist digests re-converge within a bounded number of gossip
  ticks (the anti-entropy resync's contract).
* ``net_reorder_bounded`` — reordered datagrams deliver in per-peer
  sequence order through a buffer that NEVER exceeds its window
  (evict-and-count past it, never stall, never grow).
* ``no_double_apply`` — duplicated datagrams are suppressed and
  counted; a verdict is applied to the sink exactly once.
* ``net_loss_accounted`` — a loss burst's sequence holes are conceded
  and counted (rx_gap); survivors deliver; delivered + lost accounts
  every sent wire.
* ``stale_epoch_refused`` — wires under a lying epoch stamp are
  refused-and-counted by the RANGE_EPOCH_SKEW_S bound, never applied.
* ``epoch_rebase_exact`` — a rebased verdict's ABSOLUTE expiry equals
  the originator's (within f32 quantization): the tx-epoch ->
  rx-epoch rebase loses no time.
* ``handoff_rows_conserved`` — a live shard handoff interrupted at
  ANY step loses no row and double-counts no row: the pre-handoff
  row multiset equals the post-state multiset exactly, with no key
  resident in two tables (cluster/rebalance.py ``rows_conserved``).
* ``layout_flip_converges`` — a committed layout-generation flip
  holds its fence until EVERY active rank has acked the new
  generation; a rank that missed the flip message stalls the fence,
  never splits the route.
* ``adopt_no_second_consumer`` — a supervisor adopting a live plane
  never spawns a second consumer for a span a live rank still
  drains: live ranks adopt untouched, only confirmed-dead ranks
  respawn.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class InvariantResult:
    """One named invariant's verdict for one scenario."""

    name: str
    ok: bool
    detail: str = ""

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def check(name: str, ok: bool, detail: str = "") -> InvariantResult:
    """Tiny constructor: keeps scenario code one-line-per-invariant."""
    return InvariantResult(name, bool(ok), detail)


def all_ok(results: list) -> bool:
    return all(r.ok for r in results)
