"""The timing constants of the host pipeline that this port reads.

Counterpart of ``flowsentryx_tpu/sync/tuning.py``: the same values,
with the reason for each.  All values are seconds unless the name says
otherwise.  Standard library only (a spawned ingest worker may import
it).
"""

from __future__ import annotations

#: Dispatch-thread GIL yield while the pipe is busy but nothing new is
#: sealable: a spinning dispatch loop holds the interpreter for whole
#: switch intervals and starves the sink thread's pure-Python decode
#: and writeback.  The reference sleeps 20 µs; on an H100 host measured
#: for this port any positive ``time.sleep`` lasts at least ~1 ms
#: (``sleep(20e-6)`` p50 0.97 ms, ``sleep(0)`` p50 19 µs), so the port
#: yields with ``sleep(0)``, which releases the GIL for a scheduler pass.
GIL_YIELD_S = 0.0

#: How long the serving loops keep yielding (``sleep(0)``) instead of
#: sleeping after the last record arrived: a positive sleep costs ~1 ms
#: on the card's host, a whole budget at ``--slo-us 1000``, so a link
#: that was busy in the last 10 ms (a pulse train, a bursty daemon ring)
#: is polled within tens of µs; an idle one falls back to
#: ``Engine``'s idle sleep.
IDLE_SPIN_S = 10e-3

#: Backpressure wait quantum of ``SinkChannel.wait_below``: every state
#: change notifies the condition variable, so this only bounds how
#: stale a missed wake-up could get.  It is also the watchdog's polling
#: period while the dispatch thread waits on the sink.
BACKPRESSURE_WAIT_S = 0.05

#: Worker-side pop wait quantum (``SinkChannel.pop``): the same
#: liveness bound, twice as long (an idle worker waking is cheaper than
#: a dispatch thread stalling).
POP_WAIT_S = 0.1

#: Single-thread mode's ready-reap coalescing: the least gap between
#: two sink groups while the pipe is shallow, capped at half the batch
#: deadline so that a small ``deadline_us`` keeps its budget.
MIN_SINK_GAP_S = 0.3e-3

#: Per-rung step-time EWMA smoothing of the latency-budget mode
#: (``serve --slo-us``): 0.2 follows ~90 % of a shift in ~10
#: observations without chasing single-step noise.  Applied only to a
#: launch whose call absorbed the compute; on the card's graph replays
#: the warm seed stands.
SLO_EWMA_ALPHA = 0.2

#: Dispatch-watchdog stall bound (``engine/watchdog.py``): batches in
#: flight and no completion for this long soft-trips (every thread's
#: stack dumped, a DEGRADED reason), for twice this long hard-trips (the
#: drain fails loudly instead of hanging).  Orders of magnitude above a
#: healthy gap between completions, so a trip means wedged, not slow.
WATCHDOG_STALL_S = 10.0

# -- predictive dispatch governor (engine/predict.py) -------------------------

#: Arrival-histogram bin width of the burst period estimator: pulse
#: periods of a few batch deadlines (single-digit ms) get 15-30 bins per
#: period, and a full estimator pass stays in the tens of µs.
PREDICT_BIN_S = 0.25e-3

#: Estimator observation window: ~40 periods of a 7.5 ms pulse, and it
#: follows a regime change within one window.
PREDICT_WINDOW_S = 0.3

#: Confidence gate: the normalized autocorrelation peak a forecast must
#: reach before any actuation.  A clean pulse wave scores above 0.7
#: within a few periods, steady or Poisson traffic near 0; below the
#: gate the governor is quiescent and the engine is the reactive one.
PREDICT_CONF_MIN = 0.5

#: Once a forecast is locked, tracking estimates keep it alive down to
#: ``PREDICT_CONF_MIN * this`` (hysteresis): arrivals observed at poll
#: times leave a real pulse wave's confidence hovering around the entry
#: gate.  Entry still needs the full gate.
PREDICT_CONF_EXIT_FRAC = 0.6

#: Box-smoothing width (bins) before the period search: a burst lands
#: as 1-3 clumps jittered by a dispatch-and-reap pass.  1 disables.
PREDICT_SMOOTH_BINS = 6

#: Least number of whole periods the window must span at the estimated
#: period for the estimate to count.
PREDICT_MIN_PERIODS = 4

#: Re-estimation cadence (the pass runs on the dispatch thread).
PREDICT_REESTIMATE_S = 0.05

#: Onset tolerance: arrivals within this of a predicted onset make it a
#: hit; an onset that passes by more than this with none is a miss.
PREDICT_ONSET_TOL_S = 2 * PREDICT_BIN_S

#: Pre-warm lead margin added to the predicted rung's step-time EWMA,
#: so that the masked dispatch retires before the burst lands.
PREDICT_PREWARM_MARGIN_S = PREDICT_BIN_S

#: Budget-pressure threshold: the pressure signal is on while the
#: oldest staged work's remaining headroom fraction is below this.
PREDICT_SHED_HEADROOM = 0.25

# -- the cluster (cluster/gossip.py, cluster/supervisor.py) --------------------

#: Gossip merge and heartbeat cadence (``GossipPlane.tick``, called from
#: the engine loop every iteration and throttled here): each tick stats
#: N-1 peer mailboxes, so 5 ms costs nothing measurable on the dispatch
#: thread, and a peer's block is enforced fleet-wide within one interval
#: plus one loop iteration — three orders of magnitude under the default
#: 10 s block time.
GOSSIP_MERGE_INTERVAL_S = 5e-3

#: Under the governor's budget pressure a due gossip tick is deferred by
#: this many merge intervals (anti-entropy drops to 1/4 rate, it does
#: not stop) ...
SHED_TICK_STRETCH = 4

#: ... and after this many consecutive deferrals it runs regardless:
#: shedding bounds the rate of merges, never their occurrence.
SHED_MAX_DEFER = 8

#: Supervisor liveness-poll cadence (``ClusterSupervisor.run``): bounds
#: how late a corpse is noticed, at a handful of u64 loads per rank.
SUPERVISOR_POLL_S = 0.05

#: A serving rank whose heartbeat (the gossip tick) is older than this
#: is reported stalled: ~1000 missed beats at the merge cadence.  Booting
#: over a plane refuses while any heartbeat is younger than twice this.
SUPERVISOR_HEARTBEAT_TIMEOUT_S = 5.0

#: Crash-loop respawn backoff: the k-th respawn inside the restart
#: window waits ``BASE * 2**(k-1)``, capped at MAX, so a rank that dies
#: at boot cannot burn its whole restart budget in milliseconds.
RESPAWN_BACKOFF_BASE_S = 0.1
RESPAWN_BACKOFF_MAX_S = 5.0

#: Only deaths inside this sliding window count against ``max_restarts``
#: (a crash after an hour of clean serving is a fresh incident).
RESTART_WINDOW_S = 60.0

#: Engine-exit gossip quiesce bound (``cluster/runner.py``): quiesce
#: returns after 3 idle ticks once every peer left SERVING; this is the
#: deadline for a backlogged plane.
GOSSIP_QUIESCE_S = 2.0

#: After a stop request every rank gets this long to serve its tail,
#: quiesce gossip and checkpoint before it is declared wedged.
SUPERVISOR_DRAIN_TIMEOUT_S = 60.0

#: ``ClusterSupervisor.close``: join each child this long, then SIGKILL.
SUPERVISOR_CLOSE_TIMEOUT_S = 10.0

# -- the elastic fleet (cluster/elastic.py, cluster/rebalance.py) -------------

#: Autoscaler decision cadence: the supervisor samples the signal vector
#: (ring backlog, record-rate skew) once per tick.  2 s sits between the
#: supervisor's poll (one dispatch burst would read as load) and the
#: report cadence (a backlog grows by millions of records a minute).
ELASTIC_TICK_S = 2.0

#: A grow, shrink or rebalance signal must hold this many consecutive
#: ticks before the policy emits a plan: one checkpoint stall or a
#: capture does not move the fleet, a real ramp waits ~6 s.
ELASTIC_HYSTERESIS_TICKS = 3

#: Quiet enforced after an executed plan, so the fleet shows its effect
#: before the next decision; suppressed decisions are counted and logged.
ELASTIC_COOLDOWN_S = 10.0

#: Grow when the mean ring backlog per live engine exceeds this many
#: records (several batches of pressure, not jitter).
ELASTIC_GROW_BACKLOG = 8192

#: Shrink when every live engine's backlog stays under this (sub-batch:
#: idle) and the fleet is above its floor.
ELASTIC_SHRINK_BACKLOG = 64

#: Rebalance (half the hottest rank's span to the coldest) when the
#: max/mean record-rate skew across live ranks exceeds this.
ELASTIC_SKEW_RATIO = 2.0

#: Donor-side ship bound (``rebalance.ship_rows``): a mailbox full for
#: this long means the recipient stopped draining; the handoff then
#: aborts and the donor keeps the span.
HANDOFF_SHIP_TIMEOUT_S = 30.0

#: Supervisor-side bound on a whole handoff (fence to every ack); past
#: it the supervisor aborts, which is always safe before the flip.
HANDOFF_TIMEOUT_S = 60.0

#: Bound of each side of the UDP handoff leg (``rebalance.NetHandoff``).
NET_HANDOFF_TIMEOUT_S = 10.0

# -- the multi-host gossip leg (cluster/transport.py) --------------------------

#: Reorder-buffer depth per remote peer (``NetMailbox``): out-of-order
#: datagrams wait here for the sequence hole to fill; past this depth
#: the oldest buffered wire is delivered out of order and counted
#: (``reorder_evict``) instead of the buffer growing.  16 wires (~9 KB
#: per peer) cover the reorder depth of a rack's ECMP and offload paths
#: (single-digit packets); a deeper hole is loss, and waiting on loss is
#: the coordinator coupling the gossip plane exists to avoid.
NET_REORDER_WINDOW = 16

#: How long a sequence hole may hold later wires in the reorder buffer
#: before it is conceded as loss (``rx_gap`` counted, the buffered wires
#: delivered in order).  Real reorder resolves in well under a ms on a
#: rack; 200 ms is orders above that and far under the 10 s default
#: block, so a lost wire delays its successors imperceptibly.
NET_REORDER_TIMEOUT_S = 0.2

#: A backward sequence jump deeper than this (wires) is a peer RESTART
#: (its sequence began again at 1), not a stale duplicate: the receive
#: state resets and is counted, instead of dropping the peer's whole new
#: life as duplicates.  4x the reorder window keeps real stragglers
#: (bounded by the window) inside duplicate suppression.
NET_RESTART_JUMP = 4 * NET_REORDER_WINDOW

#: Bound of the publish handoff queue (``NetMailbox.queue_tx``) and of
#: the receive staging queue: past it the wire is dropped and counted
#: (``txq_dropped``, ``rx_overflow``), never blocked on.  256 wires
#: (~144 KB) are ~1.3 s of headroom at the 5 ms gossip tick.
NET_OUTQ_MAX = 256

#: Peer discovery (``NetMailbox.handshake``): HELLO is re-sent to each
#: silent peer with exponential backoff from BASE, doubling to MAX,
#: within TIMEOUT overall.  50 ms is ~100x a rack's round trip, so one
#: lost HELLO costs little; 1 s keeps a long wait from hammering a dead
#: address; past 10 s (the supervisor's heartbeat bound) the caller
#: serves fail-open and converges when the peer appears (its first
#: HELLO triggers a full-map resync).
NET_HANDSHAKE_BACKOFF_BASE_S = 0.05
NET_HANDSHAKE_BACKOFF_MAX_S = 1.0
NET_HANDSHAKE_TIMEOUT_S = 10.0

#: Anti-entropy resync cadence (``NetMailbox.pump``): each endpoint
#: re-publishes its own blocked map to every peer this often, so UDP
#: loss and a healed partition (where no side died and no HELLO fires)
#: are repaired within one interval plus delivery.  0.5 s is 20x under
#: the default 10 s block, and the map is bounded by its expiries, so a
#: resync is a handful of wires.
NET_RESYNC_INTERVAL_S = 0.5

#: Supervisor federation beacon (``transport.HostBeacon``): each host's
#: supervisor beacons every interval; a peer host silent past the
#: timeout is DEAD (announced; fleet health folds FAILED).  Five missed
#: beacons is far past a GC or throttle pause and inside an operator's
#: glance, the intra-host heartbeat bound's discipline.
NET_BEACON_INTERVAL_S = 1.0
NET_HOST_TIMEOUT_S = 5.0
