"""Thread-contract lint: the registry of the port's shared mutable host
state and the ``ast`` pass that enforces it.

Counterpart of ``flowsentryx_tpu/sync/contracts.py``: the same checker
(the same finding kinds: discipline, unregistered, cursor, ctl,
registry), with every plan declared again over this package's own
classes.  The port's host plane is not the reference's:

* **No ring worker.**  The reference launches the drain ring from a
  pipeline worker thread; here the dispatch thread launches every
  dispatch (a CUDA graph replay returns at once), and a ring slot is
  uploaded on a copy stream instead (``Engine._upload_slot``).  The
  engine's in-process threads are the dispatch thread, the sink thread
  (``_sink_worker``) and the tiered warm's fill thread
  (``_warm_worker``), so the launch state is plainly dispatch-owned.
* **CUDA events are the cross-device waits.**  An arena slot is claimed
  again only after the event of the last dispatch staged in it fired
  (``_arena_event``); a ring device buffer is written again only after
  the round that read it copied it out (``_ring_dev_free``).  Both are
  written and consumed on the dispatch thread: the device, not a host
  thread, is the other party.
* **Capture beside serving.**  The fill thread captures graphs while the
  dispatch thread replays others: it publishes each graph as one
  rebind of ``_graphs``, and reads the live table and stats only for
  their addresses.

What the checker does, as in the reference:

* :data:`REGISTRY` declares, per class, every shared mutable field and
  the discipline that keeps it safe (owner thread, guarding lock,
  exclusive code section, atomic-reference swap, quiescent-only
  writes), each with its rationale.
* :func:`check_class` walks the real source: it attributes every read
  and write of a registered field to the thread contexts that can run
  the enclosing method (worker contexts from the declared thread
  targets, dispatch context from the public API, propagated through the
  class's call graph) and reports any access outside the declared
  discipline with file:line.
* A field MUTATED outside the quiescent methods in two thread contexts
  without an entry is itself a finding, so the registry cannot rot
  silently; so are entries naming fields or methods that no longer
  exist, and thread spawns whose target the registry never declared.
* :data:`CURSORS` pins the SPSC shm protocol: ``_head[0] = ...`` only in
  producer-side methods, ``_tail[0] = ...`` only in consumer-side ones.
* :data:`CTL_WRITERS` pins the one-writer-per-field rule of the sealed
  queue's and the cluster status block's control words.

Pure ``ast`` and the standard library: no torch, and none of the
checked modules is imported, so ``fsx sync --quick`` runs in
milliseconds on a host without a card.
"""

from __future__ import annotations

import ast
import dataclasses
from pathlib import Path

#: Contexts a method can execute under.  "dispatch" is the engine
#: caller's thread (the serving loop); "worker" is any in-process
#: helper thread spawned via Thread(target=...).
DISPATCH, WORKER = "dispatch", "worker"


@dataclasses.dataclass
class SyncFinding:
    """One violated thread contract, pinned to file:line."""

    contract: str    # discipline | unregistered | cursor | ctl | registry
    path: str        # repo-relative module path
    line: int
    where: str       # "Class.method" (or "Class" / "module")
    reason: str

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    def __str__(self) -> str:
        return (f"{self.path}:{self.line}: [{self.contract}] "
                f"{self.where}: {self.reason}")


@dataclasses.dataclass(frozen=True)
class FieldContract:
    """Discipline of one shared mutable field.

    ``discipline``:

    * ``"dispatch"`` — owner is the dispatch thread; any access from a
      method a worker context can execute is a violation.
    * ``"section:<name>"`` — accessed only inside the named exclusive
      code section (``ClassPlan.sections``): a set of methods that, by
      the runtime mode protocol, never run concurrently with each other
      or with any other accessor.
    * ``"cv"`` — every access lexically under ``with self.<lock>:``.
    * ``"cv-write"`` — writes under the lock; unlocked reads are
      declared benign (single CPython reference/int loads).
    * ``"atomic-ref"`` — reads anywhere; every write must be a plain
      whole-object assignment (no ``+=``, no item/attribute store).
    * ``"quiescent-write"`` — writes only in quiescent methods; reads
      anywhere (mode flags set before a worker exists).
    * ``"documented"`` — no mechanical rule; the entry registers the
      field and carries its rationale.

    ``extra`` grants specific additional methods access, each grant
    being part of the documented discipline (e.g. a read that is
    unreachable while the worker is active, guarded by a mode flag).
    """

    discipline: str
    rationale: str
    extra: tuple[str, ...] = ()


@dataclasses.dataclass(frozen=True)
class ClassPlan:
    """Registry entry for one concurrent class."""

    module: str                       # repo-relative path
    cls: str
    fields: dict                      # field -> FieldContract
    worker_targets: tuple[str, ...] = ()   # declared Thread targets
    sections: dict = dataclasses.field(default_factory=dict)
    quiescent: tuple[str, ...] = ()   # boot/teardown methods: no worker
    #                                   alive while they run (documented)
    lock_attr: str = ""               # the lock attribute for cv rules


@dataclasses.dataclass(frozen=True)
class CursorPlan:
    """SPSC cursor single-writer rule for one shm class."""

    module: str
    cls: str
    producer: tuple[str, ...]   # methods allowed to store head[0]
    consumer: tuple[str, ...]   # methods allowed to store tail[0]
    head: str = "_head"
    tail: str = "_tail"


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------

_PKG = "flowsentryx_tpu_torch"

_ENGINE_QUIESCENT = (
    # Methods that run with no sink thread and no serving loop alive:
    # construction, warm (before it starts the fill thread), stream
    # rebinding, checkpoint/restore, the report, thread start/stop, and
    # the live-handoff table accessors (cluster/rebalance.py calls them
    # at chunk boundaries, between runs, as it calls checkpoint()).
    "__init__", "_alloc_slots", "_new_batcher", "warm", "_capture",
    "reset_stream", "_reset_counters", "restore", "checkpoint",
    "_build_report", "_boot_report", "_start_sink_thread",
    "_stop_sink_thread", "watch_artifact", "_quiescent_table",
    "_write_table", "extract_span_rows", "drop_span_rows", "adopt_rows",
    "count_rebalance",
)

_ENGINE_SINK = (
    # The sink section: wait for a dispatch's event, decode its wire
    # (or block record), apply the updates, record the latency.  It runs
    # on the sink thread while one is active, else on the dispatch
    # thread (_reap, _reap_ready) — never both: _sink_active is written
    # only while no sink thread exists.
    "_sink_one",
)

_SINK = FieldContract(
    "section:sink",
    "sink accounting, written by the readback in _sink_one: one sinker "
    "at a time (the sink thread, or the dispatch thread without one)")
_DISP = FieldContract(
    "dispatch",
    "dispatch-thread state: staging, launching and polling all run on "
    "the serving loop's thread, and no worker touches it")
_LAUNCH = FieldContract(
    "dispatch",
    "launch accounting: the dispatch thread launches every dispatch, "
    "ring rounds included (there is no ring worker in the port)")
_CARRY = FieldContract(
    "dispatch",
    "the device carry, captured into every graph by address and "
    "written in place only by replays the dispatch thread launches; "
    "the fill thread's _capture_one reads the two references for the "
    "addresses it records (its warm-ups run on a scratch table and "
    "stats, and a capture executes nothing)",
    extra=("_capture_one",))
_UPLOAD = FieldContract(
    "dispatch",
    "the drain ring's upload side: the dispatch thread issues every "
    "upload on the copy stream and every round on the step's stream; "
    "the device orders them by the events kept here")
_LAUNCH_LOCKED = FieldContract(
    "cv",
    "the live model swap's accounting: hot_swap may run on any thread "
    "and _launch on the dispatch thread, so both touch it only under "
    "the launch lock")

ENGINE_PLAN = ClassPlan(
    module=f"{_PKG}/engine/engine.py",
    cls="Engine",
    worker_targets=("_sink_worker", "_warm_worker"),
    sections={"sink": _ENGINE_SINK},
    quiescent=_ENGINE_QUIESCENT,
    lock_attr="_launch_lock",
    fields={
        # -- the device carry and launch accounting ----------------------
        "table": _CARRY, "stats": _CARRY,
        "_n_dispatched": _LAUNCH, "_group_hist": _LAUNCH,
        "_ring_rounds": _LAUNCH, "_ring_partial_slots": _LAUNCH,
        # -- the sink section --------------------------------------------
        "_d2h_bytes": _SINK, "_sink_compact": _SINK,
        "_sink_fallback": _SINK, "_route_drop": _SINK,
        "_blocked": _SINK, "_device_now": _SINK, "_sunk_batches": _SINK,
        "_last_sink_t": FieldContract(
            "section:sink",
            "ready-reap coalescing clock, written at sink time",
            # _reap_ready returns before this read whenever a sink
            # thread is active (a mode-guarded access)
            extra=("_reap_ready",)),
        "_lat": FieldContract(
            "section:sink",
            "the latency plane (metrics.LatencyRecorder): recorded where "
            "the seal -> verdict interval closes, in the sink section; "
            "read only by the quiescent report"),
        "_first_verdict_s": FieldContract(
            "section:sink",
            "time-to-first-verdict stamp, written once by the sinker; "
            "read by the quiescent boot report"),
        # -- the card's cross-device guards (no reference counterpart) ---
        "_arena_event": FieldContract(
            "dispatch",
            "per arena slot, the CUDA event of the last dispatch staged "
            "in it: _launch records it, _claim waits on it before the "
            "slot is staged again — both on the dispatch thread, the "
            "device being the other party (its upload of the slot "
            "precedes the event)"),
        "_arena": FieldContract(
            "dispatch",
            "the pinned staging arena: claimed, staged and handed to "
            "uploads on the dispatch thread only"),
        "_ring_dev": _UPLOAD,
        "_ring_dev_free": FieldContract(
            "dispatch",
            "per ring device buffer, the event after which the round "
            "that read it has copied it out: _launch records it, "
            "_upload_slot makes the copy stream wait on it before the "
            "buffer is written again"),
        "_ring_dev_next": FieldContract(
            "dispatch",
            "round-robin cursor over the 2R ring device buffers, "
            "advanced by _upload_slot"),
        "_copy_stream": _UPLOAD,
        "_stream": FieldContract(
            "quiescent-write",
            "the step's stream, bound at construction: the sink thread's "
            "overflow copy (_fetch_blocks) and hot_swap enqueue on it"),
        "_wire_host": FieldContract(
            "quiescent-write",
            "the pinned verdict-wire slots, built by _alloc_slots: "
            "_launch enqueues the device-to-host copy into slot n, the "
            "sinker reads it after the dispatch's event, and slot n is "
            "reused only readback_depth + 2 dispatches later, after the "
            "dispatch was sunk"),
        "_blocks_slot": FieldContract(
            "quiescent-write",
            "the block-record slots, same lifecycle as _wire_host"),
        "_graphs": FieldContract(
            "atomic-ref",
            "the captured graphs: warm() captures the serving tier "
            "quiescent, the fill thread captures the rest beside "
            "serving and publishes each graph as one rebind of the "
            "whole dict, before it adds the rung to the ready set; "
            "_launch reads one ready key per dispatch"),
        "_sink_local": FieldContract(
            "documented",
            "thread-local: the sink thread marks itself (worker = True) "
            "so that _wait_event blocks there instead of polling"),
        # -- latency-budget serving --------------------------------------
        "_rung_ewma_s": FieldContract(
            "dispatch",
            "per-rung step-time EWMA: seeded by the quiescent warm "
            "pass, refined by the launch tail (_note_step_s, "
            "_note_round_s) and read by the dispatch-thread policy"),
        "_round_floor_s": FieldContract(
            "dispatch",
            "warm-seed floors of the ring-round EWMA keys, read by "
            "_note_round_s"),
        "slo_us": FieldContract(
            "quiescent-write",
            "latency-budget mode flag, written only at construction"),
        "_slo_budget_s": FieldContract(
            "quiescent-write", "the budget in seconds, same lifecycle"),
        # -- dispatch-thread-owned ---------------------------------------
        "_inflight": FieldContract(
            "dispatch",
            "dispatched-but-unsunk entries staged for the sink thread; "
            "_busy_depth reads it, and is reachable from the sink thread "
            "only through _wait_event's polling branch, which the sink "
            "thread never takes (it blocks in synchronize instead)",
            extra=("_busy_depth",)),
        "_pending": _DISP, "batcher": _DISP,
        "_staged_batches": _DISP, "_staged_bytes": _DISP,
        "_h2d_put_s": _DISP, "_h2d_overlap_s": _DISP, "_h2d_puts": _DISP,
        "_h2d_puts_overlapped": _DISP, "_t0_auto": _DISP,
        "_watch_path": _DISP, "_watch_mtime": _DISP,
        "_watch_next": _DISP, "_last_arrival_t": _DISP,
        "_restore_fallbacks": _DISP,
        "_gov": FieldContract(
            "dispatch",
            "the predictive dispatch governor (engine/predict.py, its "
            "own PREDICT_PLAN): observed, updated and read on the "
            "serving loop only"),
        "_warm_buf": FieldContract(
            "dispatch",
            "lazily built masked batch of the governor's pre-warms"),
        "_rebalance": FieldContract(
            "dispatch",
            "live-handoff counters, advanced at chunk boundaries; read "
            "by the quiescent report"),
        # -- the live model swap (launch lock) ---------------------------
        "_batches_launched": _LAUNCH_LOCKED, "_swap_at": _LAUNCH_LOCKED,
        "_swap_staging": _LAUNCH_LOCKED,
        "_hot_swaps": FieldContract(
            "cv-write",
            "swap counter: advanced by hot_swap under the launch lock; "
            "the reload announcement's unlocked read is one int load"),
        "params": FieldContract(
            "atomic-ref",
            "on the CPU hot_swap rebinds it whole (a launch reads it "
            "once); on the card it copies INTO the captured tensors "
            "under the launch lock and never rebinds"),
        "score_params": FieldContract(
            "quiescent-write",
            "the int8 scorer's ScorePack, built at construction; hot_swap "
            "rewrites its buffer in place under the launch lock"),
        # -- boot: warm and the fill thread ------------------------------
        "step": FieldContract(
            "quiescent-write",
            "the single step function, bound at construction"),
        "megasteps": FieldContract(
            "quiescent-write",
            "the ladder's step functions, bound at construction"),
        "ring_step": FieldContract(
            "quiescent-write",
            "the ring's round function, bound at construction"),
        "_ready_sizes": FieldContract(
            "atomic-ref",
            "the ready rungs: grown by the fill thread as one tuple "
            "rebind per captured rung, after the graph's own rebind; a "
            "stale read picks a smaller ready rung, never an uncaptured "
            "one"),
        "_ring_ready": FieldContract(
            "atomic-ref",
            "ring-engagement flag, flipped once by the fill thread "
            "after the ring's graph is published; a stale False routes "
            "one more round through the top rung (the same bytes)"),
        "_boot": FieldContract(
            "atomic-ref",
            "EngineReport.boot: warm() seeds it quiescent, the fill "
            "thread extends it by whole-dict rebinds, the report reads "
            "one reference"),
        "_warm_plan": FieldContract(
            "quiescent-write",
            "the fill thread's work list, written by warm() before the "
            "thread starts; read-only on the worker"),
        "_warm_thread_obj": FieldContract(
            "quiescent-write",
            "fill-thread handle: written by warm(); warm_fill_active and "
            "warm_fill_join read it from anywhere",
            extra=("warm_fill_active", "warm_fill_join")),
        "_cache": FieldContract(
            "documented",
            "the kernel compile cache: bound at construction, used by "
            "the quiescent warm pass only (the fill thread builds no "
            "kernel)"),
        "_boot_t0": FieldContract(
            "quiescent-write",
            "construction-time boot anchor, a constant afterwards"),
        "boot_import_s": FieldContract(
            "quiescent-write",
            "engine-stack import wall, stamped by the caller before "
            "run(); read by the quiescent report"),
        "_sink_active": FieldContract(
            "quiescent-write",
            "mode flag: written only while no sink thread exists "
            "(_start/_stop_sink_thread); racy reads are stable"),
        "_chan": FieldContract(
            "documented",
            "the SinkChannel: its own cv discipline is CHANNEL_PLAN; "
            "engine-side use is method calls"),
        "metrics": FieldContract(
            "documented",
            "per-stage timers with one owner each: fill/pop/stage and "
            "dispatch on the dispatch thread, readback/e2e in the sink "
            "section"),
        "sink": FieldContract(
            "documented",
            "t0_ns is written on the dispatch thread before the first "
            "batch reaches the sink section (the channel's cv is the "
            "happens-before edge); apply() runs in the sink section"),
        "on_reap": FieldContract(
            "documented",
            "bound by the caller before run() and cleared quiescent "
            "(reset_stream); read-only while serving"),
        "_watchdog": FieldContract(
            "documented",
            "dispatch watchdog (engine/watchdog.py): note_progress() "
            "runs in the sink section storing one monotonic float; "
            "check() runs on the dispatch thread only (the reap paths, "
            "the backpressure wait's on_wait hook, _wait_event's poll); "
            "a stale stamp costs at worst one quantum of delayed stall "
            "detection"),
        "gossip": FieldContract(
            "documented",
            "cluster verdict plane (cluster/gossip.py): bound at "
            "construction; publish() runs in the sink section, tick() "
            "on the dispatch thread — field by field in GOSSIP_PLAN"),
    },
)

GOSSIP_PLAN = ClassPlan(
    module=f"{_PKG}/cluster/gossip.py",
    cls="GossipPlane",
    sections={
        # publish: called from Engine._apply_updates — the engine's
        # SINK section, single owner at a time (dispatch thread in
        # single-thread mode, else the sink/pipeline worker).
        "publish": ("publish",),
        # merge: called from Engine._reap_ready — always the dispatch
        # thread.  The two sections therefore CAN run concurrently,
        # which is exactly why their fields are disjoint.  quiesce is
        # the shutdown-convergence tick loop (same thread, after the
        # local drain closed).
        "merge": ("tick", "quiesce", "_quiesce_steps"),
    },
    quiescent=("__init__", "report", "set_state", "note_progress",
               "stop_requested"),
    fields={
        # -- publish side (engine sink section owns these) ------------
        "_pub_seq": FieldContract(
            "section:publish", "wire sequence counter, one publisher"),
        "_published": FieldContract(
            "section:publish",
            "this engine's own blocked map (last-wins), the published "
            "half of the convergence digest"),
        "_tx_wires": FieldContract(
            "section:publish", "publish accounting"),
        "_tx_dropped": FieldContract(
            "section:publish",
            "full-mailbox drops: the publisher NEVER blocks — a slow "
            "peer must not stall the sink path (fail-open)"),
        "_tx": FieldContract(
            "section:publish",
            "TX mailboxes: their head cursors are single-writer "
            "because only the publish section touches them"),
        # -- merge side (dispatch thread owns these) ------------------
        "_merged": FieldContract(
            "section:merge",
            "peers' blocked map (last-wins), the merged half of the "
            "convergence digest"),
        "_rx_wires": FieldContract("section:merge", "merge accounting"),
        "_rx_seq_gaps": FieldContract(
            "section:merge",
            "torn-restart / dropped-publish gap detector (counted, "
            "never silent)"),
        "_rx_next_seq": FieldContract(
            "section:merge", "per-peer expected sequence"),
        "_merge_ticks": FieldContract("section:merge",
                                      "merge accounting"),
        "_next_tick": FieldContract(
            "section:merge", "tick throttle clock (tuning"
            ".GOSSIP_MERGE_INTERVAL_S)"),
        "_ticks_deferred": FieldContract(
            "section:merge",
            "anti-entropy ticks shed under engine budget pressure "
            "(engine/predict.py governor): counted, never silent — "
            "the paced A/B's proof that deferral only happens under "
            "measured headroom pressure"),
        "_defer_streak": FieldContract(
            "section:merge",
            "consecutive-deferral cap (tuning.SHED_MAX_DEFER): "
            "pressure may stretch the merge cadence but never starve "
            "it"),
        "_rx": FieldContract(
            "section:merge",
            "RX mailboxes: their tail cursors are single-writer "
            "because only the merge section touches them"),
        # -- cross-section by protocol --------------------------------
        "sink": FieldContract(
            "documented",
            "merged-verdict sink, applied only in the merge section; "
            "rebindable only before serving (runner wiring) — the "
            "ENGINE sink is deliberately never reachable from here"),
        "status": FieldContract(
            "documented",
            "status-block wrapper: per-FIELD writer sides are the "
            "CTL_WRITERS contract (heartbeat from the merge tick, "
            "lifecycle fields from quiescent methods)"),
        "net": FieldContract(
            "documented",
            "multi-host transport (cluster/transport.py NetMailbox): "
            "the reference is __init__-set and never rebound; its "
            "per-field disciplines are NETMAILBOX_PLAN — publish() "
            "only calls its one publish-section method (queue_tx), "
            "tick() owns everything else"),
    },
)

NETMAILBOX_PLAN = ClassPlan(
    module=f"{_PKG}/cluster/transport.py",
    cls="NetMailbox",
    sections={
        # publish: GossipPlane.publish's net leg — the engine's SINK
        # section, single owner at a time.  Its ONLY transport method:
        # everything network-facing stays on the merge side.
        "publish": ("queue_tx",),
        # merge: GossipPlane.tick's net leg — the engine's dispatch
        # thread.  The socket, the per-peer sequence/reorder state,
        # the canonical epoch-rebased map and every counter live
        # here; handshake runs pre-serving on the same thread.
        "merge": ("pump", "_resync", "_prune_expired", "_recv_all",
                  "_rx_wire", "_drain_in_order", "_concede_hole",
                  "_accept", "_send_wire", "_send_ctl", "_sendto",
                  "pop_wires", "handshake"),
    },
    quiescent=("__init__", "add_peer", "close", "report"),
    fields={
        # -- the one cross-section seam -------------------------------
        "_outq": FieldContract(
            "documented",
            "sink-section -> merge-section wire handoff: a deque "
            "whose append (publish) and popleft (merge) ends are "
            "single-owner — the SPSC idiom in CPython's atomic deque "
            "ops; bounded by NET_OUTQ_MAX at the append side"),
        "txq_dropped": FieldContract(
            "section:publish",
            "handoff-full drops: the publisher NEVER blocks or "
            "bloats on a slow/partitioned network (fail-open, the "
            "full-shm-mailbox posture)"),
        # -- merge-side transport state -------------------------------
        "_sock": FieldContract(
            "section:merge",
            "the UDP socket: all sendto/recvfrom on the merge side "
            "(one thread), so datagram ordering per peer is the "
            "kernel's, not a race of ours"),
        "_tx_seq": FieldContract(
            "section:merge",
            "per-peer u64 wire sequence (split across two u32 packet "
            "words; boundary test-pinned)"),
        "_own_map": FieldContract(
            "section:merge",
            "wires this endpoint originated (original f32 bits) — "
            "the anti-entropy resync re-publishes these verbatim so "
            "the canonical digest survives the round trip exactly"),
        "net_map": FieldContract(
            "section:merge",
            "the canonical epoch-rebased map (key -> until_wall_us): "
            "cross-host digest convergence is pinned on this form"),
        "_rx_state": FieldContract(
            "section:merge",
            "per-peer dup-suppression + bounded reorder buffer "
            "(evict-and-count past NET_REORDER_WINDOW, never stall)"),
        "_ready": FieldContract(
            "section:merge",
            "accepted (rebased) wires staged for pop_wires — both "
            "ends merge-side"),
        "_peers_seen": FieldContract(
            "section:merge",
            "peer-discovery state: any datagram from a declared peer "
            "counts as discovery"),
        "_resync_peers": FieldContract(
            "section:merge",
            "peers owed a full-map resync (a HELLO arrived: reboot "
            "or partition heal)"),
        "_next_resync": FieldContract(
            "section:merge", "anti-entropy cadence clock"),
        "peers": FieldContract(
            "quiescent-write",
            "the peer address table: written only at construction/"
            "add_peer (pre-serving); merge-side reads are stable"),
        # -- merge-side counters (report reads them quiescent) --------
        "tx_wires": FieldContract("section:merge", "tx accounting"),
        "tx_pkts": FieldContract("section:merge", "tx accounting"),
        "tx_sock_drops": FieldContract(
            "section:merge",
            "sendto backpressure/refusal drops: drop-and-count, "
            "never raise (fail-open)"),
        "rx_pkts": FieldContract("section:merge", "rx accounting"),
        "rx_wires": FieldContract("section:merge", "rx accounting"),
        "rx_dup": FieldContract(
            "section:merge",
            "suppressed duplicate deliveries (counted, never "
            "re-applied)"),
        "rx_gap": FieldContract(
            "section:merge",
            "sequence holes conceded by the bounded reorder buffer "
            "(loss made countable, never silent)"),
        "reorder_evict": FieldContract(
            "section:merge",
            "wires delivered out of order because the window filled "
            "(bounded memory, never stall)"),
        "gap_timeouts": FieldContract(
            "section:merge",
            "holes conceded by age (NET_REORDER_TIMEOUT_S): loss "
            "stops parking its successors"),
        "rx_alien": FieldContract(
            "section:merge",
            "malformed/undeclared-source datagrams (an open UDP port "
            "hears things)"),
        "peer_restarts": FieldContract(
            "section:merge",
            "far-backward seq jumps read as peer restarts (state "
            "reset, counted)"),
        "epoch_skew_dropped": FieldContract(
            "section:merge",
            "wires refused for violating RANGE_EPOCH_SKEW_S after "
            "rebase (a lying epoch must not blacklist anyone)"),
        "epoch_skew_max": FieldContract(
            "section:merge",
            "worst observed post-rebase skew (gauge; feeds the "
            "net_epoch_skew_max DEGRADED reason)"),
        "resyncs": FieldContract("section:merge",
                                 "anti-entropy accounting"),
        "resync_deferred": FieldContract(
            "section:merge",
            "PERIODIC resyncs shed under engine budget pressure "
            "(engine/predict.py governor via GossipPlane.tick): "
            "counted, never silent; hello-triggered resyncs are "
            "never deferred"),
        "_resync_defer_streak": FieldContract(
            "section:merge",
            "consecutive-deferral cap (tuning.SHED_MAX_DEFER): "
            "pressure stretches the loss-repair bound, never "
            "starves it"),
        "hellos_rx": FieldContract("section:merge",
                                   "peer-discovery accounting"),
        "rx_overflow": FieldContract(
            "section:merge",
            "rx staging bound: a consumer slower than the inflow "
            "drops-and-counts (the resync re-delivers), never grows"),
        "pruned": FieldContract(
            "section:merge",
            "long-expired verdicts dropped from the resync'd own map "
            "(without it a long-serving engine re-broadcasts every "
            "key it ever condemned, forever)"),
    },
)

CHANNEL_PLAN = ClassPlan(
    module=f"{_PKG}/sync/channel.py",
    cls="SinkChannel",
    lock_attr="cv",
    quiescent=("__init__",),
    fields={
        "_q": FieldContract(
            "cv", "the handoff queue: every access under the cv"),
        "_stop": FieldContract(
            "cv", "drain-on-stop flag: every access under the cv"),
        "_pending": FieldContract(
            "cv-write",
            "backpressure count: writes under the cv; the unlocked "
            "pending-property read is a benign single int load",
            extra=("pending",)),
        "_exc": FieldContract(
            "cv-write",
            "crash slot: set under the cv ATOMICALLY with the pending "
            "decrement; unlocked reads (crashed/check) are benign — "
            "one None->exc transition per run",
            extra=("crashed", "check")),
        "busy_s": FieldContract(
            "cv-write",
            "occupancy total: advanced under the cv at complete(); "
            "read unlocked only by the quiescent report"),
    },
)

INGEST_PLAN = ClassPlan(
    module=f"{_PKG}/ingest/sharded.py",
    cls="ShardedIngest",
    quiescent=("__init__", "start", "close"),
    fields={
        # No in-process threads: every method runs on the engine's
        # dispatch thread.  The entries pin that — a future helper
        # thread touching these would trip the checker, and the
        # cross-PROCESS state is governed by the cursor/ctl plans.
        "_rr": _DISP, "_queues": _DISP, "_procs": _DISP,
        "_seqs": _DISP, "_dead": _DISP, "_stalled": _DISP,
        "_t0": _DISP, "_t0_first_seen": _DISP, "_batches": _DISP,
        "_records": _DISP, "_dropped_tail": _DISP, "_metrics": _DISP,
        "_crash": _DISP,
        # slot-validation / quarantine plane: counted on the
        # dequeue paths, i.e. the engine's dispatch thread
        "_bad_slots": _DISP, "_quarantined": _DISP,
        "_quarantined_records": _DISP, "_quarantine_dumps": _DISP,
    },
)

REBALANCE_PLAN = ClassPlan(
    module=f"{_PKG}/cluster/rebalance.py",
    cls="EngineRebalancer",
    quiescent=("__init__",),
    fields={
        # No in-process threads: reconcile() runs pre-warm and step()
        # runs inside the engine's serving loop — both on the rank's
        # dispatch thread.  The entries pin that (a helper thread
        # driving a handoff would race the engine's table accessors,
        # which are launch-section state), and the cross-PROCESS
        # protocol — who may write c_fence / c_handoff /
        # c_layout_ack, who may store the handoff mailbox's cursors —
        # is governed by CTL_WRITERS and the HandoffMailbox
        # CursorPlan below.
        "_acked_gen": FieldContract(
            "dispatch",
            "last layout generation this rank acked: the reconcile/"
            "flip dedup latch"),
        "_fence_seen": FieldContract(
            "dispatch",
            "the serve-one-more-chunk latch: a donor ships only on "
            "the SECOND fenced tick, so rows already dispatched "
            "before the fence landed are in the table when the span "
            "is extracted"),
        "_staged": FieldContract(
            "dispatch",
            "rows received + spooled but not yet flipped in "
            "(id, keys, states); discarded when the fence clears "
            "without a flip (counted staged_discarded)"),
        "_receiver": FieldContract(
            "dispatch",
            "the per-handoff stream reassembler (seq/CRC "
            "discipline); reset whenever a stream is refused"),
        "_mbx": FieldContract(
            "dispatch",
            "the recipient's attached handoff mailbox (consumer "
            "side of the CursorPlan)"),
        "_mbx_hid": FieldContract(
            "dispatch",
            "handoff id _mbx was opened for: the retry-after-abort "
            "latch — a new handoff has a NEW mailbox file, so a "
            "stale mapping must be reopened, never drained"),
    },
)

PREDICT_PLAN = ClassPlan(
    module=f"{_PKG}/engine/predict.py",
    cls="DispatchGovernor",
    quiescent=("__init__", "reset_counters", "report"),
    fields={
        # The governor runs ENTIRELY on the engine's dispatch thread
        # (Engine._gov is dispatch-owned; every hook — note_arrivals
        # on the poll sites, update/pressure in _reap_ready,
        # flush_decision in _deadline_flush_due, prewarm_rung on the
        # idle branch — executes there).  These entries pin that: a
        # helper thread driving any of them would interleave the
        # forecast lifecycle (arm → judge → re-arm) and the actuation
        # counters the paced A/B evidence is built on.  reset_counters
        # is quiescent by the reset_stream contract (no batches in
        # flight), report by _build_report's.
        "predictor": FieldContract(
            "dispatch",
            "the BurstPredictor and its arrival window (_t/_n lists "
            "pruned in observe()): single-caller monotone-time "
            "protocol — a second observer thread would break the "
            "contiguous-tail pruning invariant"),
        "forecast": FieldContract(
            "dispatch",
            "the live Forecast (None = quiescent fallback): swapped "
            "whole-object by update(), read by every actuation"),
        "_last_estimate_t": FieldContract(
            "dispatch", "re-estimation throttle clock"),
        "_last_arrival_t": FieldContract(
            "dispatch",
            "newest arrival stamp — the onset hit/miss judge's "
            "evidence"),
        "_armed_onset": FieldContract(
            "dispatch",
            "the predicted future onset under watch (arm → judge → "
            "re-arm lifecycle in update())"),
        "_prewarmed_onset": FieldContract(
            "dispatch",
            "onset a pre-warm was already issued for: the once-per-"
            "onset latch"),
        "forecasts": FieldContract("dispatch", "actuation accounting"),
        "forecast_dropped": FieldContract(
            "dispatch",
            "forecasts expired by the confidence gate (the reactive-"
            "fallback transitions, counted)"),
        "onset_hits": FieldContract("dispatch",
                                    "per-onset forecast judging"),
        "onset_misses": FieldContract("dispatch",
                                      "per-onset forecast judging"),
        "prewarm_issued": FieldContract("dispatch",
                                        "pre-warm accounting"),
        "prewarm_hits": FieldContract("dispatch",
                                      "pre-warm accounting"),
        "prewarm_misses": FieldContract(
            "dispatch",
            "pre-warms spent on onsets that never arrived (the "
            "--alert-prewarm-miss signal)"),
        "early_flushes": FieldContract(
            "dispatch",
            "forecast-end flushes issued before the reactive rule "
            "was due — the p99 lever, counted"),
        "holds": FieldContract(
            "dispatch",
            "reactive-due flushes held inside a forecast on-window "
            "(budget-bounded; flush_decision docstring)"),
        "pressure_ticks": FieldContract(
            "dispatch",
            "iterations the shed-pressure signal fired on (pairs "
            "with the gossip/net deferral counters)"),
    },
)

ELASTIC_PLAN = ClassPlan(
    module=f"{_PKG}/cluster/elastic.py",
    cls="ElasticPolicy",
    quiescent=("__post_init__",),
    fields={
        # The policy is a pure decide-function driven ONLY by the
        # supervisor's control loop (its single thread) — these
        # entries pin that: the decision state must never be shared
        # with a helper thread, or hysteresis streaks and the
        # cooldown clock would interleave and the fleet would flap.
        "_streak": FieldContract(
            "dispatch",
            "consecutive-tick want counters (hysteresis): advanced "
            "by decide(), reset by executed()"),
        "_cooldown_until": FieldContract(
            "dispatch",
            "enforced-quiet deadline after an executed plan"),
        "suppressed": FieldContract(
            "dispatch",
            "plans wanted but not emitted (cooldown/clamp): feeds "
            "the elastic_plans_suppressed DEGRADED reason"),
        "decisions": FieldContract(
            "dispatch",
            "the audit log: every plan with its full signal vector "
            "(aggregate() surfaces the tail)"),
    },
)

REGISTRY: tuple[ClassPlan, ...] = (ENGINE_PLAN, CHANNEL_PLAN, INGEST_PLAN,
                                   GOSSIP_PLAN, NETMAILBOX_PLAN,
                                   REBALANCE_PLAN, ELASTIC_PLAN,
                                   PREDICT_PLAN)

CURSORS: tuple[CursorPlan, ...] = (
    CursorPlan(module=f"{_PKG}/engine/shm.py", cls="ShmRing",
               producer=("produce",), consumer=("consume", "advance")),
    CursorPlan(module=f"{_PKG}/engine/shm.py",
               cls="SealedBatchQueue",
               producer=("produce_batch",),
               consumer=("consume_batch", "release")),
    # cluster gossip mailbox: publish side lives in the SOURCE
    # engine's sink section, pop side on the DEST engine's dispatch
    # thread — one process per side, one thread per cursor
    CursorPlan(module=f"{_PKG}/cluster/mailbox.py",
               cls="VerdictMailbox",
               producer=("publish",),
               consumer=("pop_wires",)),
    # live-handoff mailbox (cluster/rebalance.py): donor publishes
    # from its serving loop, recipient pops from its own — one
    # process per side, the same TSO publish-after-copy /
    # release-after-copy protocol as the gossip mailbox, and the
    # same single-writer-per-cursor premise this plan makes checkable
    CursorPlan(module=f"{_PKG}/cluster/rebalance.py",
               cls="HandoffMailbox",
               producer=("_publish",),
               consumer=("pop_slots",)),
)

#: One writer side per sealed-queue control field (engine/shm.py
#: SealedBatchQueue docstring: "every control field has exactly one
#: writer side" — this is that claim, checkable).
CTL_WRITERS: dict[str, str] = {
    "hbeat": "worker", "first_ts": "worker", "wstate": "worker",
    "emit_drop": "worker",
    "t0": "engine", "stop": "engine", "spin_us": "engine",
    "idle_us": "engine",
    # cluster status block (cluster/mailbox.py StatusBlock): the
    # supervisor <-> engine lifecycle fields, cache-line-split by
    # writer side exactly like the queue cursors.  ENGINE-written:
    # heartbeat, lifecycle state, progress counters.
    "c_hbeat": "cluster-engine", "c_state": "cluster-engine",
    "c_batches": "cluster-engine", "c_records": "cluster-engine",
    # ... the elastic-fleet additions: the rank's pid (the
    # adopt census + adopted-rank liveness probe), its handoff phase
    # ack (handoff_id*8 + HP_*), and the layout generation it has
    # converged to — all ENGINE-written, the supervisor only reads.
    "c_pid": "cluster-engine", "c_handoff": "cluster-engine",
    "c_layout_ack": "cluster-engine",
    # SUPERVISOR-written: stop request, restart generation, the shared
    # cluster t0 epoch every gossiped `until` is relative to — and its
    # CLOCK_REALTIME twin, stamped at the same instant, which is what
    # lets a PEER HOST rebase this host's wires (cluster/transport.py).
    "c_stop": "supervisor", "c_gen": "supervisor",
    "c_t0": "supervisor", "c_t0_wall": "supervisor",
    # ... and the rebalance control pair: the committed layout
    # generation (the atomic route flip — engines converge TO it and
    # ack via c_layout_ack) and the handoff fence (nonzero = the
    # handoff id freezing this rank's span feed).  One writer each:
    # the coordinator that owns the handoff state machine.
    "c_layout_gen": "supervisor", "c_fence": "supervisor",
}

#: Which side each production module writes from.  Modules not listed
#: here must not call ctl_set at all (tests/scripts are out of scope —
#: they are harnesses, not the data plane).
CTL_MODULE_SIDE: dict[str, str] = {
    f"{_PKG}/ingest/worker.py": "worker",
    f"{_PKG}/ingest/sharded.py": "engine",
    f"{_PKG}/cluster/gossip.py": "cluster-engine",
    f"{_PKG}/cluster/runner.py": "cluster-engine",
    f"{_PKG}/cluster/rebalance.py": "cluster-engine",
    f"{_PKG}/cluster/supervisor.py": "supervisor",
}

#: Production modules swept for ctl_set sites.
_CTL_SCOPE = tuple(f"{_PKG}/{d}" for d in
                   ("ingest", "engine", "fused", "cluster"))


# ---------------------------------------------------------------------------
# AST machinery
# ---------------------------------------------------------------------------

def _self_chain(node: ast.AST) -> tuple[str, ...] | None:
    """``self.a.b.c`` -> ("a", "b", "c"); None when not self-rooted."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name) and node.id == "self":
        return tuple(reversed(parts))
    return None


@dataclasses.dataclass
class _Access:
    field: str
    kind: str     # read|write|augwrite|subwrite|deepwrite|deepuse
    line: int
    locked: bool


class _MethodInfo:
    def __init__(self) -> None:
        self.accesses: list[_Access] = []
        self.calls: set[str] = set()       # self.m() call edges
        self.refs: set[str] = set()        # bare self.m references
        self.spawns_thread = False


def _scan_method(fn: ast.AST, method_names: set[str],
                 lock_attr: str) -> _MethodInfo:
    """One full recursive pass over a method body: field accesses with
    lock state, intra-class call edges, bare method references, and
    whether the method spawns a thread."""
    info = _MethodInfo()
    called_funcs: set[int] = set()

    def write_roots(target: ast.AST, kind: str):
        """Record write accesses for one assignment target."""
        if isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                write_roots(elt, kind)
            return
        if isinstance(target, ast.Starred):
            write_roots(target.value, kind)
            return
        if isinstance(target, ast.Subscript):
            chain = _self_chain(target.value)
            if chain:
                info.accesses.append(_Access(
                    chain[0], "subwrite" if len(chain) == 1 else
                    "deepwrite", target.lineno, locked[-1]))
            return
        if isinstance(target, ast.Attribute):
            chain = _self_chain(target)
            if chain:
                k = kind if len(chain) == 1 else "deepwrite"
                info.accesses.append(_Access(
                    chain[0], k, target.lineno, locked[-1]))

    locked = [False]

    def visit(node: ast.AST) -> None:
        if isinstance(node, ast.With):
            is_lock = lock_attr and any(
                _self_chain(item.context_expr) == (lock_attr,)
                for item in node.items)
            for item in node.items:
                visit(item.context_expr)
            locked.append(locked[-1] or bool(is_lock))
            for stmt in node.body:
                visit(stmt)
            locked.pop()
            return
        if isinstance(node, ast.Call):
            called_funcs.add(id(node.func))
            chain = (_self_chain(node.func)
                     if isinstance(node.func, ast.Attribute) else None)
            if chain is not None:
                if len(chain) == 1:
                    info.calls.add(chain[0])
                else:
                    info.accesses.append(_Access(
                        chain[0], "deepuse", node.lineno, locked[-1]))
            func_names: list[str] = []
            n = node.func
            while isinstance(n, ast.Attribute):
                func_names.append(n.attr)
                n = n.value
            if isinstance(n, ast.Name):
                func_names.append(n.id)
            if "Thread" in func_names or "Process" in func_names:
                info.spawns_thread = True
        if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            kind = ("augwrite" if isinstance(node, ast.AugAssign)
                    else "write")
            for t in targets:
                write_roots(t, kind)
        if isinstance(node, ast.Delete):
            for t in node.targets:
                write_roots(t, "write")
        if isinstance(node, ast.Attribute) and isinstance(
                node.ctx, ast.Load):
            chain = _self_chain(node)
            if chain:
                if len(chain) == 1:
                    info.accesses.append(_Access(
                        chain[0], "read", node.lineno, locked[-1]))
                    if (chain[0] in method_names
                            and id(node) not in called_funcs):
                        info.refs.add(chain[0])
                # deeper loads surface through the root read above
                elif len(chain) > 1:
                    info.accesses.append(_Access(
                        chain[0], "read", node.lineno, locked[-1]))
        for child in ast.iter_child_nodes(node):
            visit(child)

    # visit children (not fn itself: its decorators/args are noise)
    for stmt in getattr(fn, "body", []):
        visit(stmt)
    return info


def _class_methods(tree: ast.Module, cls: str) -> dict[str, ast.AST]:
    for node in tree.body:
        if isinstance(node, ast.ClassDef) and node.name == cls:
            return {n.name: n for n in node.body
                    if isinstance(n, (ast.FunctionDef,
                                      ast.AsyncFunctionDef))}
    return {}


def _contexts(methods: dict[str, _MethodInfo],
              worker_targets: tuple[str, ...],
              public_seeds: list[str]) -> dict[str, set]:
    """Propagate thread contexts through the intra-class call graph.
    A bare reference to a non-target method counts as a call edge
    (conservative: the callable escapes into the referencer's
    context)."""
    ctx: dict[str, set] = {m: set() for m in methods}

    def flood(seed: str, tag: str) -> None:
        stack = [seed]
        while stack:
            m = stack.pop()
            if m not in ctx or tag in ctx[m]:
                continue
            ctx[m].add(tag)
            info = methods[m]
            for callee in info.calls | {
                    r for r in info.refs if r not in worker_targets}:
                if callee in ctx:
                    stack.append(callee)

    for t in worker_targets:
        if t in ctx:
            flood(t, WORKER)
    for m in public_seeds:
        flood(m, DISPATCH)
    return ctx


# ---------------------------------------------------------------------------
# checks
# ---------------------------------------------------------------------------

def _dedupe(findings: list[SyncFinding]) -> list[SyncFinding]:
    """One access site can surface as several AST records (a chained
    ``self.f.g(...)`` is a read + a deep use); report each violated
    (contract, line, where, reason) once."""
    seen: set[tuple] = set()
    out = []
    for f in findings:
        key = (f.contract, f.path, f.line, f.where, f.reason)
        if key not in seen:
            seen.add(key)
            out.append(f)
    return out


def check_class(tree: ast.Module, path: str,
                plan: ClassPlan) -> list[SyncFinding]:
    """Run the registered disciplines (and the unregistered-shared-
    state detector) over one class."""
    out: list[SyncFinding] = []
    fns = _class_methods(tree, plan.cls)
    if not fns:
        return [SyncFinding("registry", path, 1, plan.cls,
                            f"registered class {plan.cls!r} not found "
                            "in module — stale registry entry")]
    method_names = set(fns)
    scans = {m: _scan_method(fn, method_names, plan.lock_attr)
             for m, fn in fns.items()}

    # registry-rot guards: declared names must exist
    for t in plan.worker_targets:
        if t not in method_names:
            out.append(SyncFinding(
                "registry", path, 1, f"{plan.cls}.{t}",
                "declared thread target does not exist"))
    for sec, members in plan.sections.items():
        for m in members:
            if m not in method_names:
                out.append(SyncFinding(
                    "registry", path, 1, f"{plan.cls}.{m}",
                    f"section {sec!r} names a missing method"))
    for m in plan.quiescent:
        if m not in method_names:
            out.append(SyncFinding(
                "registry", path, 1, f"{plan.cls}.{m}",
                "quiescent list names a missing method"))
    all_fields = {a.field for s in scans.values() for a in s.accesses}
    for f in plan.fields:
        if f not in all_fields:
            out.append(SyncFinding(
                "registry", path, 1, f"{plan.cls}.{f}",
                "registered field is never accessed — stale entry"))

    # undeclared thread spawns: a bare method reference inside a
    # thread-spawning method must be a declared worker target
    for m, s in scans.items():
        if not s.spawns_thread:
            continue
        for r in s.refs:
            if r not in plan.worker_targets:
                out.append(SyncFinding(
                    "registry", path, fns[m].lineno, f"{plan.cls}.{m}",
                    f"thread spawned with undeclared target "
                    f"self.{r} — add it to the sync registry's "
                    "worker_targets (and give its shared state a "
                    "discipline)"))

    public = [m for m in fns if not m.startswith("_")] + ["__init__"]
    ctx = _contexts(scans, plan.worker_targets, public)
    quiescent = set(plan.quiescent)
    writes = ("write", "augwrite", "subwrite", "deepwrite")

    for m, s in scans.items():
        mctx = ctx[m]
        for a in s.accesses:
            fc = plan.fields.get(a.field)
            if fc is None:
                continue
            where = f"{plan.cls}.{m}"
            if m in quiescent or m in fc.extra:
                continue
            d = fc.discipline
            if d == "dispatch":
                if WORKER in mctx:
                    out.append(SyncFinding(
                        "discipline", path, a.line, where,
                        f"dispatch-owned field self.{a.field} "
                        f"accessed from a worker-reachable method "
                        f"(contexts: {sorted(mctx)}) — {fc.rationale}"))
            elif d.startswith("section:"):
                sec = d.split(":", 1)[1]
                if m not in plan.sections.get(sec, ()):
                    out.append(SyncFinding(
                        "discipline", path, a.line, where,
                        f"self.{a.field} belongs to the {sec!r} "
                        f"section ({', '.join(plan.sections[sec])}) "
                        f"and may not be touched elsewhere — "
                        f"{fc.rationale}"))
            elif d == "cv":
                if not a.locked:
                    out.append(SyncFinding(
                        "discipline", path, a.line, where,
                        f"self.{a.field} accessed outside "
                        f"'with self.{plan.lock_attr}:' — "
                        f"{fc.rationale}"))
            elif d == "cv-write":
                if a.kind in writes and not a.locked:
                    out.append(SyncFinding(
                        "discipline", path, a.line, where,
                        f"self.{a.field} WRITTEN outside "
                        f"'with self.{plan.lock_attr}:' — "
                        f"{fc.rationale}"))
            elif d == "atomic-ref":
                if a.kind in ("augwrite", "subwrite", "deepwrite"):
                    out.append(SyncFinding(
                        "discipline", path, a.line, where,
                        f"read-modify-write of atomic-ref field "
                        f"self.{a.field} ({a.kind}) — only a plain "
                        f"whole-object rebind is safe: {fc.rationale}"))
            elif d == "quiescent-write":
                if a.kind in writes:
                    out.append(SyncFinding(
                        "discipline", path, a.line, where,
                        f"self.{a.field} written outside the "
                        f"quiescent set ({', '.join(plan.quiescent)})"
                        f" — {fc.rationale}"))
            # "documented": registration only

    # unregistered shared-looking state: mutated (outside quiescent
    # methods) under >= 2 thread contexts without a registry entry
    write_ctx: dict[str, set] = {}
    write_site: dict[str, tuple] = {}
    for m, s in scans.items():
        if m in quiescent:
            continue
        for a in s.accesses:
            if a.kind in writes and a.field not in plan.fields:
                write_ctx.setdefault(a.field, set()).update(ctx[m])
                # point the finding at a worker-reachable site when
                # one exists — that is the racy half
                cur = write_site.get(a.field)
                if cur is None or (WORKER in ctx[m]
                                   and WORKER not in cur[2]):
                    write_site[a.field] = (a.line, m, ctx[m])
    for f, ctxs in sorted(write_ctx.items()):
        if len(ctxs) >= 2:
            line, m, _ = write_site[f]
            out.append(SyncFinding(
                "unregistered", path, line, f"{plan.cls}.{m}",
                f"self.{f} is mutated under {sorted(ctxs)} contexts "
                "but has no sync-registry entry — declare its "
                "discipline in sync/contracts.py (with its rationale) "
                "or move it off the shared path"))
    return _dedupe(out)


def check_cursors(tree: ast.Module, path: str,
                  plan: CursorPlan) -> list[SyncFinding]:
    """SPSC single-writer rule: cursor item-stores only on the
    declared side."""
    out: list[SyncFinding] = []
    fns = _class_methods(tree, plan.cls)
    if not fns:
        return [SyncFinding("registry", path, 1, plan.cls,
                            f"cursor-checked class {plan.cls!r} not "
                            "found — stale registry entry")]
    for m, fn in fns.items():
        scan = _scan_method(fn, set(fns), "")
        for a in scan.accesses:
            if a.kind not in ("subwrite", "deepwrite"):
                continue
            if a.field == plan.head and m not in plan.producer:
                out.append(SyncFinding(
                    "cursor", path, a.line, f"{plan.cls}.{m}",
                    f"head cursor stored outside the producer side "
                    f"({', '.join(plan.producer)}) — the TSO "
                    "plain-store protocol is single-writer per "
                    "cursor; a consumer-side head store races the "
                    "producer's publish"))
            if a.field == plan.tail and m not in plan.consumer:
                out.append(SyncFinding(
                    "cursor", path, a.line, f"{plan.cls}.{m}",
                    f"tail cursor stored outside the consumer side "
                    f"({', '.join(plan.consumer)}) — releasing slots "
                    "from the producer side would let it overwrite "
                    "unread records"))
    return _dedupe(out)


def check_ctl(tree: ast.Module, path: str,
              side: str | None) -> list[SyncFinding]:
    """Sealed-queue control block: one writer side per field."""
    out: list[SyncFinding] = []
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "ctl_set" and node.args):
            continue
        arg = node.args[0]
        if not (isinstance(arg, ast.Constant)
                and isinstance(arg.value, str)):
            continue  # the generic ctl_set definition itself
        field = arg.value
        owner = CTL_WRITERS.get(field)
        if owner is None:
            out.append(SyncFinding(
                "ctl", path, node.lineno, "module",
                f"ctl_set({field!r}) writes an UNDECLARED control "
                "field — add it to sync/contracts.py CTL_WRITERS "
                "with its single writer side"))
        elif side is None:
            out.append(SyncFinding(
                "ctl", path, node.lineno, "module",
                f"ctl_set({field!r}) from a module with no declared "
                "writer side — add the module to CTL_MODULE_SIDE"))
        elif owner != side:
            out.append(SyncFinding(
                "ctl", path, node.lineno, "module",
                f"ctl_set({field!r}) from the {side} side, but "
                f"{field!r} is {owner}-written — two writers on one "
                "plain-store TSO field is silent corruption"))
    return out


# ---------------------------------------------------------------------------
# runner
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SyncReport:
    ok: bool
    findings: list
    stats: dict

    def to_json(self) -> dict:
        return {"ok": self.ok,
                "stats": self.stats,
                "findings": [f.to_json() for f in self.findings]}


def _repo_root() -> Path:
    return Path(__file__).resolve().parents[2]


def run_contracts(root: Path | None = None,
                  quick: bool = False) -> SyncReport:
    """Run every registered contract over the port's tree.  ``quick``
    and full mode run the same checks (pure AST, milliseconds); the flag
    mirrors the ``fsx sync --quick`` surface."""
    root = Path(root) if root is not None else _repo_root()
    findings: list[SyncFinding] = []
    trees: dict[str, ast.Module] = {}

    def parse(rel: str) -> ast.Module | None:
        if rel not in trees:
            p = root / rel
            if not p.exists():
                findings.append(SyncFinding(
                    "registry", rel, 1, "module",
                    "registered module does not exist"))
                trees[rel] = None
            else:
                trees[rel] = ast.parse(p.read_text(), filename=rel)
        return trees[rel]

    n_fields = 0
    for plan in REGISTRY:
        tree = parse(plan.module)
        if tree is not None:
            findings += check_class(tree, plan.module, plan)
            n_fields += len(plan.fields)
    for cplan in CURSORS:
        tree = parse(cplan.module)
        if tree is not None:
            findings += check_cursors(tree, cplan.module, cplan)

    ctl_sites = 0
    for scope in _CTL_SCOPE:
        base = root / scope
        if not base.exists():
            continue
        for p in sorted(base.rglob("*.py")):
            rel = str(p.relative_to(root))
            tree = parse(rel)
            if tree is None:
                continue
            found = check_ctl(tree, rel, CTL_MODULE_SIDE.get(rel))
            findings += found
            ctl_sites += sum(
                1 for node in ast.walk(tree)
                if isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "ctl_set")

    return SyncReport(
        ok=not findings,
        findings=findings,
        stats={
            "classes": len(REGISTRY),
            "registered_fields": n_fields,
            "cursor_classes": len(CURSORS),
            "ctl_fields": len(CTL_WRITERS),
            "ctl_sites": ctl_sites,
            "quick": bool(quick),
        },
    )
