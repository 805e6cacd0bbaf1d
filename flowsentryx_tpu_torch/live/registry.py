"""The PROGRESS registry: every blocking or polling loop, and every
host wait on the device, in the port's protocol scope, with its declared
wake source, fairness assumption, progress obligation and bound.

Counterpart of ``flowsentryx_tpu/live/registry.py``, declared again for
this package's loops.  A wait that is not written down here is a wait
nobody proved anything about.  Each entry declares

* **wake** — which event un-parks the loop (a cv notify, a mailbox
  publish, a ctl stamp, a deadline, a CUDA event firing),
* **fairness** — what the proof assumes of the scheduler,
* **obligation** — what must keep happening while the loop is live,
* **bound** — the NAME of the :mod:`flowsentryx_tpu_torch.sync.tuning`
  constant bounding the wait, so the runtime and the checker share one
  number,
* **proof** — the ``fsx live`` check that drives this loop's real code
  (empty for waits whose story is a bound or a hard timeout only).

The port's host waits on the device through ``synchronize()`` (a CUDA
event's, or the whole device's), so its scan adds those calls as
blocking sites of kind ``device-wait``, each of which needs an entry of
that kind; and a ``while`` loop that sleeps through a method of its own
class (``Engine._idle``) is a poll loop like one that sleeps inline.

:func:`validate` closes the registry against the scan both ways: a
scanned site with no entry is a finding (unregistered wait), an entry
matching no scanned site is a finding (stale registry), and an entry
whose named proof did not run in this report is a finding
(never-exercised claim).

Pure ``ast`` and :mod:`tuning`: no torch.
"""

from __future__ import annotations

import ast
import dataclasses
from pathlib import Path

from flowsentryx_tpu_torch.sync import tuning

_PKG = "flowsentryx_tpu_torch"
_ENGINE = f"{_PKG}/engine/engine.py"

#: The device-wait story of the quiescent methods' whole-device syncs.
_QUIESCENT_SYNC = dict(
    kind="device-wait",
    wake="the device finishes the work already enqueued (a finite queue: "
         "no thread launches while the engine is quiescent)",
    fairness="none needed (no other host thread is waited on)",
    obligation="the device drains; standalone there is no in-process "
               "timeout, in a fleet the supervisor declares a rank that "
               "stopped heartbeating dead and respawns it",
    bound="SUPERVISOR_HEARTBEAT_TIMEOUT_S",
    proof="")


@dataclasses.dataclass(frozen=True)
class ProgressEntry:
    """One registered blocking/polling loop or device wait."""

    name: str        # registry key, unique
    path: str        # repo-relative module path
    qualname: str    # enclosing function/method (dotted, class-level)
    kind: str        # "cv-wait" | "poll" | "retry" | "device-wait"
    wake: str        # declared wake source
    fairness: str    # scheduler assumption the proof leans on
    obligation: str  # what must keep happening
    bound: str       # tuning constant name bounding the wait
    proof: str       # fsx live check exercising it ("" = bound-only)


#: The registry, ordered by module.
PROGRESS: tuple[ProgressEntry, ...] = (
    # -- SinkChannel (sync/channel.py) --------------------------------------
    ProgressEntry(
        name="channel_wait_below",
        path=f"{_PKG}/sync/channel.py",
        qualname="SinkChannel.wait_below",
        kind="cv-wait",
        wake="complete()/record_exc() notify_all",
        fairness="weak (the sink thread keeps completing)",
        obligation="pending drains below the backpressure depth",
        bound="BACKPRESSURE_WAIT_S",
        proof="channel_stop_drain_live"),
    ProgressEntry(
        name="channel_pop",
        path=f"{_PKG}/sync/channel.py",
        qualname="SinkChannel.pop",
        kind="cv-wait",
        wake="submit()/submit_many()/request_stop() notify_all",
        fairness="weak (the dispatch thread keeps submitting or stops)",
        obligation="queued work is popped; stop+drained returns None",
        bound="POP_WAIT_S",
        proof="channel_stop_drain_live"),
    # -- the engine (engine/engine.py) ---------------------------------------
    ProgressEntry(
        name="engine_sink_worker",
        path=_ENGINE,
        qualname="Engine._sink_worker",
        kind="poll",
        wake="SinkChannel.pop (submit/stop notify_all)",
        fairness="weak (the dispatch thread lives while work is queued)",
        obligation="every submitted group is sunk or its crash recorded",
        bound="POP_WAIT_S",
        proof="channel_stop_drain_live"),
    ProgressEntry(
        name="engine_wait_event_poll",
        path=_ENGINE,
        qualname="Engine._wait_event",
        kind="poll",
        wake="the CUDA event fires when the device finishes the dispatch "
             "(or, in _claim, the last dispatch staged in the arena slot)",
        fairness="none needed (the dispatch thread polls query() and "
                 "yields between polls)",
        obligation="the event fires, or the watchdog checked between "
                   "polls soft-trips after WATCHDOG_STALL_S without a "
                   "completion and raises WatchdogStall after twice that",
        bound="WATCHDOG_STALL_S",
        proof=""),
    ProgressEntry(
        name="engine_wait_event_sink_sync",
        path=_ENGINE,
        qualname="Engine._wait_event",
        kind="device-wait",
        wake="the CUDA event fires when the device finishes the dispatch",
        fairness="none needed (a device wait, no host thread involved)",
        obligation="hard timeout only: the sink thread blocks in "
                   "ev.synchronize() with no timeout of its own; a wedged "
                   "card is tripped by the dispatch thread's watchdog "
                   "(every dispatch-side wait checks it: the backpressure "
                   "wait's on_wait, _wait_event's poll, _reap_ready), "
                   "which raises WatchdogStall after 2 x WATCHDOG_STALL_S "
                   "without a completion; _stop_sink_thread's join is then "
                   "bounded and the daemon sink thread abandoned.  "
                   "watchdog_s=0 disables the trip and this wait is "
                   "unbounded",
        bound="WATCHDOG_STALL_S",
        proof=""),
    ProgressEntry(
        name="engine_run_inline",
        path=_ENGINE,
        qualname="Engine._run_inline",
        kind="poll",
        wake="records polled from the source, or staged work to dispatch "
             "(Engine._idle yields within IDLE_SPIN_S of an arrival, "
             "else sleeps IDLE_SLEEP_S)",
        fairness="none needed (sleep-bounded poll)",
        obligation="the loop re-polls within one idle sleep",
        bound="IDLE_SLEEP_S",
        proof=""),
    ProgressEntry(
        name="engine_run_sealed",
        path=_ENGINE,
        qualname="Engine._run_sealed",
        kind="poll",
        wake="sealed batches from the ingest workers (Engine._idle "
             "between empty polls)",
        fairness="none needed (sleep-bounded poll)",
        obligation="the loop re-polls within one idle sleep",
        bound="IDLE_SLEEP_S",
        proof=""),
    ProgressEntry(
        name="engine_sealed_loop_ring",
        path=_ENGINE,
        qualname="Engine._sealed_loop_ring",
        kind="poll",
        wake="sealed batches from the ingest workers (Engine._idle "
             "between empty polls)",
        fairness="none needed (sleep-bounded poll)",
        obligation="the loop re-polls within one idle sleep",
        bound="IDLE_SLEEP_S",
        proof=""),
    ProgressEntry(name="engine_warm_sync", path=_ENGINE,
                  qualname="Engine.warm", **_QUIESCENT_SYNC),
    ProgressEntry(name="engine_restore_sync", path=_ENGINE,
                  qualname="Engine.restore", **_QUIESCENT_SYNC),
    ProgressEntry(name="engine_quiescent_table_sync", path=_ENGINE,
                  qualname="Engine._quiescent_table", **_QUIESCENT_SYNC),
    ProgressEntry(name="engine_write_table_sync", path=_ENGINE,
                  qualname="Engine._write_table", **_QUIESCENT_SYNC),
    # -- gossip plane (cluster/gossip.py) -------------------------------------
    ProgressEntry(
        name="gossip_tick_rx",
        path=f"{_PKG}/cluster/gossip.py",
        qualname="GossipPlane.tick",
        kind="poll",
        wake="peer publish into the rx mailbox",
        fairness="weak (peer ticks keep draining their tx side)",
        obligation="anti-entropy merge runs despite shed deferrals",
        bound="SHED_MAX_DEFER",
        proof="shed_bounded"),
    ProgressEntry(
        name="gossip_quiesce",
        path=f"{_PKG}/cluster/gossip.py",
        qualname="GossipPlane._quiesce_steps",
        kind="poll",
        wake="idle-tick streak or deadline",
        fairness="none needed (deadline-bounded)",
        obligation="quiesce returns within the timeout",
        bound="GOSSIP_QUIESCE_S",
        proof="quiesce_terminates"),
    # -- fenced handoff (cluster/rebalance.py) --------------------------------
    ProgressEntry(
        name="handoff_ship",
        path=f"{_PKG}/cluster/rebalance.py",
        qualname="ship_rows",
        kind="retry",
        wake="recipient pop_slots frees mailbox capacity",
        fairness="weak (the recipient steps between run chunks)",
        obligation="the span ships or the handoff aborts at the bound",
        bound="HANDOFF_SHIP_TIMEOUT_S",
        proof="handoff_drop"),
    ProgressEntry(
        name="net_handoff_send",
        path=f"{_PKG}/cluster/rebalance.py",
        qualname="NetHandoff.send_stream",
        kind="retry",
        wake="peer cumulative ack datagram",
        fairness="none needed (deadline-bounded retransmit)",
        obligation="all slots acked or TimeoutError at the bound",
        bound="NET_HANDOFF_TIMEOUT_S",
        proof=""),
    ProgressEntry(
        name="net_handoff_recv",
        path=f"{_PKG}/cluster/rebalance.py",
        qualname="NetHandoff.recv_stream",
        kind="retry",
        wake="peer slot datagram",
        fairness="none needed (deadline-bounded)",
        obligation="the gap-free stream arrives or TimeoutError",
        bound="NET_HANDOFF_TIMEOUT_S",
        proof=""),
    # -- supervisor (cluster/supervisor.py) -----------------------------------
    ProgressEntry(
        name="supervisor_run",
        path=f"{_PKG}/cluster/supervisor.py",
        qualname="ClusterSupervisor.run",
        kind="poll",
        wake="rank state/heartbeat ctl stamps (bounded poll sleep)",
        fairness="weak (ranks keep stamping while alive)",
        obligation="handoffs finish or abort; stop-drain is bounded",
        bound="SUPERVISOR_DRAIN_TIMEOUT_S",
        proof="handoff_drop"),
    # -- net transport (cluster/transport.py) ---------------------------------
    ProgressEntry(
        name="net_pump_tx",
        path=f"{_PKG}/cluster/transport.py",
        qualname="NetMailbox.pump",
        kind="poll",
        wake="tx queue drains (bounded by the queue cap)",
        fairness="none needed (loop bounded by queue depth)",
        obligation="queued wires leave within one pump",
        bound="NET_OUTQ_MAX",
        proof=""),
    ProgressEntry(
        name="net_handshake",
        path=f"{_PKG}/cluster/transport.py",
        qualname="NetMailbox.handshake",
        kind="retry",
        wake="peer HELLO/ack datagram",
        fairness="none needed (deadline-bounded, fails open)",
        obligation="converges or fails open at the bound",
        bound="NET_HANDSHAKE_TIMEOUT_S",
        proof=""),
    # -- the process mesh (parallel/) ------------------------------------------
    ProgressEntry(
        name="mesh_collective_wait",
        path=f"{_PKG}/parallel/exchange.py",
        qualname="_run",
        kind="cv-wait",
        wake="the collective completes on every rank (gloo's transport "
             "delivers the peers' parts)",
        fairness="every rank makes the same collectives in the same order "
                 "(the leader's header names each op before its "
                 "collectives)",
        obligation="the collective completes, or raises PeerLost at the "
                   "group's timeout (a dead peer's closed link raises at "
                   "once); NCCL's stream-ordered wait is bounded by its "
                   "own watchdog",
        bound="MESH_TIMEOUT_S",
        proof=""),
    ProgressEntry(
        name="mesh_follower_loop",
        path=f"{_PKG}/parallel/follower.py",
        qualname="serve",
        kind="poll",
        wake="the leader's next header broadcast",
        fairness="weak (an idle leader sends a keepalive header at least "
                 "every MESH_PING_S)",
        obligation="each header's op runs; STOP returns; a silent or dead "
                   "leader raises at the group's timeout",
        bound="MESH_TIMEOUT_S",
        proof=""),
    ProgressEntry(
        name="mesh_step_timer_sync",
        path=f"{_PKG}/parallel/follower.py",
        qualname="StepTimer.event_ms",
        kind="device-wait",
        wake="the last timed step's end event fires when the device "
             "finishes the work already enqueued (the counters are read "
             "between steps: a finite queue)",
        fairness="none needed (no other host thread is waited on)",
        obligation="the device drains; a rank wedged here stops answering, "
                   "and the other ranks' next collective raises PeerLost at "
                   "the group's timeout",
        bound="MESH_TIMEOUT_S",
        proof=""),
)

#: Modules :func:`scan_blocking_sites` walks: the reference's protocol
#: scope (engine dispatch/sink, SinkChannel, gossip, rebalance,
#: supervisor, elastic autoscale, predict shedding, net transport), in
#: this package, and the process mesh's collectives and follower loop.
#: ``cluster/runner.py`` is absent as in the reference: its chunk loop
#: drives the serve, bounded by its run budgets.
SCAN_MODULES: tuple[str, ...] = tuple(f"{_PKG}/{m}" for m in (
    "sync/channel.py",
    "engine/engine.py",
    "cluster/gossip.py",
    "cluster/rebalance.py",
    "cluster/supervisor.py",
    "cluster/transport.py",
    "cluster/elastic.py",
    "engine/predict.py",
    "parallel/exchange.py",
    "parallel/follower.py",
))


def repo_root() -> Path:
    return Path(__file__).resolve().parents[2]


def registered_sites() -> set[tuple[str, str]]:
    """``(path, qualname)`` of every registered loop or wait."""
    return {(e.path, e.qualname) for e in PROGRESS}


def _noqa_lines(src: str) -> set[int]:
    return {i for i, line in enumerate(src.splitlines(), 1)
            if "noqa" in line}


def _calls_attr(node: ast.AST, attr: str) -> bool:
    return any(isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
               and n.func.attr == attr for n in ast.walk(node))


def _sleeping_methods(tree: ast.Module) -> set[tuple[str, str]]:
    """``(class, method)`` of every method whose body sleeps."""
    out = set()
    for cls in ast.walk(tree):
        if isinstance(cls, ast.ClassDef):
            for fn in cls.body:
                if (isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef))
                        and _calls_attr(fn, "sleep")):
                    out.add((cls.name, fn.name))
    return out


def scan_blocking_sites(root: Path | None = None) -> list[dict]:
    """AST scan of the protocol scope for blocking/polling sites: any
    ``*.wait(...)`` call (``cv-wait``), any ``*.synchronize()`` call
    (``device-wait``), any ``while True:`` loop, and any conditional
    ``while`` whose body sleeps or yields — inline, or through a call of
    a sleeping method of its own class (``poll``).  Returns one record
    per ``(path, qualname)`` with every matching line and kind.  ``#
    noqa`` on the line exempts it."""
    root = repo_root() if root is None else Path(root)
    sites: dict[tuple[str, str], dict] = {}

    def note(path: str, qualname: str, lineno: int, kind: str) -> None:
        rec = sites.setdefault(
            (path, qualname),
            {"path": path, "qualname": qualname, "lines": [],
             "kinds": []})
        rec["lines"].append(lineno)
        if kind not in rec["kinds"]:
            rec["kinds"].append(kind)

    for rel in SCAN_MODULES:
        p = root / rel
        if not p.exists():
            continue
        src = p.read_text()
        noqa = _noqa_lines(src)
        tree = ast.parse(src)
        sleepers = _sleeping_methods(tree)

        def helper_sleeps(loop: ast.While, cls: str | None,
                          sleepers=sleepers) -> bool:
            return cls is not None and any(
                isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
                and isinstance(n.func.value, ast.Name)
                and n.func.value.id == "self"
                and (cls, n.func.attr) in sleepers
                for n in ast.walk(loop))

        def walk(node, stack, cls, rel=rel, noqa=noqa):
            for ch in ast.iter_child_nodes(node):
                sub, sub_cls = stack, cls
                if isinstance(ch, ast.ClassDef):
                    sub, sub_cls = stack + [ch.name], ch.name
                elif isinstance(ch, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    sub = stack + [ch.name]
                qn = ".".join(stack) or "<module>"
                if isinstance(ch, ast.While) and ch.lineno not in noqa:
                    if (isinstance(ch.test, ast.Constant)
                            and ch.test.value is True):
                        note(rel, qn, ch.lineno, "while-true")
                    elif (_calls_attr(ch, "sleep")
                          or any(isinstance(n, (ast.Yield, ast.YieldFrom))
                                 for n in ast.walk(ch))
                          or helper_sleeps(ch, cls)):
                        note(rel, qn, ch.lineno, "poll")
                if (isinstance(ch, ast.Call)
                        and isinstance(ch.func, ast.Attribute)
                        and ch.lineno not in noqa):
                    if ch.func.attr == "wait":
                        note(rel, qn, ch.lineno, "cv-wait")
                    elif ch.func.attr == "synchronize":
                        note(rel, qn, ch.lineno, "device-wait")
                walk(ch, sub, sub_cls)

        walk(tree, [], None)
    return sorted(sites.values(),
                  key=lambda r: (r["path"], r["qualname"]))


def validate(root: Path | None = None,
             exercised: set[str] | None = None) -> dict:
    """Close the registry against the scan (module docstring).  A site
    with a ``device-wait`` needs an entry of that kind.  ``exercised``
    is the set of check names a run actually executed; when given,
    entries claiming a proof that did not run are findings."""
    findings: list[str] = []
    seen: set[str] = set()
    for e in PROGRESS:
        if e.name in seen:
            findings.append(f"duplicate entry name {e.name!r}")
        seen.add(e.name)
        if not e.bound or not hasattr(tuning, e.bound):
            findings.append(
                f"{e.name}: bound {e.bound!r} is not a sync/tuning "
                "constant")
        if not e.wake or not e.obligation:
            findings.append(
                f"{e.name}: wake and obligation must be declared")
    sites = scan_blocking_sites(root)
    reg = registered_sites()
    device_reg = {(e.path, e.qualname) for e in PROGRESS
                  if e.kind == "device-wait"}
    for rec in sites:
        site = (rec["path"], rec["qualname"])
        if site not in reg:
            findings.append(
                "unregistered blocking loop: "
                f"{rec['path']}::{rec['qualname']} "
                f"(lines {rec['lines']}, {'/'.join(rec['kinds'])})")
        elif "device-wait" in rec["kinds"] and site not in device_reg:
            findings.append(
                "unregistered device wait: "
                f"{rec['path']}::{rec['qualname']} (lines {rec['lines']}) "
                "has no device-wait entry")
    scanned = {(r["path"], r["qualname"]): r for r in sites}
    for e in PROGRESS:
        rec = scanned.get((e.path, e.qualname))
        if rec is None:
            findings.append(
                f"stale entry {e.name}: no blocking loop at "
                f"{e.path}::{e.qualname}")
        elif e.kind == "device-wait" and "device-wait" not in rec["kinds"]:
            findings.append(
                f"stale entry {e.name}: no synchronize() call at "
                f"{e.path}::{e.qualname}")
    if exercised is not None:
        for e in PROGRESS:
            if e.proof and e.proof not in exercised:
                findings.append(
                    f"never exercised: {e.name} claims proof "
                    f"{e.proof!r} but that check did not run")
    return {"ok": not findings, "findings": findings,
            "entries": len(PROGRESS), "sites": len(sites)}
