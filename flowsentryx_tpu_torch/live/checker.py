"""``fsx live`` scenarios: the port's real protocols under the liveness
explorer.

Counterpart of ``flowsentryx_tpu/live/checker.py``.  Five protocol
scenarios (each built by an ``mk()`` over this package's real objects —
``SinkChannel``, the supervisor's fenced handoff over the crash
harness's sim plane, ``ElasticPolicy``, ``GossipPlane``) are proved
deadlock-free, livelock-free under weak fairness, and
bounded-starvation by :func:`flowsentryx_tpu_torch.sync.interleave
.explore_live`; four planted regressions each print the schedule that
catches them, with the clean run of the same scenario re-proved as the
control.  Then the PROGRESS registry (:mod:`.registry`) is validated
against its scan, and an entry whose named proof did not run here is a
finding.

Checker design notes (the traps that shaped it, as in the reference):

* **No obligations on the handoff scenario.**  Obligation clocks count
  steps along EVERY path, including the weakly-unfair spin paths a
  ``while not converged()`` loop necessarily has, so a starvation bound
  there would flag schedules the fairness assumption excludes.
* **Plant bounds freeze at import.**  ``streak_cap_removed`` patches
  ``tuning.SHED_MAX_DEFER`` at runtime (gossip reads the attribute at
  call time); the obligation bound below is computed at import, so the
  checker still holds the regression to the declared bound.
* **Model clock in the fingerprint is capped** and only advances while
  a handoff is in flight, so timeout paths stay explorable without the
  clock splitting states without end.
"""

from __future__ import annotations

import contextlib
import tempfile
import time

import numpy as np

from flowsentryx_tpu_torch.live import registry
from flowsentryx_tpu_torch.sync import tuning
from flowsentryx_tpu_torch.sync.channel import SinkChannel
from flowsentryx_tpu_torch.sync.interleave import (
    CvWait, InstrumentedCv, LiveCheckResult, LiveSpec, ModelViolation,
    Obligation, explore_live,
)

SCHEMA = "fsx-live-report-v1"

# Bounds FROZEN at import time (see module docstring): the
# streak-cap plant patches the tuning attribute the runtime reads,
# not these.
_SHED_BOUND = tuning.SHED_MAX_DEFER + 2
_SHED_ITERS = tuning.SHED_MAX_DEFER + 4
#: Model-clock handoff deadline (ticks, not seconds): long enough for
#: a full ship+commit+ack round, short enough that the abort path is
#: explored too.
_H_DEADLINE = 6


# ---------------------------------------------------------------------------
# scenario 1: SinkChannel submit → backpressure → stop → drain
# ---------------------------------------------------------------------------

def _mk_channel_live(n_items: int = 2):
    """Dispatch submits, parks on ``wait_below(0)``, then requests
    stop; the worker pops and completes.  Proves the channel's wake
    graph is closed: every park has a live notify edge."""

    def mk():
        chan = SinkChannel("sink thread")
        chan.cv = InstrumentedCv()
        st = {"completes": 0}

        def dispatch():
            for i in range(n_items):
                yield f"submit#{i}"
                chan.submit(i, 1)
            yield CvWait(
                lambda: chan._pending <= 0 or chan._exc is not None,
                "wait_below(0)", chan.cv,
                source="complete() notify_all")
            chan.wait_below(0)
            yield "request_stop"
            chan.request_stop()

        def worker():
            while True:
                yield CvWait(
                    lambda: bool(chan._q) or chan._stop,
                    "pop", chan.cv,
                    source="submit()/request_stop() notify_all")
                got = chan.pop()
                if got is None:
                    return
                yield "complete"
                chan.complete(len(got), 0.0, None)
                st["completes"] += len(got)

        def finale():
            if st["completes"] != n_items or not chan.drained():
                raise ModelViolation(
                    f"drain broken: {st['completes']}/{n_items} "
                    f"completed, drained={chan.drained()}")

        spec = LiveSpec(
            fingerprint=lambda: (chan._pending, tuple(chan._q),
                                 chan._stop, chan._exc is not None,
                                 st["completes"]),
            progress=lambda: (st["completes"],),
            obligations=[Obligation(
                "drain", lambda: chan._pending > 0,
                lambda: st["completes"], 8)],
            finale=finale)
        return [("dispatch", dispatch()), ("worker", worker())], spec

    return mk


def _check_channel(*, expect_violation=False, expect_marker=None,
                   check="channel_stop_drain_live") -> LiveCheckResult:
    return explore_live(check, _mk_channel_live(),
                        expect_violation=expect_violation,
                        expect_marker=expect_marker)


# ---------------------------------------------------------------------------
# scenario 2: fenced handoff with a dropped stamp at every edge
# ---------------------------------------------------------------------------

class _DropStatus:
    """Status proxy that swallows the FIRST ctl write matching the
    drop spec — the model's 'lost message' (torn write, respawn racing
    the stamp).  Everything else delegates."""

    def __init__(self, inner, drop, counter):
        self._inner = inner
        self._drop = drop
        self._counter = counter

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def ctl_get(self, name):
        return self._inner.ctl_get(name)

    def ctl_set(self, name, value):
        key, rank, match = self._drop
        if (self._counter["left"] > 0 and name == key
                and self._inner.rank == rank
                and (match is None
                     or (match == "nonzero" and value)
                     or (match == "zero" and not value))):
            self._counter["left"] -= 1
            return  # dropped on the floor
        self._inner.ctl_set(name, value)


#: (edge name, drop spec) — drop spec is (ctl key, rank, value match).
#: One ``explore_live`` run per edge; a dropped stamp must RECOVER
#: (abort pre-commit, re-delivery post-commit), never deadlock.
_DROP_EDGES = [
    ("clean", None),
    ("fence_set@donor", ("c_fence", 0, "nonzero")),
    ("fence_set@recipient", ("c_fence", 1, "nonzero")),
    ("fence_lift@donor", ("c_fence", 0, "zero")),
    ("fence_lift@recipient", ("c_fence", 1, "zero")),
    ("layout_gen@donor", ("c_layout_gen", 0, None)),
    ("layout_gen@recipient", ("c_layout_gen", 1, None)),
]
_QUICK_EDGES = ("clean", "fence_lift@donor", "layout_gen@recipient")


def _mk_handoff(drop=None, holder=None):
    """Donor rank0 ships shard 1 to recipient rank1 over the crash
    harness's sim plane (same setup as ``fsx crash``'s handoff
    scenario, smaller rows); the supervisor tick, donor step and
    recipient step interleave freely under a capped model clock."""
    from flowsentryx_tpu_torch.cluster import rebalance as rb
    from flowsentryx_tpu_torch.crash.checker import (
        _keys_for_shard, _states_for,
    )
    from flowsentryx_tpu_torch.crash.world import (
        MiniEngine, SimSupervisor, World, ckpt_path,
    )

    if holder is None:
        holder = {"ctx": None}

    def mk():
        if holder["ctx"] is not None:
            holder["ctx"].close()
        w = World(n=2, w=2)
        holder["ctx"] = w.installed()
        rb.ShardAssignment.initial(w.n * w.w, w.w, w.n).save(w.dir)
        d_keys = np.concatenate([_keys_for_shard(0, 4, 1),
                                 _keys_for_shard(1, 4, 2)])
        r_keys = _keys_for_shard(2, 4, 1)
        expect_keys = sorted(int(k) for k in
                             np.concatenate([d_keys, r_keys]))
        for r, keys in ((0, d_keys), (1, r_keys)):
            eng = MiniEngine()
            eng.adopt_rows(keys, _states_for(keys))
            w.engines[r] = eng
            eng.save(ckpt_path(w.dir, r), 1)
            rz = rb.EngineRebalancer(w.dir, r, w.statuses[r])
            rz.reconcile(eng)
            w.rebalancers[r] = rz
        sup = SimSupervisor(w)
        counter = {"left": 1}
        if drop is not None:
            sup._status = [_DropStatus(st, drop, counter)
                           for st in w.statuses]
        clk = {"t": 0}
        run = {"started": False}

        def converged():
            return (run["started"] and sup._handoff is None
                    and all(w.statuses[r].ctl_get("c_fence") == 0
                            for r in range(2)))

        def sup_thread():
            yield "start_handoff"
            sup.start_handoff([1], 0, 1)
            sup._handoff["deadline"] = _H_DEADLINE
            run["started"] = True
            while not converged():
                yield "handoff_tick"
                if sup._handoff is not None and clk["t"] <= _H_DEADLINE:
                    clk["t"] += 1
                sup._handoff_tick(clk["t"])

        def rank_thread(r):
            def gen():
                while not converged():
                    yield "rebalance_step"
                    w.rebalancers[r].step(w.engines[r])
            return gen()

        def finale():
            got = sorted(int(k)
                         for r in range(2)
                         for k in w.engines[r].rows()[0])
            if got != expect_keys:
                raise ModelViolation(
                    f"row conservation broken: engines hold {got}, "
                    f"expected {expect_keys}")

        def fingerprint():
            h = sup._handoff
            rz_state = []
            for r in range(2):
                rz = w.rebalancers[r]
                rx = rz._receiver
                rz_state.append((
                    rz._acked_gen, rz._fence_seen, rz._mbx_hid,
                    rz._staged is not None,
                    None if rx is None
                    else (rx._next_seq, rx.done, rx.ok,
                          len(rx._chunks))))
            return (
                None if h is None else (h["phase"], h["n_rows"]),
                tuple(tuple(sorted(w.statuses[r].ctl.items()))
                      for r in range(2)),
                tuple(tuple(sorted(int(k)
                                   for k in w.engines[r].rows()[0]))
                      for r in range(2)),
                tuple(sorted((name, len(box._q))
                             for name, box in w.hub.boxes.items())),
                tuple(sorted((name, len(w.fs.files[fid].data))
                             for name, fid in w.fs.ns.items())),
                tuple(rz_state),
                min(clk["t"], _H_DEADLINE + 1),
                counter["left"] if drop is not None else 0,
            )

        spec = LiveSpec(
            fingerprint=fingerprint,
            progress=lambda: (sup.rebalance_counters["flips"],
                              sup.rebalance_counters["aborts"],
                              sup.rebalance_counters["fences"]),
            # NO obligations: spin-loop protocol — starvation clocks
            # would count weakly-unfair paths (module docstring)
            finale=finale)
        return [("supervisor", sup_thread()),
                ("rank0", rank_thread(0)),
                ("rank1", rank_thread(1))], spec

    return mk


def _check_handoff(edge_name, drop, *, expect_violation=False,
                   expect_marker=None) -> LiveCheckResult:
    holder = {"ctx": None}
    try:
        return explore_live(
            f"handoff_drop[{edge_name}]",
            _mk_handoff(drop, holder),
            expect_violation=expect_violation,
            expect_marker=expect_marker)
    finally:
        if holder["ctx"] is not None:
            holder["ctx"].close()
            holder["ctx"] = None


# ---------------------------------------------------------------------------
# scenario 3: autoscale hysteresis + cooldown is flap-free
# ---------------------------------------------------------------------------

def _mk_autoscale(cooldown_s: float | None = None):
    """A surge→lull regime flip races a scaler ticking the REAL
    ``ElasticPolicy``.  The flap invariant: no SHRINK may execute
    within the cooldown window after a GROW, under ANY interleaving of
    the flip against the ticks."""
    from flowsentryx_tpu_torch.cluster.elastic import (
        GROW, SHRINK, ElasticPolicy,
    )

    SURGE = {"backlog_per_engine": 20000.0, "backlog_max": 20000.0}
    LULL = {"backlog_per_engine": 4.0, "backlog_max": 4.0}
    N_TICKS = 12

    def mk():
        kw = {} if cooldown_s is None else {"cooldown_s": cooldown_s}
        pol = ElasticPolicy(min_engines=1, max_engines=4, **kw)
        st = {"regime": SURGE, "flips": 0, "t": 0.0, "n_live": 2,
              "ticks": 0, "execs": 0, "last_grow": None}

        def env():
            yield "lull"
            st["regime"] = LULL
            st["flips"] += 1

        def scaler():
            for _ in range(N_TICKS):
                yield "tick"
                st["t"] += tuning.ELASTIC_TICK_S
                now = st["t"]
                plan = pol.decide(st["regime"], st["n_live"], now)
                if plan["action"] == GROW and st["n_live"] < 4:
                    st["n_live"] += 1
                    pol.executed(now)
                    st["execs"] += 1
                    st["last_grow"] = now
                elif plan["action"] == SHRINK and st["n_live"] > 1:
                    lg = st["last_grow"]
                    if (lg is not None
                            and now - lg < tuning.ELASTIC_COOLDOWN_S):
                        raise ModelViolation(
                            f"flap: SHRINK executed {now - lg:.1f}s "
                            f"after a GROW — inside the "
                            f"{tuning.ELASTIC_COOLDOWN_S:.0f}s cooldown")
                    st["n_live"] -= 1
                    pol.executed(now)
                    st["execs"] += 1
                st["ticks"] += 1

        spec = LiveSpec(
            fingerprint=lambda: (st["flips"], st["ticks"], st["n_live"],
                                 tuple(sorted(pol._streak.items())),
                                 pol._cooldown_until, st["execs"]),
            progress=lambda: (st["ticks"],),
            obligations=[Obligation(
                "scaler_reacts",
                lambda: st["regime"] is SURGE and st["n_live"] < 4,
                lambda: st["execs"], 24)])
        return [("env", env()), ("scaler", scaler())], spec

    return mk


def _check_autoscale(*, cooldown_s=None, expect_violation=False,
                     expect_marker=None,
                     check="autoscale_flap") -> LiveCheckResult:
    return explore_live(check, _mk_autoscale(cooldown_s),
                        expect_violation=expect_violation,
                        expect_marker=expect_marker)


# ---------------------------------------------------------------------------
# scenario 4: gossip shedding deferrals are bounded
# ---------------------------------------------------------------------------

def _mk_shed(plane_dir: str):
    """Every tick arrives under pressure; the streak cap must force an
    anti-entropy run within the registry's declared bound anyway."""
    from flowsentryx_tpu_torch.cluster.gossip import GossipPlane

    def mk():
        plane = GossipPlane(plane_dir, 0, 2)
        st = {"i": 0, "runs": 0}

        def ticker():
            for _ in range(_SHED_ITERS):
                yield "tick(pressure=1)"
                st["i"] += 1
                plane._next_tick = 0.0
                plane.tick(pressure=1.0)
                if plane._defer_streak == 0:
                    st["runs"] += 1

        spec = LiveSpec(
            fingerprint=lambda: (st["i"],
                                 min(plane._defer_streak,
                                     _SHED_ITERS + 1),
                                 st["runs"]),
            progress=lambda: (st["i"],),
            obligations=[Obligation(
                "anti_entropy_runs", lambda: True,
                lambda: st["runs"], _SHED_BOUND)])
        return [("gossip", ticker())], spec

    return mk


def _check_shed(plane_dir, *, expect_violation=False,
                expect_marker=None,
                check="shed_bounded") -> LiveCheckResult:
    return explore_live(check, _mk_shed(plane_dir),
                        expect_violation=expect_violation,
                        expect_marker=expect_marker)


# ---------------------------------------------------------------------------
# scenario 5: quiesce terminates (idle streak, quiet peers, deadline)
# ---------------------------------------------------------------------------

def _mk_quiesce(plane_dir: str):
    """The REAL ``_quiesce_steps`` generator under a model clock and a
    scripted tick (busy, busy, then idle), racing the peers-go-quiet
    event.  Must return on every interleaving — by convergence or by
    its deadline."""
    from flowsentryx_tpu_torch.cluster.gossip import GossipPlane

    TIMEOUT = 1.0
    INTERVAL = 0.1
    MAX_ITERS = 12

    def mk():
        plane = GossipPlane(plane_dir, 0, 2)
        st = {"busy": 2, "quiet": False, "t": 0.0,
              "returned": False, "iters": 0}

        def scripted_tick(force=False, pressure=0.0):
            if st["busy"] > 0:
                st["busy"] -= 1
                return 7
            return 0

        plane.tick = scripted_tick
        gen = plane._quiesce_steps(TIMEOUT,
                                   peers_quiet=lambda: st["quiet"],
                                   clock=lambda: st["t"])

        def quiescer():
            while True:
                yield "quiesce_iter"
                st["iters"] += 1
                try:
                    next(gen)
                except StopIteration:
                    st["returned"] = True
                    return
                st["t"] += INTERVAL

        def peers():
            yield "peers_quiet"
            st["quiet"] = True

        def finale():
            if not st["returned"]:
                raise ModelViolation(
                    "quiesce did not return within its deadline")

        spec = LiveSpec(
            fingerprint=lambda: (st["busy"], st["quiet"],
                                 round(st["t"], 3), st["returned"]),
            progress=lambda: (st["iters"],),
            obligations=[Obligation(
                "quiesce_returns", lambda: True,
                lambda: st["returned"], MAX_ITERS + 4)],
            finale=finale)
        return [("quiescer", quiescer()), ("peers", peers())], spec

    return mk


def _check_quiesce(plane_dir, *, expect_violation=False,
                   expect_marker=None,
                   check="quiesce_terminates") -> LiveCheckResult:
    return explore_live(check, _mk_quiesce(plane_dir),
                        expect_violation=expect_violation,
                        expect_marker=expect_marker)


# ---------------------------------------------------------------------------
# plants: the regressions this leg exists to catch
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _plant_notify_deleted():
    """``cv.notify_all()`` deleted from ``SinkChannel.complete`` —
    the classic lost-wakeup: backpressure waiters park forever."""
    from flowsentryx_tpu_torch.sync import channel as channel_mod

    orig = channel_mod.SinkChannel.complete

    def complete(self, n_chunks, busy_s=0.0, exc=None):
        with self.cv:
            self.busy_s += busy_s
            self._pending -= n_chunks
            if exc is not None:
                self._exc = exc
            # regression under test: the notify_all() is gone

    channel_mod.SinkChannel.complete = complete
    try:
        yield
    finally:
        channel_mod.SinkChannel.complete = orig


@contextlib.contextmanager
def _plant_fence_lift_dropped():
    """Supervisor stamp re-delivery removed: one lost fence-lift (or
    commit stamp) wedges the fleet forever — what
    ``_redeliver_stamps`` prevents."""
    from flowsentryx_tpu_torch.cluster import supervisor as sup_mod

    orig = sup_mod.ClusterSupervisor._redeliver_stamps
    sup_mod.ClusterSupervisor._redeliver_stamps = (
        lambda self, h: None)
    try:
        yield
    finally:
        sup_mod.ClusterSupervisor._redeliver_stamps = orig


@contextlib.contextmanager
def _plant_streak_cap_removed():
    """``SHED_MAX_DEFER`` effectively removed (set astronomically
    high): pressure defers anti-entropy forever."""
    orig = tuning.SHED_MAX_DEFER
    tuning.SHED_MAX_DEFER = 1 << 30
    try:
        yield
    finally:
        tuning.SHED_MAX_DEFER = orig


def run_plants(plane_dir: str,
               controls: dict[str, LiveCheckResult] | None = None
               ) -> list[dict]:
    """Run all four planted regressions; each record carries the
    catching schedule and the clean control's verdict.  ``controls``
    maps plant name → an already-proved clean run of the same
    scenario (run_live's checks phase); any missing control is
    re-proved here."""
    controls = dict(controls or {})
    out = []

    with _plant_notify_deleted():
        r = _check_channel(expect_violation=True,
                           expect_marker="wait_below(0)",
                           check="plant:notify_deleted")
    ctl = controls.get("notify_deleted") or _check_channel()
    out.append(_plant_record(
        "notify_deleted",
        "cv.notify_all() deleted from SinkChannel.complete",
        r, ctl))

    with _plant_fence_lift_dropped():
        r = _check_handoff("fence_lift@donor~noredeliver",
                           ("c_fence", 0, "zero"),
                           expect_violation=True,
                           expect_marker="livelock")
    ctl = (controls.get("fence_lift_dropped")
           or _check_handoff("fence_lift@donor", ("c_fence", 0, "zero")))
    out.append(_plant_record(
        "fence_lift_dropped",
        "supervisor stamp re-delivery removed: one lost fence-lift "
        "wedges the fleet", r, ctl))

    with _plant_streak_cap_removed():
        r = _check_shed(plane_dir, expect_violation=True,
                        expect_marker="starvation: obligation "
                                      "'anti_entropy_runs'",
                        check="plant:streak_cap_removed")
    ctl = controls.get("streak_cap_removed") or _check_shed(plane_dir)
    out.append(_plant_record(
        "streak_cap_removed",
        "SHED_MAX_DEFER cap removed: pressure defers anti-entropy "
        "forever", r, ctl))

    r = _check_autoscale(cooldown_s=0.0, expect_violation=True,
                         expect_marker="flap",
                         check="plant:cooldown_zeroed")
    ctl = controls.get("cooldown_zeroed") or _check_autoscale()
    out.append(_plant_record(
        "cooldown_zeroed",
        "elastic cooldown zeroed: GROW→SHRINK flap inside the window",
        r, ctl))
    return out


def _plant_record(name: str, description: str, r: LiveCheckResult,
                  ctl: LiveCheckResult) -> dict:
    cx = r.counterexample
    return {
        "plant": name,
        "description": description,
        "caught": bool(r.ok),
        "caught_by": r.detector,
        "control_ok": bool(ctl.ok),
        "schedule": list(cx.schedule) if cx is not None else [],
        "detail": cx.detail if cx is not None else "",
    }


# ---------------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------------

def run_live(quick: bool = False) -> dict:
    """Run the full liveness leg: protocol proofs, planted
    regressions with controls, and the PROGRESS registry audit."""
    from flowsentryx_tpu_torch.cluster.gossip import create_plane

    t0 = time.perf_counter()
    checks: list[LiveCheckResult] = []
    with tempfile.TemporaryDirectory(prefix="fsx-live-") as td:
        create_plane(td, 2)
        checks.append(_check_channel())
        for edge_name, drop in _DROP_EDGES:
            if quick and edge_name not in _QUICK_EDGES:
                continue
            checks.append(_check_handoff(edge_name, drop))
        checks.append(_check_autoscale())
        checks.append(_check_shed(td))
        checks.append(_check_quiesce(td))
        by_name = {c.check: c for c in checks}
        plants = run_plants(td, controls={
            "notify_deleted": by_name.get("channel_stop_drain_live"),
            "fence_lift_dropped":
                by_name.get("handoff_drop[fence_lift@donor]"),
            "streak_cap_removed": by_name.get("shed_bounded"),
            "cooldown_zeroed": by_name.get("autoscale_flap"),
        })

    exercised = {c.check.split("[")[0] for c in checks}
    reg = registry.validate(exercised=exercised)

    checks_ok = all(c.ok for c in checks)
    plants_ok = all(p["caught"] and p["control_ok"] for p in plants)
    report = {
        "schema": SCHEMA,
        "quick": bool(quick),
        "ok": bool(checks_ok and plants_ok and reg["ok"]),
        "registry": reg,
        "checks": [c.to_json() for c in checks],
        "plants": plants,
        "totals": {
            "checks": len(checks),
            "states": sum(c.states for c in checks),
            "edges": sum(c.edges for c in checks),
            "steps": sum(c.steps for c in checks),
            "plants": len(plants),
        },
        "elapsed_s": round(time.perf_counter() - t0, 3),
    }
    return report
