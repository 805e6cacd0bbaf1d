"""The crash-consistency model checker (``fsx crash``).

Counterpart of ``flowsentryx_tpu/crash/checker.py``: it proves the port's
durable-state protocols crash-consistent by running their real code —
``cluster/rebalance.py``'s handoff state machine, the supervisor's
handoff and adopt halves (``cluster/supervisor.py``) and
``engine/checkpoint.py``'s write/rotate/fallback — over a simulated
filesystem and mailbox with honest POSIX semantics (simfs.py), forking a
crash at EVERY atomic step, reconstructing every legal post-crash durable
state, running the real recovery path (``reconcile()``, spool adoption,
the ``.prev`` fallback, ``_neutralize_stale_handoff``, abort-and-retry
under a fresh handoff id), and asserting the invariant catalog below.

Four scenarios, crashed in the modes each lists:

* ``checkpoint_rotate`` — three real ``save_state`` calls through the
  write -> fsync -> rotate -> publish -> dir-fsync pipeline, power crash
  at each step plus the media-fault flavor (a bit flipped in the last
  published file) that the ``.prev`` retention exists for.
* ``layout_flip`` — four generations of ``ShardAssignment.save``; a
  reboot may never read a torn layout or a generation older than one
  whose save returned.
* ``handoff`` — the full fenced donor -> recipient span move with
  post-flip checkpoints, crashed as power / donor / recipient /
  supervisor at every step.
* ``adoption`` — ``adopt_dead_span``: the supervisor ships a dead rank's
  span from its checkpoint, crashed as power / recipient / supervisor.

Planted regressions (each must produce a PRINTED crash schedule, and
each must come from a run whose unplanted control is clean):
``spool_ack_reorder`` (HP_STAGED acked before the spool write),
``fsync_skipped`` (every fsync a no-op), ``prev_rotation_dropped`` (no
``.prev`` retention) and ``dual_ownership_flip`` (reconcile stops
dropping foreign rows).  Each patches the port's module attributes for
the length of its run and restores them on the way out.

Host Python over numpy: it runs the same on a host with a card and on
one without.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import numpy as np

from flowsentryx_tpu_torch.cluster import rebalance as rb
from flowsentryx_tpu_torch.core import durable, wire

from .simfs import CrashNow, SimFS, eligible_points
from .world import (MiniEngine, SimSupervisor, World, ckpt_path,
                    restore_mini)

#: Tick budget for one protocol run INCLUDING its recovery retries —
#: a clean handoff converges in ~5 ticks, every recovery path in a
#: handful more; a run that needs 40 is wedged, and "wedged" is the
#: ``converged`` invariant's violation, not a hang.
MAX_TICKS = 40

#: The invariant catalog — every violation names one of these.
INVARIANTS = {
    "row_conservation":
        "post-recovery engine rows are byte-exact the pre-protocol "
        "multiset: nothing lost, nothing duplicated, nothing resident "
        "off its assigned owner",
    "no_dual_ownership":
        "no table key is held by two engines at once",
    "layout_gen_monotone":
        "a reboot never reads a layout generation older than one "
        "whose save returned (gen resurrection = un-fsynced rename)",
    "layout_never_torn":
        "layout.json always parses: the publish is atomic, old or "
        "new, never a mix",
    "ckpt_current_or_prev":
        "after any completed save, a checkpoint is loadable from the "
        "current file or its .prev twin",
    "ckpt_monotone":
        "a recovered checkpoint is the last completed save or its "
        "immediate predecessor, never older",
    "ckpt_no_garbage":
        "a checkpoint that loads is byte-exact the table that was "
        "saved under that marker",
    "retry_fresh_id":
        "every handoff retry after an abort/crash uses a strictly "
        "larger handoff id",
    "spsc_single_consumer":
        "no handoff mailbox is ever drained by a second consumer",
    "converged":
        "the fleet reaches goal layout + matching acks within the "
        "tick budget after every crash (recovery is live, not wedged)",
}


@dataclasses.dataclass
class Violation:
    invariant: str
    detail: str


@dataclasses.dataclass
class CrashSchedule:
    """A counterexample: the executed op schedule up to the crash,
    the crash itself, the durable-state flavor it left, and the
    invariant the recovery then violated — printed the way
    ``fsx interleave`` prints its interleavings."""

    scenario: str
    mode: str
    crash_op: str
    flavor: str
    schedule: list[str]
    violation: Violation

    def render(self) -> str:
        lines = [f"crash schedule — scenario {self.scenario}, "
                 f"mode {self.mode}:"]
        for i, op in enumerate(self.schedule):
            lines.append(f"  {i:3d}. {op}")
        lines.append(f"  >>> CRASH ({self.mode}) before: {self.crash_op}")
        if self.flavor and self.flavor != "-":
            lines.append(f"  >>> durable state: {self.flavor}")
        lines.append(f"  >>> VIOLATED {self.violation.invariant}: "
                     f"{self.violation.detail}")
        return "\n".join(lines)


# -- row helpers ------------------------------------------------------------

def _keys_for_shard(shard: int, total: int, count: int,
                    start: int = 1) -> np.ndarray:
    """``count`` u32 keys that hash to ``shard`` under the real
    Fibonacci shard rule — the scenarios place rows by searching the
    actual hash, not by assuming one."""
    out: list[int] = []
    k = start
    while len(out) < count:
        if int(wire.shard_of(np.uint32(k), total)) == shard:
            out.append(k)
        k += 1
    return np.asarray(out, np.uint32)


def _states_for(keys) -> np.ndarray:
    keys = np.asarray(keys, np.uint32)
    base = np.arange(len(keys) * wire.NUM_TABLE_COLS,
                     dtype=np.float32).reshape(len(keys), -1)
    return base + keys[:, None].astype(np.float32)


def _concat_rows(parts):
    ks = [np.asarray(k, np.uint32).reshape(-1) for k, _ in parts]
    ss = [np.asarray(s, np.float32).reshape(len(k), -1)
          for (k, s), kk in zip(parts, ks)]
    return (np.concatenate(ks) if ks else np.empty(0, np.uint32),
            np.concatenate(ss) if ss
            else np.empty((0, wire.NUM_TABLE_COLS), np.float32))


def _row_bytes(rows) -> bytes:
    k, s = rows
    p = rb.pack_rows(k, s)
    if len(p):
        p = p[np.lexsort(p.T[::-1])]
    return p.tobytes()


# -- scenario: checkpoint write/rotate/fallback ------------------------------

class CheckpointScenario:
    """Three real ``save_state`` generations over one engine; power
    crash at every primitive write/fsync/rename step, plus the
    media-fault flavor (a pure power crash with correct fsync can
    never damage an already-published file — only media corruption
    can, and ``.prev`` is the answer to exactly that)."""

    name = "checkpoint_rotate"
    modes = ("power",)
    media_fault = True

    def build(self, **kw) -> World:
        return World(n=1, **kw)

    def setup(self, w: World) -> None:
        eng = MiniEngine()
        keys = np.arange(1, 4, dtype=np.uint32)
        eng.adopt_rows(keys, _states_for(keys))
        w.engines[0] = eng
        w.meta["tables"] = {}

    def script(self, w: World) -> None:
        eng = w.engines[0]
        for m in (1, 2, 3):
            def save(m=m):
                k = np.asarray([100 + m], np.uint32)
                eng.adopt_rows(k, _states_for(k))
                w.meta["tables"][m] = _row_bytes(eng.rows())
                eng.save(ckpt_path(w.dir, 0), m)
            w.act("rank0", save)
            w.saved_markers[0].append(m)
        w.meta["converged"] = True

    def recover_power(self, w: World, state: dict,
                      flavor: str) -> World:
        w2 = World(n=1, fsync_is_noop=w.fs.fsync_is_noop)
        w2.fs = SimFS.from_state(state, w2.tracer,
                                 fsync_is_noop=w.fs.fsync_is_noop)
        w2.meta = w.power_snapshot_meta()
        w2.saved_markers = {r: list(v)
                            for r, v in w.saved_markers.items()}
        with w2.installed():
            res = restore_mini(ckpt_path(w2.dir, 0))
        completed = w2.saved_markers[0]
        tables = w2.meta["tables"]
        if res is None:
            # the FIRST generation has no .prev to fall back to: a
            # media fault on the only copy is unrecoverable by design
            must_load = (len(completed) >= 2
                         or (completed and "media fault" not in flavor))
            if must_load:
                w2.meta["violations"].append(Violation(
                    "ckpt_current_or_prev",
                    f"no checkpoint loadable after "
                    f"{len(completed)} completed save(s)"))
        else:
            eng, marker = res
            inflight = (max(tables) if tables
                        and max(tables) not in completed else None)
            allowed = set(completed[-2:])
            if inflight is not None:
                allowed.add(inflight)
            if marker not in allowed:
                w2.meta["violations"].append(Violation(
                    "ckpt_monotone",
                    f"recovered marker {marker}, allowed {sorted(allowed)} "
                    f"(completed saves: {completed})"))
            elif _row_bytes(eng.rows()) != tables.get(marker):
                w2.meta["violations"].append(Violation(
                    "ckpt_no_garbage",
                    f"marker {marker} loaded rows differ from the "
                    "table that was saved under it"))
        w2.meta["converged"] = True
        return w2

    def judge(self, w: World) -> list[Violation]:
        return list(w.meta["violations"])


# -- scenario: layout generation flip ---------------------------------------

class FlipScenario:
    """Four generations of the real ``ShardAssignment.save`` publish;
    after a power crash the layout must parse and must not be older
    than any generation whose save RETURNED (the gen-resurrection bug
    an un-fsynced rename causes — the ``fsync_skipped`` plant's
    forcing function)."""

    name = "layout_flip"
    modes = ("power",)
    media_fault = False

    def build(self, **kw) -> World:
        return World(n=2, **kw)

    def setup(self, w: World) -> None:
        pass

    def script(self, w: World) -> None:
        asg = rb.ShardAssignment.initial(w.n * w.w, w.w, w.n)
        for i in range(4):
            cur = asg
            w.act("supervisor", lambda cur=cur: cur.save(w.dir))
            w.published_gens.append(cur.generation)
            asg = cur.reassign([1], (i + 1) % w.n)
        w.meta["converged"] = True

    def recover_power(self, w: World, state: dict,
                      flavor: str) -> World:
        w2 = World(n=w.n, fsync_is_noop=w.fs.fsync_is_noop)
        w2.fs = SimFS.from_state(state, w2.tracer,
                                 fsync_is_noop=w.fs.fsync_is_noop)
        w2.meta = w.power_snapshot_meta()
        w2.published_gens = list(w.published_gens)
        with w2.installed():
            asg = None
            try:
                asg = rb.ShardAssignment.load(w2.dir)
            except (ValueError, KeyError, TypeError) as e:
                w2.meta["violations"].append(Violation(
                    "layout_never_torn",
                    f"layout.json unreadable after reboot: "
                    f"{type(e).__name__}: {e}"))
        pub = w2.published_gens
        if pub and (asg is None or asg.generation < max(pub)):
            got = "absent" if asg is None else f"gen {asg.generation}"
            w2.meta["violations"].append(Violation(
                "layout_gen_monotone",
                f"rebooted into {got} after gen {max(pub)}'s save "
                "returned (resurrected an un-fsynced rename)"))
        w2.meta["converged"] = True
        return w2

    def judge(self, w: World) -> list[Violation]:
        return list(w.meta["violations"])


# -- scenarios: the fenced handoff + dead-span adoption ----------------------

class _FleetScenario:
    """Shared machinery for the two fleet protocols: the tick loop
    that drives the real supervisor + rebalancer halves, party
    respawn through the real recovery path (restore → fresh
    rebalancer → ``reconcile``), supervisor recovery through the real
    ``_neutralize_stale_handoff``, full-host power recovery, and the
    conservation judge."""

    media_fault = False

    def _specs(self, w: World):
        return None

    # -- goal/convergence (subclass-specific goal) ---------------------------

    def _goal_met(self, w: World) -> bool:
        raise NotImplementedError

    def _start(self, w: World) -> None:
        raise NotImplementedError

    def _converged(self, w: World) -> bool:
        if w.sup is None or "supervisor" in w.dead:
            return False
        if w.sup._handoff is not None:
            return False
        if any(f"rank{r}" in w.dead and r not in w.failed_ranks
               for r in range(w.n)):
            return False
        if not self._goal_met(w):
            return False
        asg = rb.ShardAssignment.load(w.dir)
        return all(
            w.statuses[r].ctl_get("c_layout_ack") == asg.generation
            and w.statuses[r].ctl_get("c_fence") == 0
            for r in range(w.n) if r not in w.failed_ranks)

    # -- the recovery paths (all REAL protocol code) -------------------------

    def _respawn_rank(self, w: World, r: int) -> None:
        """The runner's boot path: restore from checkpoint (with
        ``.prev`` fallback), fresh rebalancer, ``reconcile`` — spool
        adoption and foreign-row drop included."""
        w.dead.discard(f"rank{r}")

        def boot():
            res = restore_mini(ckpt_path(w.dir, r))
            if res is None:
                if w.saved_markers[r]:
                    w.meta["violations"].append(Violation(
                        "ckpt_current_or_prev",
                        f"rank{r} respawn found no loadable checkpoint "
                        f"after completed save(s) "
                        f"{w.saved_markers[r]}"))
                eng = MiniEngine()
            else:
                eng = res[0]
            w.engines[r] = eng
            rz = rb.EngineRebalancer(w.dir, r, w.statuses[r])
            rz.reconcile(eng)
            w.rebalancers[r] = rz

        w.act(f"rank{r}", boot)

    def _recover_sup(self, w: World) -> None:
        """A successor supervisor re-attaching: fresh object, the real
        adopt-path hygiene (stale-handoff neutralize-or-resume)."""
        w.dead.discard("supervisor")

        def boot():
            sup = SimSupervisor(w, specs=self._specs(w))
            sup._neutralize_stale_handoff()
            w.sup = sup

        w.act("supervisor", boot)

    def _note_published(self, w: World) -> None:
        asg = rb.ShardAssignment.load(w.dir)
        if asg is not None and (not w.published_gens
                                or asg.generation > w.published_gens[-1]):
            w.published_gens.append(asg.generation)

    def _tick(self, w: World) -> None:
        if "supervisor" in w.dead:
            self._recover_sup(w)
        else:
            w.act("supervisor",
                  lambda: w.sup._handoff_tick(time.monotonic()))
            self._note_published(w)
        for r in range(w.n):
            if f"rank{r}" in w.dead and r not in w.failed_ranks:
                self._respawn_rank(w, r)
        if ("supervisor" not in w.dead and w.sup is not None
                and w.sup._handoff is None and not self._goal_met(w)):
            self._start(w)
        for r in range(w.n):
            if r in w.failed_ranks:
                continue
            w.act(f"rank{r}",
                  lambda r=r: w.rebalancers[r].step(w.engines[r]))

    def _drive(self, w: World) -> None:
        for _ in range(MAX_TICKS):
            if self._converged(w):
                break
            self._tick(w)
        w.meta["converged"] = self._converged(w)

    def script(self, w: World) -> None:
        self._start(w)
        self._drive(w)
        if not w.meta["converged"]:
            return
        # post-flip checkpoints: the death window where one side's
        # snapshot predates the flip and the other's follows it —
        # recovery must reconcile them against the committed layout
        for r in range(w.n):
            if r in w.failed_ranks:
                continue
            def save(r=r):
                w.engines[r].save(ckpt_path(w.dir, r), 2)
                # the runner's post-checkpoint spool release
                w.rebalancers[r].note_checkpointed()
            w.act(f"rank{r}", save)
            if f"rank{r}" not in w.dead:
                w.saved_markers[r].append(2)
        for r in range(w.n):
            if f"rank{r}" in w.dead and r not in w.failed_ranks:
                self._respawn_rank(w, r)

    def recover_power(self, w: World, state: dict,
                      flavor: str) -> World:
        w2 = World(n=w.n, w=w.w, fsync_is_noop=w.fs.fsync_is_noop,
                   chunk_rows=w.hub.chunk_rows)
        w2.fs = SimFS.from_state(state, w2.tracer,
                                 fsync_is_noop=w.fs.fsync_is_noop)
        w2.meta = w.power_snapshot_meta()
        w2.saved_markers = {r: list(v)
                            for r, v in w.saved_markers.items()}
        w2.handoff_ids = list(w.handoff_ids)
        w2.published_gens = list(w.published_gens)
        w2.failed_ranks = set(w.failed_ranks)
        w2.dead = {f"rank{r}" for r in w2.failed_ranks}
        with w2.installed():
            asg = None
            try:
                asg = rb.ShardAssignment.load(w2.dir)
            except (ValueError, KeyError, TypeError) as e:
                w2.meta["violations"].append(Violation(
                    "layout_never_torn",
                    f"layout.json unreadable after reboot: "
                    f"{type(e).__name__}: {e}"))
            pub = w2.published_gens
            if pub and (asg is None or asg.generation < max(pub)):
                got = ("absent" if asg is None
                       else f"gen {asg.generation}")
                w2.meta["violations"].append(Violation(
                    "layout_gen_monotone",
                    f"rebooted into {got} after gen {max(pub)}'s "
                    "save returned"))
            for r in range(w2.n):
                if r not in w2.failed_ranks:
                    self._respawn_rank(w2, r)
            sup = SimSupervisor(w2, specs=self._specs(w2))
            sup._neutralize_stale_handoff()
            w2.sup = sup
            self._drive(w2)
        return w2

    def judge(self, w: World) -> list[Violation]:
        out = list(w.meta["violations"])
        spsc = (w.meta.get("pre_spsc", [])
                + list(w.hub.second_consumer))
        if spsc:
            out.append(Violation("spsc_single_consumer",
                                 "; ".join(spsc)))
        ids = w.handoff_ids
        if any(b <= a for a, b in zip(ids, ids[1:])):
            out.append(Violation(
                "retry_fresh_id",
                f"handoff ids not strictly increasing: {ids}"))
        if not w.meta.get("converged"):
            out.append(Violation(
                "converged",
                f"fleet did not converge within {MAX_TICKS} ticks"))
            return out
        with w.installed():
            asg = rb.ShardAssignment.load(w.dir)
            parts, part_ranks = [], []
            for r in range(w.n):
                if r in w.failed_ranks:
                    continue
                parts.append(w.engines[r].rows())
                part_ranks.append(r)
            res = rb.rows_conserved(w.meta["pre"], parts,
                                    owners=asg.owners,
                                    part_ranks=part_ranks)
        if res["dup_keys"]:
            out.append(Violation("no_dual_ownership", res["detail"]))
        if not res["ok"]:
            out.append(Violation("row_conservation", res["detail"]))
        return out


class HandoffScenario(_FleetScenario):
    """The full fenced handoff: donor rank0 moves shard 1 to
    recipient rank1 while both keep rows on shards that do not move —
    so a recovery that over-drops, over-adopts, or resurrects a layout
    shows up as a conservation or dual-ownership violation."""

    name = "handoff"
    modes = ("power", "rank0", "rank1", "supervisor")

    def build(self, **kw) -> World:
        return World(n=2, w=2, **kw)

    def setup(self, w: World) -> None:
        rb.ShardAssignment.initial(w.n * w.w, w.w, w.n).save(w.dir)
        w.published_gens.append(0)
        d_keys = np.concatenate([_keys_for_shard(0, 4, 4),
                                 _keys_for_shard(1, 4, 4)])
        r_keys = _keys_for_shard(2, 4, 3)
        for r, keys in ((0, d_keys), (1, r_keys)):
            eng = MiniEngine()
            eng.adopt_rows(keys, _states_for(keys))
            w.engines[r] = eng
            eng.save(ckpt_path(w.dir, r), 1)
            w.saved_markers[r].append(1)
            rz = rb.EngineRebalancer(w.dir, r, w.statuses[r])
            rz.reconcile(eng)
            w.rebalancers[r] = rz
        w.sup = SimSupervisor(w)
        w.meta["pre"] = _concat_rows([w.engines[0].rows(),
                                      w.engines[1].rows()])
        w.meta["span"] = [1]

    def _goal_met(self, w: World) -> bool:
        asg = rb.ShardAssignment.load(w.dir)
        return asg is not None and asg.owners[1] == 1

    def _start(self, w: World) -> None:
        def go():
            hid = w.sup.start_handoff(w.meta["span"], 0, 1)
            w.handoff_ids.append(hid)
        w.act("supervisor", go)


class AdoptionScenario(_FleetScenario):
    """``adopt_dead_span``: rank0 is confirmed dead (parked), the
    supervisor ships its whole span to rank1 from rank0's last
    checkpoint — supervisor-as-donor, so the ship itself is part of
    the supervisor's crash surface."""

    name = "adoption"
    modes = ("power", "rank1", "supervisor")

    def build(self, **kw) -> World:
        return World(n=2, w=2, **kw)

    def _specs(self, w: World):
        return [{"checkpoint": str(ckpt_path(w.dir, 0))}, {}]

    def setup(self, w: World) -> None:
        rb.ShardAssignment.initial(w.n * w.w, w.w, w.n).save(w.dir)
        w.published_gens.append(0)
        d_keys = np.concatenate([_keys_for_shard(0, 4, 3),
                                 _keys_for_shard(1, 4, 3)])
        r_keys = _keys_for_shard(2, 4, 3)
        for r, keys in ((0, d_keys), (1, r_keys)):
            eng = MiniEngine()
            eng.adopt_rows(keys, _states_for(keys))
            w.engines[r] = eng
            eng.save(ckpt_path(w.dir, r), 1)
            w.saved_markers[r].append(1)
        rz = rb.EngineRebalancer(w.dir, 1, w.statuses[1])
        rz.reconcile(w.engines[1])
        w.rebalancers[1] = rz
        # rank0 is dead for good: its table survives only as its
        # checkpoint, which is exactly what adoption conserves
        w.failed_ranks = {0}
        w.dead.add("rank0")
        w.sup = SimSupervisor(w, specs=self._specs(w))
        w.meta["pre"] = _concat_rows([(d_keys, _states_for(d_keys)),
                                      w.engines[1].rows()])

    def _goal_met(self, w: World) -> bool:
        asg = rb.ShardAssignment.load(w.dir)
        return asg is not None and all(o == 1 for o in asg.owners)

    def _start(self, w: World) -> None:
        def go():
            entry = w.sup.adopt_dead_span(0, 1)
            w.handoff_ids.append(entry["handoff_id"])
        w.act("supervisor", go)


# -- the exploration harness -------------------------------------------------

def _run(sc, *, crash_at=None, crash_actor=None, build_kw=None):
    """One scenario execution: setup untraced, protocol traced with
    the given crash injected.  Returns the (possibly crashed) world;
    ``world.tracer.fired`` says whether the crash point was reached."""
    w = sc.build(**(build_kw or {}))
    with w.installed():
        sc.setup(w)
        t = w.tracer
        t.enabled = True
        t.crash_at = crash_at
        t.crash_actor = crash_actor
        try:
            sc.script(w)
        except CrashNow:
            pass  # power crash: the harness reconstructs from disk
        finally:
            t.enabled = False
    return w


def explore_scenario(sc, *, quick: bool = False, modes=None,
                     build_kw=None,
                     stop_on_violation: bool = False) -> dict:
    """Exhaustively crash one scenario: every crash point of every
    mode; for power modes, every legal durable state at each point."""
    t0 = time.perf_counter()
    res = {"scenario": sc.name, "modes": [], "crash_points": 0,
           "states_explored": 0, "recoveries": 0, "violations": 0,
           "capped": False, "first_invariant": None,
           "counterexample": None}

    def record(viols, mode, crashed_op, flavor, schedule):
        res["violations"] += len(viols)
        if res["counterexample"] is None and viols:
            res["first_invariant"] = viols[0].invariant
            res["counterexample"] = CrashSchedule(
                sc.name, mode, crashed_op, flavor, schedule,
                viols[0]).render()

    base = _run(sc, build_kw=build_kw)
    base_viols = sc.judge(base)
    if base_viols:
        record(base_viols, "none", "(no crash injected)", "-",
               base.tracer.rendered())
        res["elapsed_s"] = round(time.perf_counter() - t0, 3)
        return res  # the protocol fails without any crash: stop here
    base_ops = base.tracer.ops
    for mode in (modes if modes is not None else sc.modes):
        actor = None if mode == "power" else mode
        n_pts = eligible_points(base_ops, actor)
        res["modes"].append({"mode": mode, "crash_points": n_pts})
        for p in range(n_pts):
            res["crash_points"] += 1
            w = _run(sc, crash_at=p, crash_actor=actor,
                     build_kw=build_kw)
            if not w.tracer.fired:
                continue
            if actor is None:
                states, capped = w.fs.durable_states(
                    media_fault=getattr(sc, "media_fault", False),
                    quick=quick)
                res["capped"] = res["capped"] or capped
                for flavor, st in states:
                    res["states_explored"] += 1
                    res["recoveries"] += 1
                    w2 = sc.recover_power(w, st, flavor)
                    viols = sc.judge(w2)
                    record(viols, mode, w.tracer.crashed_op, flavor,
                           w.tracer.rendered())
                    if viols and stop_on_violation:
                        res["elapsed_s"] = round(
                            time.perf_counter() - t0, 3)
                        return res
            else:
                res["recoveries"] += 1
                viols = sc.judge(w)
                record(viols, mode, w.tracer.crashed_op, "-",
                       w.tracer.rendered())
                if viols and stop_on_violation:
                    res["elapsed_s"] = round(
                        time.perf_counter() - t0, 3)
                    return res
    res["elapsed_s"] = round(time.perf_counter() - t0, 3)
    return res


# -- planted regressions -----------------------------------------------------

@contextlib.contextmanager
def plant_fsync_skipped():
    """No patch needed: the plant is ``fsync_is_noop=True`` on the sim
    fs (every durable claim a lie) — kept as a context manager so the
    plant table drives all four plants uniformly."""
    yield


@contextlib.contextmanager
def plant_prev_rotation_dropped():
    """Publish checkpoints WITHOUT retaining the incumbent at .prev —
    the retention regression only a media fault exposes."""
    orig = durable.atomic_write

    def patched(path, data, *, rotate_prev=None):
        orig(path, data, rotate_prev=None)

    durable.atomic_write = patched
    try:
        yield
    finally:
        durable.atomic_write = orig


@contextlib.contextmanager
def plant_spool_ack_reorder():
    """Ack HP_STAGED BEFORE the spool write lands: the deferred write
    happens at the recipient's NEXT step — after the supervisor has
    already committed the flip on the ack.  A crash in between leaves
    a committed flip whose rows exist nowhere durable."""
    orig_save = rb.save_spool
    orig_step = rb.EngineRebalancer.step
    deferred: list[tuple] = []

    def save_later(path, keys, states, **kw):
        deferred.append((path, np.asarray(keys, np.uint32).copy(),
                         np.asarray(states, np.float32).copy(),
                         dict(kw)))

    def step(self, eng):
        while deferred:
            path, keys, states, kw = deferred.pop(0)
            orig_save(path, keys, states, **kw)
        return orig_step(self, eng)

    rb.save_spool = save_later
    rb.EngineRebalancer.step = step
    try:
        yield
    finally:
        rb.save_spool = orig_save
        rb.EngineRebalancer.step = orig_step


@contextlib.contextmanager
def plant_dual_ownership_flip():
    """Reconcile stops dropping foreign rows: a donor that dies after
    the flip and reboots then KEEPS the span it no longer owns while
    the recipient holds the shipped copy — dual ownership."""
    orig = rb.EngineRebalancer.reconcile

    class _NoDrop:
        def __init__(self, eng):
            self._eng = eng

        def __getattr__(self, name):
            return getattr(self._eng, name)

        def drop_span_rows(self, shards, total_shards):
            return 0

    def patched(self, eng):
        return orig(self, _NoDrop(eng))

    rb.EngineRebalancer.reconcile = patched
    try:
        yield
    finally:
        rb.EngineRebalancer.reconcile = orig


#: plant name -> (description, scenario factory, explore kwargs,
#: patch contextmanager, control scenario name)
_PLANTS = [
    ("spool_ack_reorder",
     "HP_STAGED acked before the spool write is durable",
     HandoffScenario, {"modes": ("power", "rank1")},
     plant_spool_ack_reorder, "handoff"),
    ("fsync_skipped",
     "every fsync a no-op (a publish without durable.py's discipline)",
     FlipScenario, {"build_kw": {"fsync_is_noop": True}},
     plant_fsync_skipped, "layout_flip"),
    ("prev_rotation_dropped",
     "checkpoints published without .prev retention",
     CheckpointScenario, {},
     plant_prev_rotation_dropped, "checkpoint_rotate"),
    ("dual_ownership_flip",
     "reconcile no longer drops foreign rows after a flip",
     HandoffScenario, {"modes": ("rank0", "power")},
     plant_dual_ownership_flip, "handoff"),
]


def _check_plants(quick: bool, control_ok: dict) -> list[dict]:
    out = []
    for name, desc, factory, kw, patch, control in _PLANTS:
        with patch():
            r = explore_scenario(factory(), quick=quick,
                                 stop_on_violation=True, **kw)
        out.append({
            "plant": name,
            "description": desc,
            "caught": r["violations"] > 0,
            "caught_by": r["first_invariant"],
            "control_ok": bool(control_ok.get(control)),
            "crash_points": r["crash_points"],
            "schedule": r["counterexample"],
        })
    return out


# -- entry point -------------------------------------------------------------

def run_crash(quick: bool = False) -> dict:
    """Run the full checker: four scenarios exhaustively crashed,
    then the four planted regressions (each must be caught AND its
    unplanted control must be clean).  ``quick`` trims the torn-file
    fan-out (2 tear variants instead of 5) — same crash points, same
    protocols, a fraction of the durable states."""
    t0 = time.perf_counter()
    scenarios = [CheckpointScenario(), FlipScenario(),
                 HandoffScenario(), AdoptionScenario()]
    scen_results = [explore_scenario(sc, quick=quick)
                    for sc in scenarios]
    control_ok = {r["scenario"]: r["violations"] == 0
                  for r in scen_results}
    plants = _check_plants(quick, control_ok)
    protocols_ok = all(control_ok.values())
    plants_ok = all(p["caught"] and p["control_ok"] for p in plants)
    return {
        "schema": "fsx-crash-report-v1",
        "quick": bool(quick),
        "ok": protocols_ok and plants_ok,
        "protocols_ok": protocols_ok,
        "plants_ok": plants_ok,
        "invariants": dict(INVARIANTS),
        "scenarios": scen_results,
        "plants": plants,
        "totals": {
            "crash_points": sum(r["crash_points"]
                                for r in scen_results),
            "states_explored": sum(r["states_explored"]
                                   for r in scen_results),
            "recoveries": sum(r["recoveries"] for r in scen_results),
            "violations": sum(r["violations"] for r in scen_results),
        },
        "elapsed_s": round(time.perf_counter() - t0, 3),
    }
