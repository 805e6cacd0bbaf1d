"""Bounded interleaving model checker for the port's host pipeline.

Counterpart of ``flowsentryx_tpu/sync/interleave.py``.  The thread-
contract lint (:mod:`.contracts`) proves every access obeys its declared
discipline; this module proves the protocols themselves — the
cv-coupled crash accounting, the SPSC cursor hand-off, the arena reuse
bound — over EVERY interleaving a small bounded workload can produce,
by driving this package's real protocol objects
(:class:`~flowsentryx_tpu_torch.sync.channel.SinkChannel`,
:class:`~flowsentryx_tpu_torch.engine.shm.SealedBatchQueue`,
:class:`~flowsentryx_tpu_torch.engine.arena.DispatchArena` claimed
through ``Engine._claim``) under a deterministic cooperative scheduler.

How it works
------------

A *thread program* is a Python generator: the code between two
``yield``\\s is one atomic step, and the yielded value describes the
NEXT step — a plain label (always runnable) or ``(predicate, label)``,
a step that becomes runnable once the predicate holds (the model of a
cv wait, an event wait or a bounded-retry loop; a blocked thread
consumes no schedule steps, so the exploration never diverges into spin
loops).  :func:`explore` walks the full tree of schedules depth-first,
replaying the deterministic prefix for every branch.  A step that
raises :class:`ModelViolation` (or a deadlock: live threads, none
runnable) yields a :class:`Counterexample` carrying the exact schedule.
:func:`explore_live` builds the state graph instead and checks
progress (deadlock, livelock under weak fairness, bounded starvation);
``fsx live`` drives it.

What is checked
---------------

* **SinkChannel crash atomicity**, with the ``channel_split_complete``
  planted negative (decrement and crash record as two sections) that
  must produce the silent-verdict-loss counterexample.
* **SinkChannel stop/drain with two submitters**: every submitted item
  processed exactly once, FIFO per submitter.
* **SealedBatchQueue wraparound** at 2 slots, with the
  ``queue_premature_release`` negative (release before reading).
* **DispatchArena reuse under the port's claim.**  The reference claims
  a slot needing only "the previous slot dispatched", and one slot
  below ``ring_safe_slots(depth, ring) = depth + ring + 1`` its checker
  finds the staged-copy overwrite: a claim recycles the slot of a
  dispatch the device has not read yet.  The port's claim
  (``Engine._claim``) also waits for the CUDA event of the last
  dispatch staged in the slot, recorded at its launch after the slot's
  upload.  The model drives the real arena and the real ``_claim`` over
  the reference's worst-case workload (trickle singles, then full ring
  rounds; the device reads a slot's rows when it executes the launch,
  the latest a real upload can land), with the reference's contract
  ordering otherwise (one slot of staging lookahead past a submit, then
  the reap catches up to ``readback_depth``).  Both slot counts must
  pass every interleaving, and at ``depth + ring`` slots the check
  counts the interleavings in which a claim had to wait for its event:
  there the bound is a throughput bound, not a safety bound.  The
  planted ``arena_claim_no_event_wait`` (a claim that skips the event
  wait, in the model only) must find the reference's overwrite at
  ``depth + ring`` slots and print its schedule.

Everything runs in a few seconds on the CPU; ``fsx sync`` wires it.
"""

from __future__ import annotations

from __future__ import annotations

import dataclasses
import tempfile
import threading
from pathlib import Path
from typing import Any, Callable, Iterator

import numpy as np

from flowsentryx_tpu_torch.sync.channel import SinkChannel, WorkerCrash


class ModelViolation(AssertionError):
    """An invariant failed at one step of one explored schedule."""


@dataclasses.dataclass
class Counterexample:
    """One violating schedule, replayable by hand."""

    schedule: list          # executed "thread:step" labels, in order
    detail: str             # what broke at the last step

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    def __str__(self) -> str:
        steps = "\n    ".join(
            f"{i:2d}. {s}" for i, s in enumerate(self.schedule))
        return f"{self.detail}\n  schedule:\n    {steps}"


@dataclasses.dataclass
class CheckResult:
    """Outcome of exhausting one check's schedule space."""

    check: str
    ok: bool                 # expectation met (see expect_violation)
    expect_violation: bool   # negative demo: ok means a cx was FOUND
    interleavings: int       # complete schedules explored
    steps: int               # total thread-steps executed (incl. replays)
    capped: bool             # stopped at the exploration budget
    counterexample: Counterexample | None

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["counterexample"] = (self.counterexample.to_json()
                               if self.counterexample else None)
        return d


#: Exploration budget: total executed steps across all replays.  Every
#: shipped check exhausts its space well under this; hitting it marks
#: the result ``capped`` (loudly reported) rather than silently
#: passing on partial coverage.
MAX_STEPS = 5_000_000


class InstrumentedCv(threading.Condition):
    """A Condition that COUNTS its notifies, so the liveness model can
    see wake edges.  The safety checker's ``(predicate, label)`` waits
    re-evaluate their predicate every scheduling point — a model in
    which a deleted ``notify_all`` is invisible, because the quantum
    timeout on every real wait eventually re-polls.  The liveness
    model (:func:`explore_live`) instead treats a :class:`CvWait` as
    woken only by its DECLARED wake source actually firing: swap a
    protocol object's ``cv`` for one of these (before any use) and the
    real code's ``notify``/``notify_all`` calls become observable
    events — the PROGRESS registry's wake edges, checked, not
    assumed."""

    def __init__(self, lock=None):
        super().__init__(lock)
        self.notifies = 0

    def notify(self, n: int = 1) -> None:
        self.notifies += 1
        super().notify(n)

    def notify_all(self) -> None:
        self.notifies += 1
        super().notify_all()


@dataclasses.dataclass
class CvWait:
    """A liveness-model wait descriptor: runnable only once ``pred``
    holds AND the wait has actually been woken — either the predicate
    already held when the thread parked (the real code's pre-wait
    check admits it without sleeping) or ``cv.notifies`` advanced
    since.  ``source`` names the declared wake edge (the PROGRESS
    registry's ``wake`` column) for deadlock diagnostics."""

    pred: Callable[[], bool]
    label: str
    cv: InstrumentedCv
    source: str = ""

    def describe(self) -> str:
        s = f" (wake source: {self.source})" if self.source else ""
        return f"{self.label}{s}"


class _Thread:
    """One cooperative thread: a generator plus its next-step gate."""

    def __init__(self, name: str, gen: Iterator):
        self.name = name
        self.gen = gen
        self.desc: Any = None
        self.done = False
        self._arm = 0          # cv notify count when the wait parked
        self._entry_ok = False  # predicate held at park time

    def start(self) -> None:
        """Run setup code up to the first yield (atomic, at t=0)."""
        self._advance()

    def runnable(self) -> bool:
        if self.done:
            return False
        d = self.desc
        if isinstance(d, str):
            return True
        if isinstance(d, CvWait):
            return bool(d.pred()) and (self._entry_ok
                                       or d.cv.notifies > self._arm)
        return bool(d[0]())

    def label(self) -> str:
        d = self.desc
        if isinstance(d, str):
            return d
        if isinstance(d, CvWait):
            return d.label
        return d[1]

    def wait_desc(self) -> str:
        """Human description of what this (blocked) thread waits on —
        the deadlock report's per-thread wait predicate."""
        d = self.desc
        if isinstance(d, CvWait):
            return d.describe()
        return self.label()

    def wake_armed(self) -> bool:
        """For the state fingerprint: whether a parked CvWait has
        already been handed its wake (the predicate may still be
        false) — two states differing only in a pending wake are NOT
        the same state."""
        d = self.desc
        if isinstance(d, CvWait):
            return self._entry_ok or d.cv.notifies > self._arm
        return True

    def step(self) -> None:
        """Execute the described step (runs to the next yield)."""
        self._advance()

    def _advance(self) -> None:
        try:
            self.desc = next(self.gen)
        except StopIteration:
            self.done, self.desc = True, None
            return
        if isinstance(self.desc, CvWait):
            # park: record the wake watermark and whether the real
            # code's pre-wait predicate check would have admitted it
            # without sleeping (no notify needed in that case)
            self._arm = self.desc.cv.notifies
            self._entry_ok = bool(self.desc.pred())


def explore(
    check: str,
    mk: Callable[[], tuple],
    *,
    expect_violation: bool = False,
    expect_marker: str | None = None,
    max_steps: int = MAX_STEPS,
) -> CheckResult:
    """Exhaust every schedule of the threads ``mk`` builds.

    ``mk()`` returns ``(threads, finale)``: ``threads`` is a list of
    ``(name, generator)`` built over FRESH protocol objects (the DFS
    replays prefixes, so construction must reset all state), and
    ``finale`` (or None) runs end-of-schedule assertions.

    With ``expect_violation`` the check is a planted-negative demo:
    exploration stops at the first counterexample and ``ok`` means one
    was found — the harness proving it can see that bug class.
    ``expect_marker`` pins WHICH bug class: only a counterexample
    whose detail contains the marker counts (a deadlock or an
    unrelated assertion tripping first must not let the demo stay
    green while the intended bug goes undemonstrated).
    """
    steps = 0
    interleavings = 0
    capped = False
    first_cx: Counterexample | None = None

    def matches(cx: Counterexample) -> bool:
        return expect_marker is None or expect_marker in cx.detail

    def replay(prefix: tuple) -> tuple:
        nonlocal steps
        pairs, finale = mk()
        ts = [_Thread(n, g) for n, g in pairs]
        for t in ts:
            t.start()
        trace: list[str] = []
        for choice in prefix:
            run = [t for t in ts if t.runnable()]
            t = run[choice]
            trace.append(f"{t.name}:{t.label()}")
            steps += 1
            try:
                t.step()
            except ModelViolation as e:
                # hand the caller the trace built so far — the
                # violating step is its last label — rather than
                # re-executing the whole prefix to rebuild it
                e.trace = trace
                raise
        return ts, trace, finale

    first_match: Counterexample | None = None

    def record(cx: Counterexample) -> bool:
        """Track the counterexample; True = stop exploring now."""
        nonlocal first_cx, first_match
        if first_cx is None:
            first_cx = cx
        if matches(cx) and first_match is None:
            first_match = cx
        # a negative demo stops only on the INTENDED bug class; an
        # unrelated violation keeps exploring (and fails the check if
        # the marker never shows); a positive check reports the first
        return expect_violation and first_match is not None

    stack: list[tuple] = [()]
    while stack:
        if steps >= max_steps:
            capped = True
            break
        prefix = stack.pop()
        try:
            ts, trace, finale = replay(prefix)
        except ModelViolation as e:
            # the last choice is the violating step; earlier prefixes
            # were validated when they were pushed
            if record(Counterexample(schedule=getattr(e, "trace", []),
                                     detail=str(e))):
                break
            if expect_violation:
                continue
            break
        run_idx = [i for i, t in enumerate(ts) if t.runnable()]
        if not run_idx:
            if any(not t.done for t in ts):
                stop = record(Counterexample(
                    schedule=trace,
                    detail="deadlock: live threads, none runnable "
                           f"({', '.join(t.name for t in ts if not t.done)})"))
                if stop:
                    break
                if expect_violation:
                    continue
                break
            interleavings += 1
            if finale is not None:
                try:
                    finale()
                except ModelViolation as e:
                    if record(Counterexample(schedule=trace,
                                             detail=str(e))):
                        break
                    if not expect_violation:
                        break
            continue
        for i in reversed(range(len(run_idx))):
            stack.append(prefix + (i,))

    if expect_violation:
        ok = first_match is not None
    else:
        ok = first_cx is None and not capped
    return CheckResult(check=check, ok=ok,
                       expect_violation=expect_violation,
                       interleavings=interleavings, steps=steps,
                       capped=capped,
                       counterexample=first_match or first_cx)


# ---------------------------------------------------------------------------
# liveness exploration: deadlock / livelock / starvation over a state graph
# ---------------------------------------------------------------------------
#
# `explore()` above proves SAFETY: no schedule reaches a bad state.  It
# cannot prove PROGRESS — a fleet that parks forever on a dropped wake
# never reaches a bad state, it just stops.  `explore_live()` builds the
# full state GRAPH (not just the schedule tree: states reached by
# different prefixes are merged) and runs three detectors over it:
#
#   deadlock    some thread is live but NO thread is runnable; the report
#               names each parked thread's wait predicate and declared
#               wake source.
#   livelock    a reachable cycle that is admissible under WEAK FAIRNESS
#               (every thread on the cycle either steps or is observed
#               not-runnable somewhere on it) along which no declared
#               progress counter advances.  Detected per strongly
#               connected component: an SCC with a cycle is a livelock
#               iff each thread has an intra-SCC step edge or is
#               not-runnable at some SCC node — a closed walk through
#               the SCC then starves no continuously-enabled thread.
#               Progress counters must be MONOTONIC (counts of completed
#               work); they are part of the state key, so any edge that
#               advances one leaves the SCC.
#   starvation  a declared Obligation stays enabled for more than its
#               registered bound of consecutive steps without firing.
#               The per-obligation clock is folded into the state key
#               (saturating at bound+1, keeping the space finite), so
#               the detector is exact up to the bound.


@dataclasses.dataclass
class Obligation:
    """A progress obligation: while ``enabled()`` holds, ``fired()``
    must change value within ``bound`` consecutive model steps.  The
    bound is the PROGRESS registry's declared bound — runtime and
    checker share one number."""

    name: str
    enabled: Callable[[], bool]
    fired: Callable[[], Any]
    bound: int


@dataclasses.dataclass
class LiveSpec:
    """What `explore_live` watches, built fresh by ``mk()`` alongside
    the threads.

    ``fingerprint`` must capture ALL mutable protocol state the threads
    read (hashable) — two states with equal fingerprints, thread
    states, progress and clocks are merged.  ``progress`` returns the
    declared progress counters (hashable, monotonic).  ``finale`` runs
    end-of-schedule assertions at terminal states, as in `explore`."""

    fingerprint: Callable[[], Any]
    progress: Callable[[], Any] = lambda: ()
    obligations: list[Obligation] = dataclasses.field(default_factory=list)
    finale: Callable[[], None] | None = None


@dataclasses.dataclass
class LiveCheckResult:
    """Outcome of one liveness check (JSON-serialisable)."""

    check: str
    ok: bool
    expect_violation: bool
    states: int
    edges: int
    terminals: int
    steps: int
    capped: bool
    detector: str | None
    counterexample: Counterexample | None

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        if self.counterexample is not None:
            d["counterexample"] = {
                "schedule": list(self.counterexample.schedule),
                "detail": self.counterexample.detail,
            }
        return d


def _thread_state(ts: list[_Thread]) -> tuple:
    """Per-thread component of the state key.  A parked CvWait whose
    wake already arrived is a DIFFERENT state from one still waiting,
    even if all protocol state matches."""
    return tuple(("done",) if t.done else (t.label(), t.wake_armed())
                 for t in ts)


def explore_live(
    check: str,
    mk: Callable[[], tuple],
    *,
    expect_violation: bool = False,
    expect_marker: str | None = None,
    max_steps: int = MAX_STEPS,
    max_states: int = 50_000,
) -> LiveCheckResult:
    """Build the state graph of the threads ``mk`` builds and prove
    deadlock-freedom, livelock-freedom (under weak fairness) and
    bounded starvation.

    ``mk()`` returns ``(threads, spec)``: ``threads`` as in `explore`
    (built over FRESH objects — the explorer replays prefixes), ``spec``
    a :class:`LiveSpec`.  ``expect_violation`` / ``expect_marker``
    carry the planted-negative semantics of `explore`: the check is
    a demo and ``ok`` means a counterexample whose detail contains the
    marker was found."""
    steps = 0
    capped = False
    terminals = 0
    first_cx: Counterexample | None = None
    first_match: Counterexample | None = None
    first_det: str | None = None
    match_det: str | None = None

    def record(cx: Counterexample, det: str) -> bool:
        """Track the counterexample; True = stop exploring now."""
        nonlocal first_cx, first_match, first_det, match_det
        if first_cx is None:
            first_cx, first_det = cx, det
        if first_match is None and (expect_marker is None
                                    or expect_marker in cx.detail):
            first_match, match_det = cx, det
        # negative demos stop on the INTENDED class; positives stop on
        # the first counterexample of any class
        return (first_match is not None) if expect_violation \
            else (first_cx is not None)

    def replay(prefix: tuple) -> tuple:
        nonlocal steps
        pairs, spec = mk()
        ts = [_Thread(n, g) for n, g in pairs]
        for t in ts:
            t.start()
        trace: list[str] = []
        for choice in prefix:
            run = [t for t in ts if t.runnable()]
            t = run[choice]
            trace.append(f"{t.name}:{t.label()}")
            steps += 1
            t.step()  # prefix was validated when pushed; cannot raise
        return ts, spec, trace

    # ---- phase 1: graph build (memoized-replay DFS) -------------------
    ts0, spec0, _ = replay(())
    obs_n = len(spec0.obligations)
    clocks0 = (0,) * obs_n
    fired0 = tuple(ob.fired() for ob in spec0.obligations)
    key0 = (_thread_state(ts0), spec0.fingerprint(), spec0.progress(),
            clocks0)

    # node bookkeeping: edges for SCC, meta for fairness + diagnostics
    edges: dict[tuple, list[tuple]] = {key0: []}
    meta: dict[tuple, dict] = {}
    stack: list[tuple] = [(key0, (), clocks0, fired0)]
    stopped = False

    while stack and not stopped:
        if steps >= max_steps or len(edges) >= max_states:
            capped = True
            break
        key, prefix, clocks, fired_prev = stack.pop()
        ts, spec, trace = replay(prefix)
        run = [t for t in ts if t.runnable()]
        live = [t for t in ts if not t.done]
        meta[key] = {
            "trace": trace,
            "runnable": frozenset(t.name for t in run),
            "names": frozenset(t.name for t in ts),
        }
        if not run:
            if live:
                waits = "; ".join(f"{t.name} waits on {t.wait_desc()}"
                                  for t in live)
                if record(Counterexample(
                        schedule=trace,
                        detail=f"deadlock: no runnable thread — {waits}"),
                        "deadlock"):
                    break
                continue
            terminals += 1
            if spec.finale is not None:
                try:
                    spec.finale()
                except ModelViolation as e:
                    if record(Counterexample(schedule=trace,
                                             detail=str(e)), "violation"):
                        break
            continue
        for ci in range(len(run)):
            # fresh replay per child: stepping mutates the objects
            ts2, spec2, trace2 = replay(prefix)
            t = [x for x in ts2 if x.runnable()][ci]
            label = f"{t.name}:{t.label()}"
            steps += 1
            try:
                t.step()
            except ModelViolation as e:
                if record(Counterexample(schedule=trace2 + [label],
                                         detail=str(e)), "violation"):
                    stopped = True
                    break
                if expect_violation:
                    continue
                stopped = True
                break
            obls = spec2.obligations
            fired_now = tuple(ob.fired() for ob in obls)
            new_clocks = tuple(
                0 if (not obls[i].enabled()
                      or fired_now[i] != fired_prev[i])
                else min(clocks[i] + 1, obls[i].bound + 1)
                for i in range(obs_n))
            starving = [i for i in range(obs_n)
                        if new_clocks[i] > obls[i].bound]
            if starving:
                i = starving[0]
                if record(Counterexample(
                        schedule=trace2 + [label],
                        detail=f"starvation: obligation '{obls[i].name}' "
                               f"enabled for > {obls[i].bound} steps "
                               "without firing"), "starvation"):
                    stopped = True
                    break
                if not expect_violation:
                    stopped = True
                    break
                continue  # demo: don't expand past a starving state
            child = (_thread_state(ts2), spec2.fingerprint(),
                     spec2.progress(), new_clocks)
            edges[key].append((t.name, label, child))
            if child not in edges:
                edges[child] = []
                stack.append((child, prefix + (ci,), new_clocks,
                              fired_now))

    # ---- phase 2: livelock scan (Tarjan SCC, weak fairness) -----------
    need_scan = not capped and (first_cx is None if not expect_violation
                                else first_match is None)
    if need_scan:
        index: dict[tuple, int] = {}
        low: dict[tuple, int] = {}
        on: set[tuple] = set()
        sccs: list[list[tuple]] = []
        sstack: list[tuple] = []
        counter = 0
        for root in edges:
            if root in index:
                continue
            work = [(root, iter(edges[root]))]
            index[root] = low[root] = counter
            counter += 1
            sstack.append(root)
            on.add(root)
            while work:
                node, it = work[-1]
                adv = False
                for (_tn, _lb, child) in it:
                    if child not in index:
                        index[child] = low[child] = counter
                        counter += 1
                        sstack.append(child)
                        on.add(child)
                        work.append((child, iter(edges.get(child, []))))
                        adv = True
                        break
                    if child in on:
                        low[node] = min(low[node], index[child])
                if adv:
                    continue
                work.pop()
                if work:
                    parent = work[-1][0]
                    low[parent] = min(low[parent], low[node])
                if low[node] == index[node]:
                    comp = []
                    while True:
                        w = sstack.pop()
                        on.discard(w)
                        comp.append(w)
                        if w == node:
                            break
                    sccs.append(comp)

        for comp in sccs:
            comp_set = set(comp)
            intra = [(n, tn, lb, ch) for n in comp
                     for (tn, lb, ch) in edges.get(n, [])
                     if ch in comp_set]
            if not intra:
                continue  # no cycle in this SCC
            names = set()
            for n in comp:
                names |= meta.get(n, {}).get("names", frozenset())
            steppers = {tn for (_n, tn, _lb, _ch) in intra}
            fair = all(
                tn in steppers
                or any(tn not in meta.get(n, {}).get("runnable",
                                                     frozenset())
                       for n in comp)
                for tn in names)
            if not fair:
                continue  # every escape-capable thread must eventually run
            # representative cycle: walk intra-SCC edges from the
            # shallowest node until a repeat
            entry = min(comp, key=lambda n: len(meta.get(n, {})
                                                .get("trace", [])))
            cyc_labels: list[str] = []
            seen = {entry}
            node = entry
            while True:
                nxt = next(((tn, lb, ch) for (n2, tn, lb, ch) in intra
                            if n2 == node), None)
                if nxt is None:
                    break
                cyc_labels.append(nxt[1])
                node = nxt[2]
                if node in seen:
                    break
                seen.add(node)
            tr = meta.get(entry, {}).get("trace", [])
            cx = Counterexample(
                schedule=list(tr) + [f"[cycle] {lb}" for lb in cyc_labels],
                detail="livelock: weakly-fair cycle with no progress "
                       f"({len(comp)} states; threads stepping: "
                       f"{', '.join(sorted(steppers))})")
            record(cx, "livelock")
            break

    if expect_violation:
        ok = first_match is not None
        det = match_det
    else:
        ok = first_cx is None and not capped
        det = first_det
    cx_out = first_match or first_cx
    n_edges = sum(len(v) for v in edges.values())
    return LiveCheckResult(check=check, ok=ok,
                           expect_violation=expect_violation,
                           states=len(edges), edges=n_edges,
                           terminals=terminals, steps=steps,
                           capped=capped, detector=det,
                           counterexample=cx_out)


# ---------------------------------------------------------------------------
# check 1/2: SinkChannel crash atomicity (positive + planted negative)
# ---------------------------------------------------------------------------

def _mk_channel_crash(split_complete: bool) -> Callable[[], tuple]:
    """Dispatch submits two batches; the worker crashes on the second.
    Invariant: once the backpressure wait releases the dispatch thread,
    ``check()`` must surface the crash — (pending drained, crash unset)
    must be unobservable for crashed work.  ``split_complete`` runs the
    planted-broken worker that decrements and records in two separate
    cv sections (the bug :meth:`SinkChannel.complete` exists to make
    unwritable)."""

    def mk() -> tuple:
        chan = SinkChannel("model worker")
        n_items = 2

        def dispatch():
            for i in range(n_items):
                yield f"submit#{i}"
                chan.submit(("batch", i), 1)
            yield (lambda: chan.pending == 0
                   or chan.crashed() is not None, "wait_below(0)")
            # wait_below returned: the pipe looks drained (or a crash
            # is already visible) — the next dispatch poll checks
            try:
                chan.check()
            except WorkerCrash:
                return  # LOUD — the contract held
            raise ModelViolation(
                "crash-atomicity violated: wait_below(0) released the "
                "dispatch thread with pending drained and check() "
                "silent, but batch#1 crashed in the worker — its "
                "verdicts are gone and the engine would serve on")

        def worker():
            for i in range(n_items):
                yield (lambda: len(chan._q) > 0, f"pop#{i}")
                got = chan.try_pop()
                assert got is not None
                exc = (RuntimeError("decode exploded")
                       if i == n_items - 1 else None)
                if not split_complete:
                    yield f"complete#{i}"
                    chan.complete(1, 0.0, exc)
                else:
                    # PLANTED BUG: pending decrement and crash record
                    # land in two separate cv sections — the waiter can
                    # run between them
                    yield f"complete#{i}-decrement-only"
                    chan.complete(1, 0.0, None)
                    if exc is not None:
                        yield "record_exc-too-late"
                        chan.record_exc(exc)
                if exc is not None:
                    return

        return [("dispatch", dispatch()), ("worker", worker())], None

    return mk


# ---------------------------------------------------------------------------
# check 3: SinkChannel stop/drain, three threads
# ---------------------------------------------------------------------------

def _mk_channel_stop_drain() -> tuple:
    """Two submitters + the worker: request_stop must drain — every
    submitted item processed exactly once, FIFO per submitter, and the
    queue empty at exit (the drain-preserving shutdown contract)."""
    chan = SinkChannel("model worker")
    per_submitter = 2
    processed: list = []
    submitted = [0]

    def submitter(tag: str):
        def gen():
            for i in range(per_submitter):
                yield f"submit#{tag}{i}"
                chan.submit((tag, i), 1)
                submitted[0] += 1
        return gen

    def stopper():
        # the engine requests stop only after the dispatch loop
        # quiesces (_stop_sink_thread runs at teardown) — a stop
        # racing live submitters is not a reachable engine schedule
        yield (lambda: submitted[0] == per_submitter * 2,
               "request_stop")
        chan.request_stop()

    def worker():
        while True:
            yield (lambda: len(chan._q) > 0 or chan._stop, "pop")
            got = chan.try_pop()
            if got is None:
                if chan._stop:
                    return  # stop requested and queue drained
                continue
            processed.extend(got)
            yield "complete"
            chan.complete(len(got), 0.0, None)

    def finale():
        want = per_submitter * 2
        if len(processed) != want:
            raise ModelViolation(
                f"drain-on-stop lost work: {len(processed)} of {want} "
                "items processed")
        for tag in ("a", "b"):
            mine = [i for t, i in processed if t == tag]
            if mine != sorted(mine):
                raise ModelViolation(
                    f"FIFO broken for submitter {tag}: {mine}")
        if chan.pending != 0:
            raise ModelViolation(
                f"pending={chan.pending} after full drain")
        if not chan.drained():
            raise ModelViolation("queue not empty at exit")

    return ([("submit-a", submitter("a")()),
             ("submit-b", submitter("b")()),
             ("stop", stopper()),
             ("worker", worker())], finale)


# ---------------------------------------------------------------------------
# check 4/5: SealedBatchQueue across wraparound (positive + misuse)
# ---------------------------------------------------------------------------

_Q_SLOTS = 2
_Q_WORDS = 4
_Q_BATCHES = 4  # crosses wraparound twice at 2 slots


def _q_payload(seq: int) -> np.ndarray:
    return np.full(_Q_WORDS, seq + 1, np.uint32)


def _mk_queue(path: Path, premature_release: bool) -> Callable[[], tuple]:
    """Producer pushes ``_Q_BATCHES`` sealed batches through the REAL
    2-slot shm queue; the consumer peeks (zero-copy views), lets the
    scheduler interleave, then verifies the views and releases.
    Invariants: seq order, and peeked views bit-stable until release.
    ``premature_release`` plants the cursor misuse — release first,
    read the dead views after — which the SPSC contract forbids
    exactly because some schedule overwrites them."""
    from flowsentryx_tpu_torch.engine.shm import SealedBatchQueue

    def mk() -> tuple:
        # fresh file per replay: create() rewrites header AND zeroes
        # cursors (truncate-to-zero first), so every prefix starts
        # from the same initial state
        q = SealedBatchQueue.create(path, _Q_SLOTS, _Q_WORDS)

        def producer():
            for seq in range(_Q_BATCHES):
                yield (lambda: q.readable() < q.slots, f"produce#{seq}")
                ok = q.produce_batch(
                    _q_payload(seq), seq=seq, n_records=1, wire_id=7,
                    seal_ns=seq, fill_dur_us=0)
                if not ok:
                    raise ModelViolation(
                        f"produce_batch({seq}) refused with "
                        f"{q.readable()}/{q.slots} readable — space "
                        "accounting broke")

        def consumer():
            expect = 0
            while expect < _Q_BATCHES:
                yield (lambda: q.readable() > 0, f"peek@{expect}")
                batches = q.peek_batches(_Q_SLOTS)
                n = len(batches)
                if premature_release:
                    # PLANTED MISUSE: cursor released before the views
                    # are read — the producer may now reuse the slots
                    q.release(n)
                    yield f"release@{expect}(premature)"
                else:
                    yield f"verify@{expect}"
                for hdr, payload in batches:
                    seq = int(hdr[0]) | (int(hdr[1]) << 32)
                    if seq != expect:
                        raise ModelViolation(
                            f"sequence broke: slot carries seq {seq}, "
                            f"expected {expect}")
                    if not np.array_equal(payload, _q_payload(seq)):
                        raise ModelViolation(
                            f"peeked payload view of seq {seq} changed "
                            "under the consumer: "
                            f"{payload.tolist()} != "
                            f"{_q_payload(seq).tolist()} — the slot "
                            "was overwritten before release"
                            + (" (the premature release handed it "
                               "back)" if premature_release else ""))
                    expect += 1
                if not premature_release:
                    q.release(n)

        return [("worker", producer()), ("engine", consumer())], None

    return mk


# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# check 6/7/8: the arena under the port's event-guarded claim
# ---------------------------------------------------------------------------

class _ModelEvent:
    """The CUDA event a launch records after its dispatch's reads of
    the arena (``torch.cuda.Event`` in ``Engine._launch``): ``query()``
    is True once the model's device has executed that launch."""

    def __init__(self) -> None:
        self.fired = False

    def query(self) -> bool:
        return self.fired


def _claim_host(arena):
    """An object carrying exactly what ``Engine._claim`` and
    ``Engine._wait_event`` read, with those two methods taken from the
    port's ``Engine`` itself: the model claims through the real code."""
    from flowsentryx_tpu_torch.engine.engine import Engine

    class _Host:
        _claim = Engine._claim
        _wait_event = Engine._wait_event

    host = _Host()
    host._arena = arena
    host._arena_event = [None] * arena.slots
    return host


def _mk_arena(slots: int, depth: int, ring: int, n_singles: int,
              n_rounds: int, *, event_wait: bool = True,
              tally: dict | None = None) -> Callable[[], tuple]:
    """Drive the real :class:`DispatchArena` through the port's
    ``Engine._claim`` over the reference's worst-case workload:
    ``n_singles`` trickle singles (one slot each), then ``n_rounds``
    full ring rounds of ``ring`` 1-chunk slots, each slot uploaded the
    moment it is staged and the round launched as one dispatch.

    * A claim is runnable once the event recorded for that slot (if
      any) has fired — ``_claim``'s wait; ``event_wait=False`` plants a
      claim that skips it (``arena.claim()`` alone).
    * The reference's contract ordering otherwise: the first claim past
      a submit may overlap its backpressure; before a second, the reap
      catches up to ``pending <= depth``.
    * A submit is ``_launch``: it records ONE event for every arena slot
      the dispatch reads (a ring round's event follows its slots'
      uploads on the step's stream).
    * The device executes launches in order; it reads each slot's rows
      when it executes the launch (the latest an upload on the copy
      stream can land) and then fires the event.  The sink decrements
      the pending count after that.

    The integrity invariant is checked where the device reads: every
    slot must still carry the bytes staged for its batch.  ``tally``
    (a dict) receives ``interleavings_waited``: complete schedules in
    which some claim was blocked on its event."""
    from flowsentryx_tpu_torch.engine.arena import DispatchArena

    def pat(b: int) -> int:
        return b + 1  # 0 is the arena's zero-fill: never a valid stamp

    def mk() -> tuple:
        arena = DispatchArena(slots, group_max=1, max_batch=1,
                              words=_Q_WORDS)
        host = _claim_host(arena)
        pending = [0]          # submitted-but-unsunk batches
        subq: list = []        # launched work: (kind, [(slot, b)], event)
        waited = [False]

        def slot_free() -> bool:
            ev = host._arena_event[(arena._cur + 1) % arena.slots]
            free = ev is None or ev.query()
            if not free:
                waited[0] = True
            return free

        def dispatch():
            b = 0
            armed = False   # a submit is in flight: reap before the
            #                 second claim beyond it

            def unit(kind: str, n_slots: int, r: int):
                nonlocal b, armed
                ups = []
                for j in range(n_slots):
                    label = (f"claim+stage"
                             f"{'+upload' if kind == 'ring' else ''}#{b}"
                             + (f" (round {r})" if r >= 0 else ""))
                    if event_wait:
                        yield (slot_free, label)
                        s = host._claim()
                    else:
                        yield label
                        s = arena.claim()   # PLANTED: no event wait
                    arena.rows(s)[...] = pat(b)
                    ups.append((s, b))
                    b += 1
                    if j == 0 and armed:
                        # one slot of staging lookahead is spent: the
                        # reap catches up before any further claim
                        yield (lambda: pending[0] <= depth,
                               f"reap(depth={depth})")
                yield f"launch {kind}#{ups[0][1]}"
                ev = _ModelEvent()
                for s, _ in ups:
                    host._arena_event[s] = ev
                subq.append((kind, ups, ev))
                pending[0] += n_slots
                armed = True

            for _ in range(n_singles):
                yield from unit("single", 1, -1)
            for r in range(n_rounds):
                yield from unit("ring", ring, r)

        def device():
            done = 0
            total = n_singles + n_rounds
            while done < total:
                yield (lambda: len(subq) > 0, f"execute#{done}")
                kind, ups, ev = subq.pop(0)
                for s, b in ups:
                    view = arena.rows(s)[0]
                    got = int(view[0, 0])
                    if not np.array_equal(view, np.full_like(view, pat(b))):
                        raise ModelViolation(
                            f"staged-copy overwrite: the device read of "
                            f"{kind} batch#{b} found arena slot {s} "
                            f"carrying the stamp of batch#{got - 1} — "
                            f"dispatch recycled the slot before the "
                            f"device read it ({slots} slots, "
                            f"readback_depth={depth}, ring={ring}, "
                            f"claim {'with' if event_wait else 'WITHOUT'}"
                            f" its event wait)")
                ev.fired = True
                yield f"sink#{done}"
                pending[0] -= len(ups)
                done += 1

        def finale() -> None:
            if tally is not None and waited[0]:
                tally["interleavings_waited"] = (
                    tally.get("interleavings_waited", 0) + 1)

        return [("dispatch", dispatch()), ("device", device())], finale

    return mk


# ---------------------------------------------------------------------------
# the suite
# ---------------------------------------------------------------------------

#: The reference's geometry, small enough to exhaust, big enough that
#: both phases of the worst case are present.  ring_safe_slots(1, 2) == 4.
_ARENA_DEPTH, _ARENA_RING = 1, 2
_ARENA_SINGLES, _ARENA_ROUNDS = 1, 2


@dataclasses.dataclass
class InterleaveReport:
    """The model-checking half of ``fsx sync``."""

    ok: bool
    checks: list
    interleavings: int
    steps: int
    bound: dict              # the arena check's headline numbers

    def to_json(self) -> dict:
        return {"ok": self.ok,
                "interleavings": self.interleavings,
                "steps": self.steps,
                "bound": self.bound,
                "checks": [c.to_json() for c in self.checks]}


def run_interleave(tmp_dir: str | Path | None = None) -> InterleaveReport:
    """Run every model check.  Positives must pass all interleavings;
    planted negatives must produce their counterexample."""
    from flowsentryx_tpu_torch.engine.arena import DispatchArena

    checks: list[CheckResult] = []

    checks.append(explore(
        "channel_crash_atomicity", _mk_channel_crash(False)))
    checks.append(explore(
        "channel_split_complete", _mk_channel_crash(True),
        expect_violation=True,
        expect_marker="crash-atomicity violated"))
    checks.append(explore(
        "channel_stop_drain", lambda: _mk_channel_stop_drain()))

    with tempfile.TemporaryDirectory(
            dir=tmp_dir, prefix="fsx_sync_") as td:
        qpath = Path(td) / "modelq.shm"
        checks.append(explore(
            "queue_wraparound", _mk_queue(qpath, False)))
        checks.append(explore(
            "queue_premature_release", _mk_queue(qpath, True),
            expect_violation=True,
            expect_marker="overwritten before release"))

    safe = DispatchArena.ring_safe_slots(_ARENA_DEPTH, _ARENA_RING)
    geom = (_ARENA_DEPTH, _ARENA_RING, _ARENA_SINGLES, _ARENA_ROUNDS)
    tally_safe: dict = {}
    tally_below: dict = {}
    proof = explore(f"arena_bound@{safe}_slots",
                    _mk_arena(safe, *geom, tally=tally_safe))
    below = explore(f"arena_bound@{safe - 1}_slots",
                    _mk_arena(safe - 1, *geom, tally=tally_below))
    plant = explore(f"arena_claim_no_event_wait@{safe - 1}_slots",
                    _mk_arena(safe - 1, *geom, event_wait=False),
                    expect_violation=True,
                    expect_marker="staged-copy overwrite")
    checks += [proof, below, plant]

    return InterleaveReport(
        ok=all(c.ok for c in checks),
        checks=checks,
        interleavings=sum(c.interleavings for c in checks),
        steps=sum(c.steps for c in checks),
        bound={
            "readback_depth": _ARENA_DEPTH,
            "ring": _ARENA_RING,
            "safe_slots": safe,
            "interleavings_at_safe": proof.interleavings,
            "safe_ok": proof.ok,
            "waited_at_safe": tally_safe.get("interleavings_waited", 0),
            # one slot below the bound: the event guard holds safety
            "below_slots": safe - 1,
            "below_ok": below.ok,
            "interleavings_below": below.interleavings,
            "waited_below": tally_below.get("interleavings_waited", 0),
            # the bound is a safety bound only without the event wait:
            # the marker-matched overwrite of the planted claim
            "counterexample_without_event_wait": plant.ok,
        },
    )
