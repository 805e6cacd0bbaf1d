"""The simulated host the crash checker runs the port's real protocols
on.

Counterpart of ``flowsentryx_tpu/crash/world.py``.  ``checker.py`` needs
the protocol code of this package's ``cluster/rebalance.py``,
``cluster/supervisor.py`` and ``engine/checkpoint.py`` to run unmodified
over simulated state.  Their seams make that possible:

* ``durable.use_fs`` swaps :class:`~.simfs.SimFS` under every durable
  read and write (checkpoints included),
* ``rebalance.use_mailbox_cls`` swaps :class:`SimMailboxHub` under the
  handoff's SPSC shm mailbox,
* the ``status`` object both protocol halves stamp ctl words through
  is duck-typed — :class:`SimStatus` records each stamp as a traced
  crash point,
* :class:`SimSupervisor` subclasses the real
  :class:`~flowsentryx_tpu_torch.cluster.supervisor.ClusterSupervisor`
  without its process-spawning ``__init__``, so ``start_handoff``,
  ``_handoff_tick``, ``_abort_handoff``, ``adopt_dead_span`` and
  ``_neutralize_stale_handoff`` — the code under test — are the
  shipped methods, not reimplementations.

Volatility contract (simfs.py module docstring): shm — the mailbox
hub and every ctl word — survives a PROCESS crash (it belongs to the
kernel) and is lost at POWER crash.  :class:`MiniEngine` stands in for
the engine's three quiescent table methods with a numpy table, as in the
reference; its checkpoints go through the port's real
``checkpoint.save_state`` and ``load_checkpoint``.
"""

from __future__ import annotations

import contextlib
import io
from pathlib import Path

import numpy as np

from flowsentryx_tpu_torch.cluster import rebalance as rb
from flowsentryx_tpu_torch.cluster.supervisor import ClusterSupervisor
from flowsentryx_tpu_torch.core import durable, schema, wire
from flowsentryx_tpu_torch.engine import checkpoint as ckpt
from flowsentryx_tpu_torch.engine.shm import RingNotReady

from .simfs import CrashNow, SimFS, Tracer


class SimStatus:
    """One rank's ctl-word block.  Real ctl words live in mmap'd shm:
    every stamp is immediately visible fleet-wide (x86-TSO), survives
    the stamping process, and dies with the host — so a stamp is a
    traced crash point, and the harness zeroes the words only on
    power crash."""

    def __init__(self, tracer: Tracer, rank: int):
        self.tracer = tracer
        self.rank = rank
        self.ctl: dict[str, int] = {}

    def ctl_get(self, name: str) -> int:
        return int(self.ctl.get(name, 0))

    def ctl_set(self, name: str, value: int) -> None:
        self.tracer.point(f"ctl r{self.rank} {name}={int(value)}")
        self.ctl[name] = int(value)


class SimMailbox:
    """One SPSC handoff mailbox (shm semantics, list-backed).  Publish
    never reports full: the sim is single-threaded, so a blocked
    ``ship_rows`` retry loop could never be drained concurrently —
    capacity waits are a liveness concern out of scope here (the chaos
    campaign covers them on the real mailbox).  The consumer identity
    check is the SPSC contract: a second distinct consumer popping the
    same mailbox is flagged, never silent."""

    def __init__(self, hub: "SimMailboxHub", path: str, slots: int,
                 rows_per_slot: int, row_words: int):
        self.hub = hub
        self.path = path
        self.slots = slots
        self.rows_per_slot = rows_per_slot
        self.row_words = row_words
        self._q: list[tuple] = []
        self._consumer: str | None = None

    def publish_rows(self, packed, seq: int) -> bool:
        n = len(packed)
        self.hub.tracer.point(
            f"mbx publish {n} row(s) seq {seq} -> {self.path.rsplit('/', 1)[-1]}")
        self._q.append((seq, wire.HANDOFF_KIND_ROWS, n,
                        np.ascontiguousarray(packed,
                                             np.uint32).reshape(-1)))
        return True

    def publish_seal(self, seq: int, total: int, crc: int) -> bool:
        self.hub.tracer.point(
            f"mbx publish SEAL seq {seq} (total {total}, "
            f"crc {crc:#010x})")
        payload = np.array([total & 0xFFFFFFFF,
                            (total >> 32) & 0xFFFFFFFF,
                            crc & 0xFFFFFFFF], np.uint32)
        self._q.append((seq, wire.HANDOFF_KIND_SEAL, 0, payload))
        return True

    def pop_slots(self, max_slots: int) -> list[tuple]:
        actor = self.hub.tracer.actor
        if self._consumer is None:
            self._consumer = actor
        elif actor != self._consumer:
            self.hub.second_consumer.append(
                f"{actor} popped {self.path} after {self._consumer}")
        out = self._q[:max_slots]
        if out:
            self.hub.tracer.point(
                f"mbx pop {len(out)} slot(s)")
            del self._q[:len(out)]
        return out

    def readable(self) -> int:
        return len(self._q)


class SimMailboxHub:
    """``rebalance.mailbox_cls()`` stand-in: a registry of
    :class:`SimMailbox` by path.  ``chunk_rows`` clamps the slot
    geometry so even a small row set ships as MULTIPLE slots — the
    mid-ship crash points exist only if the stream has a middle."""

    def __init__(self, tracer: Tracer, chunk_rows: int = 3):
        self.tracer = tracer
        self.chunk_rows = chunk_rows
        self.boxes: dict[str, SimMailbox] = {}
        self.second_consumer: list[str] = []

    def create(self, path, slots: int = 64, rows_per_slot: int = 512,
               row_words: int = rb.ROW_WORDS) -> SimMailbox:
        self.tracer.point(
            f"mbx create {str(path).rsplit('/', 1)[-1]}")
        mbx = SimMailbox(self, str(path), slots,
                         min(rows_per_slot, self.chunk_rows), row_words)
        self.boxes[str(path)] = mbx
        return mbx

    def __call__(self, path) -> SimMailbox:
        mbx = self.boxes.get(str(path))
        if mbx is None:
            raise RingNotReady(f"sim handoff mailbox {path} not created")
        return mbx


class MiniEngine:
    """The engine's three quiescent table methods
    (engine/engine.py: ``extract_span_rows`` / ``drop_span_rows`` /
    ``adopt_rows``) over a flat numpy table — what the rebalancer and
    reconcile actually require of ``eng``.  Checkpoints round-trip
    through the REAL ``checkpoint.save_state``/``load_checkpoint``;
    the snapshot's ``t0_ns`` carries the save MARKER so the checker
    can name which generation a recovery resumed from."""

    def __init__(self, capacity: int = 64):
        self.key = np.zeros(capacity, np.uint32)
        self.state = np.zeros((capacity, wire.NUM_TABLE_COLS),
                              np.float32)
        self.counters: dict[str, int] = {}

    # -- quiescent protocol surface -----------------------------------------

    def _span_mask(self, shards, total_shards) -> np.ndarray:
        occ = self.key != 0
        return occ & np.isin(
            wire.shard_of(self.key, total_shards),
            np.asarray(list(shards), np.uint32))

    def extract_span_rows(self, shards, total_shards):
        sel = self._span_mask(shards, total_shards)
        return self.key[sel].copy(), self.state[sel].copy()

    def drop_span_rows(self, shards, total_shards) -> int:
        sel = self._span_mask(shards, total_shards)
        n = int(sel.sum())
        self.key[sel] = 0
        self.state[sel] = 0.0
        return n

    def adopt_rows(self, keys, states):
        keys = np.asarray(keys, np.uint32).reshape(-1)
        states = np.asarray(states, np.float32).reshape(len(keys), -1)
        inserted = dropped = 0
        for k, s in zip(keys, states):
            if not k or bool((self.key == k).any()):
                dropped += 1
                continue
            free = np.flatnonzero(self.key == 0)
            if not len(free):
                dropped += 1
                continue
            self.key[free[0]] = k
            self.state[free[0]] = s
            inserted += 1
        return inserted, dropped

    def count_rebalance(self, name: str, n: int = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + int(n)

    # -- state access --------------------------------------------------------

    def rows(self):
        occ = self.key != 0
        return self.key[occ].copy(), self.state[occ].copy()

    def save(self, path, marker: int) -> None:
        ckpt.save_state(path, schema.table_from_numpy(self.key, self.state),
                        schema.make_stats(), t0_ns=marker)


def ckpt_path(cluster_dir, rank: int) -> Path:
    return Path(cluster_dir) / f"ckpt_r{rank}.npz"


def restore_mini(path):
    """``Engine.restore``'s current-then-``.prev`` fallback ladder over
    :class:`MiniEngine`: ``(engine, marker)`` from the first candidate
    that loads, ``None`` when neither does — which, after any crash
    that followed a completed save, is an invariant violation."""
    for cand in (Path(path), ckpt.prev_path(path)):
        try:
            ck = ckpt.load_checkpoint(cand)
        except (ckpt.CheckpointCorrupt, ValueError, OSError):
            continue
        eng = MiniEngine(capacity=len(ck.key))
        eng.key = np.asarray(ck.key, np.uint32).copy()
        eng.state = np.asarray(ck.state, np.float32).copy()
        return eng, int(ck.t0_ns)
    return None


class SimSupervisor(ClusterSupervisor):
    """The real supervisor's handoff half over the sim plane: only the
    attributes the coordination methods touch are initialized (no
    multiprocessing context, no spawns), and liveness is the world's
    word instead of a proc handle.  Everything else — including the
    methods under test — is inherited verbatim."""

    def __init__(self, world: "World", specs: list[dict] | None = None):
        # the real __init__ spawns nothing until boot(), but it builds a
        # process context and the gossip plane's bookkeeping the handoff
        # half never reads: only what the handoff methods touch is set
        self.world = world
        self.cluster_dir = Path(world.dir)
        self.n = world.n
        self.specs = specs if specs is not None \
            else [{} for _ in range(world.n)]
        self._status = world.statuses
        self._active = set(range(world.n))
        self._failed = set(world.failed_ranks)
        self._done: set[int] = set()
        self._shrunk: set[int] = set()
        self._adopted = set(range(world.n))
        self._procs = [None] * world.n
        self._handoff: dict | None = None
        self._handoff_seq = 0
        self.rebalance_counters = {
            "rows_shipped": 0, "flips": 0, "fences": 0, "aborts": 0,
            "adoptions": 0}
        self.adopted_spans: list[dict] = []

    def live_ranks(self) -> list[int]:
        return [r for r in sorted(self._active)
                if r not in self._failed and r not in self._done
                and self.world.rank_alive(r)]


class World:
    """One simulated host: tracer + fs + mailbox hub + ctl blocks +
    engines, plus the actor discipline (:meth:`act`) that turns a
    :class:`CrashNow` into the right kind of death — propagate on
    power (the harness reconstructs from durable state), swallow-and-
    mark-dead on a party crash (the scenario loop respawns through the
    real recovery path)."""

    def __init__(self, *, n: int = 2, w: int = 2,
                 fsync_is_noop: bool = False, chunk_rows: int = 3):
        self.n = n
        self.w = w
        self.dir = Path("/simcluster")
        self.tracer = Tracer()
        self.fs = SimFS(self.tracer, fsync_is_noop=fsync_is_noop)
        self.hub = SimMailboxHub(self.tracer, chunk_rows=chunk_rows)
        self.statuses = [SimStatus(self.tracer, r) for r in range(n)]
        self.engines: dict[int, MiniEngine] = {}
        self.rebalancers: dict[int, rb.EngineRebalancer] = {}
        self.sup: SimSupervisor | None = None
        self.dead: set[str] = set()
        #: ranks that are PERMANENTLY dead (adoption scenario): never
        #: respawned, excluded from the supervisor's ack wait
        self.failed_ranks: set[int] = set()
        #: scenario scratch carried across power recovery (expected
        #: rows, accumulated violations, convergence flag, ...)
        self.meta: dict = {"violations": []}
        #: layout generations whose save RETURNED (observed at act
        #: boundaries — conservative: a gen published inside a step
        #: that later crashed is not counted, which can only weaken,
        #: never falsify, the monotonicity invariant)
        self.published_gens: list[int] = []
        #: per-rank markers of checkpoint saves that RETURNED
        self.saved_markers: dict[int, list[int]] = {r: [] for r in
                                                    range(n)}
        self.handoff_ids: list[int] = []

    def installed(self):
        """Both protocol seams pointed at this world (and the noisy
        real abort/park announcements silenced — the checker prints
        schedules, not thousands of expected aborts)."""
        stack = contextlib.ExitStack()
        stack.enter_context(durable.use_fs(self.fs))
        stack.enter_context(rb.use_mailbox_cls(self.hub))
        stack.enter_context(contextlib.redirect_stderr(io.StringIO()))
        return stack

    def rank_alive(self, rank: int) -> bool:
        return f"rank{rank}" not in self.dead

    def act(self, actor: str, fn):
        """Run one actor's protocol step under its name.  Dead actors
        no-op (their process does not exist).  A party-mode crash
        kills exactly this actor; a power-mode crash propagates to the
        harness — the whole host is gone."""
        if actor in self.dead:
            return None
        prev = self.tracer.actor
        self.tracer.actor = actor
        try:
            return fn()
        except CrashNow:
            if self.tracer.crash_actor is None:
                raise
            self.dead.add(actor)
            return None
        finally:
            self.tracer.actor = prev

    def power_snapshot_meta(self) -> dict:
        """What survives a power crash INTO the recovered world's
        meta: the scenario expectations and trace bookkeeping (checker
        state, not host state) — plus the pre-crash hub's SPSC verdict,
        which the judge must still see after the hub itself is gone."""
        meta = {k: v for k, v in self.meta.items()
                if k != "violations"}
        meta["violations"] = []
        meta["pre_spsc"] = list(self.hub.second_consumer)
        return meta
