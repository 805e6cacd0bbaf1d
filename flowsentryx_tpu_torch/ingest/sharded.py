"""Engine-side half of the sharded ingest subsystem.

Counterpart of ``flowsentryx_tpu/ingest/sharded.py``.
:class:`ShardedIngest` is a *sealed-batch* source: instead of the
``RecordSource.poll`` record protocol it hands the engine finished
``[B+1, words]`` wire buffers dequeued from N per-worker SPSC queues
(:class:`~flowsentryx_tpu_torch.engine.shm.SealedBatchQueue`).  The
engine's loop shrinks to dequeue -> stage -> dispatch -> reap; the
per-record work (ring drain, decode, quantize, batch assembly) runs in
the worker processes, in parallel, on cores the dispatch loop never
blocks.

* **lifecycle** — spawn one :func:`~.worker.worker_main` process per
  shard (``spawn`` context, never fork: a forked child of a CUDA process
  cannot use the card), watch heartbeats, detect crashes, drain on stop.
* **t0 handshake** — collect each shard's first-record timestamp and
  publish the minimum as the shared epoch (grace-bounded, so an idle
  shard cannot stall the fleet), or impose an external one
  (:meth:`ShardedIngest.set_t0`).
* **ordering** — batches dequeue round-robin across workers; within a
  worker they are FIFO with a sequence number, so a gap is counted
  (:class:`SeqTracker`).  The IP-hash fan-out (``wire.shard_of``) keeps
  every flow on one worker.
* **slot validation** — every dequeued slot's header and metadata row
  are checked against the wire contracts; a bad slot is counted and
  skipped, a poisoned one quarantined (optionally spooled to disk).
* **fail-open** — by default a dead worker's queue drains to empty and
  the other shards keep serving; ``strict=True`` raises
  :class:`WorkerCrash` on the dispatch side instead, once the dead
  worker's queue is drained.

numpy only, like the workers: no torch.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import platform
import sys
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np

from flowsentryx_tpu_torch.core import wire as schema
from flowsentryx_tpu_torch.engine.metrics import WorkerIngestMetrics
from flowsentryx_tpu_torch.engine.shm import SealedBatchQueue
from flowsentryx_tpu_torch.sync.channel import WorkerCrash

#: Cap on spooled quarantine payloads (and on per-event stderr lines)
#: per fleet: slot contents are adversarial, so a poisoned stream must
#: not exhaust the disk or flood stderr.  Past the cap the counters keep
#: counting; the dumps and prints stop.
QUARANTINE_SPOOL_CAP = 32

#: Worker busy-spin budget after its ring goes empty, µs (the default
#: of ``spin_us=None`` where the host has cores for it: ``n_cpus >=
#: n_workers + 2``), and its sleep per empty poll after that (the
#: daemon's 200 µs, the default ``idle_us``).
SPIN_US_DEFAULT = 150
IDLE_US = 200

#: Default ``timeout_s``: how long the engine and a worker wait for a
#: ring or queue to appear.
TIMEOUT_S = 10.0
#: Default ``heartbeat_timeout_s``: a live worker whose heartbeat is
#: older than this is reported stalled.
HEARTBEAT_TIMEOUT_S = 2.0


class SealedBatch(NamedTuple):
    """One dequeued wire buffer plus its cross-process header fields."""

    raw: np.ndarray       # [B+1, words] u32 (private copy, dispatch-safe)
    n_records: int
    t_enqueue: float      # first-record arrival, perf_counter domain
    t_seal: float         # worker seal time, perf_counter domain
    worker: int
    seq: int


class SeqTracker:
    """Per-worker batch sequence bookkeeping (pure, unit-testable).

    Sequences are 1-based and strictly consecutive per worker; any jump
    counts the *missing* batches, a step backwards counts one gap event
    (a torn restart re-emitting old numbers must not hide behind a
    negative delta)."""

    def __init__(self, n_workers: int):
        self.next_seq = [1] * n_workers
        self.gaps = [0] * n_workers
        self.missing = [0] * n_workers

    def note(self, worker: int, seq: int) -> bool:
        """Record one observed sequence number; True when in order."""
        expected = self.next_seq[worker]
        ok = seq == expected
        if not ok:
            self.gaps[worker] += 1
            if seq > expected:
                self.missing[worker] += seq - expected
        self.next_seq[worker] = seq + 1
        return ok


class ShardedIngest:
    """N drain workers feeding the engine over sealed-batch queues.

    Construction only records geometry (and probes the shard-0 ring
    header for the compact-emit flag); the workers spawn in
    :meth:`start`, which the Engine calls once it has fixed the wire
    format and quantizer — those are the engine's decisions and the
    workers must seal with exactly the same ones or N=0 and N>0 would
    diverge.
    """

    #: Engine-facing capability marker (see Engine.__init__).
    provides_sealed = True

    def __init__(
        self,
        ring_base: str | Path,
        n_workers: int,
        *,
        queue_slots: int = 8,
        timeout_s: float = TIMEOUT_S,
        heartbeat_timeout_s: float = HEARTBEAT_TIMEOUT_S,
        t0_grace_s: float = 0.5,
        precompact: bool | None = None,
        spin_us: int | None = None,
        idle_us: int = IDLE_US,
        strict: bool = False,
        shard_offset: int = 0,
        total_shards: int | None = None,
        quarantine_dir: str | Path | None = None,
    ):
        if n_workers < 1:
            raise ValueError("n_workers must be >= 1")
        # a cluster rank (fsx cluster) fronts its contiguous span
        # [shard_offset, shard_offset + n_workers) of the daemon's
        # total_shards-ring fan-out; the defaults are the whole fan-out
        if total_shards is None:
            total_shards = n_workers
        if shard_offset < 0 or shard_offset + n_workers > total_shards:
            raise ValueError(
                f"shard span [{shard_offset}, {shard_offset + n_workers})"
                f" does not fit the {total_shards}-shard fan-out")
        self.shard_offset = int(shard_offset)
        self.total_shards = int(total_shards)
        if spin_us is None:
            # AUTO: a spinning worker needs a core to burn; with fewer
            # cores than workers + engine + one spare the spin only
            # steals cycles from the dispatch it is trying to feed
            n_cpus = len(os.sched_getaffinity(0))
            spin_us = SPIN_US_DEFAULT if n_cpus >= n_workers + 2 else 0
        if spin_us < 0 or idle_us < 0:
            raise ValueError("spin_us/idle_us must be >= 0")
        if platform.system() != "Linux":
            # seal/e2e accounting assumes perf_counter == CLOCK_MONOTONIC
            raise RuntimeError("ShardedIngest requires Linux")
        self.ring_base = str(ring_base)
        self.n_workers = n_workers
        self.queue_slots = queue_slots
        #: The worker's idle policy (``worker._Backoff``), written into
        #: each queue's ctl block before the worker spawns.
        self.spin_us = int(spin_us)
        self.idle_us = int(idle_us)
        self.timeout_s = timeout_s
        self.heartbeat_timeout_s = heartbeat_timeout_s
        self.t0_grace_s = t0_grace_s
        #: Crash posture.  False — the reference's documented default —
        #: is per-shard fail-open: a dead worker's queue drains to
        #: empty, the remaining shards keep serving, the death is
        #: surfaced in ``ingest_stats()``.  True raises
        #: :class:`WorkerCrash` on the dispatch side once the dead
        #: worker's queue is drained, so no sealed batch is lost
        #: (``serve --strict-ingest``).
        self.strict = bool(strict)
        self._crash: WorkerCrash | None = None
        self.ring_paths = [
            schema.shard_ring_path(self.ring_base, self.shard_offset + k,
                                   self.total_shards)
            for k in range(n_workers)
        ]
        # ``precompact=None`` probes the shard-0 ring header (blocks
        # until the daemon publishes it — the serve path, where the
        # daemon always precedes the engine).  An explicit value skips
        # the probe so a harness can spawn the fleet BEFORE its
        # producer exists and measure from a ready state.
        self.precompact = (
            self._probe_record_size(self.ring_paths[0], timeout_s)
            == schema.COMPACT_RECORD_SIZE
        ) if precompact is None else bool(precompact)
        self._queues: list[SealedBatchQueue] = []
        self._procs: list[mp.process.BaseProcess] = []
        self._seqs: SeqTracker | None = None
        self._dead: set[int] = set()
        self._stalled: set[int] = set()
        self._t0: int | None = None
        self._t0_first_seen: float | None = None
        self._rr = 0
        self._batches = [0] * n_workers
        self._records = [0] * n_workers
        self._dropped_tail = 0
        self._metrics = [WorkerIngestMetrics(k) for k in range(n_workers)]
        #: Slot validation.  Every dequeued slot's header and metadata
        #: row are checked against the contracts the step assumes (the
        #: metadata-row ranges, ``wire.RANGE_*``, and the wire id the
        #: engine fixed at start()).  A violating slot is counted and
        #: skipped, never dispatched and never a crash: ``_bad_slots``
        #: counts corrupt headers (wrong wire id — the per-slot magic —
        #: or a header/meta record-count tear), ``_quarantined`` counts
        #: poisoned-but-well-formed batches (out-of-range metadata),
        #: optionally dumped to ``quarantine_dir``; the records lost
        #: land in ingest_stats().
        self.quarantine_dir = (str(quarantine_dir)
                               if quarantine_dir is not None else None)
        self._bad_slots = [0] * n_workers
        self._quarantined = [0] * n_workers
        self._quarantined_records = 0
        self._quarantine_dumps = 0
        self._wire_id: int | None = None
        self._meta_ts_hi_max = 0
        self._started = False
        self._stopped = False

    @staticmethod
    def _probe_record_size(path: str, timeout_s: float) -> int:
        """Record size off a ring header without consuming anything
        (the engine needs the compact-emit flag before it can choose a
        wire, i.e. before workers exist)."""
        import mmap

        deadline = time.monotonic() + timeout_s
        p = Path(path)
        while True:
            if p.exists() and p.stat().st_size >= schema.SHM_HDR_SIZE:
                with open(p, "rb") as f:
                    mm = mmap.mmap(f.fileno(), schema.SHM_HDR_SIZE,
                                   prot=mmap.PROT_READ)
                hdr = np.frombuffer(mm, np.uint64, 3, 0)
                magic, rec = int(hdr[0]), int(hdr[2])
                del hdr
                mm.close()
                if magic == schema.SHM_MAGIC:
                    return rec
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"feature ring shard {path} did not appear (is the "
                    "daemon running with a matching --shards count?)"
                )
            time.sleep(0.01)

    # -- lifecycle ----------------------------------------------------------

    def start(self, batch_cfg, wire: str, quant: dict | None) -> None:
        """Spawn the worker fleet (Engine calls this; idempotence is a
        bug — two engines must not share one ingest)."""
        if self._started:
            raise RuntimeError("ShardedIngest already started")
        self._started = True
        self.wire = wire
        words = (schema.COMPACT_RECORD_WORDS
                 if wire == schema.WIRE_COMPACT16 else schema.RECORD_WORDS)
        payload_words = (batch_cfg.max_batch + 1) * words
        self._payload_shape = (batch_cfg.max_batch + 1, words)
        self._max_batch = batch_cfg.max_batch
        # per-slot "magic": the worker stamps the wire id it sealed
        # with; anything else in that header word is a corrupt slot
        self._wire_id = schema.wire_id_of(wire)
        # metadata-row timestamp HI-word ceiling: compact16 meta carries
        # base_rel_us (µs since t0), raw48 carries t0_ns; both HI words
        # are bounded by the declared deployment horizon
        horizon = schema.RANGE_DEPLOY_HORIZON_S * (
            10 ** 6 if wire == schema.WIRE_COMPACT16 else 10 ** 9)
        self._meta_ts_hi_max = horizon >> 32
        # never fork: a forked child of a process that touched CUDA
        # cannot use the card (and the workers never need it)
        ctx = mp.get_context("spawn")
        from flowsentryx_tpu_torch.ingest.worker import worker_main

        self._seqs = SeqTracker(self.n_workers)
        for k in range(self.n_workers):
            qpath = f"{self.ring_paths[k]}.batchq"
            q = SealedBatchQueue.create(qpath, self.queue_slots,
                                        payload_words)
            # idle-backoff params ride the ctl block, set before the
            # worker process exists (read-only to it thereafter)
            q.ctl_set("spin_us", self.spin_us)
            q.ctl_set("idle_us", self.idle_us)
            self._queues.append(q)
            spec = {
                "shard": k,
                "ring_path": self.ring_paths[k],
                "queue_path": qpath,
                "max_batch": batch_cfg.max_batch,
                "deadline_us": batch_cfg.deadline_us,
                "wire": wire,
                "quant": dict(quant) if quant else None,
                "timeout_s": self.timeout_s,
            }
            p = ctx.Process(
                target=worker_main, args=(spec,),
                name=f"fsx-ingest-{k}", daemon=True,
            )
            p.start()
            self._procs.append(p)

    @property
    def started(self) -> bool:
        return self._started

    def wait_ready(self, timeout_s: float = 30.0) -> None:
        """Block until every worker has booted (first heartbeat
        published; spawn cost — interpreter + numpy import — is paid).
        Optional: the engine's poll loop tolerates a booting fleet, but
        a measurement harness wants boot excluded from its window."""
        deadline = time.monotonic() + timeout_s
        for k, q in enumerate(self._queues):
            while q.ctl_get("hbeat") == 0:
                if not self._procs[k].is_alive():
                    raise RuntimeError(f"ingest worker {k} died during boot")
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"ingest worker {k} not ready in {timeout_s:.0f}s")
                time.sleep(0.01)

    @property
    def t0_ns(self) -> int | None:
        """The agreed stream epoch; None until the handshake resolves."""
        return self._t0

    def set_t0(self, t0_ns: int) -> None:
        """Impose an EXTERNAL epoch (an explicit ``t0_ns`` or a restored
        checkpoint's) on the fleet instead of the min-first_ts
        handshake.  Must run before the handshake resolves — i.e.
        before the first :meth:`poll_batches` observes traffic — or the
        workers would already be sealing against a different epoch than
        the engine/sink translate with; that inconsistency is
        unrecoverable for sealed batches, so it errors loudly."""
        if not self._started:
            raise RuntimeError("set_t0 before start()")
        t0_ns = int(t0_ns)
        if t0_ns <= 0:
            raise ValueError("t0_ns must be positive")
        if self._t0 is not None and self._t0 != t0_ns:
            raise RuntimeError(
                f"ingest epoch already resolved to {self._t0}; an "
                f"external t0 {t0_ns} must be imposed before the first "
                "poll_batches sees traffic"
            )
        self._t0 = t0_ns
        for q in self._queues:
            q.ctl_set("t0", self._t0)

    def _ensure_t0(self) -> bool:
        if self._t0 is not None:
            return True
        firsts = [q.ctl_get("first_ts") for q in self._queues]
        seen = [f for f in firsts if f > 0]
        if not seen:
            return False
        now = time.monotonic()
        if self._t0_first_seen is None:
            self._t0_first_seen = now
        live_unseen = sum(
            1 for k, f in enumerate(firsts)
            if f == 0 and k not in self._dead
        )
        if live_unseen and now - self._t0_first_seen < self.t0_grace_s:
            return False  # give idle shards a moment to report
        self._t0 = min(seen)
        for q in self._queues:
            q.ctl_set("t0", self._t0)
        return True

    def _check_health(self) -> None:
        now_ns = time.clock_gettime_ns(time.CLOCK_MONOTONIC)
        for k, (p, q) in enumerate(zip(self._procs, self._queues)):
            if k in self._dead:
                continue
            state = q.ctl_get("wstate")
            if not p.is_alive() and state not in (schema.WSTATE_DONE,):
                # Record the death; the default posture stays fail-open
                # — keep serving the other shards, and keep draining
                # this queue (sealed batches that made it out of the
                # worker are still good).  Strict mode raises this in
                # _surface_crash once the dead worker's queue drains.
                self._dead.add(k)
                if self._crash is None:
                    self._crash = WorkerCrash(
                        f"engine ingest worker {k} crashed: died "
                        f"without publishing DONE (wstate={state}, "
                        f"exitcode={p.exitcode}); its ring shard is "
                        "unserved — the kernel limiter stands alone "
                        "for those flows")
                continue
            hbeat = q.ctl_get("hbeat")
            if (p.is_alive() and hbeat
                    and now_ns - hbeat > self.heartbeat_timeout_s * 1e9):
                self._stalled.add(k)
            else:
                self._stalled.discard(k)

    def _surface_crash(self) -> None:
        """Strict-mode crash propagation: raise the recorded
        :class:`WorkerCrash` on the DISPATCH side, but only once every
        dead worker's queue is drained, so sealed batches that escaped
        the dead worker still serve."""
        if not self.strict or self._crash is None:
            return
        if all(self._queues[k].readable() == 0 for k in self._dead):
            raise self._crash

    def request_stop(self) -> None:
        """Ask every worker to drain its ring and exit (drain-on-
        shutdown).  The caller keeps consuming batches until
        :meth:`exhausted` so the tail of the stream is served, then
        calls :meth:`close`."""
        self._stopped = True
        for q in self._queues:
            q.ctl_set("stop", 1)

    def close(self, timeout_s: float = 5.0) -> None:
        """Stop + join the fleet; undelivered batches are dropped and
        counted (``ingest_stats()["dropped_tail_batches"]``)."""
        if not self._started:
            return
        self.request_stop()
        deadline = time.monotonic() + timeout_s
        for p in self._procs:
            p.join(timeout=max(0.0, deadline - time.monotonic()))
            if p.is_alive():
                p.terminate()
                p.join(timeout=1.0)
        for q in self._queues:
            self._dropped_tail += q.readable()

    # -- the sealed-batch source protocol -----------------------------------

    def _note_batch(self, wid: int, hdr: np.ndarray) -> tuple:
        """Header decode + per-worker bookkeeping shared by both
        dequeue paths: ``(seq, n_records, t_seal, fill_s)``."""
        seq = (int(hdr[schema.BATCHQ_SEQ_LO_WORD])
               | (int(hdr[schema.BATCHQ_SEQ_HI_WORD]) << 32))
        n = int(hdr[schema.BATCHQ_N_RECORDS_WORD])
        # the worker's shm-seal stamp (CLOCK_MONOTONIC ==
        # perf_counter on Linux): the latency plane's measurement
        # anchor for every record of this batch
        seal_ns = (int(hdr[schema.BATCHQ_SEAL_NS_LO_WORD])
                   | (int(hdr[schema.BATCHQ_SEAL_NS_HI_WORD]) << 32))
        fill_s = int(hdr[schema.BATCHQ_FILL_DUR_US_WORD]) * 1e-6
        t_seal = seal_ns * 1e-9
        self._seqs.note(wid, seq)
        self._batches[wid] += 1
        self._records[wid] += n
        m = self._metrics[wid]
        m.fill.add(fill_s)
        m.queue.add(max(0.0, time.perf_counter() - t_seal))
        return seq, n, t_seal, fill_s

    def _slot_problem(self, hdr: np.ndarray,
                      meta: np.ndarray) -> tuple[str, str] | None:
        """Validate one dequeued slot against the wire contracts
        (attribute docstring): ``("bad_slot"|"poison", reason)`` for a
        violating slot, None for a clean one.  "bad_slot" is header
        corruption — wrong wire id (the per-slot magic) or a
        header/metadata record-count tear; "poison" is a well-formed
        slot whose metadata violates the declared RANGE_* contracts
        the step assumes."""
        wire_id = int(hdr[schema.BATCHQ_WIRE_ID_WORD])
        if wire_id != self._wire_id:
            return ("bad_slot",
                    f"slot wire id {wire_id} != expected "
                    f"{self._wire_id} (bad slot magic)")
        n = int(hdr[schema.BATCHQ_N_RECORDS_WORD])
        if n > self._max_batch:
            return ("poison",
                    f"n_records {n} > max_batch {self._max_batch} "
                    "(encoder contract: n_valid <= max_batch)")
        if int(meta[0]) != n:
            return ("bad_slot",
                    f"header n_records {n} != metadata-row n "
                    f"{int(meta[0])} (torn slot)")
        if int(meta[2]) > self._meta_ts_hi_max:
            return ("poison",
                    f"metadata ts HI word {int(meta[2])} > "
                    f"{self._meta_ts_hi_max} (RANGE_DEPLOY_HORIZON_S "
                    "bound — the range proof's declared premise)")
        return None

    def _discard_slot(self, wid: int, hdr: np.ndarray,
                      payload: np.ndarray, kind: str,
                      reason: str) -> None:
        """Count + (for poison, up to the spool cap) spool one refused
        slot — skipped, never dispatched, never a crash, never silent
        (attribute docstring)."""
        seq = (int(hdr[schema.BATCHQ_SEQ_LO_WORD])
               | (int(hdr[schema.BATCHQ_SEQ_HI_WORD]) << 32))
        refusals = sum(self._bad_slots) + sum(self._quarantined)
        if kind == "bad_slot":
            # a corrupt header's seq is untrustworthy: not noted — the
            # next good slot's gap is the corruption signal
            self._bad_slots[wid] += 1
        else:
            # well-formed header: burn the seq so later gaps stay a
            # pure corruption signal, and account the records lost
            self._seqs.note(wid, seq)
            self._quarantined[wid] += 1
            self._quarantined_records += min(
                int(hdr[schema.BATCHQ_N_RECORDS_WORD]), self._max_batch)
            if (self.quarantine_dir is not None
                    and self._quarantine_dumps < QUARANTINE_SPOOL_CAP):
                os.makedirs(self.quarantine_dir, exist_ok=True)
                self._quarantine_dumps += 1
                dump = (Path(self.quarantine_dir)
                        / f"quarantine_w{self.shard_offset + wid}"
                          f"_seq{seq}_{self._quarantine_dumps}.npy")
                np.save(dump, np.asarray(payload).reshape(
                    self._payload_shape).copy())
                reason += f"; payload spooled to {dump}"
        # cap the refusal prints with the spool (QUARANTINE_SPOOL_CAP
        # docstring): a sustained poisoned stream must not flood
        # stderr — the counters stay the authoritative record
        if refusals < QUARANTINE_SPOOL_CAP:
            print(f"fsx ingest: worker {wid} slot REFUSED ({kind}, "
                  f"seq {seq}): {reason}", file=sys.stderr)
        elif refusals == QUARANTINE_SPOOL_CAP:
            print(f"fsx ingest: {refusals} slots refused — further "
                  "refusals counted but not printed/spooled "
                  "(ingest_stats / EngineReport.ingest carry the "
                  "totals)", file=sys.stderr)

    def poll_batches(self, max_batches: int) -> list[SealedBatch]:
        """Up to ``max_batches`` sealed batches, round-robin across the
        worker queues (fairness: a hot shard must not starve the rest).
        Copying dequeue (``consume_batch``); the engine's hot path is
        :meth:`poll_batches_into`, which stages straight into its
        dispatch arena instead."""
        if not self._started:
            raise RuntimeError("ShardedIngest.start() was never called")
        self._check_health()
        self._surface_crash()
        if not self._ensure_t0():
            return []
        out: list[SealedBatch] = []
        n_q = self.n_workers
        empty_streak = 0
        wid = self._rr
        while len(out) < max_batches and empty_streak < n_q:
            got = self._queues[wid].consume_batch()
            if got is None:
                empty_streak += 1
            else:
                empty_streak = 0
                hdr, payload = got
                rows = payload.reshape(self._payload_shape)
                prob = self._slot_problem(hdr, rows[self._max_batch])
                if prob is not None:
                    self._discard_slot(wid, hdr, payload, *prob)
                    wid = (wid + 1) % n_q
                    continue
                seq, n, t_seal, fill_s = self._note_batch(wid, hdr)
                out.append(SealedBatch(
                    raw=rows,
                    n_records=n,
                    t_enqueue=t_seal - fill_s,
                    t_seal=t_seal,
                    worker=wid,
                    seq=seq,
                ))
            wid = (wid + 1) % n_q
        self._rr = wid
        return out

    def poll_batches_into(self, dst: np.ndarray, max_batches: int,
                          pop_timer=None,
                          stage_timer=None) -> list[SealedBatch]:
        """Zero-copy-staging twin of :meth:`poll_batches`: peek the
        oldest sealed slot per queue (round-robin), copy the payload
        VIEW straight into the next row of ``dst`` — the dispatch
        pipeline's ONE host copy — and release the slot immediately, so
        the worker gets its queue slot back before the batch is even
        dispatched.  ``dst`` is a ``[k, max_batch+1, words]`` uint32 row
        array (a dispatch-arena slice); each returned
        :class:`SealedBatch`'s ``raw`` is the ``dst`` row it was staged
        into, NOT shm memory — a producer overwrite of the released slot
        can never reach it.

        ``pop_timer``/``stage_timer`` are optional
        :class:`~flowsentryx_tpu_torch.engine.metrics.StageTimer` hooks:
        the per-batch staging copy goes to ``stage``, the rest of a
        non-empty call (peek, header decode, bookkeeping) to ``pop``."""
        if not self._started:
            raise RuntimeError("ShardedIngest.start() was never called")
        self._check_health()
        self._surface_crash()
        if not self._ensure_t0():
            return []
        t_call = time.perf_counter()
        stage_s = 0.0
        out: list[SealedBatch] = []
        room = min(max_batches, len(dst))
        n_q = self.n_workers
        empty_streak = 0
        wid = self._rr
        while len(out) < room and empty_streak < n_q:
            q = self._queues[wid]
            peeked = q.peek_batches(1)
            if not peeked:
                empty_streak += 1
            else:
                empty_streak = 0
                hdr, payload = peeked[0]
                row = dst[len(out)]
                t_copy = time.perf_counter()
                row.reshape(-1)[:] = payload     # THE one host copy
                stage_s += time.perf_counter() - t_copy
                q.release(1)                     # slot back to the worker
                prob = self._slot_problem(
                    hdr, row.reshape(self._payload_shape)[self._max_batch])
                if prob is not None:
                    # refused AFTER the arena memcpy (the staged copy is
                    # what gets validated and spooled — immune to the
                    # released slot's reuse); the dst row is simply
                    # re-staged by the next batch, so nothing downstream
                    # ever sees the refused bytes
                    self._discard_slot(wid, hdr, row, *prob)
                    wid = (wid + 1) % n_q
                    continue
                seq, n, t_seal, fill_s = self._note_batch(wid, hdr)
                out.append(SealedBatch(
                    raw=row,
                    n_records=n,
                    t_enqueue=t_seal - fill_s,
                    t_seal=t_seal,
                    worker=wid,
                    seq=seq,
                ))
            wid = (wid + 1) % n_q
        self._rr = wid
        if out:
            if stage_timer is not None:
                stage_timer.add(stage_s / len(out))
            if pop_timer is not None:
                pop_timer.add(
                    max(0.0, time.perf_counter() - t_call - stage_s))
        return out

    def exhausted(self) -> bool:
        """True only once every worker is gone (clean exit or crash)
        and every queue is drained — a live fleet is a live source."""
        if not self._started:
            return False
        for k, (p, q) in enumerate(zip(self._procs, self._queues)):
            done = (not p.is_alive()) or (
                q.ctl_get("wstate") == schema.WSTATE_DONE and self._stopped
            )
            if not done or q.readable():
                return False
        return True

    # -- reporting ----------------------------------------------------------

    def ingest_stats(self) -> dict:
        assert self._seqs is not None
        workers = {}
        for k in range(self.n_workers):
            workers[str(k)] = {
                "batches": self._batches[k],
                "records": self._records[k],
                "seq_gaps": self._seqs.gaps[k],
                "seq_missing": self._seqs.missing[k],
                "dropped_emit_batches": self._queues[k].ctl_get("emit_drop"),
                "bad_wire_slots": self._bad_slots[k],
                "quarantined_batches": self._quarantined[k],
                "dead": k in self._dead,
                "stalled": k in self._stalled,
                **self._metrics[k].to_dict(),
            }
        return {
            "n_workers": self.n_workers,
            "t0_ns": self._t0,
            "strict": self.strict,
            "crashed": self._crash is not None,
            "dead_workers": sorted(self._dead),
            "dropped_tail_batches": self._dropped_tail,
            "dropped_emit_batches": sum(
                w["dropped_emit_batches"] for w in workers.values()),
            # slot validation: refused slots and the records they held
            "bad_wire_slots": sum(self._bad_slots),
            "quarantined_batches": sum(self._quarantined),
            "quarantined_records": self._quarantined_records,
            "quarantine_dir": self.quarantine_dir,
            "quarantine_dumps": self._quarantine_dumps,
            "workers": workers,
        }
