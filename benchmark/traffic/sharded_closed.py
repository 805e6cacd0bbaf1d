"""Closed loop over sharded feature rings: the line-rate deployment as
operators run it (``fsxd --shards N`` feeding ``serve --ingest-workers
N``).

A producer process stands in for the daemon: it routes the pool's
records to N ring files by the daemon's shard hash, stamps each with the
generator's clock continued past the pool's end (record ``g`` of the
stream arrives at ``t0 + g * dt``), and keeps every ring full, waiting
while a ring is full.  The engine serves through the program's
:class:`~flowsentryx_tpu_torch.ingest.ShardedIngest` (N drain workers),
seen through a wrapper that only records which sealed batch (worker,
sequence number, records) it handed over, in order: that is the
dispatch order, and with it the reference rebuilds every batch.

The producer counts, in memory the harness reads, whether the loop stays
closed: each refill notes how many records the ring still held (none, or
fewer than a batch, means a worker could have waited on the producer),
and each pass that found every ring full ends in a sleep.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import time

import numpy as np

from benchmark.traffic.pool import make_pool
from benchmark.traffic.records import RingWriter, shard_of, shard_ring_path

#: Seconds the producer may take to fill every ring before set-up fails.
READY_TIMEOUT_S = 120.0
#: Seconds the workers may take to drain their rings at the end.
STOP_TIMEOUT_S = 30.0
#: The producer's sleep while every ring is full (the daemon's 200 µs).
IDLE_S = 200e-6
#: The producer's counters, from its first pass with every ring full:
#: passes over the rings, passes that found them all full (each ends in
#: a sleep), refills, refills of a ring found empty, refills of a ring
#: holding less than a batch, the records the refilled rings held (a
#: sum), and the nanoseconds spent writing.
COUNTERS = ("passes", "full_sleeps", "refills", "refills_empty",
            "refills_under_batch", "held_at_refill", "write_ns")


def _split(pool: np.ndarray, shards: int) -> list[np.ndarray]:
    """Pool indices of each shard, in pool order."""
    sh = shard_of(pool["saddr"], shards)
    return [np.flatnonzero(sh == w) for w in range(shards)]


def producer_main(spec: dict, ready, stop, counts) -> None:
    """The producer process: build the pool from the seed (the same
    bytes as the harness builds), create the rings, fill them, keep them
    full until ``stop`` is set, counting into ``counts`` (one slot per
    name of :data:`COUNTERS`) once they were first full."""
    pool = make_pool(spec["traffic"], spec["seed"], spec["pool_records"])
    shards = spec["shards"]
    idx = _split(pool, shards)
    subs = [pool[i] for i in idx]
    n_pool = len(pool)
    t0 = int(pool["ts_ns"][0])
    dt = int(pool["ts_ns"][1]) - t0
    rings = [RingWriter(shard_ring_path(spec["ring_base"], w, shards),
                        spec["ring_records"]) for w in range(shards)]
    cursor = [0] * shards
    # refill a ring once a sixteenth of it is free
    cap = spec["ring_records"]
    chunk = cap // 16
    batch = spec["max_batch"]
    c = {name: i for i, name in enumerate(COUNTERS)}

    def write(w: int, n: int) -> None:
        c = cursor[w]
        length = len(idx[w])
        for view in rings[w].reserve(n):
            done = 0
            while done < len(view):
                pos = (c + done) % length
                m = min(len(view) - done, length - pos)
                part = view[done:done + m]
                part[:] = subs[w][pos:pos + m]
                g = ((c + done) // length) * n_pool + idx[w][pos:pos + m]
                part["ts_ns"] = (t0 + g * dt).astype(np.uint64)
                done += m
            c += len(view)
        rings[w].publish(n)
        cursor[w] = c

    try:
        signalled = False
        while not stop.is_set():
            wrote = False
            for w in range(shards):
                free = rings[w].free()
                if free >= chunk or (free and not signalled):
                    if signalled:
                        held = cap - free
                        counts[c["refills"]] += 1
                        counts[c["refills_empty"]] += held == 0
                        counts[c["refills_under_batch"]] += held < batch
                        counts[c["held_at_refill"]] += held
                        t = time.perf_counter_ns()
                    write(w, min(free, chunk))
                    if signalled:
                        counts[c["write_ns"]] += time.perf_counter_ns() - t
                    wrote = True
            if signalled:
                counts[c["passes"]] += 1
            if not wrote:
                if not signalled:
                    ready.set()
                    signalled = True
                else:
                    counts[c["full_sleeps"]] += 1
                time.sleep(IDLE_S)
    finally:
        for r in rings:
            r.close()


class Mode:
    """One cell of this mode: set-up, the window, the batches served."""

    def __init__(self, run):
        self.run = run
        p = run.workload["params"]
        self.shards = int(p["workers"])
        if len(os.sched_getaffinity(0)) < int(p.get("min_cores", 1)):
            raise RuntimeError(
                f"the cell needs {p['min_cores']} cores, "
                f"{len(os.sched_getaffinity(0))} are usable")
        self.pool_records = int(p["pool_records"])
        self.ring_records = int(p["ring_records"])
        self.mega_n = p.get("mega_n", 0)
        self.order: list[tuple[int, int, int]] = []
        self.phases: dict[str, float] = {}
        self._open = self._close = None
        self.verdicted = 0
        self.engine = self.ingest = self.proc = None

    def setup(self) -> None:
        run = self.run
        t = time.perf_counter()
        from flowsentryx_tpu_torch.engine import Engine
        from flowsentryx_tpu_torch.ingest import ShardedIngest

        self.phases["import_engine_s"] = time.perf_counter() - t

        order = self.order

        class RecordingIngest(ShardedIngest):
            """The program's fleet; notes each sealed batch it hands
            over (worker, sequence number, records), in order."""

            def poll_batches_into(self, dst, max_batches, pop_timer=None,
                                  stage_timer=None):
                out = super().poll_batches_into(dst, max_batches, pop_timer,
                                                stage_timer)
                order.extend((b.worker, b.seq, b.n_records) for b in out)
                return out

        base = os.path.join(run.tmp, "feat")
        ctx = mp.get_context("spawn")
        self.ready, self.stop = ctx.Event(), ctx.Event()
        self.counts = ctx.Array("q", len(COUNTERS), lock=False)
        t = time.perf_counter()
        self.proc = ctx.Process(target=producer_main, name="bench-producer",
                                args=({"traffic": run.config["traffic"],
                                       "seed": run.seed,
                                       "pool_records": self.pool_records,
                                       "shards": self.shards,
                                       "ring_base": base,
                                       "ring_records": self.ring_records,
                                       "max_batch": run.fsx.batch.max_batch},
                                      self.ready, self.stop, self.counts),
                                daemon=True)
        self.proc.start()
        # the stream's epoch: the pool's first record (the generator's
        # clock starts at 1 s), fixed, so every worker seals against it
        self.t0_ns = 1_000_000_000
        if not self.ready.wait(READY_TIMEOUT_S):
            raise RuntimeError("the producer did not fill its rings")
        self.phases["producer_ready_s"] = time.perf_counter() - t
        t = time.perf_counter()
        self.ingest = RecordingIngest(base, self.shards, precompact=False)
        self.engine = Engine(run.fsx, self.ingest, run.sink,
                             params=run.params, device=run.device,
                             mega_n=self.mega_n, t0_ns=self.t0_ns,
                             compile_cache=run.compile_cache)
        self.ingest.set_t0(self.t0_ns)
        self.phases["engine_s"] = time.perf_counter() - t
        t = time.perf_counter()
        self.engine.warm()
        self.phases["warm_s"] = time.perf_counter() - t
        t = time.perf_counter()
        self.ingest.wait_ready()
        self.phases["workers_ready_s"] = time.perf_counter() - t

        def reaped(n, t):
            self.verdicted += n
        self.engine.on_reap = reaped

    def serve(self, seconds: float, last: bool):
        if self._open is None:
            self._open = list(self.counts)
        try:
            return self.engine.run(max_seconds=seconds)
        finally:
            self._close = list(self.counts)

    def mark(self) -> int:
        """Batches dispatched so far."""
        return len(self.order)

    def finish(self) -> None:
        """Stop the producer, then let the workers drain their rings into
        queues this side empties (discarding what was never served), and
        join them."""
        if self.proc is not None:
            self.stop.set()
            self.proc.join(30)
            if self.proc.is_alive():
                self.proc.terminate()
                self.proc.join(5)
        if self.ingest is not None and self.ingest.started:
            self.ingest.request_stop()
            deadline = time.monotonic() + STOP_TIMEOUT_S
            while (not self.ingest.exhausted()
                   and time.monotonic() < deadline):
                if not self.ingest.poll_batches(64):
                    time.sleep(1e-3)
            self.ingest.close()

    @property
    def attempted(self) -> int:
        return sum(n for _, _, n in self.order)

    def summary(self) -> dict:
        """How many sealed batches each worker handed over, and the
        producer's counters over the window (:data:`COUNTERS`)."""
        per = [0] * self.shards
        for w, _, _ in self.order:
            per[w] += 1
        out = {"batches_per_worker": per}
        ing = self.run.reports[0].ingest if self.run.reports else None
        if ing:
            # seal -> the engine's dequeue: a sealed batch that waits
            # here waited on the engine, not on its worker
            out["fill_ms_p50"] = [w["fill_ms"].get("p50")
                                  for w in ing["workers"].values()]
            out["queue_ms_p50"] = [w["queue_ms"].get("p50")
                                   for w in ing["workers"].values()]
        if self._open is not None:
            out["producer"] = {name: b - a for name, a, b in
                               zip(COUNTERS, self._open, self._close)}
        return out

    def reference_pool(self) -> np.ndarray:
        return make_pool(self.run.config["traffic"], self.run.seed,
                         self.pool_records)

    def lost(self) -> int:
        """Records of sealed batches that never reached the engine (a gap
        in a worker's sequence, a batch a worker dropped or the engine
        refused), each counted as a full batch."""
        st = self.engine.source.ingest_stats()
        gaps = sum(w["seq_missing"] for w in st["workers"].values())
        batches = (gaps + st["dropped_emit_batches"]
                   + st["quarantined_batches"] + st["bad_wire_slots"])
        return batches * self.run.fsx.batch.max_batch

    def batches(self, pool: np.ndarray, device):
        """``(t0, batch sizes, iterator of (pool indices, ns
        timestamps))`` of every dispatched batch, in dispatch order,
        rebuilt from the pool."""
        import torch

        d = torch.device(device)
        idx = [torch.from_numpy(i).to(d) for i in _split(pool, self.shards)]
        n_pool = len(pool)
        t0 = int(pool["ts_ns"][0])
        dt = int(pool["ts_ns"][1]) - t0
        cursor = [0] * self.shards
        expect = [1] * self.shards
        for w, seq, n in self.order:
            if seq != expect[w]:
                raise RuntimeError(f"worker {w} handed over batch {seq}, "
                                   f"expected {expect[w]}")
            expect[w] += 1

        def gen():
            for w, _, n in self.order:
                pos = cursor[w] + torch.arange(n, device=d)
                cursor[w] += n
                length = len(idx[w])
                p = idx[w][pos % length]
                ts = t0 + (torch.div(pos, length, rounding_mode="floor")
                           * n_pool + p) * dt
                yield p, ts
        return self.t0_ns, [n for _, _, n in self.order], gen()
