"""Drain-worker process: one shm ring shard -> sealed batches, forever.

Counterpart of ``flowsentryx_tpu/ingest/worker.py``.  Spawned by
:class:`~flowsentryx_tpu_torch.ingest.sharded.ShardedIngest` with the
``spawn`` context: a forked child of a process that has touched CUDA
cannot use the card, and a worker never needs to.  Its import closure —
this module, :mod:`..core.wire`, :mod:`..core.config`,
:mod:`..engine.batcher`, :mod:`..engine.shm` — is numpy only: no torch
(``tests/test_torch_ingest.py`` pins it), so a worker boots in a fraction
of a second and cannot initialise CUDA.

Lifecycle (``wire.WSTATE_*``, published through the queue's control
block):

1. **SPAWNING** — open the batch queue, wait for the ring shard.
2. t0 handshake — publish the first record's timestamp as ``FIRST_TS``,
   buffer drained records (bounded), wait for the engine to publish the
   agreed ``T0``: every worker seals against one epoch.
3. **RUNNING** — drain -> decode/quantize -> seal -> enqueue.  A full
   queue is backpressure: the worker retries, the ring fills, the
   daemon's drop counters account the loss.
4. ``STOP`` observed — drain the ring to empty, flush the partial batch,
   publish **DONE**, exit.  A crash publishes **FAILED** (best effort)
   and leaves its traceback on stderr.

Each sealed buffer is copied into the queue the moment it seals (the
batcher's ``on_seal``).  The reference collects a drain's sealed buffers
first and enqueues them after, with two batcher buffers: a drain of two
batches' worth onto a partly filled batch seals two buffers and starts
refilling the first before it is enqueued, so that batch's first rows
are overwritten (ROADMAP queue 3, item 14).  Enqueueing at seal makes
two buffers enough for any drain.
"""

from __future__ import annotations

import time
import traceback

import numpy as np

#: Records a worker buffers while waiting for the t0 handshake before
#: ring backpressure takes over (64k records, ~3 MB raw48).
PENDING_CAP = 1 << 16

#: Idle sleep between empty polls, the daemon's 200 µs; also the
#: spin-exhausted sleep when the queue creator left ``idle_us`` at 0.
IDLE_SLEEP_S = 200e-6

#: Bounded wait on a full queue once stop was requested: the consumer
#: may be gone, and shutdown must not hang.  A give-up un-burns the
#: batch's seq and counts it in the queue's ``emit_drop``.
EMIT_STOP_TIMEOUT_S = 2.0


class _Backoff:
    """Bounded spin-then-sleep idle policy for the drain loop: keep
    polling for ``spin_us`` after the last productive poll, then sleep
    ``idle_us`` per miss (both from the queue's ctl block)."""

    def __init__(self, spin_us: int, idle_us: int):
        self.spin_s = spin_us / 1e6
        self.idle_s = idle_us / 1e6
        self._idle_since: float | None = None

    def reset(self) -> None:
        self._idle_since = None

    def idle(self) -> bool:
        """An empty poll: spin (False) while the budget lasts, then
        sleep (True)."""
        now = time.perf_counter()
        if self._idle_since is None:
            self._idle_since = now
        if now - self._idle_since < self.spin_s:
            return False
        time.sleep(self.idle_s)
        return True


def _monotonic_ns() -> int:
    return time.clock_gettime_ns(time.CLOCK_MONOTONIC)


class _Emitter:
    """Seal-side bookkeeping: batch header fields + queue backpressure."""

    def __init__(self, queue, batcher, wire_id: int, max_batch: int):
        self.q = queue
        self.batcher = batcher
        self.wire_id = wire_id
        self.max_batch = max_batch
        self.seq = 0
        self.stopping = False

    def emit(self, buf: np.ndarray) -> None:
        n = int(buf[self.max_batch, 0])
        first_add_t = self.batcher.pop_seal_time()
        seal_ns = _monotonic_ns()
        fill_dur_us = max(0, int(seal_ns / 1e3 - first_add_t * 1e6))
        self.seq += 1
        deadline = (time.monotonic() + EMIT_STOP_TIMEOUT_S
                    if self.stopping else None)
        while not self.q.produce_batch(
                buf, seq=self.seq, n_records=n, wire_id=self.wire_id,
                seal_ns=seal_ns, fill_dur_us=fill_dur_us):
            if deadline is not None and time.monotonic() > deadline:
                # never entered the stream: un-burn the seq (a gap stays
                # a corruption signal) and count the loss
                self.seq -= 1
                self.q.ctl_set("emit_drop", self.q.ctl_get("emit_drop") + 1)
                return
            self.q.ctl_set("hbeat", _monotonic_ns())
            time.sleep(IDLE_SLEEP_S)


def worker_main(spec: dict) -> None:
    """Entry point of one drain worker (module-level: picklable by the
    spawn context).  ``spec`` carries plain data only — paths, batch
    geometry, wire and quantizer kwargs."""
    from flowsentryx_tpu_torch.core import wire
    from flowsentryx_tpu_torch.core.config import BatchConfig
    from flowsentryx_tpu_torch.engine.batcher import MicroBatcher
    from flowsentryx_tpu_torch.engine.shm import (
        SealedBatchQueue, ShmRingSource,
    )

    q = SealedBatchQueue.wait_for(spec["queue_path"],
                                  timeout_s=spec.get("timeout_s", 10.0))
    q.ctl_set("wstate", wire.WSTATE_SPAWNING)
    try:
        quant = spec.get("quant") or {}
        if (spec["wire"] == wire.WIRE_COMPACT16
                and quant.get("feat_mode", "minifloat") == "minifloat"):
            # build the minifloat LUT while booting, not in the first seal
            wire.quantize_feat_minifloat(np.zeros(8, np.uint32))
        q.ctl_set("hbeat", _monotonic_ns())
        src = ShmRingSource(spec["ring_path"],
                            timeout_s=spec.get("timeout_s", 10.0))
        wire_name = spec["wire"]
        if src.precompact and wire_name != wire.WIRE_COMPACT16:
            raise ValueError(
                "compact-emit ring shard requires the compact16 wire")
        # verdict_k=0: the worker's config drives only the batcher
        cfg = BatchConfig(max_batch=spec["max_batch"],
                          deadline_us=spec["deadline_us"], verdict_k=0)
        poll_chunk = 2 * cfg.max_batch
        emitter = None
        pending: list[np.ndarray] = []
        pending_n = 0
        backoff = _Backoff(int(q.ctl_get("spin_us")),
                           int(q.ctl_get("idle_us"))
                           or int(IDLE_SLEEP_S * 1e6))
        q.ctl_set("wstate", wire.WSTATE_RUNNING)

        def add(batcher, records):
            if src.precompact:
                batcher.add_precompact(records, on_seal=emitter.emit)
            else:
                batcher.add(records, on_seal=emitter.emit)

        while True:
            q.ctl_set("hbeat", _monotonic_ns())
            stopping = bool(q.ctl_get("stop"))
            # zero-copy drain: pack straight out of the ring slots and
            # release them afterwards
            chunks, n_polled = src.ring.peek(poll_chunk)
            if n_polled and q.ctl_get("first_ts") == 0:
                head = chunks[0]
                if src.precompact:
                    ts0 = int(wire.unwrap_kernel_ts16(
                        head["w3"][:1], _monotonic_ns())[0])
                else:
                    ts0 = int(head["ts_ns"][0])
                q.ctl_set("first_ts", max(ts0, 1))  # 0 means "unseen"
            if emitter is None:
                t0 = q.ctl_get("t0")
                if t0 == 0:
                    if stopping:
                        # the epoch was never agreed: nothing is sealable
                        q.ctl_set("wstate", wire.WSTATE_DONE)
                        return
                    if n_polled and pending_n < PENDING_CAP:
                        # copy out (peek views die at advance); past the
                        # cap records stay in the ring, where a stalled
                        # handshake shows as the producer's drops
                        pending.extend(c.copy() for c in chunks)
                        pending_n += n_polled
                        src.ring.advance(n_polled)
                    else:
                        time.sleep(IDLE_SLEEP_S)
                    continue
                batcher = MicroBatcher(cfg, t0_ns=t0, n_buffers=2,
                                       wire=wire_name, quant=quant or None)
                emitter = _Emitter(q, batcher, wire.wire_id_of(wire_name),
                                   cfg.max_batch)
                emitter.stopping = stopping
                for r in pending:
                    add(batcher, r)
                pending = []
            batcher = emitter.batcher
            emitter.stopping = stopping
            if n_polled:
                for c in chunks:
                    add(batcher, c)
                # every record is packed and every sealed batch enqueued
                # (while an enqueue waits on backpressure, the drain's
                # ring slots stay held: at most 2 batches' worth)
                src.ring.advance(n_polled)
            flushed = False
            if not n_polled:
                if src.precompact:
                    batcher.note_poll()
                if batcher.flush_due():
                    emitter.emit(batcher.take())
                    flushed = True
            if stopping and not n_polled and src.ring.readable() == 0:
                # drain-on-shutdown: ring empty, flush the partial batch
                emitter.stopping = True
                tail = batcher.take()
                if tail is not None:
                    emitter.emit(tail)
                q.ctl_set("wstate", wire.WSTATE_DONE)
                return
            if n_polled or flushed:
                backoff.reset()
            else:
                backoff.idle()
    except Exception:
        try:
            q.ctl_set("wstate", wire.WSTATE_FAILED)
        except Exception:
            pass
        traceback.print_exc()
        raise
