"""Record sources: where the engine's packets come from.

Counterpart of ``flowsentryx_tpu/engine/sources.py``: the
:class:`RecordSource` protocol and its in-process producers
:class:`TrafficSource`, :class:`ArraySource` and the open-loop
:class:`PacedSource` (the latency measurement's).  The daemon's feature
ring is :class:`~flowsentryx_tpu_torch.engine.shm.ShmRingSource`, the
sealed-batch ingest fleet
:class:`~flowsentryx_tpu_torch.ingest.ShardedIngest`.
"""

from __future__ import annotations

import time
from typing import Protocol

import numpy as np

from flowsentryx_tpu_torch.engine.traffic import (
    TrafficGen, TrafficSpec, pulse_offsets_ns,
)


class RecordSource(Protocol):
    """A pull-based producer of ``FLOW_RECORD_DTYPE`` arrays."""

    def poll(self, max_records: int) -> np.ndarray:
        """Up to ``max_records`` new records; an empty array when none
        are ready.  Must not block longer than about a batch deadline."""
        ...

    def exhausted(self) -> bool:
        """True when no record will ever arrive again; a live source
        returns False forever."""
        ...


class TrafficSource:
    """Synthetic scenario traffic, optionally bounded to ``total`` packets."""

    def __init__(self, spec: TrafficSpec, total: int | None = None):
        self.gen = TrafficGen(spec)
        self.remaining = total

    def poll(self, max_records: int) -> np.ndarray:
        n = max_records
        if self.remaining is not None:
            n = min(n, self.remaining)
            self.remaining -= n
        if n <= 0:
            return np.empty(0, dtype=self.gen.next_records(0).dtype)
        return self.gen.next_records(n)

    def exhausted(self) -> bool:
        return self.remaining is not None and self.remaining <= 0


class ArraySource:
    """Replays a pre-built record array once, in ``poll``-sized slices.

    The generator's draws depend on the poll size, and a grouping engine
    polls group-sized chunks: feeding one pregenerated stream is how two
    engines with different dispatch policies see the same records."""

    def __init__(self, records: np.ndarray):
        self.records = records
        self.pos = 0

    def poll(self, max_records: int) -> np.ndarray:
        out = self.records[self.pos: self.pos + max_records]
        self.pos += len(out)
        return out

    def exhausted(self) -> bool:
        return self.pos >= len(self.records)


class PacedSource:
    """Open-loop load generator: replays ``pool`` records at a fixed
    offered rate against the wall clock, remembering each record's
    *scheduled* arrival time.

    The per-record latency measurement (the system's "<1 ms
    feature→verdict" target) needs an open-loop arrival process — a
    closed loop would slow the offered load down to whatever the
    pipeline sustains and hide queueing delay entirely.  ``poll()``
    releases exactly the records whose scheduled arrival has passed
    (vectorized; Python cannot pace 10 M individual emits/s), stamping
    ``ts_ns`` with the scheduled time so device-side windows see the
    offered spacing.  Scheduled arrival times are a pure function of
    record index (``t_start + (k+1)/rate`` — nothing is stored per
    record, so a long throughput replay costs O(1) memory); the engine
    reaps batches in record-FIFO order, so a reap callback can
    :meth:`pop_scheduled` one time per sunk record and compute
    arrival→verdict-sunk latency exactly (queueing included).

    ``burst_period_s`` > 0 makes the offered process a PULSE WAVE
    (same mean rate, each period's records compressed into its first
    ``duty_cycle`` fraction — the schedule is
    :func:`~flowsentryx_tpu_torch.engine.traffic.pulse_offsets_ns`, shared
    with the synthetic-clock generator): the adversarial arrival
    process the ``--slo-us`` serving mode is measured under, where a
    drain-tuned policy queues the burst head.
    """

    def __init__(self, pool: np.ndarray, rate_pps: float, total: int,
                 burst_period_s: float = 0.0, duty_cycle: float = 1.0):
        if rate_pps <= 0:
            raise ValueError("rate_pps must be positive")
        self.pool = pool
        self.rate = float(rate_pps)
        self.total = int(total)
        self.burst_period_s = float(burst_period_s)
        self.duty_cycle = float(duty_cycle)
        # validate eagerly (the shared schedule function owns the rules)
        pulse_offsets_ns(np.zeros(1, np.int64), self.rate,
                         self.burst_period_s, self.duty_cycle)
        self._pulse = burst_period_s > 0 and duty_cycle < 1.0
        self.emitted = 0
        self.popped = 0
        self.t_start: float | None = None

    def _sched_rel_s(self, idx) -> np.ndarray:
        """Scheduled arrival offsets (s from stream start) of 0-based
        record indices — one schedule for emission, ``ts_ns`` stamping
        and :meth:`pop_scheduled`, steady or pulsed."""
        return pulse_offsets_ns(idx, self.rate, self.burst_period_s,
                                self.duty_cycle) / 1e9

    def _due(self, elapsed_s: float) -> int:
        """How many records the schedule has released by ``elapsed_s``."""
        if not self._pulse:
            return int(elapsed_s * self.rate)
        # >= 1 by the eager pulse_offsets_ns validation at construction
        per = int(round(self.rate * self.burst_period_s))
        full, rem = divmod(elapsed_s, self.burst_period_s)
        on_s = self.burst_period_s * self.duty_cycle
        return int(full) * per + int(min(rem / on_s, 1.0) * per)

    def poll(self, max_records: int) -> np.ndarray:
        if self.t_start is None:
            self.t_start = time.perf_counter()
        due = self._due(time.perf_counter() - self.t_start)
        n = min(due - self.emitted, max_records, self.total - self.emitted)
        if n <= 0:
            return np.empty(0, dtype=self.pool.dtype)
        idx = (self.emitted + np.arange(n, dtype=np.int64)) % len(self.pool)
        recs = self.pool[idx]
        sched_rel = self._sched_rel_s(
            self.emitted + np.arange(n, dtype=np.int64))
        recs["ts_ns"] = np.round(sched_rel * 1e9).astype(np.uint64)
        self.emitted += n
        return recs

    def pop_scheduled(self, n: int) -> np.ndarray:
        """Scheduled arrival times (``time.perf_counter()`` domain) of
        the next ``n`` not-yet-popped records, in emission order."""
        if self.popped + n > self.emitted:
            raise ValueError(
                f"popping {n} with only {self.emitted - self.popped} emitted"
            )
        k = self.popped + np.arange(n, dtype=np.int64)
        self.popped += n
        return (self.t_start or 0.0) + self._sched_rel_s(k)

    def exhausted(self) -> bool:
        return self.emitted >= self.total
