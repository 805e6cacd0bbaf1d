"""The open-loop load generator: the benchmark's frozen copy of
``flowsentryx_tpu_torch/engine/sources.py::PacedSource`` (numpy only,
importing nothing of the program), so a change to the program's copy
cannot move the schedule the benchmark offers its load on.
"""

from __future__ import annotations

import time

import numpy as np


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
    """

    def __init__(self, pool: np.ndarray, rate_pps: float, total: int):
        if rate_pps <= 0:
            raise ValueError("rate_pps must be positive")
        self.pool = pool
        self.rate = float(rate_pps)
        self.total = int(total)
        self.emitted = 0
        self.popped = 0
        self.t_start: float | None = None

    def _sched_rel_s(self, idx) -> np.ndarray:
        """Scheduled arrival offsets (s from stream start) of 0-based
        record indices: record k one inter-arrival after k - 1, rounded
        to the nanosecond."""
        idx = np.asarray(idx, np.int64)
        return np.round((idx + 1) * (1e9 / self.rate)).astype(np.int64) / 1e9

    def poll(self, max_records: int) -> np.ndarray:
        if self.t_start is None:
            self.t_start = time.perf_counter()
        due = int((time.perf_counter() - self.t_start) * self.rate)
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
