"""Record sources: where the engine's packets come from.

Counterpart of ``flowsentryx_tpu/engine/sources.py`` (the in-process
producers ``TrafficSource`` and ``ArraySource``; the daemon's feature
ring is :class:`~flowsentryx_tpu_torch.engine.shm.ShmRingSource`, the
sealed-batch ingest fleet
:class:`~flowsentryx_tpu_torch.ingest.ShardedIngest`).
"""

from __future__ import annotations

from typing import Protocol

import numpy as np

from flowsentryx_tpu_torch.engine.traffic import TrafficGen, TrafficSpec


class RecordSource(Protocol):
    def poll(self, max_records: int) -> np.ndarray: ...

    def exhausted(self) -> bool: ...


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

