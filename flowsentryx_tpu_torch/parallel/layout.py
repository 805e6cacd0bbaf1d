"""The cluster tier of the partition rule: which engine owns a source.

Counterpart of the numpy half of ``flowsentryx_tpu/parallel/layout.py``
(``cluster_rank_of``, ``ClusterLayout``).  The daemon fans records over
``n_engines * workers_per_engine`` ring shards by
:func:`~flowsentryx_tpu_torch.core.wire.shard_of`, and engine ``r``
drains the contiguous span ``[r*w, (r+1)*w)`` end to end, so a source's
flow state lives on exactly one engine.  numpy only.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from flowsentryx_tpu_torch.core.wire import shard_of


def cluster_rank_of(saddr, n_engines: int,
                    workers_per_engine: int = 1) -> np.ndarray:
    """Owner engine of each folded source address:
    ``shard_of(saddr, n*w) // w``."""
    return (shard_of(saddr, n_engines * workers_per_engine)
            // np.uint32(workers_per_engine)).astype(np.int64)


@dataclasses.dataclass(frozen=True)
class ClusterLayout:
    """One engine's slice of the cluster partition, as one comparable
    value."""

    rank: int
    n_engines: int
    workers_per_engine: int = 1

    def __post_init__(self) -> None:
        if self.n_engines < 2:
            raise ValueError(
                f"a cluster layout needs >= 2 engines, got "
                f"{self.n_engines} (one engine is fsx serve)")
        if not 0 <= self.rank < self.n_engines:
            raise ValueError(
                f"cluster rank {self.rank} not in [0, {self.n_engines})")
        if self.workers_per_engine < 1:
            raise ValueError(
                f"workers_per_engine must be >= 1, got "
                f"{self.workers_per_engine}")

    @property
    def total_shards(self) -> int:
        """Ring shards the daemon fans over (``fsxd --shards``)."""
        return self.n_engines * self.workers_per_engine

    @property
    def shard_span(self) -> range:
        """The global ring-shard indices this engine drains."""
        lo = self.rank * self.workers_per_engine
        return range(lo, lo + self.workers_per_engine)

    def owns(self, saddr) -> np.ndarray:
        """Which of these sources this engine owns."""
        return (cluster_rank_of(saddr, self.n_engines,
                                self.workers_per_engine) == self.rank)
