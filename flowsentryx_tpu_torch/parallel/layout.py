"""Declarative placement: the partition-rule table, and the cluster
tier of the same rule.

Counterpart of ``flowsentryx_tpu/parallel/layout.py``, both halves:

* **The spec half.**  The reference declares once, as partition rules
  (a regex on a leaf's path name -> a ``PartitionSpec``), that the
  table's rows shard over the mesh's ``ip`` axis and everything else
  (stats, params, wire batches) is replicated, and derives every
  placement from that table: the sharded step's specs
  (:func:`table_specs`, :func:`stats_specs`), the engine's
  (:func:`replicated`) and the restore path's (:func:`shard_table`).
  On a process mesh (one process per shard) each rank holds only its
  own row range (:func:`rank_rows`), and :func:`gather_rows` puts the
  ranks' rows back in the one table's order.
  The rules are copied.  A mesh here is n shards on one device
  (:mod:`.mesh`), so a row-sharded table is the one contiguous table on
  that device, shard ``d`` owning rows ``[d*N/n, (d+1)*N/n)``: the
  shard-major order of the reference's global array, which is what its
  ``device_get`` yields and its checkpoints store.  A spec here says
  which leaves the step splits by row range (:mod:`.step`).
* **The cluster tier** (``cluster_rank_of``, ``ClusterLayout``, and the
  elastic fleet's ``assigned_rank_of``/``assigned_ring_of``).  The
  daemon fans records over ``n_engines * workers_per_engine`` ring
  shards by :func:`~flowsentryx_tpu_torch.core.wire.shard_of`, and
  engine ``r`` drains the contiguous span ``[r*w, (r+1)*w)`` end to end,
  so a source's flow state lives on exactly one engine.

numpy at import: the spec half imports torch only when it places a
table (the cluster supervisor imports this module and no torch).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Callable

import numpy as np

from flowsentryx_tpu_torch.core.wire import shard_of


class PartitionSpec(tuple):
    """``PartitionSpec("ip")``: rows split over the mesh axis ``ip``;
    ``PartitionSpec()``: replicated."""

    def __new__(cls, *axes: str) -> "PartitionSpec":
        return super().__new__(cls, axes)


P = PartitionSpec

#: The partition rules, first match wins: ``(leaf-path regex, the spec
#: as a function of the mesh's table axis)``.  Leaf paths are dotted names
#: rooted at the step's argument names (``table.key_rows``,
#: ``stats.allowed``, ``params``, ``raw``...).
PARTITION_RULES: tuple[tuple[str, Callable[[str], P]], ...] = (
    # per-IP state rows: sharded over the hash axis
    (r"^table\.", lambda axis: P(axis)),
    # global counters, classifier params and wire batches: replicated
    # (each shard slices its own batch span inside the step)
    (r"^(stats|params|raw|wire|slot)", lambda _axis: P()),
)


def spec_for(name: str, axis: str = "ip") -> P:
    """The :class:`PartitionSpec` of one leaf path under the rules."""
    for pat, build in PARTITION_RULES:
        if re.search(pat, name) is not None:
            return build(axis)
    raise KeyError(f"no partition rule matches leaf {name!r}")


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: where one leaf lives."""

    mesh: object
    spec: P

    @property
    def device(self):
        return self.mesh.device


def sharding_for(mesh, name: str) -> NamedSharding:
    """The placement of one leaf path on ``mesh``."""
    return NamedSharding(mesh, spec_for(name, mesh.axis_names[0]))


def replicated(mesh) -> NamedSharding:
    """The replicated placement (stats, params, wire buffers)."""
    return NamedSharding(mesh, P())


def table_specs(axis: str = "ip"):
    """The table's specs, one per leaf, derived from the rules."""
    from flowsentryx_tpu_torch.core.schema import IpTableState

    return IpTableState(*(spec_for(f"table.{f}", axis)
                          for f in IpTableState._fields))


def stats_specs():
    """The stats' specs, one per counter, derived from the rules."""
    from flowsentryx_tpu_torch.core.schema import GlobalStats

    return GlobalStats(*(spec_for(f"stats.{f}")
                         for f in GlobalStats._fields))


def shard_table(table, mesh):
    """Place a state table under the rules: its rows split over the
    mesh's shards, which on one device is the one contiguous table on
    that device (moved there when it lies elsewhere, else the same
    tensors).  The placement everything restores through."""
    from flowsentryx_tpu_torch.core.schema import IpTableState

    if table.capacity % mesh.size:
        raise ValueError("table capacity must divide by device count")
    return IpTableState(*(
        leaf.to(sharding_for(mesh, f"table.{f}").device)
        for f, leaf in zip(IpTableState._fields, table)))


def rank_rows(rows, rank: int, n: int):
    """Rank ``rank``'s row range of a whole table's rows (any array or
    tensor whose leading axis is the table's ``N`` rows) on an
    ``n``-rank process mesh: rows ``[rank*N/n, (rank+1)*N/n)``, the
    reference's shard-major order."""
    local = rows.shape[0] // n
    return rows[rank * local:(rank + 1) * local]


def gather_rows(table, mesh) -> tuple[np.ndarray, np.ndarray]:
    """Every rank's rows of a process mesh's table back in the one
    table's row order, as :func:`~..core.schema.table_to_numpy` gives a
    whole table (``[N]`` uint32 keys, ``[N, 12]`` f32 state, each
    rank's park row dropped): what checkpoints and the table digest
    read.  Every rank calls it (one gather of each column)."""
    from flowsentryx_tpu_torch.parallel import exchange

    key = exchange.gather(mesh, table.key)
    state = exchange.gather(mesh, table.state)
    return (np.concatenate([k.cpu().numpy() for k in key]).view(np.uint32),
            np.concatenate([s.cpu().numpy() for s in state]))


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


def assigned_rank_of(saddr, owners, w: int = 1) -> np.ndarray:
    """Owner engine of each folded source under a live shard assignment
    (``cluster/rebalance.py``'s ``ShardAssignment.owners``): the hash
    rule of :func:`cluster_rank_of` with the versioned shard -> rank map
    in place of ``shard // w``.  At generation 0 it is
    :func:`cluster_rank_of`; ``w`` is unused (the owners are the
    route)."""
    del w
    owners = np.asarray(owners, np.int64)
    return owners[shard_of(saddr, len(owners)).astype(np.int64)]


def assigned_ring_of(saddr, owners, w: int) -> np.ndarray:
    """The ring a producer writes each record to under a live
    assignment: the owner's physical span (rank ``owners[s]`` drains
    rings ``[owners[s]*w, (owners[s]+1)*w)`` for good; ownership is what
    moves), at the shard's lane ``s % w`` within it, so a flow's records
    stay in order across a flip."""
    owners = np.asarray(owners, np.int64)
    s = shard_of(saddr, len(owners)).astype(np.int64)
    return owners[s] * int(w) + s % int(w)
