"""The benchmark's own copy of the record layout and of the daemon's
shared-memory feature ring (``daemon/shm_ring.hpp``), numpy only.

These are contracts with other processes (the kernel's 48-byte flow
record, the ring header the drain workers read, ``fsx_shard_of``), kept
here so that the traffic the benchmark offers does not move when the
program changes.  The numbers equal ``kern/fsx_schema.h``.
"""

from __future__ import annotations

import enum
import mmap
from pathlib import Path

import numpy as np

NUM_FEATURES = 8

FLAG_TCP_SYN = 1 << 1
FLAG_TCP = 1 << 2


class Feature(enum.IntEnum):
    DST_PORT = 0
    PKT_LEN_MEAN = 1
    PKT_LEN_STD = 2
    FLOW_DUR_MS = 3
    FLOW_PPS_X1000 = 4
    FWD_IAT_MEAN = 5
    FWD_IAT_STD = 6
    FWD_IAT_MAX = 7


#: One feature-ring entry (packed, 48 bytes): ``struct fsx_flow_record``.
FLOW_RECORD_DTYPE = np.dtype([
    ("ts_ns", "<u8"),
    ("saddr", "<u4"),
    ("pkt_len", "<u2"),
    ("ip_proto", "u1"),
    ("flags", "u1"),
    ("feat", "<u4", (NUM_FEATURES,)),
])

#: ``struct fsx_shm_ring_hdr``: magic, capacity and record size on the
#: first cache line, the producer cursor and the consumer cursor on
#: their own.
SHM_MAGIC = 0x46535852494E4731  # "FSXRING1"
SHM_HDR_SIZE = 192
SHM_HEAD_OFFSET = 64
SHM_TAIL_OFFSET = 128


def shard_of(saddr, n_shards: int) -> np.ndarray:
    """The daemon's IP-hash shard of a source (``fsx_shard_of``: a
    Fibonacci hash), so a flow's records stay on one shard, in order."""
    h = (np.asarray(saddr, np.uint64) * np.uint64(2654435761)) >> np.uint64(16)
    return (h % np.uint64(n_shards)).astype(np.uint32)


def shard_ring_path(base: str, shard: int, n_shards: int) -> str:
    """The path of one shard's ring (``fsxd --shards N``'s naming)."""
    return str(base) if n_shards <= 1 else f"{base}.{shard}"


class RingWriter:
    """The producer side of one SPSC feature ring, as the daemon's
    ``ShmRing::create`` lays it out: the header fields first, the magic
    last; records are copied in before the head cursor moves (x86 keeps
    stores in order)."""

    def __init__(self, path: str | Path, capacity: int):
        if capacity <= 0 or capacity & (capacity - 1):
            raise ValueError(f"ring capacity must be a power of two, got "
                             f"{capacity}")
        self.path = Path(path)
        self.capacity = capacity
        size = SHM_HDR_SIZE + capacity * FLOW_RECORD_DTYPE.itemsize
        with open(self.path, "wb") as f:
            f.truncate(size)
        with open(self.path, "r+b") as f:
            self._mm = mmap.mmap(f.fileno(), 0)
        hdr = np.frombuffer(self._mm, np.uint64, 3, 0)
        hdr[1] = capacity
        hdr[2] = FLOW_RECORD_DTYPE.itemsize
        hdr[0] = SHM_MAGIC
        del hdr
        self.records = np.frombuffer(self._mm, FLOW_RECORD_DTYPE, capacity,
                                     SHM_HDR_SIZE)
        self._head = np.frombuffer(self._mm, np.uint64, 1, SHM_HEAD_OFFSET)
        self._tail = np.frombuffer(self._mm, np.uint64, 1, SHM_TAIL_OFFSET)

    def free(self) -> int:
        return self.capacity - (int(self._head[0]) - int(self._tail[0]))

    def reserve(self, n: int) -> list[np.ndarray]:
        """Up to two contiguous views of the next ``n`` free slots (the
        caller checked :meth:`free`); :meth:`publish` makes them
        readable."""
        i = int(self._head[0]) & (self.capacity - 1)
        first = min(n, self.capacity - i)
        views = [self.records[i:i + first]]
        if first < n:
            views.append(self.records[:n - first])
        return views

    def publish(self, n: int) -> None:
        self._head[0] = int(self._head[0]) + n

    def close(self) -> None:
        del self.records, self._head, self._tail
        self._mm.close()
