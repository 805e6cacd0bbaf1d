"""Cross-engine shared memory: gossip mailboxes and status blocks.

Counterpart of ``flowsentryx_tpu/cluster/mailbox.py``; the mapped files
are byte-compatible with the reference's (same magic, header, slot
layout and cursor protocol), so a port engine and a reference engine
can share one plane.  Both objects use the
:class:`~flowsentryx_tpu_torch.engine.shm.ShmRing` header geometry and
its x86-TSO plain-store cursor protocol (one writer per cursor, the copy
before the publish):

* :class:`VerdictMailbox` — one SPSC queue per ordered engine pair
  ``src -> dst``.  Each slot holds a 4-word header (seq lo/hi, entry
  count, 0) and one ``[2K+4]`` compact verdict wire, decoded with
  :func:`~flowsentryx_tpu_torch.engine.writeback.decode_verdict_wire`.
  A full mailbox never blocks the publisher: the drop is counted and
  the blacklist converges on the next publish.
* :class:`StatusBlock` — one per engine: the supervisor <-> engine
  lifecycle contract.  Engine-written fields (heartbeat, state,
  progress, pid) and supervisor-written fields (stop, generation, the
  shared t0 epoch) live on separate cache lines, one writer side each.

numpy and mmap only: the supervisor imports this, and never torch.
"""

from __future__ import annotations

import mmap
from pathlib import Path

import numpy as np

from flowsentryx_tpu_torch.core import wire
from flowsentryx_tpu_torch.engine.shm import RingNotReady, _require_tso


def mailbox_path(cluster_dir: str | Path, src: int, dst: int) -> str:
    """The ``src -> dst`` mailbox file (the supervisor creates it, the
    two engine sides attach)."""
    return str(Path(cluster_dir) / f"gossip_{src}to{dst}.mbx")


def status_path(cluster_dir: str | Path, rank: int) -> str:
    return str(Path(cluster_dir) / f"status_r{rank}.blk")


def _map(path: Path) -> mmap.mmap:
    with open(path, "r+b") as f:
        return mmap.mmap(f.fileno(), 0)


def _create_file(path: Path, nbytes: int) -> mmap.mmap:
    with open(path, "wb") as f:
        f.truncate(nbytes)
    return _map(path)


class VerdictMailbox:
    """SPSC queue of compact verdict wires between one engine pair.
    ``k_max`` is derived from the slot size baked into the file header,
    so publisher and consumer cannot disagree on it."""

    def __init__(self, path: str | Path):
        _require_tso()
        self.path = Path(path)
        self._mm = _map(self.path)
        hdr = np.frombuffer(self._mm, np.uint64, 3, 0)
        if int(hdr[0]) != wire.SHM_GOSSIP_MAGIC:
            raise RingNotReady(
                f"gossip mailbox magic not published yet in {self.path}")
        self.slots = int(hdr[1])
        self.slot_words = int(hdr[2]) // 4
        self.wire_words = self.slot_words - wire.GOSSIP_SLOT_HDR_WORDS
        #: Verdict slots per wire (the ``[2K+4]`` layout inverted).
        self.k_max = (self.wire_words - 4) // 2
        self._cells = np.frombuffer(
            self._mm, np.uint32, self.slots * self.slot_words,
            wire.SHM_HDR_SIZE).reshape(self.slots, self.slot_words)
        self._head = np.frombuffer(self._mm, np.uint64, 1,
                                   wire.SHM_HEAD_OFFSET)
        self._tail = np.frombuffer(self._mm, np.uint64, 1,
                                   wire.SHM_TAIL_OFFSET)

    @classmethod
    def create(cls, path: str | Path, slots: int,
               k_max: int) -> "VerdictMailbox":
        """Create a mailbox file (the supervisor, before any engine
        spawns).  Geometry first, magic last."""
        _require_tso()
        if slots < 2 or slots & (slots - 1):
            raise ValueError(
                f"slots must be a power of two >= 2, got {slots}")
        if k_max < 1:
            raise ValueError(f"k_max must be >= 1, got {k_max}")
        slot_bytes = (wire.GOSSIP_SLOT_HDR_WORDS + 2 * k_max + 4) * 4
        mm = _create_file(Path(path), wire.SHM_HDR_SIZE + slots * slot_bytes)
        hdr = np.frombuffer(mm, np.uint64, 3, 0)
        hdr[1] = slots
        hdr[2] = slot_bytes
        hdr[0] = wire.SHM_GOSSIP_MAGIC  # publish last
        del hdr
        mm.close()
        return cls(path)

    # -- producer (publishing engine) side ----------------------------------

    def publish(self, w: np.ndarray, seq: int, count: int) -> bool:
        """Copy one ``[2K+4]`` u32 verdict wire in; False when the
        mailbox is full (the caller counts the drop: a blocked publisher
        would let one slow peer stall every engine's sink)."""
        h = int(self._head[0])
        t = int(self._tail[0])
        if h - t >= self.slots:
            return False
        cell = self._cells[h & (self.slots - 1)]
        cell[0] = seq & 0xFFFFFFFF
        cell[1] = (seq >> 32) & 0xFFFFFFFF
        cell[2] = count
        cell[3] = 0
        cell[wire.GOSSIP_SLOT_HDR_WORDS:] = w
        self._head[0] = h + 1  # publish after the copy
        return True

    # -- consumer (merging peer) side ---------------------------------------

    def pop_wires(self, max_wires: int) -> list[tuple[int, np.ndarray]]:
        """``(seq, wire copy)`` of up to ``max_wires`` oldest published
        wires, oldest first, releasing their slots after the copies."""
        t = int(self._tail[0])
        h = int(self._head[0])
        n = min(h - t, max_wires)
        out: list[tuple[int, np.ndarray]] = []
        for j in range(n):
            cell = self._cells[(t + j) & (self.slots - 1)]
            seq = int(cell[0]) | (int(cell[1]) << 32)
            out.append((seq, cell[wire.GOSSIP_SLOT_HDR_WORDS:].copy()))
        if n:
            self._tail[0] = t + n  # release after the copies
        return out

    def readable(self) -> int:
        return int(self._head[0]) - int(self._tail[0])

    def published(self) -> int:
        """Wires ever published into this mailbox (the head cursor)."""
        return int(self._head[0])


class StatusBlock:
    """One engine's supervisor <-> engine lifecycle block.

    A field is its writer's last words: nothing resets the engine line
    when an engine dies, so a corpse still reads SERVING until its
    replacement's first store (SPAWNING).  Readers judge liveness by the
    process and ``c_gen``, and read ``c_state`` as the engine's last
    claim."""

    _CTL = {
        "c_hbeat": wire.STATUS_HBEAT_OFFSET,
        "c_state": wire.STATUS_STATE_OFFSET,
        "c_batches": wire.STATUS_BATCHES_OFFSET,
        "c_records": wire.STATUS_RECORDS_OFFSET,
        "c_pid": wire.STATUS_PID_OFFSET,
        "c_handoff": wire.STATUS_HANDOFF_OFFSET,
        "c_layout_ack": wire.STATUS_LAYOUT_ACK_OFFSET,
        "c_stop": wire.STATUS_STOP_OFFSET,
        "c_gen": wire.STATUS_GEN_OFFSET,
        "c_t0": wire.STATUS_T0_OFFSET,
        "c_t0_wall": wire.STATUS_T0_WALL_OFFSET,
        "c_layout_gen": wire.STATUS_LAYOUT_GEN_OFFSET,
        "c_fence": wire.STATUS_FENCE_OFFSET,
    }

    def __init__(self, path: str | Path):
        _require_tso()
        self.path = Path(path)
        self._mm = _map(self.path)
        hdr = np.frombuffer(self._mm, np.uint64, 2, 0)
        if int(hdr[0]) != wire.SHM_STATUS_MAGIC:
            raise RingNotReady(
                f"status-block magic not published yet in {self.path}")
        self.rank = int(hdr[1])
        self._ctl = {name: np.frombuffer(self._mm, np.uint64, 1, off)
                     for name, off in self._CTL.items()}

    @classmethod
    def create(cls, path: str | Path, rank: int) -> "StatusBlock":
        """Create one engine's block (the supervisor, before the spawn;
        fields start zeroed: CSTATE 0 reads as never booted)."""
        _require_tso()
        mm = _create_file(Path(path), wire.SHM_STATUS_SIZE)
        hdr = np.frombuffer(mm, np.uint64, 2, 0)
        hdr[1] = rank
        hdr[0] = wire.SHM_STATUS_MAGIC  # publish last
        del hdr
        mm.close()
        return cls(path)

    # one writer side per field; plain u64 stores under TSO
    def ctl_get(self, name: str) -> int:
        return int(self._ctl[name][0])

    def ctl_set(self, name: str, value: int) -> None:
        self._ctl[name][0] = value
