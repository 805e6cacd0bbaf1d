"""Python side of the daemon's shared-memory rings.

Counterpart of ``flowsentryx_tpu/engine/shm.py``, kept as this package's
own copy (numpy only: the ingest workers import it without torch).
Mirror of ``daemon/shm_ring.hpp`` (layout in ``kern/fsx_wire.h``, the
constants in :mod:`flowsentryx_tpu_torch.core.wire`): a 192-byte header
(magic/capacity/record_size; head and tail cursors on their own cache
lines) followed by ``capacity`` fixed-size records.  SPSC — the daemon
produces features / consumes verdicts, this process does the reverse.
On x86-TSO, numpy u64 loads/stores of the cursors are single MOVs and
the memcpy-before-cursor-publish ordering matches the C++ side's
release stores.
"""

from __future__ import annotations

import mmap
import platform
import time
from pathlib import Path

import numpy as np

from flowsentryx_tpu_torch.core import wire

# The cursor protocol below publishes with plain u64 loads/stores and
# relies on the total-store-order guarantee of x86 (a numpy scalar store
# is a single MOV; the record memcpy precedes the cursor store in
# program order and TSO forbids store-store reordering).  On weakly
# ordered ISAs (aarch64, riscv) that ordering is NOT guaranteed and a
# consumer could observe the new cursor before the record bytes —
# silent corruption.  Refuse loudly rather than corrupt quietly; the
# C++ daemon side uses real release/acquire atomics and is portable.
# Note: no i686 — x86-TSO holds there, but a numpy u64 store is two
# 32-bit stores on 32-bit x86, so the single-MOV premise breaks.
_TSO_ARCHS = {"x86_64", "AMD64"}


def _require_tso() -> None:
    m = platform.machine()
    if m not in _TSO_ARCHS:
        raise RuntimeError(
            f"ShmRing's plain-store cursor protocol requires x86-TSO; "
            f"machine is {m!r}. Port note: replace the cursor accesses "
            f"with atomic release/acquire (e.g. via a tiny C extension) "
            f"before enabling this transport on weakly ordered ISAs."
        )


class RingNotReady(Exception):
    """The ring file exists but its creator hasn't published the header
    magic yet (transient; wait_for retries this, and only this)."""


class ShmRing:
    """One mapped ring.  ``role`` is "consumer" or "producer"."""

    @classmethod
    def create(
        cls, path: str | Path, capacity: int, record: np.dtype
    ) -> "ShmRing":
        """Create a ring from the Python side (tests and in-process
        producers; the production feature rings are created by the C++
        daemon).  Same publish protocol as ``ShmRing::create`` in
        daemon/shm_ring.hpp: header fields first, magic last."""
        _require_tso()
        if capacity <= 0 or capacity & (capacity - 1):
            raise ValueError(f"capacity must be a power of two, got {capacity}")
        path = Path(path)
        nbytes = wire.SHM_HDR_SIZE + capacity * record.itemsize
        with open(path, "wb") as f:
            f.truncate(nbytes)
        with open(path, "r+b") as f:
            mm = mmap.mmap(f.fileno(), 0)
        hdr = np.frombuffer(mm, np.uint64, 3, 0)
        hdr[1] = capacity
        hdr[2] = record.itemsize
        hdr[0] = wire.SHM_MAGIC  # publish last
        del hdr
        mm.close()
        return cls(path, record)

    def __init__(self, path: str | Path, expect_record: np.dtype):
        _require_tso()
        self.path = Path(path)
        with open(self.path, "r+b") as f:
            self._mm = mmap.mmap(f.fileno(), 0)
        hdr = np.frombuffer(self._mm, np.uint64, 3, 0)
        if int(hdr[0]) != wire.SHM_MAGIC:
            # RingNotReady, not ValueError: the creator publishes magic
            # last, so this is the retryable mid-create window — a
            # record-size mismatch below is a REAL error that wait_for
            # must not retry into a misleading timeout.
            raise RingNotReady(f"ring magic not published yet in {self.path}")
        self.capacity = int(hdr[1])
        self.record_size = int(hdr[2])
        if self.record_size != expect_record.itemsize:
            raise ValueError(
                f"{self.path}: ring record size {self.record_size} != "
                f"dtype {expect_record.itemsize}"
            )
        self.dtype = expect_record
        self._records = np.frombuffer(
            self._mm, expect_record, self.capacity, wire.SHM_HDR_SIZE
        )
        # single-element u64 views of the cursors
        self._head = np.frombuffer(self._mm, np.uint64, 1, wire.SHM_HEAD_OFFSET)
        self._tail = np.frombuffer(self._mm, np.uint64, 1, wire.SHM_TAIL_OFFSET)

    @classmethod
    def wait_for(
        cls, path: str | Path, expect_record: np.dtype, timeout_s: float = 10.0
    ) -> "ShmRing":
        """Open a ring the daemon creates, waiting for it to appear."""
        deadline = time.monotonic() + timeout_s
        path = Path(path)
        while True:
            if path.exists() and path.stat().st_size >= wire.SHM_HDR_SIZE:
                try:
                    return cls(path, expect_record)
                except RingNotReady:
                    pass  # creator publishes magic last; retry
            if time.monotonic() > deadline:
                raise TimeoutError(f"ring {path} did not appear")
            time.sleep(0.01)

    # -- consumer side ------------------------------------------------------

    def consume(self, max_records: int) -> np.ndarray:
        t = int(self._tail[0])
        h = int(self._head[0])  # plain load; producer published with release
        n = min(h - t, max_records)
        if n <= 0:
            return self._records[:0].copy()
        # at most two contiguous slice copies (memcpy-speed; a fancy-
        # indexed gather here was the single largest cost in the drain
        # workers' profile — an index-array build plus an element-wise
        # structured-record copy, per poll)
        i = t & (self.capacity - 1)
        first = min(n, self.capacity - i)
        if first == n:
            out = self._records[i:i + n].copy()
        else:
            out = np.concatenate(
                [self._records[i:i + first], self._records[: n - first]])
        self._tail[0] = t + n     # publish after the copy
        return out

    def peek(self, max_records: int) -> tuple[list[np.ndarray], int]:
        """Zero-copy drain half: up to two contiguous VIEWS of the
        oldest readable records, without releasing them.  SPSC makes
        this safe — the producer cannot overwrite a slot until
        :meth:`advance` moves the tail — so a consumer that transforms
        records anyway (the ingest drain workers packing compact16) can
        skip the :meth:`consume` copy entirely.  Views die at
        ``advance``; copy anything that must outlive it."""
        t = int(self._tail[0])
        h = int(self._head[0])
        n = min(h - t, max_records)
        if n <= 0:
            return [], 0
        i = t & (self.capacity - 1)
        first = min(n, self.capacity - i)
        views = [self._records[i:i + first]]
        if first < n:
            views.append(self._records[: n - first])
        return views, n

    def advance(self, n: int) -> None:
        """Release ``n`` peeked records back to the producer."""
        self._tail[0] = int(self._tail[0]) + n

    # -- producer side ------------------------------------------------------

    def produce(self, records: np.ndarray) -> int:
        h = int(self._head[0])
        t = int(self._tail[0])
        n = min(len(records), self.capacity - (h - t))
        if n <= 0:
            return 0
        i = h & (self.capacity - 1)
        first = min(n, self.capacity - i)
        self._records[i:i + first] = records[:first]
        if first < n:
            self._records[: n - first] = records[first:n]
        self._head[0] = h + n
        return n

    def readable(self) -> int:
        return int(self._head[0]) - int(self._tail[0])


class SealedBatchQueue:
    """SPSC shared-memory queue of SEALED wire buffers — the ingest
    worker → engine hand-off of the sharded ingest subsystem
    (:mod:`flowsentryx_tpu_torch.ingest`).

    Same header geometry and x86-TSO plain-store cursor protocol as
    :class:`ShmRing`, but each "record" is one batch SLOT: an 8-word
    header (seq / n_records / wire_id / seal time / fill duration — the
    cross-process batch contract, documented at
    ``wire.SHM_BATCHQ_MAGIC``) followed by a ``[max_batch+1, words]``
    wire buffer.  The meta cache line additionally carries the worker
    control block (heartbeat, first-ts/t0 epoch handshake, stop flag,
    worker lifecycle state); every control field has exactly one writer
    side, so plain u64 stores suffice under TSO.
    """

    def __init__(self, path: str | Path, expect_payload_words: int | None = None):
        _require_tso()
        self.path = Path(path)
        with open(self.path, "r+b") as f:
            self._mm = mmap.mmap(f.fileno(), 0)
        hdr = np.frombuffer(self._mm, np.uint64, 3, 0)
        if int(hdr[0]) != wire.SHM_BATCHQ_MAGIC:
            raise RingNotReady(f"batch-queue magic not published yet in {self.path}")
        self.slots = int(hdr[1])
        self.slot_words = int(hdr[2]) // 4
        self.payload_words = self.slot_words - wire.BATCHQ_SLOT_HDR_WORDS
        if (expect_payload_words is not None
                and self.payload_words != expect_payload_words):
            raise ValueError(
                f"{self.path}: queue payload {self.payload_words} words != "
                f"expected {expect_payload_words} (batch shape mismatch "
                "between worker and engine)"
            )
        self._cells = np.frombuffer(
            self._mm, np.uint32, self.slots * self.slot_words,
            wire.SHM_HDR_SIZE,
        ).reshape(self.slots, self.slot_words)
        self._head = np.frombuffer(self._mm, np.uint64, 1, wire.SHM_HEAD_OFFSET)
        self._tail = np.frombuffer(self._mm, np.uint64, 1, wire.SHM_TAIL_OFFSET)
        self._ctl = {
            name: np.frombuffer(self._mm, np.uint64, 1, off)
            for name, off in (
                ("hbeat", wire.SHM_HBEAT_OFFSET),
                ("first_ts", wire.SHM_FIRST_TS_OFFSET),
                ("t0", wire.SHM_T0_OFFSET),
                ("stop", wire.SHM_STOP_OFFSET),
                ("wstate", wire.SHM_WSTATE_OFFSET),
                ("emit_drop", wire.SHM_EMIT_DROP_OFFSET),
                ("spin_us", wire.SHM_SPIN_US_OFFSET),
                ("idle_us", wire.SHM_IDLE_US_OFFSET),
            )
        }

    @classmethod
    def create(
        cls, path: str | Path, slots: int, payload_words: int
    ) -> "SealedBatchQueue":
        """Create a queue file (the engine parent does this BEFORE
        spawning the worker, so neither side races a missing file).
        Publish protocol: geometry first, magic last."""
        _require_tso()
        if slots < 2 or slots & (slots - 1):
            raise ValueError(f"slots must be a power of two >= 2, got {slots}")
        slot_bytes = (wire.BATCHQ_SLOT_HDR_WORDS + payload_words) * 4
        nbytes = wire.SHM_HDR_SIZE + slots * slot_bytes
        path = Path(path)
        with open(path, "wb") as f:
            f.truncate(nbytes)
        with open(path, "r+b") as f:
            mm = mmap.mmap(f.fileno(), 0)
        hdr = np.frombuffer(mm, np.uint64, 3, 0)
        hdr[1] = slots
        hdr[2] = slot_bytes
        hdr[0] = wire.SHM_BATCHQ_MAGIC  # publish last
        del hdr
        mm.close()
        return cls(path)

    @classmethod
    def wait_for(
        cls,
        path: str | Path,
        expect_payload_words: int | None = None,
        timeout_s: float = 10.0,
    ) -> "SealedBatchQueue":
        deadline = time.monotonic() + timeout_s
        path = Path(path)
        while True:
            if path.exists() and path.stat().st_size >= wire.SHM_HDR_SIZE:
                try:
                    return cls(path, expect_payload_words)
                except RingNotReady:
                    pass
            if time.monotonic() > deadline:
                raise TimeoutError(f"batch queue {path} did not appear")
            time.sleep(0.01)

    # -- control block (one writer per field; plain stores under TSO) -------

    def ctl_get(self, name: str) -> int:
        return int(self._ctl[name][0])

    def ctl_set(self, name: str, value: int) -> None:
        self._ctl[name][0] = value

    # -- producer (worker) side ---------------------------------------------

    def produce_batch(
        self,
        payload: np.ndarray,
        *,
        seq: int,
        n_records: int,
        wire_id: int,
        seal_ns: int,
        fill_dur_us: int,
    ) -> bool:
        """Copy one sealed wire buffer in; False when the queue is full
        (the worker retries — backpressure propagates to the shard ring
        and from there to the producing daemon's drop counters)."""
        h = int(self._head[0])
        t = int(self._tail[0])
        if h - t >= self.slots:
            return False
        cell = self._cells[h & (self.slots - 1)]
        cell[wire.BATCHQ_SEQ_LO_WORD] = seq & 0xFFFFFFFF
        cell[wire.BATCHQ_SEQ_HI_WORD] = (seq >> 32) & 0xFFFFFFFF
        cell[wire.BATCHQ_N_RECORDS_WORD] = n_records
        cell[wire.BATCHQ_WIRE_ID_WORD] = wire_id
        # the seal stamp (the slot-header block in core/wire.py): every
        # record of this batch is timestamped here, at shm seal
        cell[wire.BATCHQ_SEAL_NS_LO_WORD] = seal_ns & 0xFFFFFFFF
        cell[wire.BATCHQ_SEAL_NS_HI_WORD] = (seal_ns >> 32) & 0xFFFFFFFF
        cell[wire.BATCHQ_FILL_DUR_US_WORD] = min(int(fill_dur_us),
                                                   0xFFFFFFFF)
        cell[wire.BATCHQ_RESERVED_WORD] = 0
        cell[wire.BATCHQ_SLOT_HDR_WORDS:] = payload.reshape(-1)
        self._head[0] = h + 1  # publish after the copy
        return True

    # -- consumer (engine) side ---------------------------------------------

    def consume_batch(self) -> tuple[np.ndarray, np.ndarray] | None:
        """``(header[8] u32 copy, payload u32 copy)`` of the oldest
        sealed batch, or None when empty.  The payload is copied out
        before the tail advances: the slot may be overwritten by the
        worker the moment it is released, and the engine's dispatch
        holds batch buffers asynchronously."""
        t = int(self._tail[0])
        h = int(self._head[0])
        if h == t:
            return None
        cell = self._cells[t & (self.slots - 1)]
        hdr = cell[: wire.BATCHQ_SLOT_HDR_WORDS].copy()
        payload = cell[wire.BATCHQ_SLOT_HDR_WORDS:].copy()
        self._tail[0] = t + 1  # release after the copy
        return hdr, payload

    def peek_batches(
        self, max_batches: int
    ) -> list[tuple[np.ndarray, np.ndarray]]:
        """Zero-copy dequeue half: ``(header[8] u32 copy, payload u32
        VIEW)`` of up to ``max_batches`` oldest sealed slots, WITHOUT
        releasing them.  SPSC makes the views safe exactly as in
        :meth:`ShmRing.peek` — the worker cannot reuse a slot until
        :meth:`release` moves the tail — so a consumer that stages the
        payload somewhere anyway (the engine's dispatch arena) skips the
        :meth:`consume_batch` copy entirely.  Views die at ``release``;
        copy anything that must outlive it.  The 32-byte header is
        copied (it is decoded into Python ints immediately either way).
        Slots come back oldest-first; ``release(n)`` frees the first
        ``n`` of them — partial release keeps the rest peekable."""
        t = int(self._tail[0])
        h = int(self._head[0])
        n = min(h - t, max_batches)
        out: list[tuple[np.ndarray, np.ndarray]] = []
        for j in range(n):
            cell = self._cells[(t + j) & (self.slots - 1)]
            out.append((cell[: wire.BATCHQ_SLOT_HDR_WORDS].copy(),
                        cell[wire.BATCHQ_SLOT_HDR_WORDS:]))
        return out

    def release(self, n: int) -> None:
        """Hand ``n`` peeked slots back to the worker.  Every payload
        view of a released slot is DEAD the moment this returns — the
        worker may overwrite the bytes concurrently (the
        mutate-after-release tests pin that staged arena copies are
        immune to exactly this)."""
        self._tail[0] = int(self._tail[0]) + n

    def readable(self) -> int:
        return int(self._head[0]) - int(self._tail[0])


class ShmRingSource:
    """RecordSource over the daemon's feature ring.

    The record format is read off the ring header: 48 B rings carry
    full-fidelity ``FLOW_RECORD_DTYPE`` records, 16 B rings carry
    KERNEL-quantized ``COMPACT_RECORD_DTYPE`` records (a compact-emit
    data plane / ``fsxd --compact``); ``precompact`` tells the engine
    which batcher path to use."""

    def __init__(self, path: str | Path, timeout_s: float = 10.0):
        deadline = time.monotonic() + timeout_s
        try:
            self.ring = ShmRing.wait_for(
                path, wire.FLOW_RECORD_DTYPE,
                max(0.01, deadline - time.monotonic()),
            )
        except ValueError:
            # size mismatch: re-open expecting the compact record
            self.ring = ShmRing.wait_for(
                path, wire.COMPACT_RECORD_DTYPE,
                max(0.01, deadline - time.monotonic()),
            )
        self.precompact = (
            self.ring.record_size == wire.COMPACT_RECORD_SIZE
        )

    def poll(self, max_records: int) -> np.ndarray:
        return self.ring.consume(max_records)

    def exhausted(self) -> bool:
        return False  # live transport; the engine stops on its own bounds


class ShmVerdictSink:
    """VerdictSink into the daemon's verdict ring.

    Expiry translation: the engine works in f32 seconds relative to its
    ``t0_ns``; the daemon/kernel want absolute kernel-clock ns."""

    def __init__(self, path: str | Path, t0_ns: int = 0, timeout_s: float = 10.0):
        self.ring = ShmRing.wait_for(path, wire.VERDICT_RECORD_DTYPE, timeout_s)
        self.t0_ns = t0_ns
        self.dropped = 0

    def apply(self, update) -> None:
        n = len(update.key)
        if not n:
            return
        rec = np.zeros(n, wire.VERDICT_RECORD_DTYPE)
        rec["saddr"] = update.key
        rec["until_ns"] = (
            update.until_s.astype(np.float64) * 1e9
        ).astype(np.uint64) + np.uint64(self.t0_ns)
        pushed = self.ring.produce(rec)
        self.dropped += n - pushed
