"""Preallocated staging rows for the dispatch hop.

Counterpart of ``flowsentryx_tpu/engine/arena.py``.  A sealed batch is
copied ONCE on the engine side: from the shm queue slot view
(:meth:`~.shm.SealedBatchQueue.peek_batches`) or the batcher buffer into
arena rows, the queue slot released right after that copy; the dispatch
then uploads the contiguous arena slice.  On the card the rows are
pinned host memory, so the upload is one asynchronous DMA with no bounce
buffer — the reference's page-aligned anonymous ``mmap`` plays that part
for its runtime.

Geometry: ``slots`` independent group buffers of ``group_max`` wire
rows each, ``[slots, group_max, max_batch+1, words]`` overall.  A group
(1..``group_max`` batches) assembles in one slot's rows, so any
``rows[a:a+g]`` dispatch slice is contiguous.  Slots recycle round-robin
(:meth:`DispatchArena.claim`).

Reuse rule: a slot's rows may be overwritten only once every dispatch
staged in it has finished reading them.  In the reference that holds by
count (``slots >= readback_depth + 2``, with at most ``readback_depth``
batches in flight); :meth:`ring_safe_slots` generalizes it to a drain
ring, and the engine sizes its arena with it for the ring's depth (1
without a ring).  The port keeps that count and adds the card's own
proof: the engine records, per slot, the event of the last dispatch
staged there (for a ring slot, its round's, which follows the slot's
upload) and waits on it when it claims the slot again (a no-op when the
count already guarantees it).  On the CPU a step reads its input before
it returns, so the count alone suffices.
"""

from __future__ import annotations

import numpy as np
import torch


class DispatchArena:
    """Ring of ``[group_max, max_batch+1, words]`` staging slots.

    :meth:`claim` hands out the next slot index (recycling the oldest);
    :meth:`rows` is one slot's uint32 row array (for staging), and
    :meth:`tensor` the same memory as int32 bit patterns (for the
    upload).  The arena tracks no liveness itself: the engine's claim /
    dispatch / event discipline is the lifetime contract (module
    docstring)."""

    def __init__(self, slots: int, group_max: int, max_batch: int,
                 words: int, pinned: bool = False):
        if slots < 2:
            raise ValueError(f"arena needs >= 2 slots, got {slots}")
        if group_max < 1:
            raise ValueError(f"group_max must be >= 1, got {group_max}")
        self.slots = slots
        self.group_max = group_max
        self.row_shape = (max_batch + 1, words)
        self.pinned = bool(pinned)
        # zero-filled at allocation: every page is touched at boot, not
        # inside the first served batches' staging copies
        self.buf_t = torch.zeros((slots, group_max, max_batch + 1, words),
                                 dtype=torch.int32, pin_memory=self.pinned)
        self.buf = self.buf_t.numpy().view(np.uint32)
        self._cur = -1

    @property
    def nbytes(self) -> int:
        return self.buf.nbytes

    @staticmethod
    def ring_safe_slots(readback_depth: int, ring: int) -> int:
        """Slot count that keeps the reuse rule when a device-loop ring
        holds up to ``ring`` uploaded slices in flight: at any claim, at
        most ``readback_depth`` sunk-pending slots, plus up to ``ring``
        slots of the just-submitted round, plus the claim itself — the
        ``readback_depth + 2`` rule is the ``ring = 1`` case."""
        if ring < 1:
            raise ValueError(f"ring must be >= 1, got {ring}")
        return max(readback_depth, 1) + ring + 1

    def claim(self) -> int:
        """Next slot index, recycling the oldest."""
        self._cur = (self._cur + 1) % self.slots
        return self._cur

    def rows(self, slot: int) -> np.ndarray:
        """The ``[group_max, max_batch+1, words]`` uint32 rows of one
        slot; ``rows(s)[a:a+g]`` is the contiguous slice of a g-batch
        group staged at offset ``a``."""
        return self.buf[slot]

    def tensor(self, slot: int) -> torch.Tensor:
        """The same rows as an int32 tensor (the upload's source)."""
        return self.buf_t[slot]

    def info(self) -> dict:
        """Report-facing geometry (``EngineReport.dispatch["arena"]``)."""
        return {
            "slots": self.slots,
            "group_max": self.group_max,
            "row_shape": list(self.row_shape),
            "bytes": int(self.nbytes),
            "pinned": self.pinned,
        }
