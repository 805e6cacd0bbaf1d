"""Verdict writeback: decode the step's verdict wire on the host (numpy).

Counterpart of ``flowsentryx_tpu/engine/writeback.py`` (the in-process
sinks; the daemon's verdict ring is
:class:`~flowsentryx_tpu_torch.engine.shm.ShmVerdictSink`).
"""

from __future__ import annotations

from typing import NamedTuple, Protocol

import numpy as np

INVALID_KEY = np.uint32(0xFFFFFFFF)


class BlacklistUpdate(NamedTuple):
    key: np.ndarray        # [K] uint32
    until_s: np.ndarray    # [K] f32 engine-relative seconds


def extract_updates(block_key: np.ndarray, block_until: np.ndarray
                    ) -> BlacklistUpdate:
    """Compact a step's padded block arrays to the real updates."""
    block_key = np.asarray(block_key).view(np.uint32)
    mask = block_key != INVALID_KEY
    return BlacklistUpdate(key=block_key[mask],
                           until_s=np.asarray(block_until)[mask])


class VerdictWire(NamedTuple):
    key: np.ndarray
    until_s: np.ndarray
    count: int
    overflow: bool
    route_drop: int
    now: float


def decode_verdict_wire(wire: np.ndarray) -> VerdictWire:
    """Decode one ``[2K+4]`` verdict wire (uint32 or its int32 bit
    patterns).  With ``overflow`` set the key slots are incomplete and
    the caller fetches the full block arrays instead."""
    wire = np.asarray(wire).view(np.uint32)
    k = (wire.shape[0] - 4) // 2
    count = int(wire[2 * k])
    n = min(count, k)
    return VerdictWire(
        key=wire[:n],
        until_s=wire[k:k + n].view(np.float32),
        count=count,
        overflow=bool(wire[2 * k + 1]),
        route_drop=int(wire[2 * k + 2]),
        now=float(wire[2 * k + 3:2 * k + 4].view(np.float32)[0]),
    )


class VerdictSink(Protocol):
    def apply(self, update: BlacklistUpdate) -> None: ...


class NullSink:
    def apply(self, update: BlacklistUpdate) -> None:
        pass


class CollectSink:
    """Accumulates updates (last expiry wins per key)."""

    def __init__(self) -> None:
        self.blocked: dict[int, float] = {}
        self.updates = 0

    def apply(self, update: BlacklistUpdate) -> None:
        self.updates += 1
        self.blocked.update(zip(update.key.tolist(), update.until_s.tolist()))
