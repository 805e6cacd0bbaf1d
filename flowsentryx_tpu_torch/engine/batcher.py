"""Size- and deadline-triggered micro-batcher.

Counterpart of ``flowsentryx_tpu/engine/batcher.py`` (``add``, the
deadline trigger, ``take``), for both wires.  Records accumulate in
preallocated wire buffers whose row ``B`` is the metadata row; a batch
seals at ``max_batch`` records or at the deadline.

* ``raw48``: records copied verbatim as ``[B+1, 12]`` uint32, one memcpy
  per poll chunk and no per-record work; the metadata row carries the
  stream epoch ``t0``.  With ``pinned=True`` the buffers are page-locked
  host memory (a CUDA engine uploads straight from them).
* ``compact16``: records quantized on the way in as ``[B+1, 4]`` uint32;
  a batch also seals early where its record span would overflow the
  16-bit µs delta field.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from flowsentryx_tpu_torch.core import schema
from flowsentryx_tpu_torch.core.config import BatchConfig


class MicroBatcher:
    """``add()`` returns the wire buffers an addition completed;
    ``flush_due()`` is the deadline trigger; ``take()`` seals whatever is
    pending.  A buffer is reused after ``n_buffers`` further seals, so the
    engine keeps at least that many batches' worth of headroom."""

    def __init__(self, cfg: BatchConfig, t0_ns: int = 0, n_buffers: int = 4,
                 quant: dict | None = None,
                 wire: str = schema.WIRE_COMPACT16, pinned: bool = False):
        if wire == schema.WIRE_COMPACT16:
            if cfg.deadline_us > 60_000:
                raise ValueError(
                    "compact16 ts field spans 65 ms; deadline_us "
                    f"{cfg.deadline_us} would saturate record deltas")
            words = schema.COMPACT_RECORD_WORDS
        elif wire == schema.WIRE_RAW48:
            words = schema.RECORD_WORDS
        else:
            raise ValueError(f"unknown wire format {wire!r}")
        self.cfg = cfg
        self.wire = wire
        self.t0_ns = t0_ns
        self.n_buffers = max(2, n_buffers)
        self.quant = dict(quant or {})
        b = cfg.max_batch
        self._bufs = [torch.zeros((b + 1, words), dtype=torch.int32,
                                  pin_memory=pinned).numpy().view(np.uint32)
                      for _ in range(self.n_buffers)]
        self._cur = 0
        self.fill = 0
        self._first_add_t: float | None = None
        self._base_ns = 0
        self.batches_emitted = 0
        self.records_emitted = 0

    def add(self, records: np.ndarray) -> list[np.ndarray]:
        out: list[np.ndarray] = []
        pos = 0
        b = self.cfg.max_batch
        compact = self.wire == schema.WIRE_COMPACT16
        while pos < len(records):
            if self.fill == 0:
                self._first_add_t = time.perf_counter()
                self._base_ns = int(records["ts_ns"][pos])
            take = min(b - self.fill, len(records) - pos)
            if compact:
                # the u16 µs delta field: seal early at the span boundary
                span_ok = (records["ts_ns"][pos: pos + take].astype(np.int64)
                           - self._base_ns) < 65_000_000
                if not span_ok.all():
                    take = max(int(span_ok.argmin()), 0)
                    if take == 0:
                        out.append(self._seal())
                        continue
            chunk = records[pos: pos + take]
            buf = self._bufs[self._cur]
            if compact:
                buf[self.fill: self.fill + take] = schema.compact_pack(
                    chunk, self._base_ns, **self.quant)
            else:
                buf[self.fill: self.fill + take] = np.ascontiguousarray(
                    chunk).view(np.uint32).reshape(take, schema.RECORD_WORDS)
            self.fill += take
            pos += take
            if self.fill == b:
                out.append(self._seal())
        return out

    def flush_due(self) -> bool:
        return (self.fill > 0 and self._first_add_t is not None
                and (time.perf_counter() - self._first_add_t) * 1e6
                >= self.cfg.deadline_us)

    def take(self) -> np.ndarray | None:
        return self._seal() if self.fill else None

    def _seal(self) -> np.ndarray:
        buf = self._bufs[self._cur]
        meta = buf[self.cfg.max_batch]
        meta[0] = self.fill
        if self.wire == schema.WIRE_COMPACT16:
            base = max(0, self._base_ns - self.t0_ns) // 1000
        else:
            base = self.t0_ns
        meta[1] = base & 0xFFFFFFFF
        meta[2] = (base >> 32) & 0xFFFFFFFF
        # rows past fill are stale from an earlier batch; n_valid masks them
        self.batches_emitted += 1
        self.records_emitted += self.fill
        self.fill = 0
        self._first_add_t = None
        self._cur = (self._cur + 1) % self.n_buffers
        return buf
