"""Size- and deadline-triggered micro-batcher.

Counterpart of ``flowsentryx_tpu/engine/batcher.py`` (``add``,
``add_precompact``, ``note_poll``, the deadline trigger, ``take``), for
both wires.  Records accumulate in preallocated wire buffers whose row
``B`` is the metadata row; a batch seals at ``max_batch`` records or at
the deadline.

* ``raw48``: records copied verbatim as ``[B+1, 12]`` uint32, one memcpy
  per poll chunk and no per-record work; the metadata row carries the
  stream epoch ``t0``.  With ``pinned=True`` the buffers are page-locked
  host memory (a CUDA engine uploads straight from them).
* ``compact16``: records quantized on the way in as ``[B+1, 4]`` uint32;
  a batch also seals early where its record span would overflow the
  16-bit µs delta field.  ``add_precompact`` takes records a compact-emit
  data plane already quantized and only rebases their timestamps.

numpy only (torch is imported only for ``pinned=True``): the spawned
ingest workers build their batchers from this module without torch.
"""

from __future__ import annotations

import time
from collections import deque

import numpy as np

from flowsentryx_tpu_torch.core import wire as schema
from flowsentryx_tpu_torch.core.config import BatchConfig

#: A poll gap past this makes the 16-bit kernel stamps of the next
#: drain ambiguous (they wrap every 65.536 ms): counted, not corrected.
WRAP_RISK_GAP_S = 0.050


class MicroBatcher:
    """``add()`` returns the wire buffers an addition completed;
    ``flush_due()`` is the deadline trigger; ``take()`` seals whatever is
    pending.  A buffer is reused after ``n_buffers`` further seals, so the
    engine keeps at least that many batches' worth of headroom.

    ``on_seal``, when given to ``add``/``add_precompact``, receives each
    buffer the moment it seals (and the call returns ``[]``): a consumer
    that copies every sealed buffer out right away (an ingest worker) is
    then safe with two buffers however many batches one call seals.
    ``pop_seal_time()`` gives, per sealed buffer and oldest first, the
    ``perf_counter`` time its first record arrived."""

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
        if pinned:
            import torch

            self._bufs = [torch.zeros((b + 1, words), dtype=torch.int32,
                                      pin_memory=True).numpy().view(np.uint32)
                          for _ in range(self.n_buffers)]
        else:
            self._bufs = [np.zeros((b + 1, words), np.uint32)
                          for _ in range(self.n_buffers)]
        self._cur = 0
        self.fill = 0
        self._first_add_t: float | None = None
        self._base_ns = 0
        self._seal_times: deque[float] = deque(maxlen=self.n_buffers)
        self.batches_emitted = 0
        self.records_emitted = 0
        #: Drains whose preceding poll gap made the 16-bit kernel-stamp
        #: unwrap ambiguous (``add_precompact``); in the engine report.
        self.ts_wrap_risk_polls = 0
        self._last_poll_t: float | None = None

    def add(self, records: np.ndarray, on_seal=None) -> list[np.ndarray]:
        return self._fill(records, records["ts_ns"], on_seal, precompact=False)

    def add_precompact(self, records: np.ndarray,
                       on_seal=None) -> list[np.ndarray]:
        """Append KERNEL-quantized compact records
        (``COMPACT_RECORD_DTYPE``, from a compact-emit data plane):
        features pass through untouched; word 3's wrapped µs stamp is
        unwrapped against ``CLOCK_MONOTONIC`` and rebased to the batch
        base.  Requires the compact16 wire."""
        if self.wire != schema.WIRE_COMPACT16:
            raise ValueError("add_precompact requires the compact16 wire")
        if not len(records):
            return []
        # the stamps wrap every 65.536 ms: a drain after a long gap (an
        # engine stall, not a traffic lull — empty polls are noted too)
        # may hold records older than one wrap, which unwrap too late
        if self.note_poll() > WRAP_RISK_GAP_S:
            self.ts_wrap_risk_polls += 1
        now = time.clock_gettime_ns(time.CLOCK_MONOTONIC)
        ts_ns = schema.unwrap_kernel_ts16(records["w3"], now)
        return self._fill(records, ts_ns, on_seal, precompact=True)

    def note_poll(self) -> float:
        """Record a drain opportunity (a source poll, empty or not) and
        return the gap since the previous one — the cadence input to
        ``add_precompact``'s wrap-risk count."""
        t = time.perf_counter()
        gap = 0.0 if self._last_poll_t is None else t - self._last_poll_t
        self._last_poll_t = t
        return gap

    def _fill(self, records, ts_ns, on_seal, precompact: bool):
        out: list[np.ndarray] = []

        def sealed():
            buf = self._seal()
            if on_seal is None:
                out.append(buf)
            else:
                on_seal(buf)

        pos = 0
        b = self.cfg.max_batch
        compact = self.wire == schema.WIRE_COMPACT16
        while pos < len(records):
            if self.fill == 0:
                self._first_add_t = time.perf_counter()
                self._base_ns = int(ts_ns[pos])
            take = min(b - self.fill, len(records) - pos)
            if compact:
                # the u16 µs delta field: seal early at the span boundary
                span_ok = (ts_ns[pos: pos + take].astype(np.int64)
                           - self._base_ns) < 65_000_000
                if not span_ok.all():
                    take = max(int(span_ok.argmin()), 0)
                    if take == 0:
                        sealed()
                        continue
            chunk = records[pos: pos + take]
            rows = self._bufs[self._cur][self.fill: self.fill + take]
            if precompact:
                dt_us = np.clip(
                    (ts_ns[pos: pos + take].astype(np.int64) - self._base_ns)
                    // 1000, 0, schema.RANGE_DT_US_MAX).astype(np.uint32)
                rows[:, 0] = chunk["w0"]
                rows[:, 1] = chunk["w1"]
                rows[:, 2] = chunk["w2"]
                rows[:, 3] = (chunk["w3"] & np.uint32(0xFFFF)) | (dt_us << 16)
            elif compact:
                rows[:] = schema.compact_pack(chunk, self._base_ns,
                                              **self.quant)
            else:
                rows[:] = np.ascontiguousarray(chunk).view(
                    np.uint32).reshape(take, schema.RECORD_WORDS)
            self.fill += take
            pos += take
            if self.fill == b:
                sealed()
        return out

    def flush_due(self) -> bool:
        return (self.fill > 0 and self._first_add_t is not None
                and (time.perf_counter() - self._first_add_t) * 1e6
                >= self.cfg.deadline_us)

    def pending_age_s(self) -> float:
        """Age of the oldest unsealed record (0.0 when nothing is
        pending): the engine's latency-budget mode bounds the batcher's
        residency with it, beside :meth:`flush_due`'s fixed deadline."""
        if self.fill == 0 or self._first_add_t is None:
            return 0.0
        return time.perf_counter() - self._first_add_t

    def take(self) -> np.ndarray | None:
        return self._seal() if self.fill else None

    def pop_seal_time(self) -> float:
        """First-record arrival time of the oldest unclaimed sealed
        buffer."""
        return self._seal_times.popleft()

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
        self._seal_times.append(self._first_add_t or time.perf_counter())
        self.fill = 0
        self._first_add_t = None
        self._cur = (self._cur + 1) % self.n_buffers
        return buf
