"""The serving engine, minimal: one device, inline record path, singles.

Counterpart of ``flowsentryx_tpu/engine/engine.py`` — construction,
:meth:`Engine.warm` and :meth:`Engine.run` over the inline loop
(``_run_inline``: poll -> batch -> dispatch -> reap), with single-batch
dispatch only (no mega groups, drain ring, SLO mode or sink thread yet;
ROADMAP queue 1 orders what follows).

The host<->device boundary on the card:

* each sealed ``[B+1, 4]`` wire buffer is copied into a pinned staging
  slot and uploaded with ``non_blocking=True``; a slot is reused only
  ``readback_depth + 2`` dispatches later, by which time its batch has
  been reaped (so its upload has completed);
* each step's ``[2K+4]`` verdict wire is copied back into pinned host
  memory with ``non_blocking=True`` and an event is recorded behind it;
  up to ``readback_depth`` batches stay in flight, reaped oldest first
  when their event has fired (or blocking, when the pipe is full);
* a wire whose overflow flag is set is replaced by a fetch of that
  batch's full ``block_key``/``block_until`` arrays, so no block is lost.
"""

from __future__ import annotations

import functools
import time
from collections import deque
from typing import Any, NamedTuple

import numpy as np
import torch

from flowsentryx_tpu_torch.core import schema
from flowsentryx_tpu_torch.core.config import FsxConfig
from flowsentryx_tpu_torch.core.device import resolve_device
from flowsentryx_tpu_torch.engine.batcher import MicroBatcher
from flowsentryx_tpu_torch.engine.writeback import (
    BlacklistUpdate, decode_verdict_wire, extract_updates,
)
from flowsentryx_tpu_torch.models import logreg
from flowsentryx_tpu_torch.models.registry import get_model
from flowsentryx_tpu_torch.ops import fused, kernels

#: Idle-link backoff of the inline loop (a fraction of the deadline).
_IDLE_SLEEP_S = 50e-6


class EngineReport(NamedTuple):
    batches: int
    records: int
    wall_s: float
    records_per_s: float
    stats: dict
    stages_ms: dict
    blocked_sources: int
    table: dict
    readback: dict
    device: dict


class _InFlight(NamedTuple):
    out: fused.StepOutput
    host: tuple            # host copies of the wire (or block arrays)
    event: Any             # torch.cuda.Event behind the D2H copy, or None


class _StageTimer:
    """Host wall per pipeline stage (``EngineReport.stages_ms``)."""

    def __init__(self) -> None:
        self.total = 0.0
        self.n = 0

    def add(self, dt: float) -> None:
        self.total += dt
        self.n += 1

    def to_dict(self) -> dict:
        return {"n": self.n, "total_ms": round(self.total * 1e3, 3),
                "mean_ms": round(self.total * 1e3 / max(self.n, 1), 4)}


class Engine:
    """Owns the device state (table, stats, params) and runs the loop.

    ``device=None`` is the card and raises without one; pass
    ``device="cpu"`` for the plain-PyTorch path.  The stream epoch is
    the first record's timestamp, as in the reference's default."""

    def __init__(
        self,
        cfg: FsxConfig,
        source,
        sink,
        params: Any | None = None,
        device: str | torch.device | None = None,
    ):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.source = source
        self.sink = sink
        spec = get_model(cfg.model.name)
        if params is None:
            params = spec.init(self.device)
        self.params = logreg.LogRegParams(
            *(t.to(self.device) for t in params))
        # compact16 in model mode: the wire carries the model's own input
        # quantization, so scores are bit-exact to the 48-byte records
        host_params = logreg.LogRegParams(**logreg.params_to_numpy(
            self.params))
        self.quant = schema.wire_quant_for(host_params)
        self.verdict_k = cfg.batch.verdict_k
        # the scorer's kernel arguments and output table, packed once
        self.score_params = kernels.pack_score_params(self.params)
        self.step = fused.make_compact_step(
            cfg, functools.partial(spec.classify_batch,
                                   packed=self.score_params), **self.quant)
        self.table = schema.make_table(cfg.table.capacity, self.device)
        self.stats = schema.make_stats(self.device)
        self.readback_depth = cfg.batch.readback_depth
        n_slots = self.readback_depth + 2
        self.batcher = MicroBatcher(cfg.batch, n_buffers=n_slots,
                                    quant=self.quant)
        self._t0_auto = True
        self._cuda = self.device.type == "cuda"
        b = cfg.batch.max_batch
        self._upload = ([torch.empty((b + 1, schema.COMPACT_RECORD_WORDS),
                                     dtype=torch.int32, pin_memory=True)
                         for _ in range(n_slots)] if self._cuda else [])
        self._n_dispatched = 0
        self._inflight: deque[_InFlight] = deque()
        self._blocked: set[int] = set()
        self._device_now = 0.0
        self._timers = {k: _StageTimer() for k in ("fill", "step", "sink")}
        self._d2h_bytes = 0
        self._sink_compact = 0
        self._sink_fallback = 0
        self._sunk_batches = 0

    # -- dispatch and reap ---------------------------------------------------

    def _to_device(self, raw: np.ndarray) -> torch.Tensor:
        host = schema.wire_to_tensor(raw)
        if not self._cuda:
            return host
        slot = self._upload[self._n_dispatched % len(self._upload)]
        slot.copy_(host)
        return slot.to(self.device, non_blocking=True)

    def _dispatch(self, raw: np.ndarray) -> None:
        t = time.perf_counter()
        dev = self._to_device(raw)
        self.table, self.stats, out = self.step(self.table, self.stats,
                                                self.params, dev)
        arrays = ((out.wire,) if out.wire is not None
                  else (out.block_key, out.block_until))
        event = None
        if self._cuda:
            host = tuple(torch.empty(a.shape, dtype=a.dtype, pin_memory=True)
                         for a in arrays)
            for h, a in zip(host, arrays):
                h.copy_(a, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
        else:
            host = arrays
        self._n_dispatched += 1
        self._inflight.append(_InFlight(out, host, event))
        self._timers["step"].add(time.perf_counter() - t)

    def _sink_one(self, g: _InFlight) -> None:
        t = time.perf_counter()
        if g.event is not None:
            g.event.synchronize()
        if self.verdict_k:
            wire = g.host[0].numpy()
            self._d2h_bytes += wire.nbytes
            vw = decode_verdict_wire(wire)
            if vw.overflow:
                # more newly-blocked flows than wire slots: fetch the
                # full arrays for this batch so no block is lost
                keys = g.out.block_key.cpu().numpy()
                untils = g.out.block_until.cpu().numpy()
                self._d2h_bytes += keys.nbytes + untils.nbytes
                self._sink_fallback += 1
                upd = extract_updates(keys, untils)
            else:
                self._sink_compact += 1
                upd = BlacklistUpdate(key=vw.key, until_s=vw.until_s)
            now = vw.now
        else:
            keys, untils = (h.numpy() for h in g.host)
            self._d2h_bytes += keys.nbytes + untils.nbytes
            self._sink_fallback += 1
            upd = extract_updates(keys, untils)
            now = float(g.out.now.cpu())
        self.sink.apply(upd)
        self._blocked.update(upd.key.tolist())
        self._device_now = max(self._device_now, now)
        self._sunk_batches += 1
        self._timers["sink"].add(time.perf_counter() - t)

    def _reap(self, down_to: int) -> None:
        """At most ``down_to`` batches stay in flight (blocking)."""
        while len(self._inflight) > down_to:
            self._sink_one(self._inflight.popleft())

    def _reap_ready(self) -> None:
        """Sink every batch the device has already finished, oldest first."""
        while self._inflight and (self._inflight[0].event is None
                                  or self._inflight[0].event.query()):
            self._sink_one(self._inflight.popleft())

    # -- lifecycle -----------------------------------------------------------

    def warm(self) -> None:
        """Build the kernels and run one all-masked batch through the
        step (n_valid = 0: table, stats and verdicts are unchanged), so
        neither the ``nvcc`` build nor first-launch setup lands in the
        first served window.  Must not be called with batches in flight."""
        if self._cuda:
            kernels.build_all()
        warm = np.zeros((self.cfg.batch.max_batch + 1,
                         schema.COMPACT_RECORD_WORDS), np.uint32)
        self._dispatch(warm)
        self._reap(0)
        self._sunk_batches = self._sink_compact = self._sink_fallback = 0
        self._d2h_bytes = 0
        self._timers = {k: _StageTimer() for k in self._timers}
        if self._cuda:
            torch.cuda.synchronize(self.device)

    def run(self, max_batches: int | None = None,
            max_seconds: float | None = None) -> EngineReport:
        """Serve until the source is exhausted or a bound trips."""
        t_start = time.perf_counter()
        cfg_b = self.cfg.batch

        def bounded() -> bool:
            if (max_batches is not None
                    and self.batcher.batches_emitted >= max_batches):
                return True
            return (max_seconds is not None
                    and time.perf_counter() - t_start >= max_seconds)

        while not bounded():
            t = time.perf_counter()
            records = self.source.poll(cfg_b.max_batch - self.batcher.fill)
            if self._t0_auto and len(records):
                self.batcher.t0_ns = int(records["ts_ns"][0])
                self._t0_auto = False
            sealed = self.batcher.add(records) if len(records) else []
            # deadline flush only into an idle pipe
            if not sealed and not self._inflight and self.batcher.flush_due():
                sealed = [self.batcher.take()]
            self._timers["fill"].add(time.perf_counter() - t)
            for raw in sealed:
                self._dispatch(raw)
                self._reap(self.readback_depth)
            self._reap_ready()
            if not sealed and self.source.exhausted():
                if self.batcher.fill:
                    self._dispatch(self.batcher.take())
                break
            if not sealed and not len(records) and not self._inflight:
                time.sleep(_IDLE_SLEEP_S)
        self._reap(0)
        return self._build_report(time.perf_counter() - t_start)

    def _build_report(self, wall: float) -> EngineReport:
        table_sum = kernels.table_summary(self.table, now=self._device_now,
                                          stale_s=self.cfg.table.stale_s)
        k = self.verdict_k
        readback = {
            "mode": "compact" if k else "full",
            "k_max": k,
            "wire_bytes": fused.verdict_wire_words(k) * 4 if k else None,
            "compact_sinks": self._sink_compact,
            "fallback_sinks": self._sink_fallback,
            "d2h_bytes": self._d2h_bytes,
            "bytes_per_batch": round(
                self._d2h_bytes / max(self._sunk_batches, 1), 1),
        }
        device = {"type": self.device.type,
                  "name": (torch.cuda.get_device_name(self.device)
                           if self._cuda else "cpu")}
        return EngineReport(
            batches=self.batcher.batches_emitted,
            records=self.batcher.records_emitted,
            wall_s=round(wall, 4),
            records_per_s=round(
                self.batcher.records_emitted / max(wall, 1e-9), 1),
            stats=self.stats.to_dict(),
            stages_ms={k: t.to_dict() for k, t in self._timers.items()},
            blocked_sources=len(self._blocked),
            table=table_sum,
            readback=readback,
            device=device,
        )
