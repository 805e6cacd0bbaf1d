"""The serving engine: one device, inline record path, singles and the
megastep ladder, both wires.

Counterpart of ``flowsentryx_tpu/engine/engine.py`` — construction (the
wire rule: compact16 only for params carrying an input observer
``in_scale``, raw48 otherwise), :meth:`Engine.warm` and
:meth:`Engine.run` over the inline loop (``_run_inline``: poll -> batch
-> dispatch -> reap), with single-batch dispatch and backlog-triggered
grouping (``mega_n=N`` or ``"auto"``, compact16 only: the pending list,
``_drain_pending``, group dispatch and the merged-wire sink).  Not
ported yet: the drain ring, SLO mode, the predictive governor and the
sink thread (ROADMAP queue 1 orders what follows).

On the card every dispatch is ONE CUDA graph replay (:mod:`..ops.graph`):
:meth:`Engine.warm` captures the single step and every staged rung, and
a capture or launch failure raises — there is no eager path on the card.
On the CPU the same step functions run eagerly.  The host<->device
boundary on the card:

* a compact16 dispatch stages its sealed ``[B+1, 4]`` wire buffers into
  a pinned ``[g, B+1, 4]`` slot, copies it into the graph's static input
  with ``non_blocking=True`` and replays; a slot is reused only
  ``readback_depth + 2`` dispatches later, by which time its dispatch has
  been reaped (so its upload has completed).  On raw48 the batcher's own
  buffers are pinned and uploaded directly (no staging copy), under the
  same reuse rule;
* right after the replay, on the same stream, the ``[2K+4]`` verdict
  wire is copied into that slot's pinned host buffer and the block
  arrays with the clock (:func:`~..ops.fused.block_record`) into that
  slot's device buffer, then an event is recorded: the next replay
  overwrites the graph's static outputs, the slot copies survive until
  the dispatch is reaped;
* up to ``readback_depth`` BATCHES stay in flight (a group counts as its
  size), reaped oldest first when their event has fired (or blocking,
  when the pipe is full);
* a wire whose overflow flag is set is replaced by the slot's copy of
  the dispatch's full block arrays, so no block is lost.
"""

from __future__ import annotations

import functools
import time
from collections import deque
from typing import Any, NamedTuple

import numpy as np
import torch

from flowsentryx_tpu_torch.core import schema
from flowsentryx_tpu_torch.core.config import FsxConfig, unsupported
from flowsentryx_tpu_torch.core.device import resolve_device
from flowsentryx_tpu_torch.engine.batcher import MicroBatcher
from flowsentryx_tpu_torch.engine.writeback import (
    BlacklistUpdate, decode_verdict_wire, extract_updates,
)
from flowsentryx_tpu_torch.models import logreg
from flowsentryx_tpu_torch.models.registry import get_model
from flowsentryx_tpu_torch.ops import fused, kernels
from flowsentryx_tpu_torch.ops.graph import StepGraph

#: Idle-link backoff of the inline loop (a fraction of the deadline).
_IDLE_SLEEP_S = 50e-6

#: ``Engine(mega_n="auto")`` / ``serve --mega auto``: the largest group
#: size of the adaptive power-of-two ladder (rungs 8, 4, 2), as in the
#: reference.
MEGA_AUTO_MAX = 8

#: Graph key of the single step (rungs are keyed by their size >= 1).
_SINGLE = 0


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
    dispatch: dict


class _InFlight(NamedTuple):
    n_chunks: int          # batches in this dispatch (1, or the rung)
    wire: Any              # host [2K+4] wire tensor, None when K == 0
    blocks: torch.Tensor   # block_record of the dispatch (device or host)
    event: Any             # torch.cuda.Event behind the copies, or None


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
    the first record's timestamp, as in the reference's default.

    ``mega_n``: 0 dispatches every sealed batch singly; ``N >= 1`` groups
    a backlog of N sealed batches into one megastep dispatch; ``"auto"``
    (or ``mega_auto=True`` with a cap) stages every power-of-two rung up
    to the cap and dispatches the largest one the backlog fills.
    Grouping is dispatch granularity only: verdicts, stats, blacklist
    and table are byte-identical to singles.

    ``wire``: ``None`` picks the reference's default, compact16 only for
    params carrying an input observer (``in_scale``, the logreg
    families; bit-exact in model mode), raw48 otherwise (``mlp``,
    ``multiclass``); ``"compact16"`` for an observer-less model
    quantizes features to the minifloat wire.  Grouping needs compact16,
    as in the reference."""

    def __init__(
        self,
        cfg: FsxConfig,
        source,
        sink,
        params: Any | None = None,
        device: str | torch.device | None = None,
        mega_n: int | str = 0,
        mega_auto: bool = False,
        wire: str | None = None,
    ):
        bad = unsupported(cfg)
        if bad:
            raise ValueError("config not servable by this port: "
                             + "; ".join(bad))
        self.device = resolve_device(device)
        self.cfg = cfg
        self.source = source
        self.sink = sink
        if mega_n == "auto":
            mega_auto = True
            mega_n = MEGA_AUTO_MAX
        elif isinstance(mega_n, str):
            raise ValueError(
                f"mega_n must be an int or 'auto', got {mega_n!r}")
        self.mega_auto = bool(mega_auto)
        self.mega_n = int(mega_n)
        if self.mega_n < 0:
            raise ValueError(f"mega_n must be >= 0, got {mega_n}")
        if self.mega_auto and self.mega_n < 2:
            raise ValueError(
                "adaptive coalescing needs a group-size cap >= 2 "
                f"(got mega_n={self.mega_n})")
        if self.mega_auto:
            sizes = fused.pow2_group_sizes(self.mega_n)
        else:
            sizes = (self.mega_n,) if self.mega_n > 0 else ()
        #: Staged group sizes, largest first — the coalescing ladder.
        self._mega_sizes: tuple[int, ...] = sizes
        spec = get_model(cfg.model.name)
        if params is None:
            params = spec.init(self.device)
        # params go to the device once
        self.params = type(params)(*(t.to(self.device) for t in params))
        if wire is None:
            wire = (schema.WIRE_COMPACT16 if hasattr(self.params, "in_scale")
                    else schema.WIRE_RAW48)
        if wire not in (schema.WIRE_COMPACT16, schema.WIRE_RAW48):
            raise ValueError(f"unknown wire format {wire!r}")
        self.wire = wire
        compact = wire == schema.WIRE_COMPACT16
        if sizes and not compact:
            raise ValueError("mega_n requires the compact16 wire")
        if not compact:
            self.quant = {}          # raw48 carries the records verbatim
        elif isinstance(self.params, logreg.LogRegParams):
            # model mode: the wire carries the model's own input
            # quantization, so scores are bit-exact to the 48-byte records
            self.quant = schema.wire_quant_for(logreg.LogRegParams(
                **logreg.params_to_numpy(self.params)))
        else:
            self.quant = {"feat_mode": "minifloat"}
        self.verdict_k = cfg.batch.verdict_k
        # the int8 scorer's kernel arguments and output table, packed once
        self.score_params = None
        classify = spec.classify_batch
        if classify is kernels.score_int8:
            self.score_params = kernels.pack_score_params(self.params)
            classify = functools.partial(classify, packed=self.score_params)
        if compact:
            self.step = fused.make_compact_step(cfg, classify, **self.quant)
        else:
            self.step = fused.make_raw_step(cfg, classify)
        self._words = (schema.COMPACT_RECORD_WORDS if compact
                       else schema.RECORD_WORDS)
        self.megasteps = (fused.make_compact_megastep_family(
            cfg, classify, sizes, **self.quant) if sizes else {})
        # in place, and captured by address on the card: never rebound
        self.table = schema.make_table(cfg.table.capacity, self.device)
        self.stats = schema.make_stats(self.device)
        self.readback_depth = cfg.batch.readback_depth
        #: Sealed-but-undispatched wire buffers (group candidates).
        self._pending: list[np.ndarray] = []
        #: How many pending batches the loop accumulates before the
        #: coalescing policy must fire: one top-rung group.
        self._pending_cap = self.mega_n
        # a batcher buffer may be reused only after its batch is staged:
        # keep more buffers than in-flight batches + the pending group
        self._cuda = self.device.type == "cuda"
        self.batcher = MicroBatcher(
            cfg.batch, n_buffers=self.readback_depth + 2 + self._pending_cap,
            quant=self.quant, wire=wire, pinned=self._cuda and not compact)
        self._t0_auto = True
        b = cfg.batch.max_batch
        self._group_max = max(sizes, default=1)
        # per-dispatch slots, reused readback_depth + 2 dispatches later:
        # compact16 staging rows (pinned on the card; raw48 uploads from
        # the batcher's pinned buffers), and on the card the copies of
        # the graph outputs that must outlive the next replay
        n_slots = self.readback_depth + 2
        self._n_slots = n_slots
        self._stage = [torch.empty(
            (self._group_max, b + 1, self._words),
            dtype=torch.int32, pin_memory=self._cuda)
            for _ in range(n_slots if compact else 0)]
        self._stage_np = [s.numpy().view(np.uint32) for s in self._stage]
        rec_words = self._group_max * (2 * b + 1)
        if self._cuda:
            k = self.verdict_k
            self._wire_host = ([torch.empty(fused.verdict_wire_words(k),
                                            dtype=torch.int32,
                                            pin_memory=True)
                                for _ in range(n_slots)] if k else [])
            # with a wire the block record is read only on overflow, so
            # it stays on the device; without one it is always fetched
            self._blocks_slot = [
                torch.empty(rec_words, dtype=torch.int32, device=self.device)
                if k else torch.empty(rec_words, dtype=torch.int32,
                                      pin_memory=True)
                for _ in range(n_slots)]
        #: Captured graphs on the card: ``_SINGLE`` and each rung size.
        self._graphs: dict[int, StepGraph] = {}
        self._n_dispatched = 0
        self._inflight: deque[_InFlight] = deque()
        self._blocked: set[int] = set()
        self._device_now = 0.0
        self._timers = {k: _StageTimer() for k in ("fill", "step", "sink")}
        self._d2h_bytes = 0
        self._sink_compact = 0
        self._sink_fallback = 0
        self._sunk_batches = 0
        #: Dispatches per group size since warm() (singles under 1).
        self._group_hist: dict[int, int] = {}

    # -- graphs --------------------------------------------------------------

    def _capture(self) -> None:
        """Build the kernels and capture the single step and every
        staged rung (the reference's ``warm()`` compiling every rung)."""
        kernels.build_all()
        b = self.cfg.batch.max_batch
        words = self._words
        self._graphs[_SINGLE] = StepGraph(
            self.step, self.table, self.stats, self.params,
            (b + 1, words))
        for g, mega in self.megasteps.items():
            self._graphs[g] = StepGraph(
                mega, self.table, self.stats, self.params,
                (g, b + 1, words))

    # -- dispatch and reap ---------------------------------------------------

    def _launch(self, rung: int, raws: list[np.ndarray]) -> None:
        """One dispatch: the single step (``rung == _SINGLE``) over
        ``raws[0]``, or the rung-``len(raws)`` megastep over the group."""
        t = time.perf_counter()
        n = max(rung, 1)
        n_slots = self._n_slots
        # a slot is free once the dispatch that used it is sunk; the
        # batch-counted reaps keep this a no-op except at exit flushes
        while len(self._inflight) > n_slots - 2:
            self._sink_one(self._inflight.popleft())
        slot = self._n_dispatched % n_slots
        if self._stage:
            rows = self._stage_np[slot]
            for i, raw in enumerate(raws):
                rows[i] = raw
            stage = self._stage[slot]
            x = stage[0] if rung == _SINGLE else stage[:n]
        else:
            # raw48 (singles only): the sealed batcher buffer itself
            x = torch.from_numpy(raws[0].view(np.int32))
        if self._cuda:
            gr = self._graphs[rung]
            gr.input.copy_(x, non_blocking=True)
            gr.replay()
            wire = None
            if self.verdict_k:
                wire = self._wire_host[slot]
                wire.copy_(gr.out.wire, non_blocking=True)
            blocks = self._blocks_slot[slot][:gr.keep.shape[0]]
            blocks.copy_(gr.keep, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
        else:
            fn = self.step if rung == _SINGLE else self.megasteps[rung]
            _, _, out = fn(self.table, self.stats, self.params, x)
            wire, blocks, event = out.wire, fused.block_record(out), None
        self._n_dispatched += 1
        self._group_hist[n] = self._group_hist.get(n, 0) + 1
        self._inflight.append(_InFlight(n, wire, blocks, event))
        self._timers["step"].add(time.perf_counter() - t)

    def _dispatch(self, raw: np.ndarray) -> None:
        self._launch(_SINGLE, [raw])

    def _dispatch_mega(self, group: list[np.ndarray]) -> None:
        """Group dispatch of pending buffers: staged into one slot, one
        megastep (one graph replay on the card)."""
        self._launch(len(group), group)

    def _drain_pending(self, short: bool) -> None:
        """Apply the coalescing ladder to the pending list.

        Full TOP-rung groups always dispatch (a deep backlog keeps
        amortization maximal); a short poll — no backlog left behind the
        pending batches — flushes the remainder greedily through the
        largest rung it still fills, then singles.  With a fixed
        ``mega_n`` the ladder is one rung: all or nothing."""
        top = self._mega_sizes[0]
        while len(self._pending) >= top:
            self._dispatch_mega(self._pending[:top])
            del self._pending[:top]
            self._reap(self.readback_depth)
        if not self._pending or not short:
            return
        while self._pending:
            g = fused.rung_for_volume(len(self._pending), self._mega_sizes)
            if g > 1:
                self._dispatch_mega(self._pending[:g])
                del self._pending[:g]
            else:
                self._dispatch(self._pending.pop(0))
            self._reap(self.readback_depth)

    def _sink_one(self, g: _InFlight) -> None:
        t = time.perf_counter()
        if g.event is not None:
            g.event.synchronize()
        if self.verdict_k:
            wire = g.wire.numpy()
            self._d2h_bytes += wire.nbytes
            vw = decode_verdict_wire(wire)
            if vw.overflow:
                # more newly-blocked flows than wire slots: take this
                # dispatch's full block arrays so no block is lost
                keys, untils, _ = fused.split_block_record(
                    g.blocks.cpu().numpy(), g.n_chunks)
                self._d2h_bytes += keys.nbytes + untils.nbytes
                self._sink_fallback += 1
                upd = extract_updates(keys, untils)
            else:
                self._sink_compact += 1
                upd = BlacklistUpdate(key=vw.key, until_s=vw.until_s)
            now = vw.now
        else:
            keys, untils, nows = fused.split_block_record(
                g.blocks.numpy(), g.n_chunks)
            self._d2h_bytes += keys.nbytes + untils.nbytes
            self._sink_fallback += 1
            upd = extract_updates(keys, untils)
            now = float(nows.max())
        self.sink.apply(upd)
        self._blocked.update(upd.key.tolist())
        self._device_now = max(self._device_now, now)
        self._sunk_batches += g.n_chunks
        self._timers["sink"].add(time.perf_counter() - t)

    def _reap(self, down_to: int) -> None:
        """At most ``down_to`` BATCHES stay in flight (blocking).  Counted
        in batches, not dispatches: a group of g counts g, or grouping
        would multiply the configured pipe depth."""
        total = sum(g.n_chunks for g in self._inflight)
        while self._inflight and total > down_to:
            g = self._inflight.popleft()
            total -= g.n_chunks
            self._sink_one(g)

    def _reap_ready(self) -> None:
        """Sink every dispatch the device has already finished, oldest
        first."""
        while self._inflight and (self._inflight[0].event is None
                                  or self._inflight[0].event.query()):
            self._sink_one(self._inflight.popleft())

    # -- lifecycle -----------------------------------------------------------

    def warm(self) -> None:
        """On the card, build the kernels and capture the single step
        and every staged rung; then run one all-masked batch through the
        single step and each rung (n_valid = 0: table, stats and
        verdicts are unchanged), so neither the build, the capture nor
        first-launch setup lands in the first served window.  Must not
        be called with batches in flight."""
        if self._cuda and not self._graphs:
            self._capture()
        warm = np.zeros((self.cfg.batch.max_batch + 1, self._words),
                        np.uint32)
        self._dispatch(warm)
        self._reap(0)
        for g in self._mega_sizes:
            self._dispatch_mega([warm] * g)
            self._reap(0)
        self._sunk_batches = self._sink_compact = self._sink_fallback = 0
        self._d2h_bytes = 0
        self._timers = {k: _StageTimer() for k in self._timers}
        self._group_hist = {}
        if self._cuda:
            torch.cuda.synchronize(self.device)

    def run(self, max_batches: int | None = None,
            max_seconds: float | None = None) -> EngineReport:
        """Serve until the source is exhausted or a bound trips."""
        if self._cuda and not self._graphs:
            self._capture()
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
            # grouping polls up to the remaining group capacity, so a
            # deep source backlog seals several batches in one poll
            group_room = max(self._pending_cap - len(self._pending), 1)
            requested = group_room * cfg_b.max_batch - self.batcher.fill
            records = self.source.poll(requested)
            n_polled = len(records)
            if self._t0_auto and n_polled:
                self.batcher.t0_ns = int(records["ts_ns"][0])
                self._t0_auto = False
            sealed = self.batcher.add(records) if n_polled else []
            # deadline flush only into an idle pipe
            if not sealed and not self._inflight and self.batcher.flush_due():
                sealed = [self.batcher.take()]
            self._timers["fill"].add(time.perf_counter() - t)
            if self.mega_n > 0:
                # backlog-triggered grouping: a short poll (no backlog
                # behind the pending batches) flushes them down the ladder
                self._pending.extend(sealed)
                self._drain_pending(short=n_polled < requested)
            else:
                for raw in sealed:
                    self._dispatch(raw)
                    self._reap(self.readback_depth)
            self._reap_ready()
            if not sealed and self.source.exhausted():
                if self.batcher.fill:
                    self._dispatch(self.batcher.take())
                break
            if not sealed and not n_polled and not self._inflight:
                time.sleep(_IDLE_SLEEP_S)
        # a bounded exit can leave sealed group candidates pending: their
        # records are already counted, so dispatch them singly
        for raw in self._pending:
            self._dispatch(raw)
            self._reap(self.readback_depth)
        self._pending.clear()
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
        dispatches = sum(self._group_hist.values())
        dispatch = {
            "wire": self.wire,
            "mode": ("adaptive" if self.mega_auto
                     else "fixed" if self.mega_n else "single"),
            "mega_n": self.mega_n,
            "group_sizes": list(self._mega_sizes),
            "group_hist": {str(g): n for g, n in
                           sorted(self._group_hist.items())},
            "dispatches": dispatches,
            "dispatch_hz": round(dispatches / max(wall, 1e-9), 1),
            # captured CUDA graphs (single + rungs); 0 on the CPU
            "graphs": len(self._graphs),
        }
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
            dispatch=dispatch,
        )
