"""The serving engine: one device, both wires, singles and the megastep
ladder, fed inline from records or by sealed-batch ingest workers.

Counterpart of ``flowsentryx_tpu/engine/engine.py`` — construction (the
wire rule: compact16 for params carrying an input observer ``in_scale``
or for a compact-emit source, raw48 otherwise), :meth:`Engine.warm` and
:meth:`Engine.run` over the inline record loop (``_run_inline``: poll ->
batch -> dispatch -> reap) or the sealed-batch loop (``_run_sealed``:
stage -> dispatch -> reap, for :class:`~flowsentryx_tpu_torch.ingest
.ShardedIngest`), single-batch dispatch and backlog-triggered grouping
(``mega_n=N`` or ``"auto"``, compact16 only), and
:meth:`Engine.checkpoint` / :meth:`Engine.restore`.  Not ported yet: the
drain ring, SLO mode, the predictive governor and the sink thread
(ROADMAP queue 1 orders what follows).

On the card every dispatch is ONE CUDA graph replay (:mod:`..ops.graph`):
:meth:`Engine.warm` captures the single step and every staged rung, and
a capture or launch failure raises — there is no eager path on the card.
On the CPU the same step functions run eagerly.  The host<->device
boundary on the card:

* a compact16 batch (and every sealed batch) is copied once into a slot
  of the pinned dispatch arena (:mod:`.arena`; from the batcher buffer,
  or from the shm queue slot view, which is released right after that
  copy), and a dispatch uploads the contiguous ``[g, B+1, words]`` slice
  into the graph's static input with ``non_blocking=True`` and replays.
  A slot is claimed again only after the event of the last dispatch
  staged in it has fired, so its upload is complete (with at most
  ``readback_depth`` batches in flight and ``readback_depth + 2`` slots
  that wait is a no-op).  Inline raw48 uploads straight from the
  batcher's pinned buffers, reused ``readback_depth + 2`` seals later;
* right after the replay, on the same stream, the ``[2K+4]`` verdict
  wire is copied into that dispatch's pinned host buffer and the block
  arrays with the clock (:func:`~..ops.fused.block_record`) into its
  device buffer, then an event is recorded: the next replay overwrites
  the graph's static outputs, the copies survive until the dispatch is
  reaped;
* up to ``readback_depth`` BATCHES stay in flight (a group counts as its
  size), reaped oldest first when their event has fired (or blocking,
  when the pipe is full);
* a wire whose overflow flag is set is replaced by the dispatch's copy
  of its full block arrays, so no block is lost.

The table and stats are captured into every graph by address, so
:meth:`Engine.restore` copies a checkpoint INTO them rather than
rebinding them (the reference rebinds).
"""

from __future__ import annotations

import functools
import sys
import time
from collections import deque
from typing import Any, NamedTuple

import numpy as np
import torch

from flowsentryx_tpu_torch.core import schema
from flowsentryx_tpu_torch.core.config import FsxConfig, unsupported
from flowsentryx_tpu_torch.core.device import resolve_device
from flowsentryx_tpu_torch.engine import checkpoint as ckpt
from flowsentryx_tpu_torch.engine import table as tbl
from flowsentryx_tpu_torch.engine.arena import DispatchArena
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
    #: Sharded-ingest block (per-worker batches, records, seq gaps,
    #: drops, refused slots); None on the inline record path.
    ingest: dict | None = None
    #: Compact-emit drains whose poll gap made the 16-bit kernel stamps
    #: ambiguous (``MicroBatcher.add_precompact``).
    ts_wrap_risk_polls: int = 0


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
    ``device="cpu"`` for the plain-PyTorch path.  ``t0_ns`` fixes the
    stream epoch; None takes the first record's timestamp, as in the
    reference.  A sink with a ``t0_ns`` attribute (the verdict ring's)
    is given the epoch at construction when it is explicit, else at the
    first record.

    ``source``: a record source (``poll``/``exhausted``); one with
    ``precompact = True`` delivers the kernel's 16-byte compact records
    and forces the compact16 wire with minifloat features; one with
    ``provides_sealed = True`` (:class:`~flowsentryx_tpu_torch.ingest
    .ShardedIngest`) delivers sealed batches and is started here, with
    this engine's wire and quantizer.

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
        t0_ns: int | None = None,
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
        # a compact-emit data plane (fsxd --compact) delivers records the
        # kernel already quantized to the minifloat wire: the engine
        # speaks compact16/minifloat whatever was asked for
        self.precompact = bool(getattr(source, "precompact", False))
        if self.precompact:
            wire = schema.WIRE_COMPACT16
        elif wire is None:
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
        elif self.precompact:
            self.quant = {"feat_mode": "minifloat"}
            if hasattr(self.params, "in_scale"):
                print("fsx engine: compact-emit data plane delivers "
                      "kernel-quantized minifloat features (<=6.25% "
                      "relative error); the artifact's own input observer "
                      "is bypassed. Serve a 48B plane for bit-exact "
                      "model-mode quantization.", file=sys.stderr)
        elif isinstance(self.params, logreg.LogRegParams):
            # model mode: the wire carries the model's own input
            # quantization, so scores are bit-exact to the 48-byte records
            self.quant = schema.wire_quant_for(logreg.LogRegParams(
                **logreg.params_to_numpy(self.params)))
        else:
            self.quant = {"feat_mode": "minifloat"}
            print("fsx engine: params expose no input observer; compact16 "
                  "wire uses minifloat feature quantization (<=6.25% "
                  "relative error). Pass wire='raw48' for full fidelity.",
                  file=sys.stderr)
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
            cfg.batch, t0_ns=t0_ns or 0,
            n_buffers=self.readback_depth + 2 + self._pending_cap,
            quant=self.quant, wire=wire, pinned=self._cuda and not compact)
        self._t0_auto = t0_ns is None
        if t0_ns is not None and hasattr(sink, "t0_ns"):
            sink.t0_ns = t0_ns   # sinks translate engine seconds to ns
        # sealed-batch sources deliver finished wire buffers: the fleet
        # starts HERE, once the wire and quantizer are fixed, so the
        # workers seal exactly as the inline path would
        self.sealed = bool(getattr(source, "provides_sealed", False))
        if self.sealed:
            source.start(cfg.batch, self.wire, self.quant or None)
        b = cfg.batch.max_batch
        self._group_max = max(sizes, default=1)
        # per-dispatch output slots, reused readback_depth + 2 dispatches
        # later: on the card the copies of the graph outputs that must
        # outlive the next replay
        n_slots = self.readback_depth + 2
        self._n_slots = n_slots
        # the dispatch arena: pinned staging rows on the card (compact16
        # dispatches and every sealed batch; inline raw48 uploads from
        # the batcher's pinned buffers).  Sealed loops stage a few
        # batches per slot even for singles.
        self._arena = (DispatchArena(
            DispatchArena.ring_safe_slots(self.readback_depth, 1),
            max(self._group_max, 4) if self.sealed else self._group_max,
            b, self._words, pinned=self._cuda)
            if compact or self.sealed else None)
        #: Per arena slot, the event of the last dispatch staged in it:
        #: the slot is claimed again only once it has fired.
        self._arena_event: list = [None] * (self._arena.slots
                                            if self._arena else 0)
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
        self._restore_fallbacks = 0
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

    def _claim(self) -> int:
        """The next arena slot, once the last dispatch staged in it has
        finished reading it (its event fired: the upload is complete)."""
        slot = self._arena.claim()
        ev = self._arena_event[slot]
        if ev is not None:
            ev.synchronize()
            self._arena_event[slot] = None
        return slot

    def _launch(self, rung: int, x: torch.Tensor,
                arena_slot: int | None = None) -> None:
        """One dispatch of the staged ``x``: the single step
        (``rung == _SINGLE``, ``x`` one ``[B+1, words]`` batch) or the
        rung-``g`` megastep (``x`` ``[g, B+1, words]``).  ``arena_slot``
        is the arena slot ``x`` lies in, gated by this dispatch's
        event."""
        t = time.perf_counter()
        n = max(rung, 1)
        n_slots = self._n_slots
        # an output slot is free once the dispatch that used it is sunk;
        # the batch-counted reaps keep this a no-op except at exit flushes
        while len(self._inflight) > n_slots - 2:
            self._sink_one(self._inflight.popleft())
        slot = self._n_dispatched % n_slots
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
            if arena_slot is not None:
                self._arena_event[arena_slot] = event
        else:
            fn = self.step if rung == _SINGLE else self.megasteps[rung]
            _, _, out = fn(self.table, self.stats, self.params, x)
            wire, blocks, event = out.wire, fused.block_record(out), None
        self._n_dispatched += 1
        self._group_hist[n] = self._group_hist.get(n, 0) + 1
        self._inflight.append(_InFlight(n, wire, blocks, event))
        self._timers["step"].add(time.perf_counter() - t)

    def _stage(self, raws: list[np.ndarray]) -> tuple[int, torch.Tensor]:
        """Copy sealed wire buffers into a freshly claimed arena slot:
        ``(slot, its int32 rows)``."""
        slot = self._claim()
        rows = self._arena.rows(slot)
        for i, raw in enumerate(raws):
            rows[i] = raw
        return slot, self._arena.tensor(slot)

    def _dispatch(self, raw: np.ndarray) -> None:
        if self._arena is None:
            # inline raw48: the sealed batcher buffer itself
            self._launch(_SINGLE, torch.from_numpy(raw.view(np.int32)))
        else:
            slot, x = self._stage([raw])
            self._launch(_SINGLE, x[0], slot)

    def _dispatch_mega(self, group: list[np.ndarray]) -> None:
        """Group dispatch of pending buffers: staged into one slot, one
        megastep (one graph replay on the card)."""
        slot, x = self._stage(group)
        self._launch(len(group), x[:len(group)], slot)

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
        """Serve until the source is exhausted or a bound trips.  A live
        source (a shm ring) is never exhausted: bound the run."""
        if self._cuda and not self._graphs:
            self._capture()
        t_start = time.perf_counter()

        def bounded() -> bool:
            if (max_batches is not None
                    and self.batcher.batches_emitted >= max_batches):
                return True
            return (max_seconds is not None
                    and time.perf_counter() - t_start >= max_seconds)

        if self.sealed:
            self._run_sealed(bounded)
        else:
            self._run_inline(bounded)
        # a bounded exit can leave sealed group candidates pending: their
        # records are already counted, so dispatch them singly
        for raw in self._pending:
            self._dispatch(raw)
            self._reap(self.readback_depth)
        self._pending.clear()
        self._reap(0)
        return self._build_report(time.perf_counter() - t_start)

    def _set_t0(self, t0_ns: int) -> None:
        """Fix the stream epoch: the batcher seals against it, the sink
        translates engine seconds to absolute ns with it."""
        self.batcher.t0_ns = t0_ns
        if hasattr(self.sink, "t0_ns"):
            self.sink.t0_ns = t0_ns
        self._t0_auto = False

    def _run_inline(self, bounded) -> None:
        """The record-source loop: poll -> batch -> dispatch -> reap."""
        cfg_b = self.cfg.batch
        while not bounded():
            t = time.perf_counter()
            # grouping polls up to the remaining group capacity, so a
            # deep source backlog seals several batches in one poll
            group_room = max(self._pending_cap - len(self._pending), 1)
            requested = group_room * cfg_b.max_batch - self.batcher.fill
            records = self.source.poll(requested)
            n_polled = len(records)
            if self._t0_auto and n_polled:
                if self.precompact:
                    self._set_t0(int(schema.unwrap_kernel_ts16(
                        records["w3"][:1],
                        time.clock_gettime_ns(time.CLOCK_MONOTONIC))[0]))
                else:
                    self._set_t0(int(records["ts_ns"][0]))
            if not n_polled:
                sealed = []
                if self.precompact:
                    # a drain opportunity with no records: the wrap-risk
                    # count keys on drain cadence, not traffic cadence
                    self.batcher.note_poll()
            elif self.precompact:
                sealed = self.batcher.add_precompact(records)
            else:
                sealed = self.batcher.add(records)
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

    def _run_sealed(self, bounded) -> None:
        """The sealed-batch loop: stage -> dispatch -> reap.

        Everything per record already happened in the ingest workers.
        One arena slot is live at a time: ``poll_batches_into`` copies
        sealed payloads from the shm queue slot views into its rows at
        ``fill`` and releases the queue slots right away; the ladder
        dispatches contiguous ``rows[done:done+g]`` slices; a fresh slot
        is claimed only after the current one has fully dispatched,
        never on an empty poll.  Deadlines belong to the workers."""
        src = self.source
        if not self._t0_auto and hasattr(src, "set_t0"):
            # a fixed epoch (explicit t0_ns, or a restored checkpoint's)
            # must reach the fleet before its first-timestamp handshake
            # resolves: the workers seal against theirs, the sink
            # translates with ours
            src.set_t0(self.batcher.t0_ns)
        top = self._mega_sizes[0] if self._mega_sizes else 0
        slot = None
        fill = done = 0

        def flush(g: int) -> None:
            nonlocal done
            x = self._arena.tensor(slot)
            if g > 1:
                self._launch(g, x[done:done + g], slot)
            else:
                self._launch(_SINGLE, x[done], slot)
            done += g
            self._reap(self.readback_depth)

        while not bounded():
            t = time.perf_counter()
            if slot is None or (fill and fill == done):
                slot = self._claim()
                fill = done = 0
            rows = self._arena.rows(slot)
            want = len(rows) - fill
            if top:
                want = min(want, max(top - (fill - done), 0))
            batches = (src.poll_batches_into(rows[fill:], want)
                       if want > 0 else [])
            if self._t0_auto and batches and src.t0_ns:
                self._set_t0(src.t0_ns)   # the fleet's handshake epoch
            for sb in batches:
                # the workers sealed these: mirror them into the counters
                # the report and the bounds read
                self.batcher.batches_emitted += 1
                self.batcher.records_emitted += sb.n_records
            fill += len(batches)
            self._timers["fill"].add(time.perf_counter() - t)
            # want == 0 (slot rows exhausted under a pending carry) must
            # flush, not poll: treat it as a short poll
            short = len(batches) < want or want == 0
            while top and fill - done >= top:
                flush(top)
            if short or not top:
                while fill - done:
                    flush(fused.rung_for_volume(fill - done,
                                                self._mega_sizes))
            self._reap_ready()
            if not batches:
                if src.exhausted():
                    break
                if not self._inflight:
                    time.sleep(_IDLE_SLEEP_S)
        # bounded exit with staged rows: dispatch them singly (their
        # records are already counted)
        while fill - done:
            flush(1)

    # -- checkpoint / restore ------------------------------------------------

    def checkpoint(self, path) -> str:
        """Snapshot table, stats and clock (the reference's file format,
        :mod:`.checkpoint`) so a restarted engine resumes with every
        tracked flow and blacklist expiry.  Call it between runs."""
        if self._inflight or self._pending:
            raise RuntimeError("checkpoint with batches in flight")
        return str(ckpt.save_state(path, self.table, self.stats,
                                   self.batcher.t0_ns,
                                   hash_salt=self.cfg.table.salt,
                                   n_shards=1))

    def restore(self, path) -> dict:
        """Resume from a snapshot, IN PLACE: the rows and counters are
        copied into the engine's own table and stats tensors, which every
        captured graph holds by address (the park row is reset).  A
        snapshot of another geometry (capacity, or a sharded reference
        engine's row layout) is re-placed for this engine's capacity on
        the host first (:func:`.table.reshard_rows`, announced, unplaced
        rows counted).  A salt mismatch is refused.  A corrupt snapshot
        (:class:`~.checkpoint.CheckpointCorrupt`) is never loaded: the
        retained ``.prev`` generation is, announced and counted; with no
        ``.prev`` (or a corrupt one) it raises.  Returns a summary
        (``resharded``/``dropped_rows``/``from``/``to``/
        ``fallback_from``).  Call it between runs."""
        if self._inflight or self._pending:
            raise RuntimeError("restore with batches in flight")
        fallback_from = None
        try:
            ck = ckpt.load_checkpoint(path)
        except ckpt.CheckpointCorrupt as e:
            prev = ckpt.prev_path(path)
            if not prev.exists():
                raise
            print(f"fsx engine: checkpoint {path} REFUSED ({e}); falling "
                  f"back to the retained previous generation {prev}",
                  file=sys.stderr)
            ck = ckpt.load_checkpoint(prev)   # corrupt too -> raises
            fallback_from = str(path)
            self._restore_fallbacks += 1
        tcfg = self.cfg.table
        if ck.hash_salt != tcfg.salt:
            # another salt relocates every slot: refuse; the caller
            # adopts the checkpoint's salt before building the engine
            raise ValueError(
                f"checkpoint hash salt {ck.hash_salt} != configured "
                f"{tcfg.salt}; rebuild the engine with "
                "TableConfig(salt=<checkpoint salt>)")
        key, state = ck.key, ck.state
        if ("tok_bytes" in ck.missing_columns
                and self.cfg.limiter.bucket_burst_bytes > 0):
            # a snapshot from before the byte bucket: occupied rows start
            # with the full burst, as a flow's first sighting does
            state = state.copy()
            state[:, int(schema.TableCol.TOK_BYTES)] = np.where(
                key != 0, np.float32(self.cfg.limiter.bucket_burst_bytes),
                np.float32(0.0))
        info = {
            "resharded": False, "dropped_rows": 0,
            "from": {"capacity": ck.capacity, "n_shards": ck.n_shards},
            "to": {"capacity": tcfg.capacity, "n_shards": 1},
            "crc_checked": ck.crc_checked,
            "fallback_from": fallback_from,
        }
        if ck.capacity != tcfg.capacity or ck.n_shards != 1:
            plan = tbl.TablePlan(capacity=tcfg.capacity, n_shards=1,
                                 salt=tcfg.salt, probes=tcfg.probes)
            key, state, dropped = tbl.reshard_rows(key, state, plan)
            info["resharded"] = True
            info["dropped_rows"] = dropped
            print(f"fsx engine: resharding checkpoint {ck.capacity} rows "
                  f"x {ck.n_shards} shard(s) -> {plan.capacity} rows x 1 "
                  "shard" + (f"; {dropped} row(s) dropped (probe sequences "
                             "exhausted - table too full for the new "
                             "geometry)" if dropped else ""),
                  file=sys.stderr)
        self.table.key.copy_(torch.from_numpy(
            np.ascontiguousarray(key, np.uint32).view(np.int32)))
        self.table.state.copy_(torch.from_numpy(
            np.ascontiguousarray(state, np.float32)))
        self.table.key_rows[-1:].zero_()
        self.table.state_rows[-1:].zero_()
        for f in schema.GlobalStats._fields:
            lo, hi = (int(v) for v in ck.stats[f])
            getattr(self.stats, f).fill_(lo | hi << 32)
        if self._cuda:
            torch.cuda.synchronize(self.device)
        self._set_t0(ck.t0_ns)
        return info

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
            "arena": self._arena.info() if self._arena else None,
        }
        ingest = (self.source.ingest_stats()
                  if self.sealed and hasattr(self.source, "ingest_stats")
                  else None)
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
            ingest=ingest,
            ts_wrap_risk_polls=self.batcher.ts_wrap_risk_polls,
        )
