"""The serving engine: one device, both wires, singles and the megastep
ladder, fed inline from records or by sealed-batch ingest workers, with
the latency plane, a sink thread, the watchdog and health ladder, and
latency-budget dispatch.

Counterpart of ``flowsentryx_tpu/engine/engine.py`` — construction (the
wire rule: compact16 for params carrying an input observer ``in_scale``
or for a compact-emit source, raw48 otherwise), :meth:`Engine.warm` and
:meth:`Engine.run` over the inline record loop (``_run_inline``: poll ->
batch -> dispatch -> reap) or the sealed-batch loop (``_run_sealed``:
stage -> dispatch -> reap, for :class:`~flowsentryx_tpu_torch.ingest
.ShardedIngest`), single-batch dispatch and backlog-triggered grouping
(``mega_n=N`` or ``"auto"``, compact16 only), :meth:`Engine.checkpoint`
/ :meth:`Engine.restore`, :meth:`Engine.reset_stream`, the live model
swap (:meth:`Engine.hot_swap`, :meth:`Engine.watch_artifact`), the
simulated kernel tier (``kernel_tier=``, ``EngineReport.escalation``),
the drain ring (``device_loop=N``, :func:`calibrate_ring_depth`) and the
boot path (``warm(tiered=True)``, ``compile_cache=``,
``EngineReport.boot``), the cluster's gossip hooks (``gossip=``,
``EngineReport.cluster``) and the IP-hash-sharded step (``mesh=``, a
:func:`~..parallel.mesh.make_mesh` of n shards on this engine's device:
the sharded single step, ladder and ring of :mod:`..parallel.step`,
``EngineReport.route_drop``, and checkpoints that record the mesh size;
or a process mesh, one process per shard, which this engine leads:
:mod:`..parallel.follower`).

Two threads, as in the reference: the **dispatch thread** (the caller of
:meth:`Engine.run`) polls, stages and launches; a **sink thread** waits
on each dispatch's event, decodes its verdict wire and applies the
blacklist updates, the latency record and the reap hook, so that none of
that blocks dispatch.  All hand-off goes through one
:class:`~flowsentryx_tpu_torch.sync.channel.SinkChannel`: the dispatch
thread waits on it for backpressure (``readback_depth`` batches
dispatched but unsunk), and a sink crash surfaces there as a
:class:`~flowsentryx_tpu_torch.sync.channel.WorkerCrash`.
``sink_thread=None`` is auto: on where the host has at least 3 cores.
``sink_thread=False`` sinks on the dispatch thread, reaping what is
ready each iteration.  Either way the results are the same bytes.

**The latency plane** (``EngineReport.latency``): every batch carries
the stamp of its oldest record — the batcher's first-record time
inline, the ingest worker's shm seal stamp minus its fill time sealed
(``CLOCK_MONOTONIC``, which is ``time.perf_counter`` on Linux) — and the
sink charges each of its records seal -> verdict, split into staged
wait, upload, compute and sink, in an HDR histogram
(:class:`~.metrics.LatencyRecorder`).

**Latency-budget dispatch** (``slo_us > 0``, ``serve --slo-us``): the
oldest pending record's age and a per-rung step-time EWMA, seeded by a
timed second pass of :meth:`Engine.warm`, bound how long the loops hold
for a deeper backlog, which rung the greedy flush climbs to, and when
the batcher's deadline flush fires.  On the card a replay returns before
its work is done, so the EWMA is not refined online and the warm seed
stands.  ``predict=True`` (``serve --predict``) adds the burst
forecaster (:mod:`.predict`).  Grouping only changes dispatch
granularity: verdicts, stats, blacklist and table are the same bytes at
any budget.

**The watchdog** (``watchdog_s``, :mod:`.watchdog`): work in flight and
no completion for ``watchdog_s`` dumps every thread's stack, for twice
that raises :class:`~.watchdog.WatchdogStall`.  Every wait of the
dispatch thread — on the sink channel or on a CUDA event — polls and
checks it between polls, so a wedged kernel fails the drain instead of
hanging it.  ``EngineReport.health`` is the ladder of :mod:`.health`.

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
  staged in it has fired, so its upload is complete.  Inline raw48
  uploads straight from the batcher's pinned buffers, reused
  ``readback_depth + 2`` seals later;
* right after the replay, on the same stream, the ``[2K+4]`` verdict
  wire is copied into that dispatch's pinned host buffer and the block
  arrays with the clock (:func:`~..ops.fused.block_record`) into its
  device buffer, then an event is recorded: the next replay overwrites
  the graph's static outputs, the copies survive until the dispatch is
  sunk.  A dispatch's output slot is used again ``readback_depth + 2``
  dispatches later, and a launch first waits (on the sink thread, when
  there is one) until at most ``readback_depth`` batches are unsunk, so
  no wire is overwritten while it is being decoded;
* a wire whose overflow flag is set is replaced by the dispatch's copy
  of its full block arrays, so no block is lost.  On the sink thread
  that copy runs on the step's stream with the device set.

The table and stats are captured into every graph by address, so
:meth:`Engine.restore` copies a checkpoint INTO them rather than
rebinding them (the reference rebinds).

**The drain ring** (``device_loop=R``, ``serve --device-loop``): a
backlog of R top-rung groups (C batches each) goes to the device as ONE
dispatch, a CUDA graph of the R*C steps (:mod:`..fused.device_loop`)
carrying table and stats through the round and emitting one merged
verdict wire per slot; the sink harvests the round as one ``[R, 2K+4]``
buffer.  Each slot is uploaded the moment it is staged, on a copy stream
of its own, from its pinned arena rows into one of ``2R`` device slot
buffers, while the previous round computes; the round's launch makes the
step's stream wait on those uploads' events and copies the slots into
the graph's static input on the device.  A slot buffer is written again
only after the round that read it has copied it out (an event on the
step's stream that the copy stream waits on), and an arena slot is
claimed again only after its round's event.  A backlog short of a round
flushes its uploaded slots through the top-rung megastep and the rest
down the ladder: the same bytes.  The reference runs the ring from a
pipeline worker thread (``fsx-devpipe``) because XLA:CPU blocks on a
launch; a graph replay returns at once, so here the dispatch thread
launches the rounds and the sink thread stays as it is (the report's
``mode`` and ``device_loop`` block are the reference's).
``EngineReport.dispatch["device_loop"]["h2d"]`` keeps the reference's
overlap measure: the host wall of the uploads issued while earlier work
was still unsunk, over all uploads' wall.

**Boot** (:meth:`Engine.warm`): the kernels are built (or loaded from a
``compile_cache`` directory, :mod:`.compile_cache`), then the graphs are
captured.  ``warm(tiered=True)`` captures only the serving tier (the
single step and the top rung, and the ring under ``slo_us``) before it
returns; a background thread captures the remaining rungs, largest
first, then the ring, growing the ready set as each lands.  Until then
the loops drain through the ready rungs: the same bytes.
``EngineReport.boot`` holds the boot's story and the time from
construction to the first verdict.

**Live model swap** (:meth:`Engine.hot_swap`, ``serve
--artifact-reload``): the reference's swap is one reference assignment,
because its jitted step takes the params as an argument.  On the card
the graphs hold the params tensors and the int8 scorer's argument buffer
(:class:`~..ops.kernels.ScorePack`) by address, so a swap copies the new
values INTO them, on the step's stream, between two launches (it takes
the launch lock): a dispatch launched before it scores with the old
model and one launched after it with the new, by stream order, and no
graph is captured again.  The copies go from pinned staging, so the host
waits for no work in flight.  Every value a captured step derives from
the params on the host — the compact16 wire's input observer, which the
batcher, the ingest workers and the step's decode table were built from,
and the leaves' shapes and dtypes — is held fixed by
:func:`~..models.registry.validate_swap`.  On the CPU the swap rebinds
the params, as the reference does.
"""

from __future__ import annotations

import gc
import os
import sys
import threading
import time
import zipfile
from collections import deque
from typing import Any, NamedTuple

import numpy as np
import torch

from flowsentryx_tpu_torch.core import schema
from flowsentryx_tpu_torch.core.config import FsxConfig
from flowsentryx_tpu_torch.core.device import resolve_device
from flowsentryx_tpu_torch.core.signature import staging_signature
from flowsentryx_tpu_torch.engine import checkpoint as ckpt
from flowsentryx_tpu_torch.engine import health
from flowsentryx_tpu_torch.engine import table as tbl
from flowsentryx_tpu_torch.engine.arena import DispatchArena
from flowsentryx_tpu_torch.engine.compile_cache import CompileCache
from flowsentryx_tpu_torch.engine.batcher import MicroBatcher
from flowsentryx_tpu_torch.engine.metrics import (
    LatencyRecorder, PipelineMetrics,
)
from flowsentryx_tpu_torch.engine.predict import DispatchGovernor
from flowsentryx_tpu_torch.engine.watchdog import DispatchWatchdog
from flowsentryx_tpu_torch.engine.writeback import (
    BlacklistUpdate, decode_verdict_wire, extract_updates,
)
from flowsentryx_tpu_torch.fused import device_loop as dl
from flowsentryx_tpu_torch.models import logreg
from flowsentryx_tpu_torch.models.registry import (
    batch_scorer, get_model, load_artifact, validate_swap,
)
from flowsentryx_tpu_torch.ops import fused, kernels
from flowsentryx_tpu_torch.ops.graph import StepGraph
from flowsentryx_tpu_torch.parallel import exchange, follower
from flowsentryx_tpu_torch.parallel import step as pstep
from flowsentryx_tpu_torch.parallel.mesh import make_mesh
from flowsentryx_tpu_torch.sync import tuning
from flowsentryx_tpu_torch.sync.channel import SinkChannel

#: ``Engine(mega_n="auto")`` / ``serve --mega auto``: the largest group
#: size of the adaptive power-of-two ladder (rungs 8, 4, 2), as in the
#: reference.
MEGA_AUTO_MAX = 8

#: Graph key of the single step (rungs are keyed by their size >= 1).
_SINGLE = 0
#: Graph key of the drain ring's round.
_RING = -1


class EngineReport(NamedTuple):
    batches: int
    records: int
    wall_s: float
    records_per_s: float
    stats: dict
    #: Per-stage host ms percentiles (``fill``, ``pop``, ``stage``,
    #: ``dispatch``, ``readback``, ``e2e``; :class:`~.metrics
    #: .PipelineMetrics`).
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
    #: The seal -> verdict latency plane (:class:`~.metrics
    #: .LatencyRecorder`): percentiles in µs, the stage split, the
    #: mergeable bucket counts, ``negatives``, and under ``slo_us`` the
    #: budget-miss accounting.
    latency: dict | None = None
    #: The health ladder (:func:`~.health.engine_health`).
    health: dict | None = None
    #: The predictive governor's report; None unless ``predict=True``.
    predict: dict | None = None
    #: The simulated kernel tier's band counters (``kernel_drops``,
    #: ``blacklist_hits``, ``kernel_passes``, ``escalated``, the
    #: escalation ratio) and ``kernel_drop_hz``; None without a tier.
    escalation: dict | None = None
    #: The boot's story (:meth:`Engine.warm`): the kernels' build or cache
    #: load, each graph's capture, the tiered fill, the compile cache's
    #: counters, seconds to serving and to the first verdict; None
    #: before a warm.
    boot: dict | None = None
    #: The gossip plane's accounting (:meth:`~flowsentryx_tpu_torch
    #: .cluster.gossip.GossipPlane.report`); None outside cluster serving.
    cluster: dict | None = None
    #: The live-rebalance audit (``cluster/rebalance.py``): rows shipped,
    #: adopted and dropped after a flip, handoffs donated and adopted,
    #: refused streams, staged discards, boot-time foreign-row drops.
    #: None until a handoff touches this engine.
    rebalance: dict | None = None
    #: Records fail-opened because their flow overflowed owner routing
    #: in the sharded step (``parallel/step.py``); always 0 on one shard.
    route_drop: int = 0


class _InFlight(NamedTuple):
    n_chunks: int          # batches in this dispatch (1, or the rung)
    wire: Any              # host [2K+4] wire tensor, None when K == 0
    blocks: torch.Tensor   # block_record of the dispatch (device or host)
    event: Any             # torch.cuda.Event behind the copies, or None
    # the latency plane's stamps: the oldest record's arrival, the
    # valid records, when the launch began, its upload and replay walls
    t_enqueue: float = 0.0
    n_records: int = 0
    t_launch: float = 0.0
    put_s: float = 0.0
    launch_s: float = 0.0
    ring: int = 0          # slots of a drain-ring round (its wire [R, 2K+4])
    seq: int = -1          # on a process mesh: the step's number


class _Uploaded(NamedTuple):
    """One drain-ring slot on its way to the device."""

    dev: torch.Tensor      # [C, B+1, words]: device buffer, or on the CPU
    #                        the arena rows themselves
    t_enqueue: float
    n_records: int
    put_s: float           # host wall of the upload call
    event: Any             # the upload's event on the copy stream, or None
    arena_slot: int
    buf: int = -1          # index of the device slot buffer


def _same_device(a: torch.device, b: torch.device) -> bool:
    """``cuda`` and ``cuda:0`` (the current card) are the same device."""
    def norm(d):
        d = torch.device(d)
        return (d.type, d.index if d.index is not None or d.type != "cuda"
                else torch.cuda.current_device())
    return norm(a) == norm(b)


def _host_cpus() -> int:
    """Cores this process may run on (affinity, not ``cpu_count``: a
    container pinned to 2 cores of a large host must read as 2)."""
    try:
        return len(os.sched_getaffinity(0))
    except AttributeError:
        return os.cpu_count() or 1


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
    as in the reference.

    ``readback_depth``: batches dispatched but unsunk before the
    dispatch thread waits (None = the config's).  ``sink_thread``: sink
    on a thread of its own (None = auto, on with >= 3 cores).
    ``slo_us``: the feature -> verdict budget of latency-budget dispatch
    (0 = off).  ``predict``: the burst forecaster (needs ``slo_us``).
    ``watchdog_s``: the stall bound (None = ``tuning.WATCHDOG_STALL_S``,
    0 disables).

    ``kernel_tier``: a simulated kernel tier
    (:class:`~flowsentryx_tpu_torch.distill.sim.SimKernelTier`:
    ``filter(records) -> records`` and ``report() -> dict``) that
    band-splits the drained records before the batcher, where the XDP
    stage splits them; record path only.

    ``device_loop``: the drain ring's depth R (0 = off): a backlog of R
    top-rung groups goes as one dispatch (module docstring).  It needs
    grouping and the compact verdict wire; ``readback_depth`` grows to
    one round when it was not given, and an explicit smaller value is
    refused.  ``compile_cache``: a directory (or a
    :class:`~.compile_cache.CompileCache`) that keeps the built kernel
    libraries across boots.

    ``gossip``: a :class:`~flowsentryx_tpu_torch.cluster.gossip
    .GossipPlane` (a cluster rank): the sink section publishes every
    group's blacklist updates to the peers right after the local sink
    applies them, and the dispatch thread merges the peers' verdicts
    (``tick``) every loop iteration, idle ones included, deferring under
    the governor's budget pressure.

    ``mesh``: a :class:`~..parallel.mesh.Mesh` of more than one shard
    serves through the IP-hash-sharded step (:mod:`..parallel.step`)
    over the same one table; its shards must lie on this engine's
    device.  A one-shard mesh (or None) is the single-shard step.  On a
    process mesh (one process per shard, :mod:`..parallel.launch`) this
    engine is rank 0, the leader: it holds its own shard's rows, sends
    every batch to the followers (:mod:`..parallel.follower`), and folds
    reports, checkpoints and restores over them; :meth:`close` stops
    them.  There it serves singles only (the ladder and the drain ring
    are refused), without a sink thread (every collective is made from
    the dispatch thread) and without :meth:`hot_swap`; under NCCL its
    step is captured like every card step, under gloo (host collectives)
    it runs eagerly.  A lost follower raises
    :class:`~..parallel.exchange.PeerLost` out of :meth:`run`, its
    ``health`` FAILED.

    ``audit`` (None: on when the environment sets ``FSX_AUDIT=1``)
    proves the graph contracts of exactly the step variants this engine
    will serve (single or sharded, every rung, the ring) at
    construction, before any capture and before the first batch
    (:func:`~flowsentryx_tpu_torch.audit.boot_audit`), and raises
    :class:`~flowsentryx_tpu_torch.audit.AuditError` rather than serve
    on a violated one.  Results are cached per staged shape; the boot
    report carries ``audit_s`` and ``audit_cache_hit``."""

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
        readback_depth: int | None = None,
        sink_thread: bool | None = None,
        slo_us: int = 0,
        predict: bool = False,
        watchdog_s: float | None = None,
        kernel_tier: Any | None = None,
        device_loop: int = 0,
        compile_cache: Any | None = None,
        gossip: Any | None = None,
        mesh: Any | None = None,
        audit: bool | None = None,
    ):
        #: Boot anchor: ``EngineReport.boot``'s walls count from here.
        self._boot_t0 = time.perf_counter()
        self.slo_us = int(slo_us)
        if self.slo_us < 0:
            raise ValueError(f"slo_us must be >= 0, got {slo_us}")
        if predict and not self.slo_us:
            # every actuation of the governor is phrased in budget
            # headroom: without a budget there is nothing to govern
            raise ValueError(
                "predict=True requires slo_us > 0: the governor actuates "
                "the latency-budget machinery (early flush, holds and "
                "pre-warms are all phrased in budget headroom)")
        self.device = resolve_device(device)
        #: The mesh when it spans more than one shard, else None (the
        #: single-shard step).
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        if self.mesh is not None and not _same_device(self.mesh.device,
                                                      self.device):
            raise ValueError(
                f"mesh shards lie on {self.mesh.device}, the engine on "
                f"{self.device}: a mesh's shards must lie on the engine's "
                "device")
        #: One process per shard: this engine leads the followers.
        self._proc = self.mesh is not None and self.mesh.is_process
        if self._proc:
            if self.mesh.rank:
                raise ValueError("a process mesh's engine is rank 0 (the "
                                 "followers run parallel.follower.serve)")
            if mega_n or mega_auto or device_loop:
                raise ValueError(
                    "mega grouping and the drain ring on a process mesh "
                    "are not ported (ROADMAP queue 1): serve singles")
            if sink_thread:
                raise ValueError(
                    "a sink thread on a process mesh is refused: every "
                    "collective is made from the dispatch thread, in the "
                    "followers' order")
            sink_thread = False
        self.cfg = cfg
        self.source = source
        self.sink = sink
        #: The cluster's gossip plane, or None outside a cluster.
        self.gossip = gossip
        self.kernel_tier = kernel_tier
        if kernel_tier is not None:
            if getattr(source, "provides_sealed", False):
                raise ValueError(
                    "kernel_tier needs the inline record path; sealed-"
                    "batch ingest bypasses the record stream (run the "
                    "real kernel tier via fsx distill --pin instead)")
            if getattr(source, "precompact", False):
                raise ValueError(
                    "kernel_tier cannot rescore a compact-emit ring: "
                    "records arrive kernel-quantized; the distilled "
                    "bands are defined on raw u32 features")
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
        classify, self.score_params = batch_scorer(cfg.model.name,
                                                   self.params)
        if self._proc:
            # this rank's process step; the followers build the same
            self.step = follower.process_steps(cfg, classify, self.mesh,
                                               wire, self.quant)
            self.megasteps = {}
        elif self.mesh is not None:
            # the sharded step, ladder and ring over the same one table
            self.step = (pstep.make_sharded_compact_step(
                cfg, classify, self.mesh, **self.quant) if compact
                else pstep.make_sharded_raw_step(cfg, classify, self.mesh))
            self.megasteps = (pstep.make_sharded_compact_megastep_family(
                cfg, classify, self.mesh, sizes, **self.quant)
                if sizes else {})
        else:
            self.step = (fused.make_compact_step(cfg, classify, **self.quant)
                         if compact else fused.make_raw_step(cfg, classify))
            self.megasteps = (fused.make_compact_megastep_family(
                cfg, classify, sizes, **self.quant) if sizes else {})
        self._words = (schema.COMPACT_RECORD_WORDS if compact
                       else schema.RECORD_WORDS)
        # in place, and captured by address on the card: never rebound
        self.table = (schema.make_table(cfg.table.capacity, self.device)
                      if self.mesh is None
                      else pstep.make_process_table(cfg, self.mesh)
                      if self._proc
                      else pstep.make_sharded_table(cfg, self.mesh))
        self.stats = schema.make_stats(self.device)
        self.readback_depth = (cfg.batch.readback_depth
                               if readback_depth is None
                               else int(readback_depth))
        if self.readback_depth < 0:
            raise ValueError(
                f"readback_depth must be >= 0, got {readback_depth}")
        # -- the drain ring ------------------------------------------------
        self.ring = int(device_loop)
        if self.ring < 0:
            raise ValueError(
                f"device_loop must be >= 0, got {device_loop}")
        self._ring_chunks = 0
        self.ring_step = None
        if self.ring:
            if not sizes:
                raise ValueError(
                    "device_loop requires mega grouping (mega_n >= 2 or "
                    "'auto'): each ring slot carries one top-rung group")
            if self.verdict_k < 1:
                raise ValueError(
                    "device_loop requires the compact verdict wire "
                    "(verdict_k >= 1): the ring's steady-state readback "
                    "is one [ring, 2K+4] buffer per round")
            self._ring_chunks = max(sizes)
            round_b = dl.ring_round_batches(self.ring, self._ring_chunks)
            if readback_depth is not None and self.readback_depth < round_b:
                raise ValueError(
                    f"device_loop={self.ring} with readback_depth="
                    f"{readback_depth} < {round_b} (one ring round of "
                    f"{self.ring}x{self._ring_chunks} batches): the pipe "
                    "could never keep a round in flight while the next "
                    "stages, so every H2D upload would serialize behind "
                    "the drain — raise readback_depth to >= "
                    f"{round_b} or shrink the ring")
            # a config-default depth grows to cover one full round
            self.readback_depth = max(self.readback_depth, round_b)
            self.ring_step = (dl.make_compact_device_loop(
                cfg, classify, self.ring, self._ring_chunks, **self.quant)
                if self.mesh is None else dl.make_sharded_compact_device_loop(
                    cfg, classify, self.mesh, self.ring, self._ring_chunks,
                    **self.quant))
        # -- the static audit: before any capture and the first batch --
        if audit is None:
            audit = os.environ.get("FSX_AUDIT", "").lower() in (
                "1", "true", "on")
        #: ``EngineReport.boot``'s audit keys (empty when not audited).
        self._audit_boot: dict[str, Any] = {}
        if audit:
            from flowsentryx_tpu_torch.audit import boot_audit

            t_a = time.perf_counter()
            # a process mesh runs the shard body of the one-process
            # mesh of its size, which the audit stages on this device
            rep = boot_audit(cfg, wire=self.wire, mesh=make_mesh(
                self.mesh.size, devices=[self.device] * self.mesh.size)
                if self._proc else self.mesh,
                             mega_n=self.mega_n if sizes else 0,
                             mega_sizes=sizes or None,
                             device_loop=self.ring, params=self.params,
                             device=self.device, classify=classify)
            self._audit_boot = {
                "audit_s": round(time.perf_counter() - t_a, 4),
                "audit_cache_hit": rep is None}
        #: Sealed-but-undispatched ``(wire buffer, oldest-record stamp)``
        #: group candidates.
        self._pending: list[tuple[np.ndarray, float]] = []
        #: How many pending batches the loop accumulates before the
        #: coalescing policy must fire: one ring round with the ring, one
        #: top-rung group otherwise.
        self._pending_cap = (self.ring * self._ring_chunks if self.ring
                             else self.mega_n)
        self._cuda = self.device.type == "cuda"
        #: Card steps replay captured graphs; a gloo process mesh's
        #: step, whose exchanges are host calls, runs eagerly.
        self._graphed = self._cuda and not (self._proc
                                            and self.mesh.backend == "gloo")
        self.batcher = self._new_batcher(t0_ns or 0)
        self._t0_auto = t0_ns is None
        if t0_ns is not None and hasattr(sink, "t0_ns"):
            sink.t0_ns = t0_ns   # sinks translate engine seconds to ns
        # sealed-batch sources deliver finished wire buffers: the fleet
        # starts HERE, once the wire and quantizer are fixed, so the
        # workers seal exactly as the inline path would
        self.sealed = bool(getattr(source, "provides_sealed", False))
        if self.sealed:
            source.start(cfg.batch, self.wire, self.quant or None)
        self._group_max = max(sizes, default=1)
        self._alloc_slots()
        #: The step's stream on the card (the sink thread's overflow
        #: copy runs on it).
        self._stream = (torch.cuda.current_stream(self.device)
                        if self._cuda else None)
        #: Captured graphs on the card: ``_SINGLE``, each rung size and
        #: ``_RING``.
        self._graphs: dict[int, StepGraph] = {}
        #: The drain ring's upload side on the card: a copy stream, ``2R``
        #: device slot buffers and, per buffer, the event after which the
        #: round that read it no longer needs it.
        self._copy_stream = None
        self._ring_dev: list[torch.Tensor] = []
        self._ring_dev_free: list = []
        self._ring_dev_next = 0
        if self.ring and self._cuda:
            self._copy_stream = torch.cuda.Stream(self.device)
            self._ring_dev = [torch.zeros(
                (self._ring_chunks, cfg.batch.max_batch + 1, self._words),
                dtype=torch.int32, device=self.device)
                for _ in range(2 * self.ring)]
            self._ring_dev_free = [None] * len(self._ring_dev)
        #: Optional device-side trace of the ring (a list): each upload
        #: and each launch appends ``(kind, start event, end event)``
        #: with timing events on its stream (``chip_smoke.py`` measures
        #: the H2D/compute overlap on the card from it).
        self.trace_h2d: list | None = None
        self._ring_rounds = 0
        self._ring_partial_slots = 0
        self._h2d_put_s = 0.0
        self._h2d_overlap_s = 0.0
        self._h2d_puts = 0
        self._h2d_puts_overlapped = 0
        #: Batches copied into the arena (the host copies per batch).
        self._staged_batches = 0
        self._staged_bytes = 0
        self._n_dispatched = 0
        self._inflight: deque[_InFlight] = deque()
        self._blocked: set[int] = set()
        self._device_now = 0.0
        self.metrics = PipelineMetrics()
        self._lat = LatencyRecorder()
        self._restore_fallbacks = 0
        #: Routing-overflow fail-opens of the sharded step, from each
        #: sunk wire (or block record).
        self._route_drop = 0
        #: The live-rebalance counters (``cluster/rebalance.py`` drives
        #: the quiescent span methods; ``engine/health.py`` folds the
        #: loss-shaped ones into DEGRADED).  Written between runs only.
        self._rebalance: dict[str, int] = {}
        self._d2h_bytes = 0
        self._sink_compact = 0
        self._sink_fallback = 0
        self._sunk_batches = 0
        #: Dispatches per group size since warm() (singles under 1).
        self._group_hist: dict[int, int] = {}
        #: Optional per-dispatch reap hook ``(n_records, t_done)``, called
        #: after a dispatch's verdicts are sunk, in record order (a
        #: :class:`~.sources.PacedSource` caller pairs it with
        #: ``pop_scheduled`` for exact per-record latencies).
        self.on_reap = None
        # -- the sink thread ------------------------------------------------
        if sink_thread is None:
            # auto: a sink thread needs a core of its own; on 1-2 cores
            # it only contends with the dispatch thread
            sink_thread = _host_cpus() >= 3
        self.sink_thread = bool(sink_thread)
        #: The only state the dispatch and sink threads share.
        self._chan = SinkChannel("sink thread")
        self._sink_active = False
        self._sink_thread_obj: threading.Thread | None = None
        #: Marks the sink thread (``worker``), whose event waits block.
        self._sink_local = threading.local()
        # single-thread ready-reap coalescing: each sink has a fixed host
        # cost, so a shallow pipe sinks at most every MIN_SINK_GAP_S, and
        # never less often than half the flush deadline
        self._last_sink_t = 0.0
        #: When the loop last polled records (the idle spin window).
        self._last_arrival_t = 0.0
        self._min_sink_gap_s = min(tuning.MIN_SINK_GAP_S,
                                   cfg.batch.deadline_us * 1e-6 / 2)
        # -- latency-budget dispatch ---------------------------------------
        self._slo_budget_s = self.slo_us * 1e-6
        #: Per-group-size step-time EWMA (seconds), keyed by the chunk
        #: count (1 and each rung), seeded by warm()'s timed pass when
        #: ``slo_us`` is set; read advisorily (a stale value can only
        #: mis-size a group, never change a result).
        self._rung_ewma_s: dict[int, float] = {}
        self._gov = (DispatchGovernor(rung_sizes=self._mega_sizes,
                                      batch_records=cfg.batch.max_batch)
                     if predict else None)
        #: Lazily built masked batch of the governor's pre-warms.
        self._warm_buf: np.ndarray | None = None
        if watchdog_s is None:
            watchdog_s = tuning.WATCHDOG_STALL_S
        self._watchdog = DispatchWatchdog(watchdog_s)
        # -- the live model swap -------------------------------------------
        #: Held by every launch and by hot_swap: a swap from another
        #: thread lands between two dispatches, never inside one.
        self._launch_lock = threading.Lock()
        #: Real batches launched (masked warm-ups not counted), and the
        #: count at each swap: the batch index the swap landed at.
        self._batches_launched = 0
        self._swap_at: list[int] = []
        self._hot_swaps = 0
        #: Pinned sources of the last swap's copies, with their event.
        self._swap_staging: tuple | None = None
        self._watch_path: str | None = None
        self._watch_mtime = 0
        self._watch_next = 0.0
        # -- boot (warm, the tiered fill, the compile cache) ----------------
        if compile_cache is None or isinstance(compile_cache, CompileCache):
            self._cache = compile_cache
        else:
            self._cache = CompileCache(compile_cache, staging_signature(
                cfg, wire=self.wire, mesh_devices=self._n_shards(),
                mega_sizes=self._mega_sizes,
                device_loop=self.ring, params=self.params, donate=True))
        #: The READY rungs: captured and safe to dispatch.  The whole
        #: ladder unless a tiered warm shrank it to the serving tier;
        #: its fill grows it back rung by rung.
        self._ready_sizes: tuple[int, ...] = self._mega_sizes
        #: Whether the ring may engage (captured, same story).
        self._ring_ready = bool(self.ring)
        #: Warm-seed floors of the ring-round EWMA keys (negated round
        #: sizes): the online refinement never goes below them.
        self._round_floor_s: dict[int, float] = {}
        self._warm_plan: tuple = ()
        self._warm_thread_obj: threading.Thread | None = None
        #: ``EngineReport.boot``; the fill thread rebinds it whole.
        self._boot: dict | None = None
        #: Wall from construction to the first real verdict sunk.
        self._first_verdict_s: float | None = None
        #: Import wall of the engine stack, stamped by the caller that
        #: measured it (the engine cannot observe its own import).
        self.boot_import_s = 0.0
        #: Seconds of the cluster runner's boot-time reconcile, when one
        #: ran (the runner sets it, as it sets ``boot_import_s``).
        self.boot_reconcile_s: float | None = None
        #: On a process mesh, the followers' side of every step, report,
        #: checkpoint and restore; they build their shard from this boot
        #: message (step numbers kept: more than the dispatches unsunk).
        self._leader = (follower.Leader(self.mesh, {
            "cfg": cfg, "wire": self.wire, "quant": self.quant,
            "params": type(self.params)(*(t.cpu() for t in self.params)),
            "keep": self._n_slots + 1}) if self._proc else None)

    def _new_batcher(self, t0_ns: int) -> MicroBatcher:
        # a batcher buffer may be reused only after its batch is staged:
        # keep more buffers than in-flight batches + the pending group
        return MicroBatcher(
            self.cfg.batch, t0_ns=t0_ns,
            n_buffers=self.readback_depth + 2 + self._pending_cap,
            quant=self.quant, wire=self.wire,
            pinned=self._cuda and self.wire != schema.WIRE_COMPACT16)

    def _alloc_slots(self) -> None:
        """The arena and the per-dispatch output slots for this
        ``readback_depth``: ``readback_depth + 2`` output slots, so a slot
        is reused only after its dispatch is sunk, each sized for the
        largest dispatch (a ring round with the ring); arena slots by
        :meth:`~.arena.DispatchArena.ring_safe_slots` for the ring's
        depth (``readback_depth + 2`` without one)."""
        compact = self.wire == schema.WIRE_COMPACT16
        b = self.cfg.batch.max_batch
        n_slots = self.readback_depth + 2
        self._n_slots = n_slots
        # the dispatch arena: pinned staging rows on the card (compact16
        # dispatches and every sealed batch; inline raw48 uploads from
        # the batcher's pinned buffers).  Sealed loops stage a few
        # batches per slot even for singles.
        self._arena = (DispatchArena(
            DispatchArena.ring_safe_slots(self.readback_depth,
                                          self.ring or 1),
            max(self._group_max, 4) if self.sealed else self._group_max,
            b, self._words, pinned=self._cuda)
            if compact or self.sealed else None)
        #: Per arena slot, the event of the last dispatch staged in it:
        #: the slot is claimed again only once it has fired.
        self._arena_event: list = [None] * (self._arena.slots
                                            if self._arena else 0)
        if self._cuda:
            k = self.verdict_k
            most = max(self._group_max, self.ring * self._ring_chunks)
            # per batch: the block arrays, the clock and, sharded, the
            # route_drop word (fused.block_record)
            rec_words = most * (2 * b + 1 if self.mesh is None else
                                2 * pstep.block_rows(b, self.mesh.size) + 2)
            self._wire_host = ([torch.empty(
                max(self.ring, 1) * fused.verdict_wire_words(k),
                dtype=torch.int32, pin_memory=True)
                for _ in range(n_slots)] if k else [])
            # with a wire the block record is read only on overflow, so
            # it stays on the device; without one it is always fetched
            self._blocks_slot = [
                torch.empty(rec_words, dtype=torch.int32, device=self.device)
                if k else torch.empty(rec_words, dtype=torch.int32,
                                      pin_memory=True)
                for _ in range(n_slots)]

    # -- graphs --------------------------------------------------------------

    @staticmethod
    def _label(key: int) -> str:
        """A graph key's name in ``EngineReport.boot`` (the reference's
        variant labels)."""
        return ("single" if key == _SINGLE else "ring" if key == _RING
                else f"mega{key}")

    def _capture_one(self, key: int, warm_state: tuple | None = None
                     ) -> dict:
        """Capture one graph (``_SINGLE``, a rung, ``_RING``) and return
        its boot entry.  ``warm_state`` (a scratch table and stats) makes
        it a capture beside serving (:mod:`..ops.graph`)."""
        b, words = self.cfg.batch.max_batch, self._words
        kw = ({} if warm_state is None
              else {"warm_state": warm_state, "sync_check": False})
        if key == _SINGLE:
            if self._leader is not None:
                self._leader.capture()   # every rank captures its step
            gr = StepGraph(self.step, self.table, self.stats, self.params,
                           (b + 1, words), **kw)
        elif key == _RING:
            gr = StepGraph(self.ring_step, self.table, self.stats,
                           self.params,
                           (self.ring, self._ring_chunks, b + 1, words),
                           slots=True, **kw)
        else:
            gr = StepGraph(self.megasteps[key], self.table, self.stats,
                           self.params, (key, b + 1, words), **kw)
        # one rebind: the fill thread publishes a graph beside serving
        self._graphs = {**self._graphs, key: gr}
        return {"source": "capture", "seconds": round(gr.capture_s, 4),
                "nodes": gr.nodes}

    def _capture(self) -> None:
        """Build the kernels and capture every graph: the single step,
        every staged rung and the ring (the reference's ``warm()``
        compiling every variant)."""
        kernels.build_all(cache=self._cache)
        for key in ([_SINGLE] + list(self._mega_sizes)
                    + ([_RING] if self.ring else [])):
            self._capture_one(key)

    # -- waits of the dispatch thread ----------------------------------------

    def _wait_event(self, ev) -> None:
        """Wait for a CUDA event.  The sink thread blocks in
        ``synchronize``; the dispatch thread polls ``query``, yielding
        and checking the watchdog between polls, so a wedged kernel
        trips it instead of hanging the thread."""
        if ev is None or ev.query():
            return
        if getattr(self._sink_local, "worker", False):
            ev.synchronize()
            return
        while not ev.query():
            self._watchdog.check(self._busy_depth())
            time.sleep(tuning.GIL_YIELD_S)

    def _claim(self) -> int:
        """The next arena slot, once the last dispatch staged in it has
        finished reading it (its event fired: the upload is complete)."""
        slot = self._arena.claim()
        ev = self._arena_event[slot]
        if ev is not None:
            self._wait_event(ev)
            self._arena_event[slot] = None
        return slot

    # -- dispatch ------------------------------------------------------------

    def _chunks(self, key: int) -> int:
        """Batches one dispatch of graph ``key`` carries."""
        return (self.ring * self._ring_chunks if key == _RING
                else max(key, 1))

    def _launch(self, key: int, x: torch.Tensor | None, arena_slots,
                t_enqueue: float, n_records: int,
                uploaded: list[_Uploaded] | None = None) -> None:
        """One dispatch: the single step (``key == _SINGLE``, ``x`` one
        ``[B+1, words]`` batch), the rung-``g`` megastep (``x`` ``[g,
        B+1, words]``) or a ring round (``key == _RING``).  ``x`` is a
        host tensor (pinned arena rows or a batcher buffer), uploaded
        here on the step's stream; or ``uploaded`` holds slots already
        on their way to the device (:meth:`_upload_slot`: a round's R,
        or one slot flushed through the top rung), copied into the
        graph's input on the device once their uploads have landed.
        ``arena_slots`` are the arena slots the data lies in, gated by
        this dispatch's event; ``t_enqueue`` the oldest record's stamp,
        ``n_records`` the valid records (the latency plane's)."""
        # an output slot is free once the dispatch that used it is sunk:
        # at most readback_depth batches unsunk leaves the slot of
        # readback_depth + 2 dispatches ago sunk (a no-op except at exit
        # flushes: every dispatch site already reaps to that depth)
        self._reap(self._n_slots - 2)
        t_l = time.perf_counter()
        n = self._chunks(key)
        slot = self._n_dispatched % self._n_slots
        seq = -1
        with self._launch_lock:
            if self._graphed:
                gr = self._graphs[key]
                if uploaded is None:
                    gr.input.copy_(x, non_blocking=True)
                    if self._leader is not None:
                        seq = self._leader.step(gr.input)
                else:
                    dst = gr.input if key == _RING else gr.input[None]
                    for r, u in enumerate(uploaded):
                        self._stream.wait_event(u.event)
                        dst[r].copy_(u.dev, non_blocking=True)
                    copied = torch.cuda.Event()
                    copied.record()
                    for u in uploaded:
                        self._ring_dev_free[u.buf] = copied
                t_p = time.perf_counter()
                ev0 = self._trace_event()
                gr.replay()
                self._trace_end("compute", ev0)
                wire = None
                if self.verdict_k:
                    w = gr.out.wire
                    wire = self._wire_host[slot][:w.numel()].view(w.shape)
                    wire.copy_(w, non_blocking=True)
                blocks = self._blocks_slot[slot][:gr.keep.shape[0]]
                blocks.copy_(gr.keep, non_blocking=True)
                event = torch.cuda.Event()
                event.record()
                for a in arena_slots:
                    self._arena_event[a] = event
            else:
                t_p = t_l
                if key == _RING:
                    _, _, out = self.ring_step(
                        self.table, self.stats, self.params,
                        *(u.dev for u in uploaded))
                else:
                    fn = (self.step if key == _SINGLE
                          else self.megasteps[key])
                    arg = x if uploaded is None else uploaded[0].dev
                    if self._leader is not None:
                        seq = self._leader.step(arg)
                        arg = arg.to(self.device)
                    _, _, out = fn(self.table, self.stats, self.params, arg)
                wire, blocks, event = out.wire, fused.block_record(out), None
                if self._cuda and wire is not None:
                    wire = wire.cpu()   # the eager card step (gloo mesh)
            if n_records:
                self._batches_launched += n
        t_d = time.perf_counter()
        self._n_dispatched += 1
        self._group_hist[n] = self._group_hist.get(n, 0) + 1
        self.metrics.dispatch.add(t_d - t_l)
        put_s = (t_p - t_l if uploaded is None
                 else sum(u.put_s for u in uploaded))
        if key == _RING:
            self._ring_rounds += 1
            self._note_round_s(-n, t_d - t_l + put_s, event)
        else:
            self._note_step_s(n, t_d - t_p, event)
        self._inflight.append(_InFlight(
            n, wire, blocks, event, t_enqueue=t_enqueue,
            n_records=n_records, t_launch=t_l, put_s=put_s,
            launch_s=t_d - t_p, ring=self.ring if key == _RING else 0,
            seq=seq))

    def _trace_event(self, stream=None):
        """A timing event recorded now on ``stream`` (the current one by
        default) while :attr:`trace_h2d` is on, else None."""
        if self.trace_h2d is None:
            return None
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(stream)
        return ev

    def _trace_end(self, kind: str, ev0, stream=None) -> None:
        if ev0 is not None:
            self.trace_h2d.append((kind, ev0, self._trace_event(stream)))

    def _note_step_s(self, key: int, dt: float, event) -> None:
        """Online refinement of the per-rung step-time EWMA, under a
        budget only, and only when the launch absorbed the compute (the
        output ready the moment the call returned: the eager CPU step).
        A graph replay returns before its work is done, so on the card
        the warm seed stands; no host sync is added to refine it."""
        if not self._slo_budget_s or (event is not None
                                      and not event.query()):
            return
        prev = self._rung_ewma_s.get(key)
        self._rung_ewma_s[key] = (
            dt if prev is None
            else prev + tuning.SLO_EWMA_ALPHA * (dt - prev))

    def _note_round_s(self, key: int, dt: float, event) -> None:
        """Online refinement of a ring-round EWMA key (negated round
        size), as the reference guards it: launch-absorbed rounds only
        (the eager CPU step), ``dt`` the launch wall plus the round's
        upload wall, the key never created here (:meth:`warm` seeds it),
        and the value never below the warm seed, the only measurement
        that saw the uploads and the reap."""
        if not self._slo_budget_s or (event is not None
                                      and not event.query()):
            return
        prev = self._rung_ewma_s.get(key)
        if prev is None:
            return
        self._rung_ewma_s[key] = max(
            prev + tuning.SLO_EWMA_ALPHA * (dt - prev),
            self._round_floor_s.get(key, prev))

    def _stage(self, raws: list[np.ndarray]) -> tuple[int, torch.Tensor]:
        """Copy sealed wire buffers into a freshly claimed arena slot:
        ``(slot, its int32 rows)``."""
        slot = self._claim()
        t = time.perf_counter()
        rows = self._arena.rows(slot)
        for i, raw in enumerate(raws):
            rows[i] = raw
        self.metrics.stage.add(time.perf_counter() - t)
        self._staged_batches += len(raws)
        self._staged_bytes += int(rows[0].nbytes) * len(raws)
        return slot, self._arena.tensor(slot)

    def _n_valid(self, raw: np.ndarray) -> int:
        return int(raw[self.cfg.batch.max_batch, 0])

    def _dispatch(self, raw: np.ndarray,
                  t_enqueue: float | None = None) -> None:
        """Dispatch one sealed batch singly; ``t_enqueue`` is its oldest
        record's stamp (now, when not given)."""
        if t_enqueue is None:
            t_enqueue = time.perf_counter()
        n = self._n_valid(raw)
        if self._arena is None:
            # inline raw48: the sealed batcher buffer itself
            self._launch(_SINGLE, torch.from_numpy(raw.view(np.int32)),
                         (), t_enqueue, n)
        else:
            slot, x = self._stage([raw])
            self._launch(_SINGLE, x[0], (slot,), t_enqueue, n)

    def _dispatch_mega(self, group: list[tuple[np.ndarray, float]]) -> None:
        """Group dispatch of ``(buffer, stamp)`` pending pairs: staged
        into one slot, one megastep (one graph replay on the card),
        stamped with the oldest member's stamp."""
        slot, x = self._stage([raw for raw, _ in group])
        self._launch(len(group), x[:len(group)], (slot,),
                     min(t for _, t in group),
                     sum(self._n_valid(raw) for raw, _ in group))

    # -- the drain ring --------------------------------------------------------

    def _upload_slot(self, arena_slot: int, x: torch.Tensor,
                     t_enqueue: float, n_records: int) -> _Uploaded:
        """Start the upload of one staged ring slot (``x``, its ``[C,
        B+1, words]`` arena rows) the moment it is staged, so that it
        overlaps whatever round is still computing.  On the card: on the
        copy stream, into the next of the ``2R`` device slot buffers,
        once the round that last read that buffer has copied it out; on
        the CPU the arena rows are the slot (the eager step reads them
        at the dispatch).  An upload issued while earlier work is
        unsunk counts as overlapped (``EngineReport.dispatch
        ["device_loop"]["h2d"]``, the reference's measure)."""
        busy = self._busy_depth() > 0
        t0 = time.perf_counter()
        event, i, dev = None, -1, x
        if self._cuda:
            i = self._ring_dev_next
            self._ring_dev_next = (i + 1) % len(self._ring_dev)
            dev = self._ring_dev[i]
            cs = self._copy_stream
            with torch.cuda.stream(cs):
                if self._ring_dev_free[i] is not None:
                    cs.wait_event(self._ring_dev_free[i])
                ev0 = self._trace_event(cs)
                dev.copy_(x, non_blocking=True)
                self._trace_end("h2d", ev0, cs)
                event = torch.cuda.Event()
                event.record(cs)
        dt = time.perf_counter() - t0
        self._h2d_put_s += dt
        self._h2d_puts += 1
        if busy:
            self._h2d_overlap_s += dt
            self._h2d_puts_overlapped += 1
        return _Uploaded(dev, t_enqueue, n_records, dt, event, arena_slot, i)

    def _dispatch_ring(self, uploaded: list[_Uploaded]) -> None:
        """ONE dispatch of a full round of R uploaded slots: one
        in-flight entry of R*C batches whose wire is R merged slot
        wires, harvested by the sink as one ``[R, 2K+4]`` buffer."""
        self._launch(_RING, None, [u.arena_slot for u in uploaded],
                     min(u.t_enqueue for u in uploaded),
                     sum(u.n_records for u in uploaded), uploaded=uploaded)

    def _dispatch_group_dev(self, u: _Uploaded) -> None:
        """An uploaded slot of a round that did not fill, through the
        top-rung megastep: the same bytes, since the ring's slot body IS
        that megastep."""
        self._launch(self._ring_chunks, None, (u.arena_slot,), u.t_enqueue,
                     u.n_records, uploaded=[u])
        self._ring_partial_slots += 1

    def _ring_from_pending(self) -> None:
        """One full round out of the inline pending list: R arena slots of
        C buffers each, each uploaded as soon as it is staged, then one
        dispatch."""
        c = self._ring_chunks
        uploaded = []
        for _ in range(self.ring):
            group = self._pending[:c]
            del self._pending[:c]
            slot, x = self._stage([raw for raw, _ in group])
            uploaded.append(self._upload_slot(
                slot, x[:c], min(t for _, t in group),
                sum(self._n_valid(raw) for raw, _ in group)))
        self._dispatch_ring(uploaded)

    def _rung_for(self, backlog: int) -> int:
        """The coalescing policy over the READY rungs (a tiered warm's
        fill may still be capturing the rest): the largest the backlog
        fills, else 1."""
        return fused.rung_for_volume(backlog, self._ready_sizes)

    def _prewarm_dispatch(self, rung: int) -> None:
        """The governor's pre-warm (:mod:`.predict`): ONE all-masked
        dispatch through ``rung`` (n_valid = 0: table, stats and verdicts
        untouched, no latency sample), reaped to empty before returning,
        so the pipe reads idle again before the burst arrives."""
        if self._warm_buf is None:
            self._warm_buf = np.zeros(
                (self.cfg.batch.max_batch + 1, self._words), np.uint32)
        t0 = time.perf_counter()
        if rung > 1 and self._arena is not None:
            self._dispatch_mega([(self._warm_buf, t0)] * rung)
        else:
            self._dispatch(self._warm_buf, t0)
        self._reap(0)

    # -- latency-budget policy -----------------------------------------------
    # Advisory predicates over the warm-seeded step-time EWMA, no-ops at
    # slo_us = 0.  They bound COALESCING, never results.

    def _slo_cap(self, t_oldest: float) -> int:
        """The largest rung whose expected completion — the oldest
        pending record's age plus the rung's EWMA — still fits the
        budget; 1 when none does.  A record already past its budget
        gets no cap: a late record cannot be saved by a rung choice,
        and the greedy flush at full amortization drains the backlog
        soonest.  A rung without a measurement is taken as free."""
        headroom = self._slo_budget_s - (time.perf_counter() - t_oldest)
        if headroom <= 0.0:
            # the top rung is always ready (a tiered warm's serving tier)
            return self._mega_sizes[0] if self._mega_sizes else 1
        for s in self._ready_sizes:
            if self._rung_ewma_s.get(s, 0.0) <= headroom:
                return s
        return 1

    def _slo_pressed(self, t_oldest: float) -> bool:
        """Stop holding for a deeper backlog once a top-rung step no
        longer fits the oldest pending record's headroom (a late record
        included): flush now, through :meth:`_slo_cap`'s choice."""
        top = self._mega_sizes[0] if self._mega_sizes else 1
        headroom = self._slo_budget_s - (time.perf_counter() - t_oldest)
        return self._rung_ewma_s.get(top, 0.0) >= headroom

    def _slo_round_fits(self, t_oldest: float) -> bool:
        """The ring's round sizer: whether waiting for a FULL round can
        still land the oldest staged record inside the budget (its
        negated round key, seeded by :meth:`warm`).  With less headroom
        the loops flush through the megastep and the ladder; once the
        record is late the ring is back on (it recovers a backlog
        fastest, :meth:`_slo_cap`'s no-cap rule)."""
        headroom = self._slo_budget_s - (time.perf_counter() - t_oldest)
        if headroom <= 0.0:
            return True
        key = -(self.ring * self._ring_chunks)
        return self._rung_ewma_s.get(key, 0.0) < headroom

    def _drain_pending(self, short: bool) -> None:
        """Apply the coalescing ladder to the pending list.

        Full TOP-rung groups always dispatch (a deep backlog keeps
        amortization maximal, under a budget too: the step's time is
        sub-linear in the group size, so the largest rung finishes every
        record of an existing backlog soonest); a short poll — no
        backlog left behind the pending batches — flushes the remainder
        greedily through the largest rung it still fills, then singles.
        Under ``slo_us`` the hold is also broken once the budget says
        holding is no longer free (:meth:`_slo_pressed`), and the greedy
        flush climbs no higher than :meth:`_slo_cap`.  With a fixed
        ``mega_n`` the ladder is one rung: all or nothing.

        The drain ring adds a rung above the ladder: a backlog of a whole
        round goes as one round (once the ring is ready); anything less
        falls through to the ladder, so the ring engages only on
        backlogs that were queueing anyway."""
        slo = self._slo_budget_s
        if self.ring and self._ring_ready:
            while len(self._pending) >= self._pending_cap:
                self._ring_from_pending()
                self._reap(self.readback_depth)
            if not short and not (
                    slo and self._pending
                    and self._slo_pressed(self._pending[0][1])):
                # a full poll: the backlog is still building toward the
                # next round, hold the remainder
                return
        top = self._mega_sizes[0]
        while len(self._pending) >= top:
            self._dispatch_mega(self._pending[:top])
            del self._pending[:top]
            self._reap(self.readback_depth)
        if not self._pending or not (short or (
                slo and self._slo_pressed(self._pending[0][1]))):
            return
        while self._pending:
            g = self._rung_for(len(self._pending))
            if slo:
                g = min(g, self._slo_cap(self._pending[0][1]))
            if g > 1:
                self._dispatch_mega(self._pending[:g])
                del self._pending[:g]
            else:
                raw, t = self._pending.pop(0)
                self._dispatch(raw, t)
            self._reap(self.readback_depth)

    def _busy_depth(self) -> int:
        """Batches dispatched but not yet sunk (staged here, queued to
        the sink thread, or being sunk)."""
        return sum(g.n_chunks for g in self._inflight) + self._chan.pending

    def _deadline_flush_due(self) -> bool:
        """The batcher's deadline flush, only into an idle pipe: while
        batches are in flight (queued to the sink thread included) an
        early flush cannot cut latency, only burn a padded step.  Under
        ``slo_us`` the batcher's residency is also bounded by the budget:
        the flush fires once the oldest record's age plus the single
        step's EWMA reaches it, but never before half the budget (an
        inflated estimate must not become flush-every-poll).  With the
        governor, a confident forecast may hold or advance that point
        inside the budget (:meth:`~.predict.DispatchGovernor
        .flush_decision`)."""
        if self._busy_depth() != 0:
            return False
        if self.batcher.flush_due():
            return True
        if not self._slo_budget_s:
            return False
        age = self.batcher.pending_age_s()
        if age <= 0.0:
            return False
        if self._gov is not None:
            d = self._gov.flush_decision(
                time.perf_counter(), age, self._rung_ewma_s.get(1, 0.0),
                self._slo_budget_s)
            if d is not None:
                return d
        return age >= max(self._slo_budget_s - self._rung_ewma_s.get(1, 0.0),
                          self._slo_budget_s / 2)

    # -- the sink section ----------------------------------------------------

    def _fetch_blocks(self, g: _InFlight) -> np.ndarray:
        """The dispatch's block record on the host.  From device memory
        (the overflow fallback) the copy runs on the step's stream with
        the device set, whichever thread asks.  On a process mesh every
        owner's block arrays are gathered from the followers."""
        if self._leader is not None:
            return self._leader.blocks(g.seq, g.blocks).cpu().numpy()
        if g.blocks.device.type != "cuda":
            return g.blocks.numpy()
        with torch.cuda.device(self.device), torch.cuda.stream(self._stream):
            return g.blocks.to("cpu").numpy()

    def _split_blocks(self, g: _InFlight) -> tuple:
        """:func:`~..ops.fused.split_block_record` of the dispatch's
        block record, and the route_drop words a sharded step's record
        ends with, summed (0 on one shard and for a ring round, whose
        wires carry them)."""
        rec, rd = self._fetch_blocks(g), 0
        if self.mesh is not None and not g.ring:
            rec, rd = rec[:-g.n_chunks], int(rec[-g.n_chunks:].sum())
        return (*fused.split_block_record(rec, g.n_chunks,
                                          1 if g.ring else None), rd)

    def _sink_one(self, g: _InFlight) -> None:
        """Sink one dispatch: wait for its event, decode its wire (or its
        block record), apply the updates, then the latency record, the
        reap hook and the watchdog's progress stamp."""
        t_fetch = time.perf_counter()
        self._wait_event(g.event)
        if self.verdict_k:
            # one wire, or a ring round's [R, 2K+4]: one per slot
            wire = g.wire.numpy()
            self._d2h_bytes += wire.nbytes
            rows = [decode_verdict_wire(w) for w in wire.reshape(
                -1, wire.shape[-1])]
            self._route_drop += sum(vw.route_drop for vw in rows)
            if any(vw.overflow for vw in rows):
                # more newly-blocked flows than wire slots: take this
                # dispatch's full block arrays (a whole round's, in chunk
                # order) so no block is lost
                keys, untils, _, _ = self._split_blocks(g)
                self._d2h_bytes += keys.nbytes + untils.nbytes
                self._sink_fallback += 1
                upd = extract_updates(keys, untils)
            else:
                self._sink_compact += len(rows)
                upd = (BlacklistUpdate(key=rows[0].key,
                                       until_s=rows[0].until_s)
                       if len(rows) == 1 else BlacklistUpdate(
                           key=np.concatenate([vw.key for vw in rows]),
                           until_s=np.concatenate([vw.until_s
                                                   for vw in rows])))
            now = max(vw.now for vw in rows)
        else:
            keys, untils, nows, rd = self._split_blocks(g)
            self._route_drop += rd
            self._d2h_bytes += keys.nbytes + untils.nbytes
            self._sink_fallback += 1
            upd = extract_updates(keys, untils)
            now = float(nows.max())
        self.metrics.readback.add(time.perf_counter() - t_fetch)
        self.sink.apply(upd)
        if self.gossip is not None:
            # republish to every peer right where the local sink applied:
            # the gossip TX mailboxes' single producer is the sink
            # section, whichever thread owns it
            self.gossip.publish(upd, now)
        self._blocked.update(upd.key.tolist())
        self._device_now = max(self._device_now, now)
        self._sunk_batches += g.n_chunks
        t_done = time.perf_counter()
        if self._first_verdict_s is None and g.n_records:
            # masked warm batches carry no records: the first REAL one
            self._first_verdict_s = t_done - self._boot_t0
        self._last_sink_t = t_done
        self.metrics.e2e.add(t_done - g.t_enqueue)
        # every record of the dispatch is charged its OLDEST record's
        # path (a conservative per-record bound, as in the reference)
        self._lat.record(
            total_s=t_done - g.t_enqueue,
            staged_s=g.t_launch - g.t_enqueue,
            upload_s=g.put_s, compute_s=g.launch_s,
            sink_s=t_done - t_fetch, n=g.n_records,
            budget_s=self._slo_budget_s)
        if self.on_reap is not None:
            self.on_reap(g.n_records, t_done)
        self._watchdog.note_progress()

    @staticmethod
    def _ready(g: _InFlight) -> bool:
        return g.event is None or g.event.query()

    def _handoff(self) -> None:
        """Move the staged in-flight entries to the sink thread."""
        if self._inflight:
            self._chan.submit_many(list(self._inflight), lambda g: g.n_chunks)
            self._inflight.clear()

    def _reap(self, down_to: int) -> None:
        """At most ``down_to`` BATCHES stay dispatched but unsunk
        (blocking).  Counted in batches, not dispatches: a group of g
        counts g, or grouping would multiply the configured pipe depth.
        With the sink thread: hand over and wait on the channel, checking
        the watchdog each quantum; without: sink here, oldest first."""
        if self._sink_active:
            self._handoff()
            self._chan.wait_below(
                down_to,
                on_wait=lambda: self._watchdog.check(self._chan.pending))
            self._chan.check()
            return
        total = sum(g.n_chunks for g in self._inflight)
        while self._inflight and total > down_to:
            g = self._inflight.popleft()
            total -= g.n_chunks
            self._sink_one(g)

    def _reap_ready(self) -> None:
        """Once per loop iteration: the watchdog's poll, the governor's
        heartbeat, then (with a sink thread) the hand-over and a crash
        check, or (without) a sink of every dispatch the device has
        finished, oldest first — coalesced: a shallow pipe sinks at most
        every ``_min_sink_gap_s``.  Every serving loop passes here, so
        the artifact watcher's throttled check runs first."""
        self._maybe_reload_artifact()
        self._watchdog.check(self._busy_depth())
        pressure = 0.0
        if self._gov is not None:
            now = time.perf_counter()
            self._gov.update(now)
            age = self.batcher.pending_age_s()
            if self._pending:
                age = max(age, now - self._pending[0][1])
            pressure = self._gov.pressure(age, self._slo_budget_s)
        if self.gossip is not None:
            # merge the peers' verdicts between dispatches, idle
            # iterations too (RX mailboxes and the plane's own sink are
            # this thread's); under budget pressure the plane defers the
            # merge, never the publish
            self.gossip.tick(pressure=pressure)
        if self._sink_active:
            self._handoff()
            self._chan.check()
            return
        if not self._inflight or not self._ready(self._inflight[0]):
            return
        if (len(self._inflight) < 2 and time.perf_counter()
                - self._last_sink_t < self._min_sink_gap_s):
            return
        while self._inflight and self._ready(self._inflight[0]):
            self._sink_one(self._inflight.popleft())

    # -- the live model swap --------------------------------------------------

    def hot_swap(self, params) -> None:
        """Serve ``params`` (the same family, leaf shapes and dtypes, and
        on a compact16 ``model``-mode wire the same input observer:
        :func:`~..models.registry.validate_swap`, which raises
        ``ValueError`` otherwise) from the next launch on, without a
        drain and without a new capture.  Dispatches launched before the
        swap finish on the old model.  Safe from any thread: it takes the
        launch lock, so it lands between two dispatches.

        On the card every params tensor and the int8 scorer's argument
        buffer are rewritten in place on the step's stream from pinned
        staging (:func:`~..ops.kernels.repack_score_params`); the graphs,
        which hold them by address, replay the new model.  On the CPU
        the params are rebound, as in the reference."""
        if self._proc:
            raise ValueError("hot_swap on a process mesh is not ported: "
                             "the followers hold the params they booted "
                             "with (ROADMAP queue 1)")
        validate_swap(self.params, params, self.quant)
        with self._launch_lock:
            if self._cuda:
                with torch.cuda.device(self.device), \
                        torch.cuda.stream(self._stream):
                    staged = [t.detach().to("cpu").pin_memory()
                              for t in params]
                    for dst, src in zip(self.params, staged):
                        dst.copy_(src, non_blocking=True)
                    if self.score_params is not None:
                        kernels.repack_score_params(self.score_params,
                                                    params, self._stream)
                    event = torch.cuda.Event()
                    event.record()
                self._swap_staging = (staged, event)
            else:
                self.params = type(params)(*(t.to(self.device)
                                             for t in params))
                if self.score_params is not None:
                    kernels.repack_score_params(self.score_params,
                                                self.params)
            self._hot_swaps += 1
            self._swap_at.append(self._batches_launched)

    def watch_artifact(self, path: str) -> None:
        """Live artifact reload (``serve --artifact-reload``): the serving
        loops re-stat ``path`` at most twice a second and
        :meth:`hot_swap` it when its mtime changes.  A failed reload (a
        half-written file, another family) is announced on stderr and
        serving continues on the incumbent model: fail-open."""
        self._watch_path = str(path)
        try:
            self._watch_mtime = os.stat(self._watch_path).st_mtime_ns
        except OSError:
            self._watch_mtime = 0
        self._watch_next = 0.0

    def _maybe_reload_artifact(self) -> None:
        if self._watch_path is None:
            return
        t = time.monotonic()
        if t < self._watch_next:
            return
        self._watch_next = t + 0.5
        try:
            m = os.stat(self._watch_path).st_mtime_ns
        except OSError:
            return  # mid-replace or gone; try again next tick
        if m == self._watch_mtime:
            return
        self._watch_mtime = m
        try:
            self.hot_swap(load_artifact(self.cfg.model.name,
                                        self._watch_path, self.device))
            print(f"fsx engine: hot-swapped artifact {self._watch_path} "
                  f"(swap #{self._hot_swaps})", file=sys.stderr)
        # BadZipFile: a non-atomic deploy caught mid-write hands np.load
        # a partial zip (a later poll picks up the finished file)
        except (ValueError, KeyError, OSError, zipfile.BadZipFile) as e:
            print("fsx engine: artifact reload failed (serving continues "
                  f"on the incumbent model): {e}", file=sys.stderr)

    # -- the sink thread -----------------------------------------------------

    def _start_sink_thread(self) -> None:
        if self._sink_active or not self.sink_thread:
            return
        self._chan.reset()
        self._sink_thread_obj = threading.Thread(
            target=self._sink_worker, name="fsx-sink", daemon=True)
        self._sink_active = True
        self._sink_thread_obj.start()

    def _stop_sink_thread(self) -> None:
        """Drain-preserving shutdown: the worker sinks everything queued,
        then exits.  After a hard watchdog trip the worker is wedged, so
        the join is bounded and the daemon thread abandoned (the
        ``WatchdogStall`` is the loud failure).  Never raises."""
        if not self._sink_active:
            return
        self._chan.request_stop()
        self._sink_thread_obj.join(
            timeout=2.0 if self._watchdog.tripped else None)
        self._sink_thread_obj = None
        self._sink_active = False

    def _sink_worker(self) -> None:
        """Sink-thread main: pop the oldest dispatch with every following
        one already finished, sink them in order, account the group (a
        crash recorded with it, atomically), repeat.  One worker popping
        in FIFO order keeps ``on_reap`` in record order."""
        self._sink_local.worker = True
        try:
            while True:
                group = self._chan.pop(coalesce=self._ready)
                if group is None:
                    return       # stop requested and queue drained
                t0 = time.perf_counter()
                exc: BaseException | None = None
                try:
                    for g in group:
                        self._sink_one(g)
                except BaseException as e:  # noqa: BLE001 — surfaced
                    exc = e
                self._chan.complete(sum(g.n_chunks for g in group),
                                    time.perf_counter() - t0, exc)
                if exc is not None:
                    return
        except BaseException as e:  # noqa: BLE001 — surfaced by check()
            self._chan.record_exc(e)

    # -- lifecycle -----------------------------------------------------------

    def warm(self, tiered: bool = False) -> None:
        """Build the kernels (or load them from the compile cache) and
        capture every graph on the card; then run one all-masked batch
        through the single step, each rung and the ring (n_valid = 0:
        table, stats and verdicts are unchanged), so neither the build,
        the capture nor first-launch setup lands in the first served
        window.  Under ``slo_us`` the ladder runs a second, timed time
        and seeds the step-time EWMA of the single step, every rung and
        the ring's round (its negated key, which is also the floor of
        its online refinement) with the wall of one dispatch plus its
        sink (on the card: one replay and its event wait).  Must not be
        called with batches in flight.

        ``tiered=True`` (``serve --tiered-warm``) captures only the
        SERVING tier here: the single step and the top rung, and the ring
        under ``slo_us`` (its round key needs this quiescent pass).  The
        engine serves the moment this returns; a background thread
        (:meth:`_warm_worker`) captures the remaining rungs, largest
        first, then the ring, and grows the ready set as each lands;
        until then the loops drain through the ready rungs (the same
        bytes).  Refused while a fill runs."""
        if self.warm_fill_active():
            raise RuntimeError(
                "warm() called while a background warm fill is active "
                "— warm_fill_join() first (nothing else may touch the "
                "captured graphs while the fill thread captures)")
        self._warm_thread_obj = None
        serving = self._mega_sizes
        ring_now = bool(self.ring)
        fill_plan: list[int] = []
        if tiered and self._mega_sizes:
            serving = self._mega_sizes[:1]
            ring_now = bool(self.ring) and bool(self._slo_budget_s)
            fill_plan = list(self._mega_sizes[1:])
            if self.ring and not ring_now:
                fill_plan.append(_RING)
        boot: dict[str, Any] = {
            "tiered": bool(fill_plan),
            "variants": {},
            "fill_pending": [self._label(k) for k in fill_plan],
            **self._audit_boot,
        }
        if self._cuda:
            # from the compile cache where it has them; a miss, drift or
            # corrupt entry builds with nvcc (counted), never a plain
            # version
            boot["kernels"] = kernels.build_all(cache=self._cache)
            for key in ([_SINGLE] + list(serving)
                        + ([_RING] if ring_now else [])):
                if self._graphed and key not in self._graphs:
                    boot["variants"][self._label(key)] = \
                        self._capture_one(key)
        warm = np.zeros((self.cfg.batch.max_batch + 1, self._words),
                        np.uint32)
        for timed in (False, True) if self._slo_budget_s else (False,):
            if timed:
                self._rung_ewma_s.clear()
            t0 = time.perf_counter()
            self._dispatch(warm, t0)
            self._reap(0)
            if timed:
                self._rung_ewma_s[1] = time.perf_counter() - t0
            for g in serving:
                t0 = time.perf_counter()
                self._dispatch_mega([(warm, t0)] * g)
                self._reap(0)
                if timed:
                    self._rung_ewma_s[g] = time.perf_counter() - t0
            if ring_now:
                t0 = time.perf_counter()
                self._pending = [(warm, t0)] * self._pending_cap
                self._ring_from_pending()
                self._reap(0)
                if timed:
                    key = -self._pending_cap
                    self._rung_ewma_s[key] = time.perf_counter() - t0
                    self._round_floor_s[key] = self._rung_ewma_s[key]
        # publish the ready set LAST: every graph above is captured
        self._ready_sizes = serving
        self._ring_ready = ring_now
        self._reset_counters()
        if self._cuda:
            torch.cuda.synchronize(self.device)
        boot["serving_ready_s"] = round(
            time.perf_counter() - self._boot_t0, 4)
        if self._cache is not None:
            boot["cache"] = self._cache.report()
        self._boot = boot
        if fill_plan:
            self._warm_plan = tuple(fill_plan)
            self._warm_thread_obj = threading.Thread(
                target=self._warm_worker, name="fsx-warm", daemon=True)
            self._warm_thread_obj.start()

    def _warm_worker(self) -> None:
        """The tiered warm's background fill: capture the remaining
        rungs, largest first, then the ring, and grow the ready set as
        each lands.  It never dispatches.  Its warm-ups run on a scratch
        table and stats (:mod:`..ops.graph`, capture beside serving).
        Everything it publishes (graph, ready set, boot block) is one
        rebind.  A failed capture is recorded as ``boot["fill_error"]``
        and its rung stays unready: the ready rungs keep serving, and
        nothing falls back to an eager step."""
        scratch = None
        try:
            if self._cuda:
                scratch = (schema.make_table(self.cfg.table.capacity,
                                             self.device),
                           schema.make_stats(self.device))
            for key in self._warm_plan:
                label = self._label(key)
                entry = self._fill_one(key, scratch)
                if key == _RING:
                    self._ring_ready = True
                else:
                    self._ready_sizes = tuple(sorted(
                        set(self._ready_sizes) | {key}, reverse=True))
                boot = dict(self._boot or {})
                boot["variants"] = {**boot.get("variants", {}),
                                    label: entry}
                boot["fill_pending"] = [
                    v for v in boot.get("fill_pending", ()) if v != label]
                self._boot = boot
            self._boot = {**(self._boot or {}), "fill_done_s": round(
                time.perf_counter() - self._boot_t0, 4)}
        except Exception as e:  # noqa: BLE001 — recorded, never raised
            self._boot = {**(self._boot or {}), "fill_error": repr(e)}
        finally:
            del scratch

    def _fill_one(self, key: int, scratch) -> dict:
        """One graph of the fill: captured beside serving on the card;
        on the CPU there is nothing to capture."""
        if not self._cuda:
            return {"source": "ready", "seconds": 0.0}
        return self._capture_one(key, warm_state=scratch)

    def warm_fill_active(self) -> bool:
        """Whether a tiered warm's background fill is still running."""
        t = self._warm_thread_obj
        return t is not None and t.is_alive()

    def warm_fill_join(self, timeout: float | None = None) -> bool:
        """Wait for the background fill; True once it is done (also when
        none was started)."""
        t = self._warm_thread_obj
        if t is None:
            return True
        t.join(timeout)
        return not t.is_alive()

    def _reset_counters(self) -> None:
        """Per-stream report counters (warm dispatches are not traffic)."""
        self._sunk_batches = self._sink_compact = self._sink_fallback = 0
        self._d2h_bytes = 0
        self.metrics = PipelineMetrics()
        self._lat = LatencyRecorder()
        self._group_hist = {}
        self._staged_batches = self._staged_bytes = 0
        self._ring_rounds = self._ring_partial_slots = 0
        self._h2d_put_s = self._h2d_overlap_s = 0.0
        self._h2d_puts = self._h2d_puts_overlapped = 0
        self._route_drop = 0

    def reset_stream(self, source, sink=None,
                     readback_depth: int | None = None,
                     t0_ns: int | None = None) -> None:
        """Rebind the engine to a new stream without recapturing (the
        reference's ``reset_stream``): new source (and sink, and pipe
        depth), a new batcher, per-stream counters reset.  The table,
        stats, clock epoch (``t0_ns=None`` keeps it), step-time EWMA and
        the governor's learned arrival window persist; the reap hook
        does not.  Must not be called with batches in flight."""
        if self._inflight or self._pending:
            raise RuntimeError("reset_stream with batches in flight")
        self.source = source
        sealed = bool(getattr(source, "provides_sealed", False))
        if sealed and not getattr(source, "started", False):
            source.start(self.cfg.batch, self.wire, self.quant or None)
        if sink is not None:
            self.sink = sink
        depth = (self.readback_depth if readback_depth is None
                 else int(readback_depth))
        if depth != self.readback_depth or sealed != self.sealed:
            self.readback_depth, self.sealed = depth, sealed
            self._alloc_slots()
        keep_t0 = self.batcher.t0_ns if t0_ns is None else t0_ns
        self.batcher = self._new_batcher(keep_t0)
        if t0_ns is not None:
            self._t0_auto = False
            if hasattr(self.sink, "t0_ns"):
                self.sink.t0_ns = t0_ns
        elif not self._t0_auto and hasattr(self.sink, "t0_ns"):
            self.sink.t0_ns = keep_t0   # a swapped-in sink needs the epoch
        self._reset_counters()
        self._blocked = set()
        if self._gov is not None:
            self._gov.reset_counters()
        self.on_reap = None

    def run(self, max_batches: int | None = None,
            max_seconds: float | None = None) -> EngineReport:
        """Serve until the source is exhausted or a bound trips.  A live
        source (a shm ring) is never exhausted: bound the run.  With a
        sink thread it runs for the duration of this call: started here,
        drained and joined before the report is built; its crash raises
        :class:`~flowsentryx_tpu_torch.sync.channel.WorkerCrash`.  A
        tiered warm's background fill is joined before it returns."""
        if (self._slo_budget_s and self.ring
                and -self._pending_cap not in self._rung_ewma_s):
            # the round sizer's key is seeded only by warm()'s quiescent
            # pass (it must include the uploads and the reap)
            self.warm()
        if self._graphed and not self._graphs:
            self._capture()
        self._watchdog.note_progress()     # an idle pipe re-arms the clock
        t_start = time.perf_counter()

        def bounded() -> bool:
            if (max_batches is not None
                    and self.batcher.batches_emitted >= max_batches):
                return True
            return (max_seconds is not None
                    and time.perf_counter() - t_start >= max_seconds)

        self._start_sink_thread()
        try:
            if self.sealed:
                self._run_sealed(bounded)
            else:
                self._run_inline(bounded)
            # a bounded exit can leave sealed group candidates pending:
            # their records are already counted, so dispatch them singly
            for raw, t in self._pending:
                self._dispatch(raw, t)
                self._reap(self.readback_depth)
            self._pending.clear()
            self._reap(0)
        except exchange.PeerLost as e:
            # a rank of the process mesh is gone: nothing more can be
            # sent to it, and the ladder reads the engine FAILED
            self._leader.stopped = True
            e.health = health.engine_health(
                watchdog=self._watchdog.to_dict(),
                mesh={"peer_lost": str(e)})
            raise
        finally:
            self._stop_sink_thread()
            # serving is over: hand no capturing thread to interpreter
            # teardown (bounded: a capture always ends)
            if not self.warm_fill_join(300.0):
                print("fsx engine: warm fill still capturing 300 s after "
                      "the drain finished — abandoning it (the report's "
                      "fill_done_s will be missing)", file=sys.stderr)
        self._chan.check()         # a crash in the very last group
        return self._build_report(time.perf_counter() - t_start)

    def _set_t0(self, t0_ns: int) -> None:
        """Fix the stream epoch: the batcher seals against it, the sink
        translates engine seconds to absolute ns with it."""
        self.batcher.t0_ns = t0_ns
        if hasattr(self.sink, "t0_ns"):
            self.sink.t0_ns = t0_ns
        self._t0_auto = False

    def _idle(self) -> None:
        """An iteration with nothing to do: yield (the GIL to the sink
        thread, the core to the scheduler) while work is in flight, a
        batch is forming or records arrived in the last
        ``tuning.IDLE_SPIN_S``; sleep on a link idle for longer.  A
        process mesh's leader keeps its followers' link alive."""
        if self._leader is not None:
            self._leader.keepalive()
        if (self._busy_depth() or self.batcher.fill
                or time.perf_counter() - self._last_arrival_t
                < tuning.IDLE_SPIN_S):
            time.sleep(tuning.GIL_YIELD_S)
        else:
            time.sleep(tuning.IDLE_SLEEP_S)

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
            if n_polled:
                # the idle backoff and the governor see the link's
                # arrivals, before the kernel tier drops any
                self._last_arrival_t = time.perf_counter()
                if self._gov is not None:
                    self._gov.note_arrivals(self._last_arrival_t, n_polled)
                if self.kernel_tier is not None:
                    # the (simulated) kernel tier splits records where
                    # XDP would: after the drain, before the batcher
                    records = self.kernel_tier.filter(records)
            if not len(records):
                sealed = []
                if self.precompact:
                    # a drain opportunity with no records: the wrap-risk
                    # count keys on drain cadence, not traffic cadence
                    self.batcher.note_poll()
            elif self.precompact:
                sealed = self.batcher.add_precompact(records)
            else:
                sealed = self.batcher.add(records)
            if not sealed and self._deadline_flush_due():
                took = self.batcher.take()
                sealed = [took] if took is not None else []
            # each sealed buffer with its first record's arrival
            sealed = [(raw, self.batcher.pop_seal_time()) for raw in sealed]
            self.metrics.fill.add(time.perf_counter() - t)
            if self.mega_n > 0:
                # backlog-triggered grouping: a short poll (no backlog
                # behind the pending batches) flushes them down the
                # ladder; judged pre-filter: a flood the kernel tier
                # mostly drops is still a deep backlog
                self._pending.extend(sealed)
                self._drain_pending(short=n_polled < requested)
            else:
                for raw, t_seal in sealed:
                    self._dispatch(raw, t_seal)
                    self._reap(self.readback_depth)
            self._reap_ready()
            if not sealed and self.source.exhausted():
                if self.batcher.fill:
                    raw = self.batcher.take()
                    self._dispatch(raw, self.batcher.pop_seal_time())
                break
            if not sealed and not n_polled:
                if self._gov is not None and self._busy_depth() == 0:
                    # inside the lead window before a forecast onset: one
                    # masked dispatch through the predicted rung refreshes
                    # its path (idle iterations only)
                    rung = self._gov.prewarm_rung(
                        time.perf_counter(), self._rung_ewma_s.get(1, 0.0))
                    if rung:
                        self._prewarm_dispatch(
                            self._rung_for(rung)
                            if rung > 1 else rung)
                        continue
                self._idle()

    def _run_sealed(self, bounded) -> None:
        """The sealed-batch loop: stage -> dispatch -> reap.

        Everything per record already happened in the ingest workers.
        One arena slot is live at a time: ``poll_batches_into`` copies
        sealed payloads from the shm queue slot views into its rows at
        ``fill`` and releases the queue slots right away; the ladder
        dispatches contiguous ``rows[done:done+g]`` slices; a fresh slot
        is claimed only after the current one has fully dispatched,
        never on an empty poll.  Deadlines belong to the workers; under
        ``slo_us`` a held remainder is flushed once the budget presses,
        through budget-capped rungs."""
        src = self.source
        if not self._t0_auto and hasattr(src, "set_t0"):
            # a fixed epoch (explicit t0_ns, or a restored checkpoint's)
            # must reach the fleet before its first-timestamp handshake
            # resolves: the workers seal against theirs, the sink
            # translates with ours
            src.set_t0(self.batcher.t0_ns)
        if self.ring:
            self._sealed_loop_ring(src, bounded)
            return
        top = self._mega_sizes[0] if self._mega_sizes else 0
        slo = self._slo_budget_s
        slot = None
        fill = done = 0
        metas: list[tuple[float, int]] = []   # (t_enqueue, n_records)/row

        def flush(g: int) -> None:
            nonlocal done
            x = self._arena.tensor(slot)
            t_e = min(m[0] for m in metas[done:done + g])
            n = sum(m[1] for m in metas[done:done + g])
            if g > 1:
                self._launch(g, x[done:done + g], (slot,), t_e, n)
            else:
                self._launch(_SINGLE, x[done], (slot,), t_e, n)
            done += g
            self._reap(self.readback_depth)

        while not bounded():
            if slot is None or (fill and fill == done):
                slot = self._claim()
                fill = done = 0
                metas = []
            rows = self._arena.rows(slot)
            want = len(rows) - fill
            if top:
                want = min(want, max(top - (fill - done), 0))
            batches = (src.poll_batches_into(
                rows[fill:], want, pop_timer=self.metrics.pop,
                stage_timer=self.metrics.stage) if want > 0 else [])
            if self._t0_auto and batches and src.t0_ns:
                self._set_t0(src.t0_ns)   # the fleet's handshake epoch
            self._note_sealed(batches, metas)
            fill += len(batches)
            # want == 0 (slot rows exhausted under a pending carry) must
            # flush, not poll: treat it as a short poll
            short = len(batches) < want or want == 0
            while top and fill - done >= top:
                flush(top)
            if short or not top or (slo and fill - done
                                    and self._slo_pressed(metas[done][0])):
                while fill - done:
                    g = self._rung_for(fill - done)
                    if slo:
                        g = min(g, self._slo_cap(metas[done][0]))
                    flush(g)
            self._reap_ready()
            if not batches:
                if src.exhausted():
                    break
                self._idle()
        # bounded exit with staged rows: dispatch them singly (their
        # records are already counted)
        while fill - done:
            flush(1)

    def _note_sealed(self, batches, metas: list) -> None:
        """Polled sealed batches: mirror them into the counters the report
        and the bounds read (the workers sealed them), one arena copy
        each, and note their arrival."""
        row_bytes = 4 * self._arena.row_shape[0] * self._arena.row_shape[1]
        for sb in batches:
            self.batcher.batches_emitted += 1
            self.batcher.records_emitted += sb.n_records
            self._staged_batches += 1
            self._staged_bytes += row_bytes
            metas.append((sb.t_enqueue, sb.n_records))
        if batches:
            self._last_arrival_t = time.perf_counter()
            if self._gov is not None:
                self._gov.note_arrivals(
                    self._last_arrival_t,
                    sum(sb.n_records for sb in batches))

    def _sealed_loop_ring(self, src, bounded) -> None:
        """The sealed loop feeding the drain ring.  One arena slot at a
        time fills to exactly C batches (the staging copy is still the
        one host copy); the moment it fills it is uploaded, while the
        previous round computes, and R uploaded slots launch as ONE
        round.  A short poll flushes the uploaded slots through the
        top-rung megastep and the partial slot down the ladder (the same
        bytes); under ``slo_us`` the uploaded slots are flushed too once
        a full round no longer fits the oldest one's budget
        (:meth:`_slo_round_fits`).  A fresh slot is claimed only after
        the current one is staged away, never on an empty poll."""
        c = self._ring_chunks
        slo = self._slo_budget_s
        uploaded: list[_Uploaded] = []
        slot = None
        fill = 0
        metas: list[tuple[float, int]] = []   # (t_enqueue, n_records)/row

        def flush_uploaded() -> None:
            for u in uploaded:
                self._dispatch_group_dev(u)
                self._reap(self.readback_depth)
            uploaded.clear()

        while not bounded():
            if slot is None:
                slot = self._claim()
                fill = 0
                metas = []
            rows = self._arena.rows(slot)
            want = c - fill
            batches = src.poll_batches_into(
                rows[fill:c], want, pop_timer=self.metrics.pop,
                stage_timer=self.metrics.stage)
            if self._t0_auto and batches and src.t0_ns:
                self._set_t0(src.t0_ns)   # the fleet's handshake epoch
            self._note_sealed(batches, metas)
            fill += len(batches)
            short = len(batches) < want
            x = self._arena.tensor(slot)
            if fill == c:
                # slot full: upload NOW, overlapping in-flight compute
                uploaded.append(self._upload_slot(
                    slot, x[:c], min(m[0] for m in metas),
                    sum(m[1] for m in metas)))
                slot = None
                if len(uploaded) == self.ring:
                    if self._ring_ready:
                        self._dispatch_ring(uploaded)
                        uploaded = []
                        self._reap(self.readback_depth)
                    else:
                        # a tiered warm still capturing the ring: the
                        # round's slots go through the top rung
                        flush_uploaded()
            elif short:
                # partial round: the uploaded slots first (arrival
                # order), then the partial slot down the ladder
                flush_uploaded()
                done = 0
                while fill - done:
                    g = self._rung_for(fill - done)
                    if slo:
                        g = min(g, self._slo_cap(metas[done][0]))
                    t_e = min(m[0] for m in metas[done:done + g])
                    n = sum(m[1] for m in metas[done:done + g])
                    if g > 1:
                        self._launch(g, x[done:done + g], (slot,), t_e, n)
                    else:
                        self._launch(_SINGLE, x[done], (slot,), t_e, n)
                    done += g
                    self._reap(self.readback_depth)
                if fill:
                    slot = None
            if (slo and uploaded
                    and not self._slo_round_fits(uploaded[0].t_enqueue)):
                flush_uploaded()
            self._reap_ready()
            if not batches:
                if src.exhausted():
                    break
                self._idle()
        # bounded exit: the uploaded slots, then the staged rows singly
        flush_uploaded()
        if slot is not None:
            x = self._arena.tensor(slot)
            for i in range(fill):
                self._launch(_SINGLE, x[i], (slot,), metas[i][0],
                             metas[i][1])
                self._reap(self.readback_depth)

    # -- checkpoint / restore ------------------------------------------------

    def _n_shards(self) -> int:
        return self.mesh.size if self.mesh is not None else 1

    def table_rows(self) -> tuple[np.ndarray, np.ndarray]:
        """The whole table's ``(key, state)`` on the host, in the one
        table's row order (gathered over a process mesh's ranks), as
        :func:`~..core.schema.table_to_numpy` reads one table.  Call it
        between runs."""
        return self._quiescent_table("table_rows")

    def close(self) -> None:
        """Stop a process mesh's followers (their loops return); a no-op
        otherwise.  The engine serves no more batches after it."""
        if self._leader is not None:
            self._leader.stop()

    def checkpoint(self, path) -> str:
        """Snapshot table, stats and clock (the reference's file format,
        :mod:`.checkpoint`) so a restarted engine resumes with every
        tracked flow and blacklist expiry.  The header records the
        geometry (salt, shard count, capacity): a sharded table's rows are
        stored shard-major, as the reference's.  Call it between runs."""
        if self._inflight or self._pending:
            raise RuntimeError("checkpoint with batches in flight")
        table = self.table
        if self._leader is not None:
            # every rank's rows, in the one table's order
            table = schema.table_from_numpy(
                *self._quiescent_table("checkpoint"))
        return str(ckpt.save_state(path, table, self.stats,
                                   self.batcher.t0_ns,
                                   hash_salt=self.cfg.table.salt,
                                   n_shards=self._n_shards()))

    def restore(self, path) -> dict:
        """Resume from a snapshot, IN PLACE: the rows and counters are
        copied into the engine's own table and stats tensors, which every
        captured graph holds by address (the park row is reset).  A
        snapshot of another geometry (capacity or shard count) is
        re-placed for this engine's geometry on the host first (:func:`.table.reshard_rows`, announced, unplaced
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
        n_shards = self._n_shards()
        info = {
            "resharded": False, "dropped_rows": 0,
            "from": {"capacity": ck.capacity, "n_shards": ck.n_shards},
            "to": {"capacity": tcfg.capacity, "n_shards": n_shards},
            "crc_checked": ck.crc_checked,
            "fallback_from": fallback_from,
        }
        if ck.capacity != tcfg.capacity or ck.n_shards != n_shards:
            plan = tbl.TablePlan(capacity=tcfg.capacity, n_shards=n_shards,
                                 salt=tcfg.salt, probes=tcfg.probes)
            key, state, dropped = tbl.reshard_rows(key, state, plan)
            info["resharded"] = True
            info["dropped_rows"] = dropped
            print(f"fsx engine: resharding checkpoint {ck.capacity} rows "
                  f"x {ck.n_shards} shard(s) -> {plan.capacity} rows x "
                  f"{plan.n_shards} shard(s)"
                  + (f"; {dropped} row(s) dropped (probe sequences "
                     "exhausted - table too full for the new geometry)"
                     if dropped else ""),
                  file=sys.stderr)
        counters = [int(lo) | int(hi) << 32 for lo, hi in
                    (ck.stats[f] for f in schema.GlobalStats._fields)]
        if self._leader is not None:
            # each rank takes its own row range of the re-placed table
            self._leader.load(self.table, self.stats,
                              np.ascontiguousarray(key, np.uint32),
                              np.ascontiguousarray(state, np.float32),
                              counters)
        else:
            self.table.key.copy_(torch.from_numpy(
                np.ascontiguousarray(key, np.uint32).view(np.int32)))
            self.table.state.copy_(torch.from_numpy(
                np.ascontiguousarray(state, np.float32)))
            self.table.key_rows[-1:].zero_()
            self.table.state_rows[-1:].zero_()
            for field, v in zip(self.stats, counters):
                field.fill_(v)
        if self._cuda:
            torch.cuda.synchronize(self.device)
        self._set_t0(ck.t0_ns)
        return info

    # -- live shard handoff (cluster/rebalance.py) ---------------------------
    #
    # All three are quiescent, as checkpoint() and restore() are: the
    # rebalancer calls them between runs.  They read the table through one
    # host fetch and write it back IN PLACE (``copy_`` into the engine's
    # own tensors), so every captured graph, rung and drain-ring round
    # keeps the table it holds by address.  Keys are u32 bit patterns in
    # int32: viewed as uint32 before the shard rule, back to int32 to
    # write.  The park row is never shipped, probed or written.

    def count_rebalance(self, name: str, n: int = 1) -> None:
        self._rebalance[name] = self._rebalance.get(name, 0) + int(n)

    def _quiescent_table(self, what: str) -> tuple[np.ndarray, np.ndarray]:
        if self._inflight or self._pending:
            raise RuntimeError(f"{what} with batches in flight")
        if self._cuda:
            # nothing on any stream: the copy stream's uploads and the
            # sink's readbacks included
            torch.cuda.synchronize(self.device)
        if self._leader is not None:
            return self._leader.rows(self.table)
        return schema.table_to_numpy(self.table)

    def _write_table(self, key: np.ndarray, state: np.ndarray) -> None:
        if self._leader is not None:
            self._leader.load(self.table, self.stats,
                              np.ascontiguousarray(key, np.uint32),
                              np.ascontiguousarray(state, np.float32),
                              [schema.stat_value(f) for f in self.stats])
        else:
            self.table.key.copy_(torch.from_numpy(
                np.ascontiguousarray(key, np.uint32).view(np.int32)))
            self.table.state.copy_(torch.from_numpy(
                np.ascontiguousarray(state, np.float32)))
        if self._cuda:
            torch.cuda.synchronize(self.device)

    @staticmethod
    def _span_mask(key: np.ndarray, shards, total_shards: int
                   ) -> np.ndarray:
        return (key != 0) & np.isin(schema.shard_of(key, total_shards),
                                    np.asarray(list(shards), np.uint32))

    def extract_span_rows(
        self, shards, total_shards: int
    ) -> tuple[np.ndarray, np.ndarray]:
        """Occupied ``(keys, states)`` of the given ring shards (the
        producers' ``shard_of`` over the table keys, which are the folded
        sources).  A pure read: the donor serves the span until the flip."""
        key, state = self._quiescent_table("extract_span_rows")
        sel = self._span_mask(key, shards, total_shards)
        return key[sel].copy(), state[sel].copy()

    def drop_span_rows(self, shards, total_shards: int) -> int:
        """Zero every row of the given ring shards (the donor after the
        flip, or the boot-time foreign-row reconcile).  Returns the
        count."""
        key, state = self._quiescent_table("drop_span_rows")
        sel = self._span_mask(key, shards, total_shards)
        n = int(np.sum(sel))
        if n:
            key[sel] = 0
            state[sel] = 0.0
            self._write_table(key, state)
        return n

    def adopt_rows(self, keys, states) -> tuple[int, int]:
        """Probe-insert handed-off rows into the live table
        (:func:`~.table.insert_rows`, under this engine's shard count).  Returns ``(inserted,
        dropped)``: a dropped row (its key already live, or its probes
        exhausted) is the caller's to count, never silent."""
        keys = np.asarray(keys, np.uint32).reshape(-1)
        if not len(keys):
            return 0, 0
        key, state = self._quiescent_table("adopt_rows")
        tcfg = self.cfg.table
        plan = tbl.TablePlan(capacity=tcfg.capacity,
                             n_shards=self._n_shards(), salt=tcfg.salt,
                             probes=tcfg.probes)
        key, state, dropped = tbl.insert_rows(key, state, keys, states,
                                              plan)
        self._write_table(key, state)
        return len(keys) - dropped, dropped

    def _build_report(self, wall: float) -> EngineReport:
        table_sum = (kernels.table_summary(
            self.table, now=self._device_now, stale_s=self.cfg.table.stale_s)
            if self._leader is None else self._leader.report(
                self.table, self._device_now, self.cfg.table.stale_s))
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
            "sink_thread": self.sink_thread,
            # the sink thread's busy share of the run's wall
            "sink_occupancy": (round(self._chan.busy_s / max(wall, 1e-9), 4)
                               if self.sink_thread else None),
        }
        device = {"type": self.device.type,
                  "name": (torch.cuda.get_device_name(self.device)
                           if self._cuda else "cpu")}
        dispatches = sum(self._group_hist.values())
        device_loop = None
        if self.ring:
            full = self._ring_rounds * self.ring
            staged_slots = full + self._ring_partial_slots
            device_loop = {
                "ring": self.ring,
                "chunks_per_slot": self._ring_chunks,
                "batches_per_round": self.ring * self._ring_chunks,
                "rounds": self._ring_rounds,
                "steps_per_round": self.ring,   # megasteps per round
                "partial_slot_flushes": self._ring_partial_slots,
                "ring_occupancy": round(full / staged_slots, 4)
                if staged_slots else 0.0,
                "h2d": {
                    "puts": self._h2d_puts,
                    "puts_overlapped": self._h2d_puts_overlapped,
                    "put_s": round(self._h2d_put_s, 6),
                    "overlap_s": round(self._h2d_overlap_s, 6),
                    "overlap_fraction": round(
                        self._h2d_overlap_s / self._h2d_put_s, 4)
                    if self._h2d_put_s else 0.0,
                },
            }
        chunks = sum(g * n for g, n in self._group_hist.items())
        dispatch = {
            "wire": self.wire,
            "mode": ("device_loop" if self.ring
                     else "adaptive" if self.mega_auto
                     else "fixed" if self.mega_n else "single"),
            "mega_n": self.mega_n,
            "device_loop": device_loop,
            "group_sizes": list(self._mega_sizes),
            "group_hist": {str(g): n for g, n in
                           sorted(self._group_hist.items())},
            "dispatches": dispatches,
            "dispatch_hz": round(dispatches / max(wall, 1e-9), 1),
            # host copies per dispatched batch: the arena staging copy
            # (1.0 on the sealed path); 0.0 for inline raw48 singles,
            # which upload the batcher's own buffer
            "staged_batches": self._staged_batches,
            "staged_bytes": self._staged_bytes,
            "host_copies_per_batch": round(
                self._staged_batches / max(chunks, 1), 3),
            # captured CUDA graphs (single, rungs, ring); 0 on the CPU
            "graphs": len(self._graphs),
            "graph_nodes": {self._label(k): g.nodes
                            for k, g in sorted(self._graphs.items())},
            "arena": self._arena.info() if self._arena else None,
            # latency-budget dispatch: the budget and the step-time EWMA
            # the policy read (negated keys are ring rounds); None
            # without a budget
            "slo": ({"slo_us": self.slo_us,
                     "rung_ewma_ms": {
                         (str(g) if g > 0 else f"round{-g}"):
                             round(v * 1e3, 4)
                         for g, v in sorted(self._rung_ewma_s.items())}}
                    if self.slo_us else None),
        }
        ingest = (self.source.ingest_stats()
                  if self.sealed and hasattr(self.source, "ingest_stats")
                  else None)
        escalation = None
        if self.kernel_tier is not None:
            escalation = self.kernel_tier.report()
            escalation["kernel_drop_hz"] = round(
                (escalation.get("kernel_drops", 0)
                 + escalation.get("blacklist_hits", 0)) / max(wall, 1e-9),
                1)
        cluster = self.gossip.report() if self.gossip is not None else None
        predict = self._gov.report() if self._gov is not None else None
        if predict is not None and cluster is not None:
            # the shed counter beside the actuation counters it motivates
            predict["gossip_ticks_deferred"] = cluster["ticks_deferred"]
        return EngineReport(
            batches=self.batcher.batches_emitted,
            records=self.batcher.records_emitted,
            wall_s=round(wall, 4),
            records_per_s=round(
                self.batcher.records_emitted / max(wall, 1e-9), 1),
            stats=self.stats.to_dict(),
            stages_ms=self.metrics.to_dict(),
            blocked_sources=len(self._blocked),
            table=table_sum,
            readback=readback,
            device=device,
            dispatch=dispatch,
            ingest=ingest,
            ts_wrap_risk_polls=self.batcher.ts_wrap_risk_polls,
            # the eager CPU step's call wall is its compute; a replay's
            # is its enqueue (the compute lands in the sink's wait)
            latency=self._lat.to_dict(self.slo_us,
                                      compute_is_wall=not self._cuda),
            health=health.engine_health(
                ingest=ingest, gossip=cluster,
                watchdog=self._watchdog.to_dict(),
                restore_fallbacks=self._restore_fallbacks,
                rebalance=self._rebalance or None),
            predict=predict,
            escalation=escalation,
            boot=self._boot_report(),
            cluster=cluster,
            rebalance=dict(self._rebalance) or None,
            route_drop=self._route_drop,
        )

    def _boot_report(self) -> dict | None:
        """``EngineReport.boot``: one snapshot of the warm and fill story
        (the fill thread rebinds the dict whole, so one read is
        coherent), the cache's counters, the caller's import wall and
        the sink's time to the first verdict."""
        snap = self._boot
        if snap is None:
            return None
        rep = dict(snap)
        if self._cache is not None:
            rep["cache"] = self._cache.report()
        # µs: an import of modules this process already holds takes
        # tens of µs, which 4 places round to 0
        rep["import_s"] = round(self.boot_import_s, 6)
        if self.boot_reconcile_s is not None:
            # a cluster rank's boot-time reconcile (cluster/rebalance.py):
            # a full host fetch of the table, on the path to serving
            rep["reconcile_s"] = round(self.boot_reconcile_s, 4)
        rep["time_to_first_verdict_s"] = (
            round(self._first_verdict_s, 4)
            if self._first_verdict_s is not None else None)
        rep["fill_active"] = self.warm_fill_active()
        return rep


# ---------------------------------------------------------------------------
# ring-depth autotuning (serve --device-loop auto)
# ---------------------------------------------------------------------------

def calibrate_ring_depth(cfg: FsxConfig, params: Any | None = None,
                         mega_n: int | str = "auto",
                         candidates: tuple[int, ...] = (2, 4, 8),
                         batches: int = 48, seed: int = 17,
                         device: str | torch.device | None = None,
                         mesh: Any | None = None) -> tuple[int, dict]:
    """Measure a short calibration drain at each candidate ring depth and
    pick one (``serve --device-loop auto``): the drive half of the
    autotuner, whose policy is :func:`~..fused.device_loop
    .choose_ring_depth`.  Each candidate serves a deep prefilled
    synthetic backlog with a throwaway engine of its own, captured for
    its depth; the engine, its graphs and their memory pools are freed
    before the next (each holds a full table), so the serving engine
    boots into a clean card.  Table and stats never leak into
    serving."""
    from flowsentryx_tpu_torch.engine.sources import ArraySource
    from flowsentryx_tpu_torch.engine.traffic import (
        Scenario, TrafficGen, TrafficSpec,
    )
    from flowsentryx_tpu_torch.engine.writeback import NullSink

    recs = TrafficGen(TrafficSpec(
        scenario=Scenario.UDP_FLOOD_MULTI, rate_pps=1e7,
        n_attack_ips=8, n_benign_ips=24, attack_fraction=0.8,
        seed=seed)).next_records(batches * cfg.batch.max_batch)
    measurements: list[dict] = []
    for d in sorted(set(int(c) for c in candidates)):
        eng = Engine(cfg, ArraySource(np.copy(recs)), NullSink(),
                     params=params, device=device, mega_n=mega_n,
                     device_loop=d, sink_thread=False, mesh=mesh)
        eng.warm()
        t0 = time.perf_counter()
        rep = eng.run()
        wall = time.perf_counter() - t0
        cuda = eng._cuda
        del eng
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        d_l = rep.dispatch["device_loop"]
        measurements.append({
            "ring": d,
            "rounds": d_l["rounds"],
            "ring_occupancy": d_l["ring_occupancy"],
            "overlap_fraction": d_l["h2d"]["overlap_fraction"],
            "records_per_s": round(rep.records / max(wall, 1e-9), 1),
        })
    depth, detail = dl.choose_ring_depth(measurements)
    detail["calibration_batches"] = batches
    return depth, detail
