"""Cluster engine-process entry points.

Counterpart of ``flowsentryx_tpu/cluster/runner.py``.
:func:`engine_main` is what one ``fsx cluster`` engine process runs: a
full serving engine on the card (its own drain workers, dispatch arena
and flow table) owning one shard span, wired into the gossip plane,
speaking the supervisor's lifecycle protocol (status-block states,
heartbeats through the gossip tick, stop-drain on ``c_stop``) and
writing its :class:`~flowsentryx_tpu_torch.engine.engine.EngineReport`
as JSON where the supervisor aggregates it.  A rank's CUDA context is
its own: the supervisor spawns it and never touches the card.

:func:`stub_engine_main` speaks the same status-block protocol but boots
in milliseconds and imports no torch: the supervisor's restart machinery
is tested against it on the CPU.

Both are ``spawn`` targets and move into their own process group first:
the engine's drain workers inherit it, so the supervisor can ``killpg``
a crashed engine's whole tree (an orphaned worker still consuming a
ring shard would be a second consumer once the replacement boots).
"""

from __future__ import annotations

import json
import os
import time
import traceback
from pathlib import Path

from flowsentryx_tpu_torch.cluster.gossip import GossipPlane
from flowsentryx_tpu_torch.cluster.mailbox import StatusBlock, status_path
from flowsentryx_tpu_torch.core import wire
from flowsentryx_tpu_torch.sync import tuning


def _own_process_group() -> None:
    try:
        os.setpgid(0, 0)
    except OSError:
        pass  # already a group leader


def pin_core_for(rank: int, n_engines: int, mode: str = "auto",
                 ncpu: int | None = None) -> int | None:
    """Which core rank ``rank`` of ``n_engines`` owns, or None for the
    scheduler's choice.  ``auto`` pins rank r to core r exactly when
    the fleet fits the host; ``on`` pins regardless (modulo the host);
    ``off`` never pins."""
    ncpu = ncpu or os.cpu_count() or 1
    if mode == "off":
        return None
    if mode == "auto" and n_engines > ncpu:
        return None
    return rank % ncpu


def pin_to_core(core: int) -> None:
    """Pin this engine process (and the drain workers that inherit its
    mask) to ``core``, and size torch's intra-op pool to that one core:
    the pool is sized from the core count, not the mask, and would
    otherwise time-slice many threads on one core."""
    import torch

    os.sched_setaffinity(0, {core})
    torch.set_num_threads(1)


def _wait_for_token(path: str, timeout_s: float = 120.0) -> None:
    deadline = time.monotonic() + timeout_s
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"start token {path} never appeared")
        time.sleep(0.005)


def engine_main(spec: dict) -> int:
    """One cluster engine process.  ``spec`` is a plain JSON-able dict
    (``cli.py``'s ``_cmd_cluster`` and the supervisor fill it): ``rank``,
    ``n_engines``, ``cluster_dir``, ``gen``, ``t0_ns``, ``cfg_json``,
    ``ring_base``, ``workers``, ``total_shards``, ``device`` (``"cuda"``
    unless given), and the serve options.  A rank that cannot serve on
    its device — no card, a kernel that does not build or launch — ends
    ``CSTATE_FAILED``; it never falls back to the CPU."""
    _own_process_group()
    plane = GossipPlane(spec["cluster_dir"], spec["rank"],
                        spec["n_engines"])
    plane.status.ctl_set("c_pid", os.getpid())
    plane.set_state(wire.CSTATE_SPAWNING)
    try:
        _serve(spec, plane)
        plane.set_state(wire.CSTATE_DONE)
        return 0
    except BaseException:  # noqa: BLE001 — the crash IS the payload
        traceback.print_exc()
        plane.set_state(wire.CSTATE_FAILED)
        return 1


def _serve(spec: dict, plane: GossipPlane) -> None:
    # torch and the engine import only here, in the child, timed: the
    # import is part of boot-to-serving (EngineReport.boot["import_s"])
    t_imp = time.perf_counter()
    from flowsentryx_tpu_torch.core.config import FsxConfig
    from flowsentryx_tpu_torch.engine import Engine, NullSink
    from flowsentryx_tpu_torch.ingest import ShardedIngest
    from flowsentryx_tpu_torch.ops import kernels

    import_s = time.perf_counter() - t_imp
    if spec.get("pin_core") is not None:
        # before the engine exists: its drain workers inherit the mask
        pin_to_core(spec["pin_core"])

    rank, n = spec["rank"], spec["n_engines"]
    w = spec["workers"]
    device = spec.get("device", "cuda")
    cfg = FsxConfig.from_json(spec["cfg_json"])
    source = ShardedIngest(spec["ring_base"], w, shard_offset=rank * w,
                           total_shards=spec["total_shards"])
    if spec.get("verdict_ring"):
        from flowsentryx_tpu_torch.engine.shm import ShmVerdictSink

        sink = ShmVerdictSink(spec["verdict_ring"])
    else:
        sink = NullSink()
    params = None
    if spec.get("artifact"):
        from flowsentryx_tpu_torch.models.registry import load_artifact

        params = load_artifact(cfg.model.name, spec["artifact"], device)
    eng = Engine(
        cfg, source, sink,
        params=params,
        device=device,
        t0_ns=spec["t0_ns"],
        mega_n=spec.get("mega") or 0,
        device_loop=spec.get("device_loop", 0),
        slo_us=spec.get("slo_us") or 0,
        predict=bool(spec.get("predict")),
        gossip=plane,
        compile_cache=spec.get("compile_cache"),
    )
    eng.boot_import_s = round(import_s, 4)
    restore_info = None
    if spec.get("restore"):
        restore_info = eng.restore(spec["restore"])
    # (the reference reconciles and steps its live-rebalance hooks here
    # and between run chunks; they come back with cluster/rebalance.py,
    # ROADMAP queue 1)
    eng.warm(tiered=bool(spec.get("tiered_warm")))
    if spec.get("ready_token"):
        Path(spec["ready_token"]).touch()
    if spec.get("start_token"):
        _wait_for_token(spec["start_token"])
    plane.set_state(wire.CSTATE_SERVING)
    # this rank's launch window: zeroed here, read after its last run
    kernels.reset_launches()

    chunk_s = spec.get("chunk_s", 0.5)
    ckpt = spec.get("checkpoint")
    every = spec.get("checkpoint_every") or 0
    t0 = time.perf_counter()
    next_ckpt = time.monotonic() + every if (ckpt and every) else None
    if spec.get("drain"):
        # drain mode: the ring shards are prefilled and the rank serves
        # them to exhaustion in ONE timed run (no chunk boundaries inside
        # the measured wall).  The epoch reaches the workers before the
        # stop does: a worker that sees the stop with no epoch agreed
        # seals nothing and exits (the reference's order — stop, then
        # run() imposes the epoch — loses a shard when a worker polls
        # in between)
        source.set_t0(eng.batcher.t0_ns)
        source.request_stop()
        rep = eng.run()
        plane.note_progress(rep.batches, rep.records)
    else:
        while True:
            rep = eng.run(max_seconds=chunk_s)
            plane.note_progress(rep.batches, rep.records)
            if next_ckpt is not None and time.monotonic() >= next_ckpt:
                eng.checkpoint(ckpt)
                next_ckpt = time.monotonic() + every
            if plane.stop_requested():
                # drain-on-stop: the workers empty their shards, the
                # engine serves the tail, then the rank exits
                source.request_stop()
                rep = eng.run()
                plane.note_progress(rep.batches, rep.records)
                break
            if source.exhausted():
                break
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    # converge on shutdown: DRAINING (every publish of this engine
    # happened before this store), then merge the peers' wires until
    # each peer also left SERVING and the mailboxes run dry, so
    # co-terminating drains report the same blacklist views
    plane.set_state(wire.CSTATE_DRAINING)
    peers = {p: StatusBlock(status_path(spec["cluster_dir"], p))
             for p in range(n) if p != rank}
    quiet = (wire.CSTATE_DRAINING, wire.CSTATE_DONE, wire.CSTATE_FAILED)
    plane.quiesce(
        spec.get("gossip_quiesce_s", tuning.GOSSIP_QUIESCE_S),
        peers_quiet=lambda: all(st.ctl_get("c_state") in quiet
                                for st in peers.values()))
    rep = rep._replace(cluster=plane.report())
    if ckpt:
        eng.checkpoint(ckpt)
    source.close()
    rep = rep._replace(
        wall_s=round(wall, 4),
        records_per_s=round(rep.records / max(wall, 1e-9), 1),
        ingest=source.ingest_stats(),
    )
    if spec.get("report_path"):
        out = {
            "rank": rank, "n_engines": n, "gen": spec.get("gen", 0),
            "restored": restore_info,
            "pid": os.getpid(),
            "launches": launches,
            "report": rep._asdict(),
        }
        p = Path(spec["report_path"])
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(json.dumps(out, indent=2) + "\n")


def stub_engine_main(spec: dict) -> int:
    """Lifecycle-protocol stub: heartbeats, honors stop, optionally dies
    on schedule (``stub_crash_after_s``, first generation only, or every
    generation with ``stub_crash_every_gen``) and records the restore
    path the supervisor handed it."""
    _own_process_group()
    plane = GossipPlane(spec["cluster_dir"], spec["rank"],
                        spec["n_engines"])
    plane.status.ctl_set("c_pid", os.getpid())
    plane.set_state(wire.CSTATE_SPAWNING)
    gen = spec.get("gen", 0)
    crash_after = spec.get("stub_crash_after_s")
    serve_s = spec.get("stub_serve_s", 0.5)
    plane.set_state(wire.CSTATE_SERVING)
    t0 = time.monotonic()
    while time.monotonic() - t0 < serve_s:
        plane.tick(force=True)  # heartbeat + merge, the engine cadence
        if plane.stop_requested() and not spec.get("stub_ignore_stop"):
            break
        if crash_after is not None \
                and (gen == 0 or spec.get("stub_crash_every_gen")) \
                and time.monotonic() - t0 >= crash_after:
            os._exit(17)  # a hard death: no cleanup, no DONE
        time.sleep(0.01)
    if spec.get("report_path"):
        p = Path(spec["report_path"])
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(json.dumps({
            "rank": spec["rank"], "gen": gen, "stub": True,
            "restored": spec.get("restore"),
            "report": {"records": 0, "batches": 0},
        }) + "\n")
    plane.set_state(wire.CSTATE_DONE)
    return 0
