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

:func:`engine_main`'s drain mode (``spec["drain"]``) and the net settle
(``spec["net_settle_s"]``: after the run, merge the network leg until
its canonical map holds still, report, then keep gossiping until the
stop) are this port's additions for timed fleet runs; the rest is the
reference's.

:func:`prewarm_main` builds an elastic fleet's kernels into the compile
cache at boot, for the spares a GROW spawns later.

:func:`stub_engine_main` speaks the same status-block protocol but boots
in milliseconds and imports no torch: the supervisor's restart machinery
is tested against it on the CPU.

All three are ``spawn`` targets and move into their own process group first:
the engine's drain workers inherit it, so the supervisor can ``killpg``
a crashed engine's whole tree (an orphaned worker still consuming a
ring shard would be a second consumer once the replacement boots).
"""

from __future__ import annotations

import json
import os
import sys
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
    unless given), and the serve options; in a multi-host fleet also
    ``t0_wall_ns`` and ``net``, the CLI's net spec.  A rank that cannot
    serve on its device — no card, a kernel that does not build or
    launch — ends ``CSTATE_FAILED``; it never falls back to the CPU."""
    _own_process_group()
    net = None
    if spec.get("net"):
        # the multi-host leg: its socket lives in the engine process,
        # its counters ride the report's gossip block (numpy only)
        from flowsentryx_tpu_torch.cluster.transport import (
            engine_net_mailbox,
        )

        net = engine_net_mailbox(spec["net"], spec["rank"],
                                 spec["t0_ns"], spec["t0_wall_ns"])
    plane = GossipPlane(spec["cluster_dir"], spec["rank"],
                        spec["n_engines"], net=net)
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
    finally:
        if net is not None:
            net.close()


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
    # the live-rebalance hooks (cluster/rebalance.py): the boot-time
    # reconcile first (adopt a committed but uninserted spool, drop the
    # rows the committed layout gave away: the two deaths after a flip),
    # then the handoff state machine between run chunks below
    from flowsentryx_tpu_torch.cluster.rebalance import EngineRebalancer

    rebalancer = EngineRebalancer(
        spec["cluster_dir"], rank, plane.status,
        crash_midship=bool(spec.get("handoff_crash_midship")))
    t_rec = time.perf_counter()
    reconciled = rebalancer.reconcile(eng)
    eng.boot_reconcile_s = time.perf_counter() - t_rec
    eng.warm(tiered=bool(spec.get("tiered_warm")))
    if spec.get("ready_token"):
        Path(spec["ready_token"]).touch()
    if spec.get("start_token"):
        _wait_for_token(spec["start_token"])
    if plane.net is not None:
        # peer discovery with backoff, fail-open on timeout: a silent
        # peer host is its own supervisor's incident, and its first
        # HELLO triggers a full-map resync when it appears
        from flowsentryx_tpu_torch.cluster.transport import (
            NetHandshakeTimeout,
        )

        try:
            plane.net.handshake(
                spec["net"].get("handshake_timeout_s",
                                tuning.NET_HANDSHAKE_TIMEOUT_S))
        except NetHandshakeTimeout as e:
            print(f"fsx cluster rank {rank}: {e} — serving fail-open",
                  file=sys.stderr)
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
        runs = 1
        plane.note_progress(rep.batches, rep.records)
    else:
        runs = 0
        while True:
            rep = eng.run(max_seconds=chunk_s)
            runs += 1
            plane.note_progress(rep.batches, rep.records)
            rebalancer.step(eng)
            if next_ckpt is not None and time.monotonic() >= next_ckpt:
                eng.checkpoint(ckpt)
                # the checkpoint now holds any adopted rows: the staged
                # spool (their durable copy until this save) goes
                rebalancer.note_checkpointed()
                next_ckpt = time.monotonic() + every
            if plane.stop_requested():
                # drain-on-stop: the workers empty their shards, the
                # engine serves the tail, then the rank exits
                source.request_stop()
                rep = eng.run()
                runs += 1
                plane.note_progress(rep.batches, rep.records)
                break
            if source.exhausted():
                break
    wall = time.perf_counter() - t0
    drain_end_wall_ns = time.time_ns()
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
    settle = None
    if plane.net is not None and spec.get("net_settle_s"):
        settle = net_settle(plane, spec["net_settle_s"], drain_end_wall_ns)
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
            "reconciled": reconciled,
            "pid": os.getpid(),
            # this rank's launch window and its run() calls (one report,
            # so one table_summary, each)
            "launches": launches,
            "runs": runs,
            "report": rep._asdict(),
        }
        if settle is not None:
            out["net_settle"] = settle
        _write_report(spec["report_path"], out)
        if settle is not None:
            # keep the gossip (heartbeat, resync, merges) alive until the
            # supervisor's stop, then report the plane as it ended
            while not plane.stop_requested():
                plane.tick(force=True)
                time.sleep(plane.merge_interval_s)
            out["report"]["cluster"] = plane.report()
            _write_report(spec["report_path"], out)


def _write_report(path: str, out: dict) -> None:
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(json.dumps(out, indent=2) + "\n")


def net_settle(plane: GossipPlane, settle_s: float, drain_end_wall_ns: int,
               timeout_s: float = 60.0) -> dict:
    """After a drain, merge the network leg until its canonical map has
    not changed for ``settle_s`` (bounded by ``timeout_s``): the fleet's
    cross-host convergence, seen from this engine.  Returns the wall
    stamps (CLOCK_REALTIME ns) of the drain's end and of the map's last
    change, the map (``[key, until_wall_us]`` pairs, sorted), the keys
    this engine originated in the same form, and their digests."""
    from flowsentryx_tpu_torch.cluster.transport import (
        map_digest, until_wall_us,
    )

    net = plane.net
    t_end = time.monotonic() + timeout_s
    digest = map_digest(net.net_map)
    changed_ns = time.time_ns()
    still_since = time.monotonic()
    ticks = 0
    while time.monotonic() < t_end:
        plane.tick(force=True)
        ticks += 1
        d = map_digest(net.net_map)
        if d != digest:
            digest, changed_ns = d, time.time_ns()
            still_since = time.monotonic()
        elif time.monotonic() - still_since >= settle_s:
            break
        time.sleep(plane.merge_interval_s)
    own = dict(zip(net._own_map, until_wall_us(
        list(net._own_map.values()), net.t0_wall_ns).tolist()))
    return {
        "drain_end_wall_ns": drain_end_wall_ns,
        "changed_wall_ns": changed_ns,
        "settled": time.monotonic() - still_since >= settle_s,
        "ticks": ticks,
        "t0_wall_ns": net.t0_wall_ns,
        "net_digest": digest,
        "net_map": sorted(net.net_map.items()),
        "own_digest": map_digest(own),
        "own_map": sorted(own.items()),
    }


def prewarm_main(spec: dict) -> int:
    """One-shot fleet pre-warm: build the fleet's staged geometry into
    the compile cache, so that a later GROW spare (or a crash respawn)
    loads every kernel from it instead of running ``nvcc`` while the
    burst it was spawned for lands.  The supervisor spawns it at an
    elastic fleet's boot when the specs carry ``compile_cache``; the
    spares share the ranks' spec, so one child with an empty source
    covers them all: ``warm()`` the full ladder, then exit.  Best effort:
    the fleet never waits on it, and if it fails a spare builds its
    kernels itself."""
    _own_process_group()
    try:
        import numpy as np

        from flowsentryx_tpu_torch.core import wire
        from flowsentryx_tpu_torch.core.config import FsxConfig
        from flowsentryx_tpu_torch.engine import Engine, NullSink
        from flowsentryx_tpu_torch.engine.sources import ArraySource

        device = spec.get("device", "cuda")
        cfg = FsxConfig.from_json(spec["cfg_json"])
        params = None
        if spec.get("artifact"):
            from flowsentryx_tpu_torch.models.registry import load_artifact

            params = load_artifact(cfg.model.name, spec["artifact"], device)
        eng = Engine(
            cfg, ArraySource(np.empty(0, wire.FLOW_RECORD_DTYPE)),
            NullSink(),
            params=params,
            device=device,
            mega_n=spec.get("mega") or 0,
            device_loop=spec.get("device_loop", 0),
            slo_us=spec.get("slo_us") or 0,
            sink_thread=False,
            compile_cache=spec["compile_cache"],
        )
        eng.warm()
        rep = eng._cache.report() if eng._cache is not None else {}
        print(f"fsx cluster prewarm: cache ready at {rep.get('dir')} "
              f"(stores {rep.get('stores', 0)}, hits "
              f"{rep.get('hits', 0)}): GROW spares load from it",
              file=sys.stderr)
        return 0
    except BaseException:  # noqa: BLE001 — best effort, announced
        traceback.print_exc()
        return 1


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
