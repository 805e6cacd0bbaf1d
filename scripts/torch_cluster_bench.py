"""Paced scale-out comparison: two engine processes against the port's
own pre-cluster single engine, on the same sealed corpus.

The port of the reference's ``scripts/cluster_bench.py`` (``fsx bench
--cluster``).  One side is two engine processes, each owning one shard
of the IP-hash fan-out end to end and exchanging blacklists over the
gossip plane; the other is the single engine of the port's last commit
before ``flowsentryx_tpu_torch/cluster/`` existed (``c8043dd``), draining
the same two-shard fan-out with two drain workers.  Target: the
cluster's aggregate records/s at 1.6x the single engine's on the
latency shape.

The two serving shapes (:data:`SHAPES`), as the reference has them:

* ``latency``: batch 128, no mega coalescing, 2,400 batches a trial --
  per-batch dispatch cost dominates and the single engine serializes
  both shards through one dispatch thread.  The headline.
* ``throughput``: batch 256, ``mega_n="auto"``, 1,600 batches a trial.

Method (the reference's):

* all three engine processes (the baseline, two cluster ranks; one
  warmed engine per shape each) are persistent: every capture and every
  kernel build happens in ``warm()``, outside every timed trial;
* trials are interleaved ABAB (the order alternates per shape per
  trial), synchronized by file tokens, every trial's rings created and
  prefilled afresh by the orchestrator;
* a trial times only the sealed drain: the drain workers seal the whole
  corpus first and exit, then ``Engine.run`` drains it to exhaustion;
* a cluster trial's rate is all records over the slowest rank's wall;
* four failure checks per trial: the single served what was produced,
  each rank served its shard, each rank's merged digest equals its
  peer's published digest, zero gossip RX sequence gaps.

Each rank is pinned to its own core (``cluster/runner.py::pin_core_for``
and ``pin_to_core``, one torch thread); the single engine keeps the
whole host.  Every role runs on ``--device``, by default the card.

**Why a script and not a package module.**  A role puts its ``--repo``
first on ``sys.path`` and only then imports ``flowsentryx_tpu_torch``;
the single role imports the baseline's package, which has the same name
as today's.  So this file imports nothing of the package at module
level, and the roles are spawned by path, never with ``-m``.

**The baseline tree.**  ``--baseline-repo DIR`` (default
``build/fsx_port_pr9_tree``) must hold ``flowsentryx_tpu_torch/``; make
it from the repository's own history::

    git worktree add --detach build/fsx_port_pr9_tree c8043dd
    # or
    mkdir -p build/fsx_port_pr9_tree
    git archive c8043dd flowsentryx_tpu_torch | tar -x -C build/fsx_port_pr9_tree

It builds its kernels from its own ``csrc/`` into its own
``build/kernels`` (``FSX_KERNEL_BUILD`` is unset for that role).  Where
its ring code does not read the ring layout of today's ``core/wire.py``
(:func:`ring_layout` differs), the single role prefills its own rings
with its own code from the same corpus, and the artifact says so
(``baseline_rings``).

    python3 scripts/torch_cluster_bench.py [--trials 6]
        [--baseline-repo DIR] [--device D] [--out build/CLUSTER_torch.json]
        [--cut N]

``--cut N`` divides each shape's ``total_batches`` by N (batch size and
mega unchanged) and is recorded in the artifact's ``config``; only the
tests and ``chip_smoke.py`` use it.  Progress goes to stderr; stdout
gets one JSON line, the latency shape's headline with ``ok``, the
failures, each shape's headline, ``device_kind`` and ``power_limit_w``.
Exit codes (the reference's): 2 when the baseline tree lacks the
package, 1 on a failure or a missed target, and 1 naming the device when
there is no card and no ``--device cpu``.  (``--role single|rank`` are
the orchestrator's own invocations.)
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: The port's last commit before ``flowsentryx_tpu_torch/cluster/``.
BASELINE_COMMIT = "c8043dd"
DEFAULT_BASELINE = os.path.join(REPO, "build", "fsx_port_pr9_tree")
DEFAULT_OUT = os.path.join(REPO, "build", "CLUSTER_torch.json")
TARGET_SCALING_X = 1.6

#: (name, batch, mega_n, total_batches).  ``latency`` is the headline
#: shape (module docstring); ``throughput`` the disclosure.
SHAPES = [
    ("latency", 128, 0, 2400),
    ("throughput", 256, "auto", 1600),
]


def log(msg: str) -> None:
    print(f"bench: {msg}", file=sys.stderr, flush=True)


def _records(n: int, seed: int, batch: int):
    from flowsentryx_tpu_torch.engine.traffic import (
        Scenario, TrafficGen, TrafficSpec,
    )

    # many flows: the IP-hash fan-out splits flows, so few hot sources
    # would give one shard most records and the slowest rank's wall
    # would measure data skew, not engine scaling
    return TrafficGen(TrafficSpec(
        scenario=Scenario.UDP_FLOOD_MULTI, rate_pps=1e7,
        n_attack_ips=2048, n_benign_ips=4096, attack_fraction=0.8,
        seed=seed,
    )).next_records(batch * n)


def _cfg(batch: int):
    import dataclasses

    from flowsentryx_tpu_torch.core.config import FsxConfig

    cfg = FsxConfig()
    return dataclasses.replace(
        cfg,
        batch=dataclasses.replace(cfg.batch, max_batch=batch),
        table=dataclasses.replace(cfg.table, capacity=1 << 16),
        limiter=dataclasses.replace(cfg.limiter, pps_threshold=200.0,
                                    bps_threshold=1e9),
    )


def shapes_for(cut: int) -> list:
    """:data:`SHAPES` with each ``total_batches`` divided by ``cut``."""
    return [(n, b, m, max(1, tb // cut)) for n, b, m, tb in SHAPES]


def _wait(path: str, timeout_s: float = 900.0, procs=()) -> None:
    """Wait for a sync token; raise at the deadline, or at once when one
    of ``procs`` (``(label, Popen)``) has exited non-zero."""
    deadline = time.monotonic() + timeout_s
    while not os.path.exists(path):
        for label, p in procs:
            if p.poll() not in (None, 0):
                raise RuntimeError(
                    f"{label} exited {p.returncode} before {path}")
        if time.monotonic() > deadline:
            raise TimeoutError(f"sync token {path} never appeared")
        time.sleep(0.01)


def _ring_base(sync: str, config: str, shape: str, trial: int) -> str:
    return os.path.join(sync, f"rings_{config}_{shape}_{trial}", "fring")


def _write(path: str, text: str = "1") -> None:
    """A sync token with its payload, whole when it appears (the waiter
    reads it as soon as the path exists)."""
    with open(path + ".tmp", "w") as f:
        f.write(text)
    os.replace(path + ".tmp", path)


def _read_json(path: str):
    with open(path) as f:
        return json.load(f)


def _append_line(path: str, rec: dict) -> None:
    with open(path, "a") as f:
        f.write(json.dumps(rec) + "\n")


def _read_lines(path: str) -> list:
    with open(path) as f:
        return [json.loads(ln) for ln in f]


def ring_layout() -> dict:
    """What a ring reader must agree on with the rings' writer, from the
    importable ``core/wire.py``: the header's magic and offsets, the
    record dtype, the fan-out's hash and the shard ring names."""
    import numpy as np

    from flowsentryx_tpu_torch.core import wire

    consts = ("SHM_MAGIC", "SHM_HDR_SIZE", "SHM_CAPACITY_OFFSET",
              "SHM_RECORD_SIZE_OFFSET", "SHM_HEAD_OFFSET", "SHM_TAIL_OFFSET")
    return json.loads(json.dumps({
        **{c: getattr(wire, c, None) for c in consts},
        "record": str(wire.FLOW_RECORD_DTYPE.descr),
        "shard_of": wire.shard_of(np.arange(1, 257), 2).tolist(),
        "names": [wire.shard_ring_path("r", k, 2) for k in range(2)]}))


# ---------------------------------------------------------------------------
# runner roles (spawned by the orchestrator; --repo picks the code tree)
# ---------------------------------------------------------------------------


def _drain_one(eng, src, t0_ns: int, seal_timeout_s: float = 180.0):
    """The shared trial shape: impose the epoch, let the drain workers
    seal the WHOLE corpus (``queue_slots`` covers every batch, so they
    never block on the consumer and exit DONE), then time the pure
    sealed drain, stop to exhaustion: dequeue -> stage -> upload ->
    dispatch -> reap."""
    from flowsentryx_tpu_torch.core import wire

    src.set_t0(t0_ns)
    src.request_stop()
    deadline = time.monotonic() + seal_timeout_s
    while any(q.ctl_get("wstate") != wire.WSTATE_DONE
              for q in src._queues):
        if time.monotonic() > deadline:
            raise TimeoutError("drain workers never finished sealing")
        time.sleep(0.02)
    tw = time.perf_counter()
    rep = eng.run()
    return rep, time.perf_counter() - tw


def _queue_slots(total_batches: int) -> int:
    """Power-of-two sealed-queue depth covering every batch a shard
    could seal (the whole corpus in the worst skew), so pre-sealing
    never blocks on the consumer."""
    return 1 << (total_batches + 2).bit_length()


def _build_engines(t0_ns: int, shapes, device, gossip=None) -> dict:
    import numpy as np

    from flowsentryx_tpu_torch.engine import ArraySource, CollectSink, Engine

    dtype = _records(1, 0, 1).dtype
    engines = {}
    for name, batch, mega, _tb in shapes:
        kw = {"gossip": gossip} if gossip is not None else {}
        eng = Engine(_cfg(batch), ArraySource(np.empty(0, dtype)),
                     CollectSink(), mega_n=mega, device=device,
                     sink_thread=False, t0_ns=t0_ns, **kw)
        eng.warm()
        engines[name] = eng
    return engines


def _device_kind(device) -> str:
    import torch

    dev = torch.device(device) if device is not None else torch.device(
        "cuda")
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def _counted_drain(eng, src, t0_ns: int):
    """:func:`_drain_one` in a launch window of its own (the role's
    ``kernels.LAUNCHES``, zeroed just before, read just after)."""
    from flowsentryx_tpu_torch.ops import kernels

    kernels.reset_launches()
    rep, wall = _drain_one(eng, src, t0_ns)
    return rep, wall, dict(kernels.LAUNCHES)


def run_single(args) -> int:
    sys.path.insert(0, args.repo)

    import numpy as np

    from flowsentryx_tpu_torch.engine import CollectSink
    from flowsentryx_tpu_torch.ingest import ShardedIngest

    meta = _read_json(os.path.join(args.sync, "meta.json"))
    t0_ns = meta["t0_ns"]
    shapes = [tuple(s) for s in meta["shapes"]]
    own_rings = ring_layout() != meta["ring_layout"]
    engines = _build_engines(t0_ns, shapes, args.device)
    _write(os.path.join(args.sync, "ready_single"), json.dumps(
        {"rings": "own" if own_rings else "orchestrator",
         "device_kind": _device_kind(args.device)}))
    for t in range(args.trials):
        for name, batch, mega, tb in shapes:
            _wait(os.path.join(args.sync, f"go_single_{name}_{t}"))
            if own_rings:
                corpus = os.path.join(args.sync, f"corpus_{name}_{t}.npy")
                _prefill(args.sync, "s", name, t, np.load(corpus))
            src = ShardedIngest(_ring_base(args.sync, "s", name, t), 2,
                                queue_slots=_queue_slots(tb),
                                precompact=False)
            sink = CollectSink()
            eng = engines[name]
            eng.reset_stream(src, sink, t0_ns=t0_ns)
            try:
                rep, wall, launches = _counted_drain(eng, src, t0_ns)
            finally:
                src.close()
            _append_line(os.path.join(args.sync, "single.jsonl"), {
                "trial": t, "shape": name, "records": rep.records,
                "batches": rep.batches, "wall_s": round(wall, 4),
                "mpps": round(rep.records / wall / 1e6, 4),
                "blocked": len(sink.blocked), "launches": launches})
            _write(os.path.join(args.sync, f"done_single_{name}_{t}"))
    return 0


def run_rank(args) -> int:
    sys.path.insert(0, args.repo)

    from flowsentryx_tpu_torch.cluster.gossip import GossipPlane
    from flowsentryx_tpu_torch.cluster.runner import pin_core_for, pin_to_core
    from flowsentryx_tpu_torch.engine import CollectSink
    from flowsentryx_tpu_torch.ingest import ShardedIngest

    meta = _read_json(os.path.join(args.sync, "meta.json"))
    t0_ns = meta["t0_ns"]
    shapes = [tuple(s) for s in meta["shapes"]]
    r = args.rank
    # the per-core deployment shape (what fsx cluster --pin-cores auto
    # boots): the rank, and the drain worker that inherits its mask, on
    # a core of its own with a one-thread torch pool; the baseline is
    # not pinned and keeps the whole host
    pin_to_core(pin_core_for(r, 2, "on"))
    plane = GossipPlane(os.path.join(args.sync, "plane"), r, 2,
                        sink=CollectSink())
    engines = _build_engines(t0_ns, shapes, args.device, gossip=plane)
    _write(os.path.join(args.sync, f"ready_rank{r}"),
           json.dumps({"device_kind": _device_kind(args.device)}))
    for t in range(args.trials):
        for name, batch, mega, tb in shapes:
            _wait(os.path.join(args.sync, f"go_cluster_{name}_{t}"))
            src = ShardedIngest(_ring_base(args.sync, "c", name, t), 1,
                                shard_offset=r, total_shards=2,
                                queue_slots=_queue_slots(tb),
                                precompact=False)
            sink = CollectSink()
            eng = engines[name]
            eng.reset_stream(src, sink, t0_ns=t0_ns)
            try:
                rep, wall, launches = _counted_drain(eng, src, t0_ns)
            finally:
                src.close()
            # local drain done; quiesce the gossip so both ranks' digests
            # cover everything either will publish this step
            _write(os.path.join(args.sync, f"drained_rank{r}_{name}_{t}"))
            _wait(os.path.join(args.sync,
                               f"drained_rank{1 - r}_{name}_{t}"))
            plane.quiesce(10.0)
            g = plane.report()
            _append_line(os.path.join(args.sync, f"rank{r}.jsonl"), {
                "trial": t, "shape": name, "rank": r,
                "records": rep.records, "batches": rep.batches,
                "wall_s": round(wall, 4),
                "mpps": round(rep.records / wall / 1e6, 4),
                "blocked": len(sink.blocked),
                "published_digest": g["published_digest"],
                "merged_digest": g["merged_digest"],
                "rx_seq_gaps": g["rx_seq_gaps"],
                "tx_dropped": g["tx_dropped"], "launches": launches})
            _write(os.path.join(args.sync, f"done_rank{r}_{name}_{t}"))
    return 0


# ---------------------------------------------------------------------------
# orchestrator
# ---------------------------------------------------------------------------


def _prefill(sync: str, config: str, shape: str, trial: int,
             recs) -> list[int]:
    from flowsentryx_tpu_torch.core import wire
    from flowsentryx_tpu_torch.engine.shm import ShmRing

    base = _ring_base(sync, config, shape, trial)
    os.makedirs(os.path.dirname(base), exist_ok=True)
    shard = wire.shard_of(recs["saddr"], 2)
    counts = []
    cap = 1 << max(16, int(len(recs)).bit_length())
    for k in range(2):
        ring = ShmRing.create(wire.shard_ring_path(base, k, 2),
                              cap, wire.FLOW_RECORD_DTYPE)
        part = recs[shard == k]
        assert ring.produce(part) == len(part), f"shard {k} overflow"
        counts.append(int(len(part)))
    return counts


def _summarize(trials: list[dict]) -> dict:
    # a TRUE median (mean of the middle pair for even counts): the
    # upper-middle order statistic would bias the headline
    # optimistically on even trial counts
    med = round(statistics.median(
        t["scaling_x"] for t in trials), 3)
    med_single = round(statistics.median(
        t["single_mpps"] for t in trials), 4)
    med_cluster = round(statistics.median(
        t["cluster_agg_mpps"] for t in trials), 4)
    s_range = [min(t["single_mpps"] for t in trials),
               max(t["single_mpps"] for t in trials)]
    c_range = [min(t["cluster_agg_mpps"] for t in trials),
               max(t["cluster_agg_mpps"] for t in trials)]
    return {
        "median_single_mpps": med_single,
        "median_cluster_agg_mpps": med_cluster,
        "median_scaling_x": med,
        "single_range_mpps": s_range,
        "cluster_range_mpps": c_range,
        "ranges_disjoint": c_range[0] > s_range[1],
    }


def missing_baseline(baseline_repo: str) -> str | None:
    """The refusal for a baseline tree without the package, naming both
    ways to make it; None when the tree is there."""
    if os.path.isdir(os.path.join(baseline_repo, "flowsentryx_tpu_torch")):
        return None
    return (f"baseline repo {baseline_repo} holds no flowsentryx_tpu_torch/ "
            f"(make it from the pre-cluster commit {BASELINE_COMMIT} first: "
            f"git worktree add --detach {baseline_repo} {BASELINE_COMMIT}, "
            f"or mkdir -p {baseline_repo} && git archive {BASELINE_COMMIT} "
            f"flowsentryx_tpu_torch | tar -x -C {baseline_repo})")


def preflight(baseline_repo: str, device: str | None
              ) -> tuple[int, str] | None:
    """``(exit code, message)`` when the run cannot start -- 2 for a
    baseline tree without the package, 1 when ``device`` (None: the
    card) is not there -- else None.  Nothing is spawned before it."""
    why = missing_baseline(baseline_repo)
    if why is not None:
        return 2, why
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    from flowsentryx_tpu_torch.core.device import resolve_device

    try:
        resolve_device(device)
    except RuntimeError as e:
        return 1, str(e)
    return None


def _power_limit_w() -> float | None:
    from flowsentryx_tpu_torch import bench

    return bench.smi_power()[1]


def orchestrate(args) -> int:
    sys.path.insert(0, REPO)
    refused = preflight(args.baseline_repo, args.device)
    if refused is not None:
        rc, msg = refused
        print(f"bench: {msg}", file=sys.stderr)
        return rc

    from flowsentryx_tpu_torch.cluster.gossip import create_plane

    shapes = shapes_for(args.cut)
    sync = tempfile.mkdtemp(prefix="fsx_clbench_")
    t_start = time.time()
    load0 = os.getloadavg()
    # one shared epoch for every engine in every config, as the
    # supervisor stamps it: trial 0's corpus gives a plausible anchor
    probe = _records(shapes[0][3], 100, shapes[0][1])
    meta = {"t0_ns": int(probe["ts_ns"].min()), "shapes": shapes,
            "ring_layout": ring_layout()}
    _write(os.path.join(sync, "meta.json"), json.dumps(meta))
    create_plane(os.path.join(sync, "plane"), 2)

    common = ["--sync", sync, "--trials", str(args.trials)]
    if args.device is not None:
        common += ["--device", args.device]
    script = os.path.abspath(__file__)
    # the baseline builds its kernels into its own tree's build/
    single_env = {k: v for k, v in os.environ.items()
                  if k != "FSX_KERNEL_BUILD"}
    roles = [("single", ["--role", "single", "--repo", args.baseline_repo],
              single_env)] + [
        (f"rank{r}", ["--role", "rank", "--rank", str(r), "--repo", REPO],
         None) for r in range(2)]
    procs, errs = [], []
    try:
        for label, argv, env in roles:
            errs.append(open(os.path.join(sync, f"{label}.err"), "w"))
            procs.append((label, subprocess.Popen(
                [sys.executable, script] + argv + common, env=env,
                stderr=errs[-1])))
        for name in ("ready_single", "ready_rank0", "ready_rank1"):
            _wait(os.path.join(sync, name), procs=procs)
        ready = {n: _read_json(os.path.join(sync, f"ready_{n}"))
                 for n in ("single", "rank0", "rank1")}
        own_rings = ready["single"]["rings"] == "own"
        log("all three engines warmed (one per shape each)"
            + ("; the baseline prefills its own rings" if own_rings
               else ""))

        produced: dict[str, list[list[int]]] = {
            name: [] for name, *_ in shapes}
        for t in range(args.trials):
            for si, (name, batch, mega, tb) in enumerate(shapes):
                recs = _records(tb, 100 + t * len(shapes) + si, batch)
                counts_c = _prefill(sync, "c", name, t, recs)
                if own_rings:
                    import numpy as np

                    np.save(os.path.join(sync, f"corpus_{name}_{t}.npy"),
                            recs)
                else:
                    counts_s = _prefill(sync, "s", name, t, recs)
                    assert counts_s == counts_c
                produced[name].append(counts_c)
                # alternate which config goes first per shape per trial
                # (ABAB at the step level)
                order = ("single", "cluster") if (t + si) % 2 == 0 \
                    else ("cluster", "single")
                for config in order:
                    _write(os.path.join(sync, f"go_{config}_{name}_{t}"))
                    if config == "single":
                        _wait(os.path.join(
                            sync, f"done_single_{name}_{t}"), procs=procs)
                    else:
                        _wait(os.path.join(
                            sync, f"done_rank0_{name}_{t}"), procs=procs)
                        _wait(os.path.join(
                            sync, f"done_rank1_{name}_{t}"), procs=procs)
                for k in range(2):
                    shutil.rmtree(os.path.dirname(_ring_base(
                        sync, "sc"[k], name, t)), ignore_errors=True)
                log(f"trial {t} shape {name} done ({order[0]} first)")
        for _, p in procs:
            p.wait(timeout=120)
    except BaseException:
        for label, _ in procs:
            with open(os.path.join(sync, f"{label}.err")) as f:
                tail = f.read()[-3000:]
            if tail.strip():
                print(f"bench: {label} stderr:\n{tail}", file=sys.stderr)
        shutil.rmtree(sync, ignore_errors=True)
        raise
    finally:
        for _, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in errs:
            f.close()

    single = _read_lines(os.path.join(sync, "single.jsonl"))
    ranks = [_read_lines(os.path.join(sync, f"rank{r}.jsonl"))
             for r in range(2)]
    load1 = os.getloadavg()

    failures: list[str] = []
    names = [n for n, *_ in shapes]
    by_shape: dict[str, list[dict]] = {name: [] for name in names}
    for i in range(args.trials * len(shapes)):
        s = single[i]
        r0, r1 = ranks[0][i], ranks[1][i]
        name, t = s["shape"], s["trial"]
        assert (r0["shape"], r0["trial"]) == (name, t)
        want = produced[name][t]
        if s["records"] != sum(want):
            failures.append(
                f"{name} trial {t}: single served {s['records']} != "
                f"{sum(want)} produced")
        for r, rep in enumerate((r0, r1)):
            if rep["records"] != want[r]:
                failures.append(
                    f"{name} trial {t}: rank {r} served "
                    f"{rep['records']} != {want[r]} produced into its "
                    f"shard")
        for a, b in ((r0, r1), (r1, r0)):
            if a["merged_digest"] != b["published_digest"]:
                failures.append(
                    f"{name} trial {t}: rank {a['rank']} merged "
                    f"digest != peer published (gossip did not "
                    f"converge)")
            if a["rx_seq_gaps"]:
                failures.append(
                    f"{name} trial {t}: rank {a['rank']} saw "
                    f"{a['rx_seq_gaps']} gossip seq gaps")
        agg_wall = max(r0["wall_s"], r1["wall_s"])
        agg_mpps = round((r0["records"] + r1["records"])
                         / agg_wall / 1e6, 4)
        by_shape[name].append({
            "trial": t,
            "order": "single-first"
                     if (t + names.index(name)) % 2 == 0
                     else "cluster-first",
            "produced_per_shard": want,
            "single_mpps": s["mpps"], "single_wall_s": s["wall_s"],
            "rank_mpps": [r0["mpps"], r1["mpps"]],
            "rank_walls_s": [r0["wall_s"], r1["wall_s"]],
            "cluster_agg_mpps": agg_mpps,
            "scaling_x": round(agg_mpps / s["mpps"], 3),
            # the port's: each role's batches and its drain's launch
            # window, and the blocked sources
            "single_batches": s["batches"],
            "rank_batches": [r0["batches"], r1["batches"]],
            "single_blocked": s["blocked"],
            "rank_blocked": [r0["blocked"], r1["blocked"]],
            "launches": {"single": s["launches"],
                         "rank": [r0["launches"], r1["launches"]]},
        })

    shapes_out = {}
    for name, batch, mega, tb in shapes:
        shapes_out[name] = {
            "config": {"batch": batch, "mega": mega,
                       "total_batches": tb,
                       "fully_presealed": True},
            "headline": _summarize(by_shape[name]),
            "trials": by_shape[name],
        }
    head = dict(shapes_out["latency"]["headline"])
    head.update({
        "shape": "latency",
        "target_scaling_x": TARGET_SCALING_X,
        "meets_target": head["median_scaling_x"] >= TARGET_SCALING_X,
    })
    device_kind = ready["rank0"]["device_kind"]
    power_w = _power_limit_w() if device_kind != "cpu" else None
    baseline_is_tree = (os.path.realpath(args.baseline_repo)
                        == os.path.realpath(REPO))
    paced = {
        "ts": t_start,
        "method": (
            "Interleaved ABAB sealed-drain trials against the port's own "
            f"pre-cluster single engine (commit {BASELINE_COMMIT}, the "
            "tree at baseline_repo), per serving shape: three persistent "
            "engine processes on the one device (the baseline with 2 "
            "drain workers, two cluster ranks with 1 worker each from "
            "this tree), each holding one warmed engine per shape "
            "(captures and kernel builds in warm()), released per step "
            "by shared file tokens over freshly prefilled 2-shard "
            "fan-outs of the same corpus. Shapes: 'latency' (batch 128, "
            "no mega coalescing; the headline) and 'throughput' (batch "
            "256, mega auto). Cluster ranks run core-pinned with a "
            "one-thread torch pool (runner.pin_to_core); the baseline "
            "keeps the whole host. Per-step wall = the pure sealed "
            "drain, stop to exhaustion (the corpus is pre-sealed and "
            "the workers have exited before the clock starts); cluster "
            "aggregate = total records / slowest rank wall. "
            "Losslessness per shard, gossip digest convergence and zero "
            "seq gaps checked every step."),
        "host_noise": (
            f"{os.cpu_count()}-core host shared with the machine's other "
            "work; ABAB order alternates per shape per trial, the raw "
            f"per-trial data below is the evidence; loadavg {load0} -> "
            f"{load1}."),
        "baseline_repo": args.baseline_repo,
        "baseline_is_tree_under_test": baseline_is_tree,
        "baseline_rings": ("prefilled by the baseline's own ring code "
                           "(its ring layout differs from today's)"
                           if own_rings else
                           "prefilled by the orchestrator (the baseline's "
                           "ring code reads today's layout)"),
        "device": args.device or "cuda",
        "device_kind": device_kind,
        "power_limit_w": power_w,
        "config": {"trials": args.trials, "cut": args.cut,
                   "reduced": ([f"total_batches / {args.cut}"]
                               if args.cut > 1 else []),
                   "shapes": {n: {"batch": b, "mega": m,
                                  "total_batches": tb}
                              for n, b, m, tb in shapes}},
        "headline": head,
        "shapes": shapes_out,
        "lost_batches": 0 if not any("produced" in f
                                     for f in failures) else None,
        "ok": not failures,
        "failures": failures,
    }

    try:
        artifact = _read_json(args.out)
    except (OSError, ValueError):
        artifact = {}
    artifact["paced"] = paced
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(artifact, f, indent=2)
        f.write("\n")
    log(f"wrote {args.out}")
    for name in shapes_out:
        h = shapes_out[name]["headline"]
        log(f"[{name}] median single {h['median_single_mpps']} Mpps, "
            f"cluster agg {h['median_cluster_agg_mpps']} Mpps, scaling "
            f"{h['median_scaling_x']}x")
    log(f"headline (latency shape) scaling {head['median_scaling_x']}x "
        f"(target {TARGET_SCALING_X}x met={head['meets_target']}, "
        f"evidence ok={paced['ok']})")
    for msg in failures:
        log(f"FAIL {msg}")
    print(json.dumps({**head, "ok": paced["ok"], "failures": failures,
                      "shapes": {n: shapes_out[n]["headline"]
                                 for n in shapes_out},
                      "device_kind": device_kind, "power_limit_w": power_w,
                      "baseline_repo": args.baseline_repo,
                      "artifact": args.out}), flush=True)
    shutil.rmtree(sync, ignore_errors=True)
    return 1 if failures or not head["meets_target"] else 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="paced 2-engine-vs-single scale-out comparison")
    ap.add_argument("--role", default="orchestrate",
                    choices=("orchestrate", "single", "rank"))
    ap.add_argument("--repo", default=REPO)
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--sync")
    ap.add_argument("--trials", type=int, default=6)
    ap.add_argument("--baseline-repo", default=DEFAULT_BASELINE,
                    help=f"a tree of commit {BASELINE_COMMIT} (module "
                         "docstring)")
    ap.add_argument("--device", default=None,
                    help="torch device of every role; default the card")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--cut", type=int, default=1,
                    help="divide each shape's total_batches by N")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.cut < 1:
        print("bench: --cut must be >= 1", file=sys.stderr)
        return 2
    if args.role == "single":
        return run_single(args)
    if args.role == "rank":
        return run_rank(args)
    return orchestrate(args)


if __name__ == "__main__":
    sys.exit(main())
