"""Host-ingest stress harness: ``fsxd --sim`` -> shm ring -> batcher ->
engine, pushed to the daemon's rate; and the sharded ingest subsystem
against the inline path.

Counterpart of the reference's ``scripts/shm_stress.py``, with its two
modes, its phases and its report keys::

    python -m flowsentryx_tpu_torch.shm_stress [--shards N] [--device D]
                                                [--out PATH]

**Default mode.** :func:`phase_drain` (``ShmRingSource.poll`` in a bare
loop: the ring's ceiling on the Python side), then nine engine rows
(:func:`phase_engine`: the real :class:`~.engine.engine.Engine`, micro-
batcher -> fused step -> verdict ring, fed by a live daemon): paced
0.25 / 0.5 / 1.0 / 1.5 M records/s, 1.5 M with ``mega_n=8``, free-run
B=2048 and B=2048 with ``mega_n=8``, free-run B=1024, and a free-run
mixed row with 20 % attack traffic.

**Sharded mode** (``--shards N``): :func:`run_sharded_suite`.  The inline
references first (one paced engine row at 1.0 M/s, and
:func:`phase_inline_host`, the drain -> seal stage with no device), then
:func:`phase_sharded` (``fsxd --shards N`` -> N spawned drain workers ->
:meth:`~.ingest.ShardedIngest.poll_batches`) over a paced ladder of
3.4, 3.4, 3.2, 3.1 and 3.05 M/s that stops at the first lossless row at
3 M/s or more, a free-run row, and, on a host with fewer cores than N, a
cores-matched row.

The engine rows run on the card (``--device`` absent) and serve through
its captured graphs: ``score_int8`` once per dispatched batch and
``table_summary`` once per report.  ``--device cpu`` runs them on the
plain versions.  Both reports carry ``device_kind`` and
``power_limit_w`` beside the reference's keys.  The full report goes
only to ``--out``; the harness prints one line, the report's
``headline``.  ``FSX_STRESS_DUR`` sets the seconds per row (default
20) and ``FSX_STRESS_INGEST_BATCH`` the sharded rows' seal size
(default 4096).

Spawned drain workers re-import this module, so its module level
imports numpy-only modules and never ``torch``: the engine phases import
it when they run.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

from flowsentryx_tpu_torch.core import wire as schema
from flowsentryx_tpu_torch.core.config import (
    BatchConfig, FsxConfig, ModelConfig, TableConfig,
)

REPO = Path(__file__).resolve().parents[1]
FSXD = REPO / "daemon" / "build" / "fsxd"
DUR = float(os.environ.get("FSX_STRESS_DUR", "20"))
#: The engine rows' state table (the production table).
TABLE_CAPACITY = 1 << 20
#: The report keys this harness adds to the reference's.
ADDED_KEYS = ("device_kind", "power_limit_w")
#: Free-run rows of the reference's default-mode artifact served at
#: this rate through the pipeline it measured before (its
#: ``SERVE_r04`` artifact): the reference's fixed comparison point.
SERVE_R04_RECORDS_PER_S = 1628.8


def build_daemon() -> str:
    """Build ``fsxd`` into ``daemon/build/``: ``make -C daemon``; if the
    compiler trips ``-Werror``, once more with the Makefile's flags
    without it; without ``make``, the Makefile's ``g++`` line by hand.
    Returns the command that built it."""
    ddir = REPO / "daemon"
    relaxed = "-O2 -std=c++17 -Wall -Wextra -I../kern"
    if shutil.which("make"):
        tries = [(["make", "-C", str(ddir)], "make"),
                 (["make", "-C", str(ddir), f"CXXFLAGS={relaxed}"],
                  f"make CXXFLAGS={relaxed}")]
    else:
        (ddir / "build").mkdir(parents=True, exist_ok=True)
        line = ["g++", *relaxed.split(), "fsxd.cpp", "-o", "build/fsxd",
                "-lpthread"]
        tries = [(line, " ".join(line))]
    err = ""
    for cmd, label in tries:
        r = subprocess.run(cmd, cwd=ddir, capture_output=True, text=True,
                           timeout=300)
        if r.returncode == 0:
            return label
        err = r.stderr
    raise RuntimeError(f"daemon build failed: {err[-2000:]}")


def start_daemon(fring: str, vring: str, duration: float,
                 attack_fraction: float, rate_pps: float,
                 ring_capacity: int = 1 << 17,
                 pace: bool = False, shards: int = 1,
                 boost: bool = False) -> subprocess.Popen:
    """``fsxd --sim`` into ``fring`` / ``vring``, seed 7, 64 attack
    sources.  The benign pool scales with the sim clock's rate so that
    each benign source stays near 250 records/s: a fixed pool at a
    1e6 records/s clock would stamp every benign source at ~1 k/s, which
    the model rightly reads as an attack.  ``boost`` raises a paced
    producer's priority (root only), as a NIC does not slow down for a
    busy host: the backpressure stays on the consumers measured."""
    n_benign = max(1024, int(rate_pps * (1.0 - attack_fraction) / 250))
    cmd = [str(FSXD), "--sim",
           "--duration", str(duration),
           "--rate", str(rate_pps),
           "--attack-fraction", str(attack_fraction),
           "--attack-ips", "64",
           "--benign-ips", str(n_benign),
           "--feature-ring", fring, "--verdict-ring", vring,
           "--ring-capacity", str(ring_capacity),
           "--seed", "7"]
    if shards > 1:
        cmd += ["--shards", str(shards)]
    if pace:
        cmd.append("--pace")
    pre = None
    if boost and hasattr(os, "nice") and os.geteuid() == 0:
        def pre():
            os.nice(-10)
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.DEVNULL, text=True,
                            preexec_fn=pre)


def daemon_result(proc) -> dict:
    """The daemon's closing JSON line (its counters), {} without one."""
    out, _ = proc.communicate(timeout=30)
    for line in out.splitlines()[::-1]:
        line = line.strip()
        if line.startswith("{"):
            return json.loads(line)
    return {}


def phase_drain(duration: float) -> dict:
    """Bare ring-drain ceiling: no batcher, no step."""
    from flowsentryx_tpu_torch.engine.shm import ShmRingSource

    with tempfile.TemporaryDirectory() as td:
        fring, vring = f"{td}/fring", f"{td}/vring"
        proc = start_daemon(fring, vring, duration + 1.0,
                            attack_fraction=0.0, rate_pps=1e7)
        try:
            src = ShmRingSource(fring)
            n = 0
            polls = 0
            t0 = time.perf_counter()
            deadline = t0 + duration
            while time.perf_counter() < deadline:
                chunk = src.poll(8192)
                polls += 1
                if len(chunk):
                    n += len(chunk)
                else:
                    time.sleep(0.0002)
            wall = time.perf_counter() - t0
        finally:
            proc.terminate()
        d = daemon_result(proc)
        return {
            "records_drained": n,
            "wall_s": round(wall, 3),
            "drain_mpps": round(n / wall / 1e6, 4),
            "polls": polls,
            "daemon": d,
        }


class _IdleSource:
    """Placeholder source so engines can be built (and their graphs
    captured) before the daemon's rings exist."""

    def poll(self, max_records: int):
        import numpy as np

        return np.zeros(0, schema.FLOW_RECORD_DTYPE)

    def exhausted(self) -> bool:
        return True


#: ``(max_batch, mega_n, device, capacity) -> (engine, checkpoint)``.
_ENGINES: dict = {}
#: The pristine checkpoints' directory, removed at exit.
_CKPT_DIR: list = []


def _ckpt_path(tag: str) -> str:
    if not _CKPT_DIR:
        _CKPT_DIR.append(tempfile.TemporaryDirectory(
            prefix="fsx_stress_ckpt_"))
    return os.path.join(_CKPT_DIR[0].name, tag)


def close_engines() -> None:
    """Drop the cached engines and their checkpoints."""
    _ENGINES.clear()
    while _CKPT_DIR:
        _CKPT_DIR.pop().cleanup()


def engine_config(max_batch: int,
                  capacity: int = TABLE_CAPACITY) -> FsxConfig:
    """The engine rows' config: a ``capacity``-row table, a 10 ms flush
    deadline, the young-flow vote at 4 records and 2 votes."""
    return FsxConfig(
        table=TableConfig(capacity=capacity),
        batch=BatchConfig(max_batch=max_batch, deadline_us=10_000),
        model=ModelConfig(vote_k=4, vote_m=2),
    )


def get_engine(max_batch: int, mega_n: int = 0, *, device=None,
               capacity: int = TABLE_CAPACITY):
    """Build + WARM a cached engine for ``max_batch``.

    The pristine table/stats checkpoint is taken first; ``Engine.warm``
    then captures the step's graphs (on the card; on the CPU it runs the
    step once) OUTSIDE any measured window, and the checkpoint is
    restored so every row starts from identical state.  ``device=None``
    is the card."""
    key = (max_batch, mega_n, None if device is None else str(device),
           capacity)
    got = _ENGINES.get(key)
    if got is not None:
        return got
    from flowsentryx_tpu_torch.engine.engine import Engine
    from flowsentryx_tpu_torch.engine.writeback import NullSink

    cfg = engine_config(max_batch, capacity)
    # readback_depth counts BATCHES: a mega engine needs 2 groups'
    # worth so one group can fill/dispatch while the previous runs.
    eng = Engine(cfg, _IdleSource(), NullSink(), device=device,
                 readback_depth=max(8, 2 * mega_n), mega_n=mega_n)
    ckpt = eng.checkpoint(_ckpt_path(f"b{max_batch}_m{mega_n}_{len(_ENGINES)}"))
    eng.warm()
    eng.restore(ckpt)
    _ENGINES[key] = (eng, ckpt)
    return eng, ckpt


def phase_engine(duration: float, attack_fraction: float,
                 max_batch: int, label: str,
                 rate_pps: float = 1e7, pace: bool = False,
                 mega_n: int = 0, *, device=None,
                 capacity: int = TABLE_CAPACITY) -> dict:
    """Real pipeline: ring -> MicroBatcher -> fused step -> verdict ring.

    ``pace=True`` offers records at ``rate_pps`` in real time (achieved
    against offered); ``pace=False`` free-runs against ring backpressure
    (the ceiling, generator and engine sharing the host).  Engines are
    cached per batch size (``reset_stream`` between runs), so each
    capture is paid once, as a long-lived server pays it, and each row
    RESTORES the pristine checkpoint taken at construction: every fsxd
    restart rewinds the sim clock to ~1 s, and the previous row's table
    (last-seen stamps ahead of the new stream) would feed the flow core
    negative time deltas.  A 10 ms flush deadline keeps batches full at
    low offered loads."""
    from flowsentryx_tpu_torch.engine.shm import ShmRingSource, ShmVerdictSink
    from flowsentryx_tpu_torch.engine.writeback import NullSink

    eng, ckpt = get_engine(max_batch, mega_n, device=device,
                           capacity=capacity)
    # Reset + restore BEFORE the daemon exists: a daemon already
    # producing into a 131072-slot ring would overflow it during the
    # restore, startup loss read as steady-state loss.  The live
    # source/sink swap in afterwards without touching engine state.
    eng.reset_stream(_IdleSource(), NullSink())
    eng.restore(ckpt)
    with tempfile.TemporaryDirectory() as td:
        fring, vring = f"{td}/fring", f"{td}/vring"
        proc = start_daemon(fring, vring, duration + 2.0,
                            attack_fraction=attack_fraction,
                            rate_pps=rate_pps, pace=pace)
        try:
            src = ShmRingSource(fring)
            sink = ShmVerdictSink(vring)
            eng.source = src
            eng.sink = sink
            t0 = time.perf_counter()
            rep = eng.run(max_seconds=duration)
            wall = time.perf_counter() - t0
            ring_left = src.ring.readable()
        finally:
            proc.terminate()
        d = daemon_result(proc)
        offered = d.get("produced", 0) - d.get("suppressed", 0)
        # The daemon outlives the engine's window (duration + 2 and the
        # terminate latency), so its dropped_ring_full is dominated by
        # the tail after the run when the engine keeps up: achieved
        # against offered over the ENGINE's window is the loss signal.
        return {
            "label": label,
            "attack_fraction": attack_fraction,
            "max_batch": max_batch,
            "mega_n": mega_n,
            "paced": pace,
            "offered_mpps": (round(rate_pps / 1e6, 3) if pace
                             else round(offered / max(wall, 1e-9) / 1e6, 4)),
            "wire": eng.wire,
            "engine_records": rep.records,
            # rep.wall_s covers the serving loop and the final reap and
            # EXCLUDES the report's table summary, which the outer wall
            # would count as serving time
            "engine_wall_s": rep.wall_s,
            "outer_wall_s": round(wall, 3),
            "ring_readable_at_stop": int(ring_left),
            "engine_mpps": round(rep.records_per_s / 1e6, 4),
            "records_per_s": rep.records_per_s,
            "stages_ms": {k: {"p50": v.get("p50"), "p99": v.get("p99")}
                          for k, v in rep.stages_ms.items()},
            "blocked_sources": rep.blocked_sources,
            "stats": rep.stats,
            "daemon": d,
        }


#: Seal size of the sharded rows (and of their inline-host reference):
#: per-batch overhead (queue-slot copy, seal bookkeeping, dequeue
#: wake-ups) amortizes out by ~4k records, while larger seals stretch a
#: worker's drain cadence until one descheduling eats the ring's depth.
INGEST_BATCH = int(os.environ.get("FSX_STRESS_INGEST_BATCH", "4096"))


def phase_inline_host(duration: float, max_batch: int = INGEST_BATCH) -> dict:
    """The inline host-ingest stage alone: one thread draining the ring
    and sealing compact16 batches (drain -> decode -> quantize -> seal),
    no device step.  This is the per-record work the sharded subsystem
    moves into its drain workers: sharded against THIS row is the
    stage's speedup, sharded against the full inline engine the
    system's."""
    import numpy as np

    from flowsentryx_tpu_torch.engine.batcher import MicroBatcher
    from flowsentryx_tpu_torch.engine.shm import ShmRingSource

    schema.quantize_feat_minifloat(np.zeros(8, np.uint32))  # LUT build
    with tempfile.TemporaryDirectory() as td:
        fring, vring = f"{td}/fring", f"{td}/vring"
        proc = start_daemon(fring, vring, duration + 1.0,
                            attack_fraction=0.0, rate_pps=1e6)
        try:
            src = ShmRingSource(fring)
            b = None
            n = 0
            batches = 0
            t0 = time.perf_counter()
            deadline = t0 + duration
            while time.perf_counter() < deadline:
                chunk = src.poll(2 * max_batch)
                if not len(chunk):
                    time.sleep(0.0002)
                    continue
                if b is None:  # anchor t0 on the first record, as Engine does
                    b = MicroBatcher(
                        BatchConfig(max_batch=max_batch, deadline_us=10_000),
                        t0_ns=int(chunk["ts_ns"][0]), n_buffers=2,
                        wire=schema.WIRE_COMPACT16,
                        quant=dict(feat_mode="minifloat"))
                for _ in b.add(chunk):
                    b.pop_seal_time()
                    batches += 1
                n += len(chunk)
            wall = time.perf_counter() - t0
        finally:
            proc.terminate()
        daemon_result(proc)
        return {
            "label": f"inline_host_b{max_batch}",
            "records": n,
            "batches_sealed": batches,
            "wall_s": round(wall, 3),
            "mpps": round(n / wall / 1e6, 4),
        }


def phase_sharded(duration: float, n_workers: int, rate_pps: float,
                  pace: bool, max_batch: int = INGEST_BATCH,
                  label: str | None = None) -> dict:
    """Sharded host ingest, end to end but the device: ``fsxd --shards
    N`` -> N drain workers (decode + minifloat quantize + seal in
    parallel processes) -> sealed-batch SPSC queues -> this process
    dequeuing through ``ShardedIngest.poll_batches``, the engine's own
    host cost per batch (one queue-slot copy and the sequence
    bookkeeping).  The daemon exits after ``duration`` and the fleet
    drains its queues on stop, so LOSSLESS is checkable: consumed ==
    produced, no ring-full drops, no sequence gaps."""
    from flowsentryx_tpu_torch.ingest import ShardedIngest

    with tempfile.TemporaryDirectory() as td:
        fring, vring = f"{td}/fring", f"{td}/vring"
        # Fleet first, producer second: the workers' boot (spawn + numpy
        # import) must not overlap the window, or startup overflow reads
        # as steady-state loss.  precompact is explicit: no ring exists
        # to probe yet (the sim daemon writes 48 B records).
        ing = ShardedIngest(fring, n_workers, queue_slots=32,
                            precompact=False)
        ing.start(BatchConfig(max_batch=max_batch, deadline_us=10_000),
                  schema.WIRE_COMPACT16, dict(feat_mode="minifloat"))
        ing.wait_ready()
        # 2^18-slot shards: a worker descheduled for ~100 ms on a busy
        # host is absorbed by ring depth, not read as steady-state loss
        proc = start_daemon(fring, vring, duration,
                            attack_fraction=0.0, rate_pps=rate_pps,
                            pace=pace, shards=n_workers,
                            ring_capacity=1 << 18, boost=pace)
        records = 0
        batches = 0
        stopped = False
        try:
            t0 = time.perf_counter()
            while True:
                got = ing.poll_batches(16)
                for sb in got:
                    records += sb.n_records
                    batches += 1
                if not stopped and proc.poll() is not None:
                    ing.request_stop()  # daemon exited: drain the tail
                    stopped = True
                if stopped and ing.exhausted():
                    break
                if not got:
                    time.sleep(0.0002)
            wall = time.perf_counter() - t0
        finally:
            ing.close()
            if proc.poll() is None:
                proc.terminate()
        d = daemon_result(proc)
        stats = ing.ingest_stats()
        produced = d.get("produced", 0)
        ring_drops = d.get("dropped_ring_full", 0)
        seq_gaps = sum(w["seq_gaps"] for w in stats["workers"].values())
        return {
            "label": label or f"sharded_w{n_workers}"
                              f"{'_paced' if pace else '_freerun'}",
            "n_workers": n_workers,
            "max_batch": max_batch,
            "paced": pace,
            "offered_mpps": (round(rate_pps / 1e6, 3) if pace
                             else round(produced / max(wall, 1e-9) / 1e6, 4)),
            "records": records,
            "batches": batches,
            "wall_s": round(wall, 3),
            "mpps": round(records / wall / 1e6, 4),
            "lossless": bool(records == produced and ring_drops == 0
                             and seq_gaps == 0
                             and stats["dropped_emit_batches"] == 0
                             and not stats["dead_workers"]),
            "produced": produced,
            "dropped_ring_full": ring_drops,
            "seq_gaps": seq_gaps,
            "dropped_tail_batches": stats["dropped_tail_batches"],
            "dropped_emit_batches": stats["dropped_emit_batches"],
            "workers": stats["workers"],
            "daemon": d,
        }


#: The sharded suite's paced ladder (records/s): the first lossless row
#: at :data:`LADDER_TARGET` or more ends it.
LADDER = (3.4e6, 3.4e6, 3.2e6, 3.1e6, 3.05e6)
LADDER_TARGET = 3.0


def run_sharded_suite(n_workers: int, dur: float, *, device=None) -> dict:
    """The sharded-against-inline run (``--shards N``)."""
    out = {
        "round": 6,
        "purpose": ("sharded parallel host ingest (flowsentryx_tpu_torch/"
                    "ingest/) against the inline single-threaded path: "
                    "N drain workers seal in parallel and the engine "
                    "dequeues finished batches"),
        "host_cores": os.cpu_count(),
        "n_workers": n_workers,
        "ingest_batch": INGEST_BATCH,
        "duration_s_per_phase": dur,
        "wire": "compact16 (minifloat quantize in the seal stage: the "
                "default engine wire)",
    }
    # Inline references first: the engine row builds and captures its
    # graphs before any worker process exists to contend with it.
    out["inline_engine"] = phase_engine(
        dur, 0.0, 2048, "inline_paced_1.0mpps", 1.0e6, pace=True,
        device=device)
    out["inline_host"] = phase_inline_host(dur)
    # A rate LADDER, not fixed-rate retries: the boosted producer does
    # not slow down for a busy host (a NIC would not either), so an
    # offer above the consumers' ceiling drops records however well the
    # host holds the target; step the offer down and keep the first
    # lossless row at the target.  Every attempt stays in the report.
    rows = []
    for attempt, rate in enumerate(LADDER):
        row = phase_sharded(dur, n_workers, rate, pace=True,
                            label=f"sharded_w{n_workers}_paced_"
                                  f"{rate / 1e6:g}mpps_try{attempt}")
        rows.append(row)
        if row["lossless"] and row["mpps"] >= LADDER_TARGET:
            break
    rows.append(phase_sharded(dur, n_workers, 1e6, pace=False))
    # Cores-matched context row: with fewer cores than workers the w=N
    # rows measure oversubscription on top of the subsystem.
    cores = os.cpu_count() or 1
    if 1 < cores < n_workers:
        rows.append(phase_sharded(
            dur, cores, 3.4e6, pace=True,
            label=f"sharded_w{cores}_coresmatched_paced_3.4mpps"))
    out["sharded_rows"] = rows
    # the headline from the requested worker count's rows only
    wn = [r for r in rows if r["n_workers"] == n_workers]
    best = max(wn, key=lambda r: r["mpps"])
    lossless = [r for r in wn if r["lossless"]]
    best_lossless = max(lossless, key=lambda r: r["mpps"]) if lossless else None
    out["headline"] = {
        "inline_engine_mpps": out["inline_engine"]["engine_mpps"],
        "inline_host_mpps": out["inline_host"]["mpps"],
        "sharded_mpps": best["mpps"],
        "sharded_lossless_mpps": (best_lossless["mpps"]
                                  if best_lossless else 0.0),
        "sharded_config": best["label"],
        "meets_3mpps_lossless": bool(best_lossless
                                     and best_lossless["mpps"]
                                     >= LADDER_TARGET),
    }
    cm = [r for r in rows if r["n_workers"] != n_workers]
    if cm:
        out["headline"]["coresmatched_lossless_mpps"] = max(
            (r["mpps"] for r in cm if r["lossless"]), default=0.0)
    return out


#: The default mode's engine rows: ``(attack_fraction, max_batch, label,
#: rate_pps, pace, mega_n)``.  Free-run rows pin the SIM clock at 1e6
#: records/s: the generator runs at memcpy speed either way, but the
#: records' stamps must keep each source's rate benign-plausible.
ENGINE_ROWS = (
    (0.0, 2048, "paced_0.25mpps", 0.25e6, True, 0),
    (0.0, 2048, "paced_0.5mpps", 0.5e6, True, 0),
    (0.0, 2048, "paced_1.0mpps", 1.0e6, True, 0),
    # offered above the single-dispatch ceiling, with and without
    # grouping: a backlog forms, groups fire, and the dispatch
    # amortization shows as achieved throughput
    (0.0, 2048, "paced_1.5mpps", 1.5e6, True, 0),
    (0.0, 2048, "paced_1.5mpps_mega8", 1.5e6, True, 8),
    (0.0, 2048, "freerun_b2048", 1e6, False, 0),
    (0.0, 2048, "freerun_b2048_mega8", 1e6, False, 8),
    (0.0, 1024, "freerun_b1024", 1e6, False, 0),
    (0.2, 2048, "freerun_mixed_attack20", 1e6, False, 0),
)


def engine_row(dur: float, row: tuple, *, device=None,
               capacity: int = TABLE_CAPACITY) -> dict:
    """One of :data:`ENGINE_ROWS` through :func:`phase_engine`."""
    af, b, label, rate, pace, mega_n = row
    return phase_engine(dur, af, b, label, rate, pace=pace, mega_n=mega_n,
                        device=device, capacity=capacity)


def run_default_suite(dur: float, *, device=None) -> dict:
    """The default mode: the drain ceiling and the nine engine rows."""
    out = {
        "round": 5,
        "purpose": ("shm ring -> batcher -> engine throughput ceiling of "
                    "the port, the daemon free-running or paced"),
        "engine_backend": str(device or "cuda"),
        "duration_s_per_phase": dur,
        "drain_only": phase_drain(dur),
    }
    rows = [engine_row(dur, row, device=device) for row in ENGINE_ROWS]
    out["engine_rows"] = rows
    best = max(rows, key=lambda r: r["engine_mpps"])
    out["headline"] = {
        "drain_mpps": out["drain_only"]["drain_mpps"],
        "engine_mpps": best["engine_mpps"],
        "engine_config": best["label"],
        "host_cores": os.cpu_count(),
        "vs_serve_r04_records_per_s": SERVE_R04_RECORDS_PER_S,
    }
    return out


def device_fields(dev) -> dict:
    """:data:`ADDED_KEYS`: the card's name (``cpu`` on the host) and its
    power limit in W from ``nvidia-smi`` (None without one)."""
    from flowsentryx_tpu_torch import bench

    watts = bench.smi_power()[1] if dev.type == "cuda" else None
    return {"device_kind": bench.device_kind(dev), "power_limit_w": watts}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m flowsentryx_tpu_torch.shm_stress",
        description="host-ingest stress: fsxd -> shm ring -> engine; "
                    "prints the report's headline as one JSON line")
    p.add_argument("--shards", type=int, default=0,
                   help="N > 0: the sharded ingest suite with N drain "
                        "workers (default: the engine rows)")
    p.add_argument("--device", default=None,
                   help="torch device of the engine rows; default the "
                        "card (exits 1 without one)")
    p.add_argument("--out", default=None,
                   help="write the full report (JSON) here")
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    from flowsentryx_tpu_torch.core.device import resolve_device

    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        print(f"shm_stress: {e}", file=sys.stderr)
        return 1
    build_daemon()
    try:
        if args.shards:
            out = run_sharded_suite(args.shards, DUR, device=dev)
        else:
            out = run_default_suite(DUR, device=dev)
    finally:
        close_engines()
    out.update(device_fields(dev))
    if args.out:
        path = Path(args.out)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(out, indent=1))
    print(json.dumps(out["headline"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
