"""One run of one cell: set-up, the measured window, the check against
the plain reference, and the result line.

Everything a cell needs is found by name: its workload file
(``workloads/<cell>.json``: the configuration, the traffic mode and its
parameters), the configuration file (``configs/<config>.json``), the
traffic mode's module (``traffic/<mode>.py``), and one reader per metric
(``metrics/<metric>.py``).  ``BENCHMARK.json`` at the checkout's root
says which metrics the cell reports.  Adding a cell, a configuration or
a metric is adding files.
"""

from __future__ import annotations

import copy
import importlib
import importlib.util
import json
import multiprocessing as mp
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

#: Top-level modules no run may load: the JAX reference and JAX itself.
FORBIDDEN = ("jax", "jaxlib", "flax", "flowsentryx_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _merge(base: dict, extra: dict) -> dict:
    out = copy.deepcopy(base)
    for k, v in extra.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _merge(out[k], v)
        else:
            out[k] = v
    return out


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is
    one of :data:`FORBIDDEN`, compared whole."""
    return sorted({m for m in sys.modules
                   if m.split(".", 1)[0] in FORBIDDEN})


def process_start_boottime() -> float:
    """This process's start, in ``CLOCK_BOOTTIME`` seconds."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    return int(fields[19]) / os.sysconf("SC_CLK_TCK")


def io_written(pid="self") -> int:
    """Bytes a process caused to be written to storage so far
    (``/proc/<pid>/io``; a page counts when it is dirtied, an mmap'd ring
    included); 0 where the kernel does not say."""
    try:
        with open(f"/proc/{pid}/io") as f:
            return int(dict(line.split(": ") for line in
                            f.read().splitlines())["write_bytes"])
    except (OSError, KeyError, ValueError):
        return 0


def cpu_seconds(pid="self") -> float | None:
    """CPU seconds (user and system, every thread) a process has used so
    far (``/proc/<pid>/stat``); None where it cannot be read."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        return (int(fields[11]) + int(fields[12])) / os.sysconf("SC_CLK_TCK")
    except (OSError, IndexError, ValueError):
        return None


def run_processes() -> dict[str, int]:
    """This process (``engine``: the engine's loop and sink threads, and
    the harness) and each live child (the producer, the ingest workers),
    by name."""
    return {"engine": os.getpid(),
            **{p.name: p.pid for p in mp.active_children()}}


def cpu_now(procs: dict[str, int]) -> dict[str, float | None]:
    """CPU seconds so far of each process of ``procs`` (name -> pid)."""
    return {name: cpu_seconds(pid) for name, pid in procs.items()}


def cores_used(before: dict, after: dict, seconds: float) -> dict:
    """Cores each process kept busy between two :func:`cpu_now`
    readings ``seconds`` apart."""
    return {name: (after[name] - c0) / seconds
            for name, c0 in before.items()
            if c0 is not None and after.get(name) is not None
            and seconds > 0}


def speed_probe_ms() -> float:
    """Milliseconds a fixed piece of host work takes: ``log1p`` over 2^20
    float32 values, 16 times (the workers' quantizer is this operation).
    Run once the window's processes have stopped, it reads how fast the
    host ran for this run, whatever the run did."""
    x = np.arange(1 << 20, dtype=np.float32)
    t = time.perf_counter()
    for _ in range(16):
        np.log1p(x)
    return (time.perf_counter() - t) * 1e3


class CollectingSink:
    """The verdict sink of a run: every block update, in order."""

    def __init__(self):
        self.keys: list[np.ndarray] = []
        self.untils: list[np.ndarray] = []

    def apply(self, update) -> None:
        self.keys.append(np.asarray(update.key, np.uint32).copy())
        self.untils.append(np.asarray(update.until_s, np.float32).copy())

    def blocks(self) -> tuple[np.ndarray, np.ndarray]:
        if not self.keys:
            return np.zeros(0, np.uint32), np.zeros(0, np.float32)
        return np.concatenate(self.keys), np.concatenate(self.untils)


class Run:
    """The context every traffic mode and metric reader sees."""

    def __init__(self, root: Path, cell: str, seed: int, seconds: float,
                 trace: bool, device: str, overrides: dict | None = None):
        overrides = overrides or {}
        self.root = Path(root)
        self.bench = self.root / "benchmark"
        self.manifest = load_json(self.root / "BENCHMARK.json")
        self.cell = cell
        if cell not in {w["name"] for w in self.manifest["workloads"]}:
            raise SystemExit(f"unknown workload {cell!r}")
        self.workload = _merge(load_json(self.bench / "workloads"
                                         / f"{cell}.json"),
                               overrides.get("workload", {}))
        self.config = _merge(load_json(self.bench / "configs"
                                       / f"{self.workload['config']}.json"),
                             overrides.get("config", {}))
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.device = device
        self.reports: list = []
        self.segments: list[tuple[int, int, float]] = []
        self.trace_summary: dict | None = None
        self.setup_s = None
        self.window_s = None
        self.memory_peak = 0
        self.distinct_per_batch: np.ndarray | None = None
        self.imported_s = None
        self.host: dict = {}
        #: (records verdicted, seconds) over the untraced part of the
        #: window the served rate is read from
        self.served: tuple[int, float] = (0, 0.0)
        #: device operations in an untraced window, and the card's busy
        #: seconds over it (the union of their intervals)
        self.device_ops = 0
        self.device_busy_s = 0.0

    def metric_names(self, kind: str) -> list[dict]:
        """The ``end_to_end`` or ``per_layer`` metrics this cell reports."""
        return [m for m in self.manifest[kind]
                if "workloads" not in m or self.cell in m["workloads"]]


def load_reader(bench: Path, name: str):
    """``metrics/<name>.py``: its ``read(run)`` gives the metric's value,
    or None where it finds nothing to read."""
    path = bench / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_cell(root, cell: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", overrides: dict | None = None,
             t_process: float | None = None,
             control_bits: int | None = None) -> dict:
    """Run ``cell`` once and return its result line (a dict), with the
    numbers compared under the last key, ``checks``.  ``control_bits``
    (the control's runs only) also puts the reference at that weight
    precision in the program's place and compares it with the reference
    (``control_checks``)."""
    import torch

    from flowsentryx_tpu_torch.core.config import FsxConfig
    from flowsentryx_tpu_torch.models import logreg

    run = Run(Path(root), cell, seed, seconds, trace, device, overrides)
    if t_process is not None:
        run.imported_s = time.clock_gettime(time.CLOCK_BOOTTIME) - t_process
    cuda = torch.device(device).type == "cuda"
    run.fsx = FsxConfig.from_dict(run.config["fsx"])
    w = run.config["weights"]
    run.params = logreg.make_params(
        w["w_int8"], bias=w["bias"], w_scale=w["w_scale"],
        in_scale=w["in_scale"], in_zp=w["in_zp"], out_scale=w["out_scale"],
        out_zp=w["out_zp"], log1p=bool(w.get("log1p", 0)))
    run.compile_cache = (str(run.root / ".bench_cache" / "compile_cache")
                         if cuda else None)
    run.sink = CollectingSink()
    run.device_kind = torch.cuda.get_device_name() if cuda else None
    mode_mod = importlib.import_module(
        f"benchmark.traffic.{run.workload['mode']}")
    with tempfile.TemporaryDirectory(prefix="fsxbench-") as tmp:
        run.tmp = tmp
        mode = mode_mod.Mode(run)
        run.mode = mode
        try:
            mode.setup()
            if cuda:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            if t_process is not None:
                run.setup_s = time.clock_gettime(time.CLOCK_BOOTTIME) - t_process
            _window(run, mode, cuda)
        finally:
            # the children's writes, read while they live
            kids = sum(io_written(p.pid) for p in mp.active_children())
            mode.finish()
        run.host["probe_ms"] = speed_probe_ms()
        if cuda:
            run.memory_peak = int(torch.cuda.max_memory_allocated())
        run.io_written = io_written() + kids
        result = _result(run, mode, cuda, control_bits)
    return result


def _window(run: Run, mode, cuda: bool) -> None:
    """The measured window, and the cores each process kept busy over
    it; untraced, on the card, the whole window under the device trace
    (the card's activity alone), read once the window has closed.  The
    trace starts after set-up is timed and before the window opens."""
    import torch

    from benchmark import trace

    procs = run_processes()
    if cuda and not run.trace:
        with trace.device_only() as prof:
            cpu = cpu_now(procs)
            t0 = time.perf_counter()
            _serve(run, mode, cuda, t0)
            run.window_s = time.perf_counter() - t0
            cpu_end = cpu_now(procs)
            torch.cuda.synchronize()
        run.device_ops, run.device_busy_s = trace.device_busy(prof)
        del prof
    else:
        cpu = cpu_now(procs)
        t0 = time.perf_counter()
        _serve(run, mode, cuda, t0)
        run.window_s = time.perf_counter() - t0
        cpu_end = cpu_now(procs)
    # the cores each of the run's processes kept busy over the window:
    # a worker near 1 is bound by its own work, not by its ring
    run.host = {"cores": cores_used(cpu, cpu_end, run.window_s)}


def _serve(run: Run, mode, cuda: bool, t0: float) -> None:
    """One call of the engine's loop, or, traced, three (before, under
    the profiler, after); the records served over the wall of the first
    call, which no profiler slows, give the served rate."""
    import torch

    if not run.trace:
        run.reports.append(mode.serve(run.seconds, last=True))
        run.served = (mode.verdicted, time.perf_counter() - t0)
    else:
        from benchmark import trace

        span = float(run.workload.get("trace_seconds", 1.0))
        pre = max(run.seconds - span, 0.0) / 2
        run.reports.append(mode.serve(pre, last=False))
        run.served = (mode.verdicted, time.perf_counter() - t0)
        b0 = mode.mark()
        with trace.profiled(cuda) as prof:
            t_a = time.perf_counter()
            run.reports.append(mode.serve(span, last=False))
            if cuda:
                torch.cuda.synchronize()
            t_b = time.perf_counter()
        run.segments.append((b0, mode.mark(), t_b - t_a))
        run.trace_summary = trace.summarize(prof, t_b - t_a) if cuda else None
        rest = max(run.seconds - (time.perf_counter() - t0), 0.0)
        run.reports.append(mode.serve(rest, last=True))


def _result(run: Run, mode, cuda: bool, control_bits=None) -> dict:
    import torch

    from benchmark.reference.replay import PoolInputs, compare, replay
    from benchmark.reference.step import ReferenceFilter

    eng = mode.engine
    found = forbidden_modules()
    lost = mode.lost()
    program = {"counters": eng.stats.to_dict(), "blocks": run.sink.blocks(),
               "table": eng.table_rows()}
    # the engine's device state is the program's: freed before the
    # reference runs
    mode.engine = None
    del eng
    if cuda:
        torch.cuda.empty_cache()
    pool = mode.reference_pool()
    inputs = PoolInputs(pool, run.config["weights"], run.device)
    ref = ReferenceFilter(run.config["fsx"], run.config["weights"],
                          run.device)
    t_ref = time.perf_counter()
    t0_ns, sizes, batches = mode.batches(pool, run.device)
    shape = (run.fsx.batch.max_batch, len(sizes), int(sum(sizes)))
    keys, untils, distinct = replay(ref, inputs, batches, t0_ns, *shape)
    run.distinct_per_batch = distinct
    reference = {"counters": ref.counters(), "blocks": (keys, untils),
                 "table": ref.table()}
    run.reference_s = time.perf_counter() - t_ref
    checks = compare(program, reference)
    control = None
    if control_bits:
        low = ReferenceFilter(run.config["fsx"], run.config["weights"],
                              run.device, weight_bits=control_bits)
        _, _, batches = mode.batches(pool, run.device)
        lk, lu, _ = replay(low, inputs, batches, t0_ns, *shape)
        control = compare({"counters": low.counters(), "blocks": (lk, lu),
                           "table": low.table()}, reference)
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    kind = "per_layer" if run.trace else "end_to_end"
    metrics = {}
    for m in run.metric_names(kind):
        value = load_reader(run.bench, m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": run.device_kind or "cpu",
              "count": 1, "memory_peak_bytes": run.memory_peak}
    out = {"correct": bool(correct and lost == 0 and not found),
           "attempted": int(mode.attempted), "failed": int(lost),
           "metrics": metrics, "device": device}
    if run.trace and run.trace_summary is not None:
        device["busy_s"] = run.trace_summary["busy_s"]
        device["window_s"] = run.trace_summary["window_s"]
        out["breakdown"] = run.trace_summary["breakdown"]
    out["window_s"] = run.window_s
    n, wall = run.served
    out["served"] = {"records_per_s": n / wall if wall > 0 else None,
                     "device_ops": run.device_ops,
                     "device_busy_s": run.device_busy_s,
                     **program["counters"],
                     "blocks": int(len(program["blocks"][0])),
                     "tracked_rows": int(np.count_nonzero(program["table"][0])),
                     **mode.summary()}
    out["host"] = run.host
    out["setup_phases"] = {"imported_s": run.imported_s,
                           **getattr(mode, "phases", {})}
    out["forbidden_modules"] = found
    out["reference_s"] = run.reference_s
    out["bytes_written"] = run.io_written
    if control is not None:
        out["control_checks"] = control
    out["checks"] = checks
    return out
