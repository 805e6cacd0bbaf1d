#!/usr/bin/env python3
"""Where the port's serving time goes, on one GPU: the eager step, the
single-step CUDA graph and the top megastep rung, in turns, in one
process; then the engine end to end.

    python3 scripts/torch_step_profile.py [--scenario mixed_l34_1m]
        [--batches 64] [--turns 3] [--rung 8] [--serve-batches 256]
        [--out step_profile.json]

Dispatch layer (2^20-row table, B=2048, golden params, the same
pregenerated compact16 batches for every mode, each mode on its own
table).  Every dispatch is what the engine does on the card: copy the
batch (or the rung's group) from pinned memory to the device, run the
step (eager) or replay its graph, copy the ``[2K+4]`` wire back into
pinned memory and record an event; at most ``readback_depth`` (8)
batches stay in flight, the oldest waited for beyond that.  Per mode
and turn, over a window of ``--batches`` batches:

* ``host_us_per_dispatch``: host time inside the dispatch calls (copies,
  step or replay, event), without the waits;
* ``wall_ms_per_batch``: the window's wall, ending in a synchronize,
  without the profiler;
* ``device_ops_per_batch`` and ``device_busy_ms_per_batch``: CUDA kernels
  and copies seen by ``torch.profiler`` over a second, profiled window
  (the union of their intervals), and the idle share
  ``1 - busy / wall`` of the unprofiled window.

The engine's own dispatch path (``Engine._dispatch``/``_dispatch_mega``
and the reaps) over pre-sealed batches, without the fill: host µs per
batch in the dispatch calls and wall per batch.

Then ``Engine(mega_n=0)`` (singles, one graph replay per batch) and
``Engine(mega_n="auto")`` serve ``--serve-batches`` batches of the
scenario from a deep backlog, in turns: records/s, the host stage times
(fill / step / sink) and the dispatch histogram; and one profiled run
of each gives the device's busy time per batch, whose idle share is
taken against the unprofiled runs' median wall.

Needs a CUDA device; exits 2 without one.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

DEPTH = 8


def _busy_and_ops(prof) -> tuple[float, int]:
    import torch

    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = 0.0
    cur_s = cur_e = None
    for s, e in sorted((e.time_range.start, e.time_range.end)
                       for e in events):       # union of device intervals
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy, len(events)


def _top_ops(prof, n_batches: int, k: int = 12) -> list[dict]:
    """Device time per batch by kernel or copy name, largest first."""
    import torch

    by_name: dict[str, list] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            d = by_name.setdefault(e.name, [0, 0.0])
            d[0] += 1
            d[1] += e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:k]
    return [{"name": name[:90], "calls_per_batch": v[0] / n_batches,
             "us_per_batch": v[1] / n_batches} for name, v in top]


def _top_host_ops(prof, n_batches: int, k: int = 10) -> list[dict]:
    """Host (CPU) self time per batch by operator or CUDA runtime call,
    largest first (under the profiler, which inflates host time)."""
    import torch

    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CPU]
    rows.sort(key=lambda e: -e.self_cpu_time_total)
    return [{"name": e.key[:60], "calls_per_batch": e.count / n_batches,
             "self_us_per_batch": e.self_cpu_time_total / n_batches}
            for e in rows[:k]]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenario", default="mixed_l34_1m")
    ap.add_argument("--batches", type=int, default=64,
                    help="batches per window (a multiple of --rung)")
    ap.add_argument("--turns", type=int, default=3)
    ap.add_argument("--rung", type=int, default=8)
    ap.add_argument("--serve-batches", type=int, default=256)
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args()
    if args.batches % args.rung:
        ap.error("--batches must be a multiple of --rung")

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_step_profile: no CUDA device", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    from flowsentryx_tpu_torch.core import schema
    from flowsentryx_tpu_torch.core.config import (
        BatchConfig, FsxConfig, TableConfig,
    )
    from flowsentryx_tpu_torch.engine import (
        Engine, NullSink, Scenario, TrafficGen, TrafficSource, TrafficSpec,
    )
    from flowsentryx_tpu_torch.models import logreg
    from flowsentryx_tpu_torch.ops import fused, graph, kernels

    dev = torch.device("cuda")
    b, cap, g = 2048, 1 << 20, args.rung
    cfg = FsxConfig(table=TableConfig(capacity=cap, salt=0x5EED),
                    batch=BatchConfig(max_batch=b))
    params = logreg.golden_params(dev)
    quant = schema.wire_quant_for(logreg.LogRegParams(
        **logreg.params_to_numpy(params)))
    classify = functools.partial(kernels.score_int8,
                                 packed=kernels.pack_score_params(params))
    step = fused.make_compact_step(cfg, classify, **quant)
    mega = fused.make_compact_megastep(cfg, classify, g, **quant)

    # two windows (unprofiled, profiled) per turn, the same batches for
    # every mode, in pinned memory as the engine stages them
    n_windows = 2 * args.turns
    gen = TrafficGen(TrafficSpec(scenario=Scenario(args.scenario), seed=1,
                                 rate_pps=1e6))
    t0 = None
    raws = []
    for _ in range(n_windows * args.batches):
        rec = gen.next_records(b)
        t0 = int(rec["ts_ns"][0]) if t0 is None else t0
        raws.append(schema.encode_compact(rec, b, t0, **quant))
    host = schema.wire_to_tensor(np.stack(raws)).pin_memory()
    host = host.reshape(n_windows, args.batches, b + 1, 4)

    class Mode:
        def __init__(self, name):
            self.name = name
            self.table = schema.make_table(cap, dev)
            self.stats = schema.make_stats(dev)
            self.n = 1 if name != "rung" else g
            self.x = torch.zeros((b + 1, 4) if name != "rung"
                                 else (g, b + 1, 4), dtype=torch.int32,
                                 device=dev)
            self.gr = None
            if name == "graph":
                self.gr = graph.StepGraph(step, self.table, self.stats,
                                          params, (b + 1, 4))
            elif name == "rung":
                self.gr = graph.StepGraph(mega, self.table, self.stats,
                                          params, (g, b + 1, 4))
            self.wires = [torch.empty(fused.verdict_wire_words(64),
                                      dtype=torch.int32, pin_memory=True)
                          for _ in range(DEPTH + 2)]

        def dispatch(self, src, i):
            if self.gr is None:
                self.x.copy_(src, non_blocking=True)
                t = time.perf_counter()
                _, _, out = step(self.table, self.stats, params, self.x)
            else:
                self.gr.input.copy_(src, non_blocking=True)
                t = time.perf_counter()
                self.gr.replay()
                out = self.gr.out
            self.launch_s += time.perf_counter() - t
            self.wires[i % len(self.wires)].copy_(out.wire,
                                                  non_blocking=True)
            ev = torch.cuda.Event()
            ev.record()
            return ev

        def window(self, w):
            """One window of batches; returns (host s in dispatch calls,
            dispatches)."""
            groups = (host[w] if self.n == 1
                      else host[w].reshape(-1, g, b + 1, 4))
            inflight = []
            host_s = 0.0
            self.launch_s = 0.0
            for i, src in enumerate(groups):
                t = time.perf_counter()
                inflight.append(self.dispatch(src, i))
                host_s += time.perf_counter() - t
                while len(inflight) * self.n > DEPTH:
                    inflight.pop(0).synchronize()
            return host_s, len(groups)

    modes = [Mode(m) for m in ("eager", "graph", "rung")]
    for m in modes:                        # one warm window, not recorded
        m.window(0)
    torch.cuda.synchronize()
    turns = []
    top: dict[str, list] = {}         # the last turn's device ops by name
    order = ["eager", "graph", "rung", "rung", "graph", "eager"]
    for t in range(args.turns):
        row = {}
        for name in (order[:3] if t % 2 == 0 else order[3:]):
            m = next(x for x in modes if x.name == name)
            torch.cuda.synchronize()
            t_w = time.perf_counter()
            host_s, n_disp = m.window(2 * t)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t_w
            launch_s = m.launch_s
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                m.window(2 * t + 1)
                torch.cuda.synchronize()
            busy_us, n_ops = _busy_and_ops(prof)
            top[name] = _top_ops(prof, args.batches)
            nb = args.batches
            row[name] = {
                "dispatches": n_disp,
                "host_us_per_dispatch": host_s * 1e6 / n_disp,
                "host_us_per_batch": host_s * 1e6 / nb,
                # the eager step's calls, or the graph's replay() alone
                "launch_us_per_dispatch": launch_s * 1e6 / n_disp,
                "wall_ms_per_batch": wall * 1e3 / nb,
                "records_per_s": nb * b / wall,
                "device_ops_per_batch": n_ops / nb,
                "device_busy_ms_per_batch": busy_us / 1e3 / nb,
                "device_idle_share": 1.0 - busy_us / 1e6 / wall,
            }
        turns.append(row)
    same = all(torch.equal(modes[0].table.key, m.table.key)
               and torch.equal(modes[0].table.state.view(torch.int32),
                               m.table.state.view(torch.int32))
               and modes[0].stats.to_dict() == m.stats.to_dict()
               for m in modes[1:])

    # the engine end to end, singles (graph) and auto, in turns; then
    # one profiled run of each for the device's busy time
    def serve_run(mega_n, profiled=False):
        src = TrafficSource(TrafficSpec(scenario=Scenario(args.scenario),
                                        seed=1, rate_pps=1e6),
                            total=args.serve_batches * b)
        eng = Engine(cfg, src, NullSink(), params=params, device=dev,
                     mega_n=mega_n)
        eng.warm()
        if not profiled:
            return eng.run(), None
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            r = eng.run()
            torch.cuda.synchronize()
        return r, (*_busy_and_ops(prof), _top_host_ops(prof, r.batches))

    # the engine's own dispatch (staging, upload, replay, wire and
    # block-record copies, event) over pre-sealed batches, no fill
    def dispatch_only(mega_n):
        eng = Engine(cfg, TrafficSource(TrafficSpec(), total=0), NullSink(),
                     params=params, device=dev, mega_n=mega_n)
        eng.warm()
        n = args.batches
        torch.cuda.synchronize()
        t = time.perf_counter()
        for i in range(0, n, eng._group_max):
            if mega_n:
                eng._dispatch_mega([(r, t) for r in
                                    raws[i:i + eng._group_max]])
            else:
                eng._dispatch(raws[i], t)
            eng._reap(eng.readback_depth)
        eng._reap(0)
        wall = time.perf_counter() - t
        disp = eng.metrics.dispatch.percentiles_ms()
        total_us = disp["mean"] * disp["n"] * 1e3
        return {"host_us_per_batch": total_us / n,
                "host_us_per_dispatch": disp["mean"] * 1e3,
                "wall_ms_per_batch": wall * 1e3 / n}

    engine_dispatch = [{m: dispatch_only(mega_n)
                        for m, mega_n in (("single", 0), ("auto", "auto"))}
                       for _ in range(args.turns)]

    serve = []
    for t in range(args.turns):
        row = {}
        for mega_n in ((0, "auto") if t % 2 == 0 else ("auto", 0)):
            r, _ = serve_run(mega_n)
            row["single" if mega_n == 0 else "auto"] = {
                "records_per_s": r.records_per_s,
                "wall_ms_per_batch": r.wall_s * 1e3 / r.batches,
                "stages_ms": r.stages_ms,
                "group_hist": r.dispatch["group_hist"],
                "dispatch_hz": r.dispatch["dispatch_hz"]}
        serve.append(row)
    serve_busy = {}
    for mode, mega_n in (("single", 0), ("auto", "auto")):
        r, (busy_us, n_ops, host_top) = serve_run(mega_n, profiled=True)
        wall = statistics.median(row[mode]["wall_ms_per_batch"]
                                 for row in serve)
        busy = busy_us / 1e3 / r.batches
        serve_busy[mode] = {"device_ops_per_batch": n_ops / r.batches,
                            "device_busy_ms_per_batch": busy,
                            "device_idle_share": 1.0 - busy / wall,
                            "profiled_records_per_s": r.records_per_s,
                            "top_host_ops_profiled": host_top}

    def med(rows, mode, key):
        vals = [r[mode][key] for r in rows]
        return {"median": statistics.median(vals), "min": min(vals),
                "max": max(vals)}

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    out = {
        "card": smi, "scenario": args.scenario, "batches": args.batches,
        "turns": args.turns, "rung": g, "readback_depth": DEPTH,
        "tables_equal_across_modes": same,
        "summary": {mode: {k: med(turns, mode, k) for k in (
            "host_us_per_dispatch", "launch_us_per_dispatch",
            "wall_ms_per_batch", "records_per_s",
            "device_ops_per_batch", "device_busy_ms_per_batch",
            "device_idle_share")} for mode in ("eager", "graph", "rung")},
        "serve_summary": {mode: {
            "records_per_s": med(serve, mode, "records_per_s"),
            "wall_ms_per_batch": med(serve, mode, "wall_ms_per_batch"),
            **serve_busy[mode]} for mode in ("single", "auto")},
        "engine_dispatch_no_fill": {mode: {k: med(engine_dispatch, mode, k)
                                           for k in engine_dispatch[0][mode]}
                                    for mode in ("single", "auto")},
        "top_device_ops": top,
        "turns_detail": turns,
        "serve_detail": serve,
    }
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps({k: out[k] for k in (
        "card", "scenario", "batches", "turns", "rung",
        "tables_equal_across_modes")}))
    for mode, vals in out["summary"].items():
        print(json.dumps({"mode": mode, **{k: v["median"]
                                           for k, v in vals.items()},
                          "spread": {k: [v["min"], v["max"]]
                                     for k, v in vals.items()}}))
    for mode, vals in out["engine_dispatch_no_fill"].items():
        print(json.dumps({"engine_dispatch_no_fill": mode, **vals}))
    for mode, vals in out["serve_summary"].items():
        print(json.dumps({"serve": mode, **vals}))
    for t, row in enumerate(serve):
        print(json.dumps({"serve_turn": t, **row}))
    for mode, rows in top.items():
        for row in rows[:8]:
            print(json.dumps({"top_op": mode, **row}))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
