#!/usr/bin/env python3
"""Where the port's serving time goes, on one GPU.

    python3 scripts/torch_step_profile.py [--scenario mixed_l34_1m]
        [--batches 128] [--out step_profile.json]

Serves a scenario through ``flowsentryx_tpu_torch.engine.Engine`` on the
card at the production geometry (2^20-row table, B=2048), warms up,
then profiles a steady window with ``torch.profiler`` (CPU + CUDA):

* wall per batch and records/s of the window;
* device busy time (union of kernel and memcpy intervals) and the idle
  share of the window;
* the wall per batch of an equal window run just before it in the same
  process without the profiler, and the idle share it implies for the
  same busy time (the profiler slows the host, not the kernels);
* kernel count and device time by kernel name (top entries);
* the engine's host stage times (fill / step enqueue / sink), over all
  windows, and the step enqueue ms per batch of the unprofiled window.

Needs a CUDA device; exits 2 without one.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenario", default="mixed_l34_1m")
    ap.add_argument("--batches", type=int, default=128)
    ap.add_argument("--artifact", default=None)
    ap.add_argument("--out", default=None,
                    help="also write the full JSON (all top ops) here")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_step_profile: no CUDA device", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    from flowsentryx_tpu_torch.core.config import (
        BatchConfig, FsxConfig, TableConfig,
    )
    from flowsentryx_tpu_torch.engine import (
        Engine, NullSink, Scenario, TrafficSource, TrafficSpec,
    )
    from flowsentryx_tpu_torch.models import logreg

    b = 2048
    cfg = FsxConfig(table=TableConfig(capacity=1 << 20, salt=0x5EED),
                    batch=BatchConfig(max_batch=b))
    params = (logreg.load_params(args.artifact, "cuda")
              if args.artifact else None)
    src = TrafficSource(TrafficSpec(scenario=Scenario(args.scenario),
                                    seed=1), total=None)
    eng = Engine(cfg, src, NullSink(), params=params, device="cuda")
    eng.warm()
    r0 = eng.run(max_batches=64)            # steady state before the window
    torch.cuda.synchronize()
    t = time.perf_counter()
    r1 = eng.run(max_batches=eng.batcher.batches_emitted + args.batches)
    torch.cuda.synchronize()
    wall_plain = time.perf_counter() - t
    start = eng.batcher.batches_emitted
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
                 ) as prof:
        t = time.perf_counter()
        rep = eng.run(max_batches=start + args.batches)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = 0.0
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    cur_s = cur_e = None
    for s, e in spans:                       # union of device intervals
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy_us += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy_us += cur_e - cur_s
    by_name: dict[str, list] = {}
    for e in events:
        d = by_name.setdefault(e.name, [0, 0.0])
        d[0] += 1
        d[1] += e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:25]
    n = args.batches
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    out = {
        "card": smi,
        "scenario": args.scenario,
        "artifact": args.artifact,
        "batches": n,
        "records": n * b,
        "wall_s": wall,
        "wall_ms_per_batch": wall * 1e3 / n,
        "records_per_s": n * b / wall,
        "device_busy_ms_per_batch": busy_us / 1e3 / n,
        "device_idle_share": 1.0 - busy_us / 1e6 / wall,
        "device_ops_per_batch": len(events) / n,
        "unprofiled_wall_ms_per_batch": wall_plain * 1e3 / n,
        "unprofiled_records_per_s": n * b / wall_plain,
        "unprofiled_device_idle_share": 1.0 - busy_us / 1e6 / wall_plain,
        # host ms per batch enqueuing the step, unprofiled window only
        # (the report's stage totals are cumulative over runs)
        "unprofiled_step_enqueue_ms_per_batch": (
            r1.stages_ms["step"]["total_ms"]
            - r0.stages_ms["step"]["total_ms"]) / n,
        "stages_ms": rep.stages_ms,
        "top_device_ops": [
            {"name": k[:90], "calls_per_batch": v[0] / n,
             "us_per_batch": v[1] / n} for k, v in top],
        "table": rep.table,
    }
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps({k: v for k, v in out.items()
                      if k != "top_device_ops"}))
    for row in out["top_device_ops"][:12]:
        print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
