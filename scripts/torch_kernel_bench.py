#!/usr/bin/env python3
"""Time the port's CUDA kernels at the main path's shapes, on one GPU.

    python3 scripts/torch_kernel_bench.py [--tree DIR] [--label NAME]
        [--out FILE] [--flush read|write]

Imports ``flowsentryx_tpu_torch`` from ``--tree`` (default: this
checkout), so the same script times another revision of the kernels and
their wrappers: unpack that revision with ``git archive`` into a
directory that ``.gitignore`` lists and pass it as ``--tree``.  Runs of
two trees in one call, in turns (A, B, B, A), compare the designs on
one card.  Only what both designs share is used: the wrappers' public
API (``build_all``, ``pack_score_params``, ``score_int8``,
``table_summary_counts``) and the engine's captured single step
(``Engine._graphs[0]``, ``StepGraph.replay``).

Per kernel, at the shapes the served path gives it:

* ``score_int8`` on a decoded B=2048 ``syn_benign_mix`` serving batch
  (golden params), back to back as the step issues it;
* ``table_summary`` on the tables that 384 served batches of
  ``syn_benign_mix`` and of ``mixed_l34_1m`` leave in a 2^20-row table,
  with the 50 MB L2 flushed before each call, as a report finds it
  (``--flush read``, the default, reads a 256 MB buffer, which leaves
  L2 clean; ``--flush write`` zero-fills it, which leaves L2 full of
  dirty lines that the timed call then pays to write back);

* ``segment_sum_seq`` on the sorted byte lanes of raw48 batches: a
  served ``mixed_l34_1m`` batch (B=2048), the crafted batch where one
  source sends 300 records of 65,535 B, and single-source floods (one
  segment over the whole batch) at B=2048 and B=16,384;
* ``gemv_seq``, the QAT weight gradient's row-order FMA chains, on
  operands of the training path's shapes (seeded: a dL/dy of mixed
  magnitudes and zeros, quantized inputs on the 0..255 grid times a
  scale): one chain of 2,016,639 rows, and the data-parallel epoch's 8
  shards of 252,080 rows (one ``gemv_seq_shards`` launch where the tree
  has it, else 8 ``gemv_seq`` launches, as that tree's epoch makes them);

it prints ``device_ms`` (the kernel's own time, ``torch.profiler``),
``event_ms`` (CUDA events per call: back to back for the scorer, one
flushed call at a time for the summary; launch gaps included),
``host_us_per_call`` (the wrapper's enqueue time) and whether the result
equals the plain version; and, beside each table, the engine's captured
single step replayed back to back on a batch of that scenario (device
busy ms per batch from ``torch.profiler``, event ms per batch).  The
chain kernels' rows add the card's SM clock, read with ``nvidia-smi``
while the kernel runs, and the chain's floor at that clock (its
dependent adds or FMAs, 4 cycles each).  Needs a
CUDA device; exits 2 without one.
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 20261016
BATCH = 2048
TABLE_CAP = 1 << 20
SERVE_BATCHES = 384


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=HERE)
    ap.add_argument("--label", default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--flush", choices=("read", "write"), default="read")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree))

    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_bench: no CUDA device", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    from flowsentryx_tpu_torch.core import schema
    from flowsentryx_tpu_torch.core.config import (
        BatchConfig, FsxConfig, ModelConfig, TableConfig,
    )
    from flowsentryx_tpu_torch.engine import (
        Engine, NullSink, Scenario, TrafficSource, TrafficSpec,
    )
    from flowsentryx_tpu_torch.models import logreg
    from flowsentryx_tpu_torch.ops import kernels

    assert os.path.abspath(kernels.__file__).startswith(
        os.path.abspath(args.tree)), kernels.__file__
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    t = time.perf_counter()
    kernels.build_all()
    build_s = time.perf_counter() - t

    def back_to_back(fn, reps):
        """CUDA-event ms per call over ``reps`` calls issued back to back,
        as the step issues the scorer (launch gaps included)."""
        fn()
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(True), torch.cuda.Event(True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / reps

    def flushed_time(fn, reps, flush):
        """CUDA-event ms of one call, L2 flushed before each, averaged."""
        fn()
        total = 0.0
        for _ in range(reps):
            flush()
            a, b = torch.cuda.Event(True), torch.cuda.Event(True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            total += a.elapsed_time(b)
        return total / reps

    def host_us(fn, reps):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        us = (time.perf_counter() - t0) / reps * 1e6
        torch.cuda.synchronize()
        return us

    def device_ms(fn, reps, name):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        return sum(ev.time_range.elapsed_us() for ev in prof.events()
                   if ev.device_type == torch.autograd.DeviceType.CUDA
                   and name in ev.name) / reps / 1e3

    # score_int8 on a decoded serving batch
    params = logreg.golden_params(dev)
    packed = kernels.pack_score_params(params)
    quant = schema.wire_quant_for(logreg.LogRegParams(
        **logreg.params_to_numpy(params)))
    rec = TrafficSource(TrafficSpec(scenario=Scenario("syn_benign_mix"),
                                    rate_pps=1e6, seed=SEED),
                        total=BATCH).poll(BATCH)
    raw = schema.encode_compact(rec, BATCH, int(rec["ts_ns"][0]), **quant)
    x = schema.decode_compact(schema.wire_to_tensor(raw).to(dev),
                              **quant).feat.contiguous()

    def score():
        return kernels.score_int8(params, x, packed)

    out = {"label": args.label, "tree": args.tree, "card": card,
           "build_s": build_s}
    out["score_int8"] = {
        "shape": list(x.shape),
        "equal_plain": bool(torch.equal(score(),
                                        kernels.score_int8_plain(params, x))),
        "device_ms": device_ms(score, 100, "score_int8_kernel"),
        "event_ms": back_to_back(score, 200),
        "host_us_per_call": host_us(score, 500),
    }

    # table_summary on the served tables
    scratch = torch.zeros(64 << 20, dtype=torch.float32, device=dev)
    flush = scratch.sum if args.flush == "read" else scratch.zero_
    scratch.sum()          # write the zero fill back before any timing
    out["flush"] = args.flush
    out["table_summary"] = {}
    for scen, model in (("syn_benign_mix", "logreg_int8"),
                        ("mixed_l34_1m", "logreg_int8_pallas")):
        cfg = FsxConfig(table=TableConfig(capacity=TABLE_CAP,
                                          salt=SEED & 0xFFFFFFFF),
                        batch=BatchConfig(max_batch=BATCH),
                        model=ModelConfig(name=model))
        src = TrafficSource(TrafficSpec(scenario=Scenario(scen),
                                        rate_pps=1e6, seed=SEED),
                            total=SERVE_BATCHES * BATCH)
        e = Engine(cfg, src, NullSink(), device=dev)
        e.run()
        torch.cuda.synchronize()
        key, state, now = e.table.key, e.table.state, e._device_now

        def summary():
            return kernels.table_summary_counts(key, state, now, 30.0)

        def flushed():
            flush()
            return summary()

        got, want = summary(), kernels.table_summary_plain(key, state, now,
                                                            30.0)
        out["table_summary"][scen] = {
            "rows": int(key.shape[0]), "tracked": int((key != 0).sum()),
            "equal_plain": bool(torch.equal(got[0], want[0]))
            and float(got[1]) == float(want[1]),
            "device_ms": device_ms(flushed, 30, "table_summary_kernel"),
            "event_ms": flushed_time(summary, 30, flush),
            "host_us_per_call": host_us(summary, 100),
        }
        # the captured single step (golden params on syn_benign_mix, the
        # pallas lane's on mixed_l34_1m) replayed back to back on a real
        # batch of the scenario: the step's device ms per batch, and its
        # event ms (launch gaps included)
        gr = e._graphs[0]
        srec = TrafficSource(TrafficSpec(scenario=Scenario(scen),
                                         rate_pps=1e6, seed=SEED + 1),
                             total=BATCH).poll(BATCH)
        gr.input.copy_(schema.wire_to_tensor(schema.encode_compact(
            srec, BATCH, int(srec["ts_ns"][0]), **e.quant)).to(dev))

        def replay():
            gr.replay()

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                replay()
            torch.cuda.synchronize()
        spans = sorted((ev.time_range.start, ev.time_range.end)
                       for ev in prof.events()
                       if ev.device_type == torch.autograd.DeviceType.CUDA)
        busy, hi = 0, None
        for a, b in spans:
            if hi is None or a > hi:
                busy += b - a
                hi = b
            elif b > hi:
                busy += b - hi
                hi = b
        out["table_summary"][scen]["step"] = {
            "device_busy_ms_per_batch": busy / 20 / 1e3,
            "event_ms_per_batch": back_to_back(replay, 100)}
    print("torch_kernel_bench: score_int8, table_summary done",
          file=sys.stderr, flush=True)
    chain_rows(out, dev, back_to_back, host_us)
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


def closed_device_ms(fn, reps, name):
    """The ``name`` kernels' device ms per call from ``torch.profiler``,
    the window closed by a torch kernel (without one the trace may drop
    the last launches of a library loaded with ``ctypes``); None when
    the trace holds none."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    tail = torch.zeros(1, device="cuda")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        tail.add_(1)
        torch.cuda.synchronize()
    evs = [ev.time_range.elapsed_us() for ev in prof.events()
           if ev.device_type == torch.autograd.DeviceType.CUDA
           and name in ev.name]
    return sum(evs) / reps / 1e3 if evs else None


def chain_rows(out, dev, back_to_back, host_us):
    """``segment_sum_seq`` and ``gemv_seq`` rows (module docstring)."""
    import numpy as np
    import torch

    from flowsentryx_tpu_torch.core import schema
    from flowsentryx_tpu_torch.engine import (
        Scenario, TrafficSource, TrafficSpec,
    )
    from flowsentryx_tpu_torch.ops import agg, kernels

    sys.path.insert(1, HERE)    # chip_smoke's helpers; --tree stays first
    from chip_smoke import _chain_floor_ms as floor_ms
    from chip_smoke import _sm_clock_under as sm_clock

    def byte_segments(rec, b):
        fb = schema.decode_raw(schema.wire_to_tensor(schema.encode_raw(
            rec, b, int(rec["ts_ns"][0]))).to(dev))
        key = torch.where(fb.valid, fb.key, agg.INVALID_KEY)
        key_s, order = torch.sort(key, stable=True)
        seg = torch.cumsum(agg.run_heads(key_s), 0) - 1
        v = torch.where(fb.valid[order], fb.pkt_len[order], 0.0)
        return v.contiguous(), seg.contiguous()

    def flood(b):
        rec = np.zeros(b, schema.FLOW_RECORD_DTYPE)
        rec["ts_ns"] = 5 * 10 ** 9 + np.arange(b) * 100
        rec["saddr"] = 0x0A000001
        rec["pkt_len"] = 65535
        return rec

    def heavy():
        r = np.random.default_rng(SEED + 1)
        rec = np.zeros(BATCH, schema.FLOW_RECORD_DTYPE)
        rec["ts_ns"] = 5 * 10 ** 9 + np.arange(BATCH) * 100
        keys = r.integers(2, 200, BATCH)
        keys[r.choice(BATCH, 300, replace=False)] = 1
        rec["saddr"] = keys
        rec["pkt_len"] = np.where(keys == 1, 65535,
                                  r.integers(40, 65536, BATCH))
        return rec

    mixed = TrafficSource(TrafficSpec(scenario=Scenario("mixed_l34_1m"),
                                      rate_pps=1e6, seed=SEED),
                          total=BATCH).poll(BATCH)
    cases = {"mixed_l34_1m": byte_segments(mixed, BATCH),
             "heavy_300x65535": byte_segments(heavy(), BATCH),
             "one_source_2048": byte_segments(flood(BATCH), BATCH),
             "one_source_16384": byte_segments(flood(16_384), 16_384)}
    clock = None
    out["segment_sum_seq"] = {}
    for label, (v, seg) in cases.items():
        b = v.shape[0]

        def call(v=v, seg=seg, b=b):
            return kernels.segment_sum_seq(v, seg, b)

        if clock is None:
            clock = sm_clock(call)
        longest = int(torch.bincount(seg).max())
        got, want = call(), agg.segment_sum_seq_plain(v, seg, b)
        out["segment_sum_seq"][label] = {
            "lanes": b, "segments": int(seg[-1]) + 1,
            "longest_segment": longest,
            "equal_plain": bool(torch.equal(got.view(torch.int32),
                                            want.view(torch.int32))),
            "device_ms": closed_device_ms(call, 100,
                                          "segment_sum_seq_kernel"),
            "event_ms": back_to_back(call, 500),
            "host_us_per_call": host_us(call, 500),
            "bound_ms": (b * 12 + b * 4) / 3.35e12 * 1e3,
            "chain_floor_ms": floor_ms(longest - 1, clock),
            "sm_clock": clock}
        print(f"torch_kernel_bench: segment_sum_seq {label}",
              json.dumps(out["segment_sum_seq"][label]), file=sys.stderr,
              flush=True)

    # gemv_seq on seeded operands of the training path's shapes
    n, shards = 2_016_639, 8
    rows = -(-n // shards)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    gy = torch.randn(rows * shards, device=dev, generator=gen) * 10.0 ** (
        torch.rand(rows * shards, device=dev, generator=gen) * 6 - 5)
    gy[torch.rand(rows * shards, device=dev, generator=gen) < 0.1] = 0.0
    xq = torch.randint(0, 256, (rows * shards, 8), device=dev,
                       generator=gen).float() * 0.0174
    g1, m1 = gy[:n].contiguous(), xq[:n].contiguous()
    g8 = gy.reshape(shards, rows).contiguous()
    m8 = xq.reshape(shards, rows, 8).contiguous()
    one_launch = hasattr(kernels, "gemv_seq_shards")

    def single():
        return kernels.gemv_seq(g1, m1)

    def dp_epoch():
        if one_launch:
            return kernels.gemv_seq_shards(g8, m8)
        return torch.stack([kernels.gemv_seq(g8[i], m8[i])
                            for i in range(shards)])

    out["gemv_seq"] = {}
    for label, fn, steps, nrows in (
            ("rows_2016639", single, n, n),
            ("dp_8x252080", dp_epoch, rows, rows * shards)):
        clock = sm_clock(fn)
        got = fn()
        want = (kernels.gemv_seq_plain(g1.cpu(), m1.cpu()) if fn is single
                else torch.stack([kernels.gemv_seq_plain(g8[i].cpu(),
                                                         m8[i].cpu())
                                  for i in range(shards)]))
        out["gemv_seq"][label] = {
            "rows": nrows,
            "launches": 1 if fn is single or one_launch else shards,
            "equal_plain": bool(torch.equal(got.cpu().view(torch.int32),
                                            want.view(torch.int32))),
            "device_ms": closed_device_ms(fn, 5, "gemv_seq_kernel"),
            "event_ms": back_to_back(fn, 10),
            "host_us_per_call": host_us(fn, 10),
            "bound_ms": (nrows * 36 + 32) / 3.35e12 * 1e3,
            "chain_floor_ms": floor_ms(steps, clock),
            "sm_clock": clock,
            "library_event_ms": back_to_back(
                (lambda: torch.mv(m1.t(), g1)) if fn is single
                else (lambda: torch.bmm(g8[:, None, :], m8)), 20)}
        print(f"torch_kernel_bench: gemv_seq {label}",
              json.dumps(out["gemv_seq"][label]), file=sys.stderr,
              flush=True)


if __name__ == "__main__":
    sys.exit(main())
