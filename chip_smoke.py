#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one GPU and hold its kernels to their
plain versions.

    python3 chip_smoke.py            # from the repository root, one card

Phases (each prints one JSON line; any failure exits non-zero and the
final ``{"ok": true, ...}`` line is never printed):

1. ``nvidia-smi`` name and power limit; build both kernels from
   ``flowsentryx_tpu_torch/csrc/`` (one ``nvcc`` per source, in
   parallel) into ``build/kernels/``.
2. ``score_int8`` kernel vs its plain version on the card, exact:
   golden params over the model-mode decode grid (every u8 code of every
   feature) plus 2^16 random rows, then the log1p artifact
   ``artifacts/logreg_int8.npz`` the same way; and for each params the
   decoded B=2048 serving batches of both scenarios, the shape the main
   path hands the scorer; ragged batches of 1, 15, 2047 and 2049 rows;
   and the packed output table against the plain output stage.
3. ``table_summary`` kernel vs plain, exact: an empty 2^20-row table, a
   random fill at 2^20 rows, a row count that is no multiple of 1024,
   and (after phase 4) the real table the served run left.
4. Serve: ``Engine(device="cuda")`` at capacity 2^20, B=2048 over
   ``syn_benign_mix`` and ``mixed_l34_1m``; launch counters are zeroed
   just before and read just after, and each kernel must have launched.
5. Cross-check: a shorter corpus of each scenario through the CUDA
   engine and through ``Engine(device="cpu")`` (the plain versions):
   stats, blacklist and a digest of the whole table must be equal; and
   the XLA:CPU rounding helpers (``xla_exp``, ``xla_exp2``, ``fma32``,
   ``recip_mul``) give the same bits on the card as on the host.

Then the timing line per kernel: ``ms`` (CUDA events, host launch gaps
included), ``device_ms`` (the kernel's own time from ``torch.profiler``),
``host_us_per_call`` (the wrapper's enqueue time), the plain version,
one library call where one exists (event and profiler time), and the
bound from this run's inputs (for ``table_summary``: every key plus the
two state words of each tracked row, which is what the kernel must
read; beside it the sector-level floor, every key plus each distinct
32-byte sector that holds a tracked row's two words, counted on this
run's table), ``table_summary`` on both served tables; then the card
line, and
last the ``ok`` line.  The script imports nothing of JAX.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import time
import traceback

#: Card peaks used for the bound (NVIDIA H100 SXM data sheet).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
SEED = 20261016
TABLE_CAP = 1 << 20
BATCH = 2048
SERVE_BATCHES = 384
CROSS_BATCHES = 48
RAGGED_B = (1, 15, 2047, 2049)

FAILED: list[str] = []


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def phase(name: str):
    """Run a phase function; record (never swallow) its failure."""
    def wrap(fn):
        def run(*a, **kw):
            t = time.perf_counter()
            try:
                res = fn(*a, **kw)
            except Exception as e:  # reported, and the run exits non-zero
                traceback.print_exc()
                FAILED.append(name)
                emit({"phase": name, "ok": False, "error": repr(e),
                      "s": round(time.perf_counter() - t, 3)})
                return None
            ok = bool(res.pop("ok", True))
            if not ok:
                FAILED.append(name)
            emit({"phase": name, "ok": ok, **res,
                  "s": round(time.perf_counter() - t, 3)})
            return res
        return run
    return wrap


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else (
        "nvidia-smi: " + out.stderr.strip())


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import numpy as np

    from flowsentryx_tpu_torch.core import schema
    from flowsentryx_tpu_torch.core.config import (
        BatchConfig, FsxConfig, TableConfig,
    )
    from flowsentryx_tpu_torch.engine import (
        CollectSink, Engine, Scenario, TrafficSource, TrafficSpec,
    )
    from flowsentryx_tpu_torch.models import logreg
    from flowsentryx_tpu_torch.ops import kernels

    dev = torch.device("cuda")
    card = smi_line()
    emit({"phase": "card", "nvidia_smi": card,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0)})
    artifact = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "artifacts", "logreg_int8.npz")
    errs = {"score_int8": 0.0, "table_summary": 0.0}

    @phase("build")
    def build():
        t = time.perf_counter()
        info = kernels.build_all()
        return {"wall_s": round(time.perf_counter() - t, 3), "kernels": info}

    if build() is None:
        return 1

    rng = np.random.default_rng(SEED)

    def decoded_grid(params, n_random):
        """Features as the model-mode wire decodes them: every u8 code
        of every feature (8 x 256 rows, the other features random), plus
        ``n_random`` rows of random codes."""
        q = rng.integers(0, 256, (8 * 256 + n_random, 8), dtype=np.uint32)
        for f in range(8):
            q[f * 256:(f + 1) * 256, f] = np.arange(256, dtype=np.uint32)
        n = q.shape[0]
        raw = np.zeros((n + 1, 4), np.uint32)
        raw[:n, 1] = q[:, 0] | q[:, 1] << 8 | q[:, 2] << 16 | q[:, 3] << 24
        raw[:n, 2] = q[:, 4] | q[:, 5] << 8 | q[:, 6] << 16 | q[:, 7] << 24
        raw[n, 0] = n
        quant = schema.model_quant_args(logreg.LogRegParams(
            **logreg.params_to_numpy(params)))
        return schema.decode_compact(
            schema.wire_to_tensor(raw).to(dev), **quant).feat.contiguous()

    def serving_batch(params, scenario):
        """A decoded B = 2048 serving batch of ``scenario``, as the main
        path hands it to the scorer: records -> compact16 wire in the
        params' model mode -> device decode."""
        quant = schema.wire_quant_for(logreg.LogRegParams(
            **logreg.params_to_numpy(params)))
        rec = TrafficSource(TrafficSpec(scenario=Scenario(scenario),
                                        rate_pps=1e6, seed=SEED),
                            total=BATCH).poll(BATCH)
        raw = schema.encode_compact(rec, BATCH, int(rec["ts_ns"][0]),
                                    **quant)
        return schema.decode_compact(schema.wire_to_tensor(raw).to(dev),
                                     **quant).feat

    def compare_scores(params, x):
        got = kernels.score_int8(params, x)
        want = kernels.score_int8_plain(params, x)
        torch.cuda.synchronize()
        diff = (got - want).abs()
        mism = int((got != want).sum())
        errs["score_int8"] = max(errs["score_int8"], float(diff.max()))
        return mism

    @phase("score_int8_vs_plain")
    def score_phase():
        res = {}
        mismatches = []
        for name, params in (("golden", logreg.golden_params(dev)),
                             ("log1p_artifact",
                              logreg.load_params(artifact, dev))):
            grid = decoded_grid(params, 1 << 16)
            raw_x = torch.from_numpy(rng.uniform(
                0, 2e6, (1 << 16, 8)).astype(np.float32)).to(dev)
            res[name] = {"grid_rows": grid.shape[0],
                         "grid_mismatches": compare_scores(params, grid),
                         "raw_rows": raw_x.shape[0],
                         "raw_mismatches": compare_scores(params, raw_x)}
            mismatches += [res[name]["grid_mismatches"],
                           res[name]["raw_mismatches"]]
            # the main path's shape: decoded [2048, 8] serving batches
            for scen in ("syn_benign_mix", "mixed_l34_1m"):
                x = serving_batch(params, scen)
                m = compare_scores(params, x)
                res[name][f"serve_{scen}"] = {"shape": list(x.shape),
                                              "mismatches": m}
                mismatches.append(m)
            # ragged batches: a partial block, a partial last row group
            ragged = {}
            for b in RAGGED_B:
                ragged[b] = compare_scores(params, raw_x[:b].contiguous())
                mismatches.append(ragged[b])
            res[name]["ragged_mismatches"] = ragged
            # the packed output table is the plain output stage, per code
            codes = torch.arange(256, dtype=torch.float32, device=dev)
            table_ok = torch.equal(kernels.pack_score_params(params).table,
                                   logreg.score_from_code(params, codes))
            res[name]["table_equals_plain"] = table_ok
            mismatches.append(int(not table_ok))
        ok = not any(mismatches)
        return {"ok": ok, "tolerance": "exact (0 mismatches)", **res}

    def compare_summary(key, state, now, stale_s):
        ck, nk = kernels.table_summary_counts(key, state, now, stale_s)
        cp, np_ = kernels.table_summary_plain(key, state, now, stale_s)
        torch.cuda.synchronize()
        err = max(float((ck - cp).abs().max()), abs(float(nk) - float(np_)))
        errs["table_summary"] = max(errs["table_summary"], err)
        return {"kernel": [*ck.tolist(), float(nk)],
                "plain": [*cp.tolist(), float(np_)],
                "equal": bool(torch.equal(ck, cp)) and float(nk) == float(np_)}

    def random_table(n):
        key = torch.zeros(n, dtype=torch.int32, device=dev)
        state = torch.zeros(n, schema.NUM_TABLE_COLS, dtype=torch.float32,
                            device=dev)
        fill = torch.from_numpy(rng.random(n) < 0.6).to(dev)
        key[fill] = torch.from_numpy(rng.integers(
            1, 1 << 31, n, dtype=np.int64).astype(np.int32)).to(dev)[fill]
        state[:, schema.TableCol.LAST_SEEN] = torch.from_numpy(
            rng.uniform(0, 100, n).astype(np.float32)).to(dev)
        state[:, schema.TableCol.BLOCKED_UNTIL] = torch.from_numpy(
            np.where(rng.random(n) < 0.3, rng.uniform(80, 200, n), 0.0)
            .astype(np.float32)).to(dev)
        return key, state

    @phase("table_summary_vs_plain")
    def summary_phase():
        empty = schema.make_table(TABLE_CAP, dev)
        cases = {"empty_2^20": compare_summary(empty.key, empty.state,
                                               5.0, 30.0)}
        key, state = random_table(TABLE_CAP)
        cases["random_2^20"] = compare_summary(key, state, 90.0, 30.0)
        odd = TABLE_CAP - 3
        key, state = random_table(odd)
        cases[f"random_{odd}"] = compare_summary(key, state, 90.0, 30.0)
        return {"ok": all(c["equal"] for c in cases.values()),
                "tolerance": "exact", "cases": cases}

    score_phase()
    summary_phase()

    cfg = FsxConfig(table=TableConfig(capacity=TABLE_CAP, salt=SEED & 0xFFFFFFFF),
                    batch=BatchConfig(max_batch=BATCH))
    scenarios = (("syn_benign_mix", "logreg_int8"),
                 ("mixed_l34_1m", "logreg_int8_pallas"))

    def engine_for(scen, model, total, device, params=None):
        import dataclasses

        c = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, name=model))
        src = TrafficSource(TrafficSpec(scenario=Scenario(scen),
                                        rate_pps=1e6, seed=SEED),
                            total=total)
        return Engine(c, src, CollectSink(), params=params, device=device)

    served: dict = {}

    @phase("serve")
    def serve_phase():
        engines = [engine_for(s, m, SERVE_BATCHES * BATCH, "cuda")
                   for s, m in scenarios]
        for e in engines:
            e.warm()
        kernels.reset_launches()          # the main path's window opens
        reports = [e.run() for e in engines]
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)  # ... and closes
        served["engines"] = engines
        served["launches"] = launches
        out = {"card": card, "launches": launches}
        for (s, m), r in zip(scenarios, reports):
            out[s] = {"model": m, "batches": r.batches, "records": r.records,
                      "wall_s": r.wall_s, "records_per_s": r.records_per_s,
                      "stages_ms": r.stages_ms, "stats": r.stats,
                      "blocked_sources": r.blocked_sources, "table": r.table,
                      "readback": r.readback}
        checks = [r.records == SERVE_BATCHES * BATCH for r in reports]
        checks += [r.stats["allowed"] + r.stats["dropped"] == r.records
                   for r in reports]
        checks += [r.table["tracked"] > 0 for r in reports]
        checks += [launches[k] > 0 for k in launches]
        return {"ok": all(checks), **out}

    serve_phase()

    @phase("table_summary_real_table")
    def real_table_phase():
        res = {}
        for (s, _), e in zip(scenarios, served.get("engines", [])):
            res[s] = compare_summary(e.table.key, e.table.state,
                                     e._device_now, cfg.table.stale_s)
        return {"ok": bool(res) and all(c["equal"] for c in res.values()),
                "cases": res}

    real_table_phase()

    def digest(e):
        k, st = schema.table_to_numpy(e.table)
        return hashlib.sha256(k.tobytes() + st.tobytes()).hexdigest()[:16]

    @phase("cross_check_cpu")
    def cross_phase():
        res = {}
        ok = True
        for s, m in scenarios:
            for label, params in (("golden", None),
                                  ("log1p_artifact", "artifact")):
                runs = {}
                tables = {}
                for device in ("cuda", "cpu"):
                    p = (logreg.load_params(artifact, device)
                         if params else None)
                    e = engine_for(s, m, CROSS_BATCHES * BATCH, device, p)
                    r = e.run()
                    runs[device] = (r.stats, sorted(e.sink.blocked.items()),
                                    digest(e), r.table)
                    tables[device] = schema.table_to_numpy(e.table)
                same = {"stats": runs["cuda"][0] == runs["cpu"][0],
                        "blacklist": runs["cuda"][1] == runs["cpu"][1],
                        "table_digest": runs["cuda"][2] == runs["cpu"][2],
                        "table_summary": runs["cuda"][3] == runs["cpu"][3]}
                ok &= all(same.values())
                res[f"{s}/{label}"] = {
                    "equal": same, "stats": runs["cuda"][0],
                    "blocked": len(runs["cuda"][1]),
                    "digest": runs["cuda"][2]}
                if not same["table_digest"]:
                    # name what differs: rows per state column, max ULP
                    (kc, sc), (kp, sp) = tables["cuda"], tables["cpu"]
                    ulp = np.abs(sc.view(np.int32).astype(np.int64)
                                 - sp.view(np.int32).astype(np.int64))
                    res[f"{s}/{label}"]["diff"] = {
                        "key_rows": int((kc != kp).sum()),
                        "state_rows_by_col": {
                            schema.TableCol(c).name: [int((ulp[:, c] > 0).sum()),
                                                      int(ulp[:, c].max())]
                            for c in range(ulp.shape[1]) if ulp[:, c].any()}}
        # XLA:CPU's rounding rules (vote decay, limiter, minifloat decode)
        # give the same bits on the card as on the host
        from flowsentryx_tpu_torch.core import device as fdev

        x = torch.from_numpy(np.concatenate([
            rng.uniform(-100.0, 0.0, 1 << 22),
            rng.uniform(-88.8, -86.0, 1 << 18)]).astype(np.float32))
        a, b_, c = (torch.from_numpy(rng.standard_normal(1 << 20)
                                     .astype(np.float32)) for _ in range(3))
        math = {
            "xla_exp": (fdev.xla_exp, (x,)),
            "xla_exp2": (fdev.xla_exp2, (x,)),
            "fma32": (fdev.fma32, (a, b_, c)),
            "recip_mul_0.3": (lambda t: fdev.recip_mul(t, 0.3), (x,)),
        }
        res["xla_math"] = {}
        for name, (fn, args) in math.items():
            got = fn(*(t.to(dev) for t in args)).cpu()
            mism = int((got.view(torch.int32)
                        != fn(*args).view(torch.int32)).sum())
            res["xla_math"][name] = {"n": int(got.numel()),
                                     "mismatches": mism}
            ok &= mism == 0
        return {"ok": ok, "batches": CROSS_BATCHES, **res}

    cross_phase()

    def time_ms(fn, reps, flush=None):
        """Mean device ms per call with CUDA events (after a warm-up);
        ``flush`` runs between calls, outside the timed region."""
        fn()
        torch.cuda.synchronize()
        total = 0.0
        if flush is None:
            a, b = torch.cuda.Event(True), torch.cuda.Event(True)
            a.record()
            for _ in range(reps):
                fn()
            b.record()
            b.synchronize()
            return a.elapsed_time(b) / reps
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
        """Host microseconds per call: the enqueue alone, no sync inside."""
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        us = (time.perf_counter() - t) / reps * 1e6
        torch.cuda.synchronize()
        return us

    def device_us(calls, reps, name=None):
        """The kernels' own device time per call from ``torch.profiler``:
        kernels whose name holds ``name`` (all kernels when None)."""
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                calls()
            torch.cuda.synchronize()
        return sum(ev.time_range.elapsed_us() for ev in prof.events()
                   if ev.device_type == torch.autograd.DeviceType.CUDA
                   and (name is None or name in ev.name)) / reps

    def bound(nbytes, ops):
        tb = nbytes / HBM_BYTES_PER_S * 1e3
        to = ops / FP32_FLOPS * 1e3
        return (tb, "bytes") if tb >= to else (to, "operations")

    @phase("kernel_timing")
    def timing_phase():
        engines = served.get("engines")
        launches = served.get("launches", {})
        e = engines[0] if engines else engine_for(
            "syn_benign_mix", "logreg_int8", BATCH, "cuda")
        params, packed = e.params, e.score_params
        # a real decoded serving batch of the main path (B = 2048)
        x = serving_batch(params, "syn_benign_mix")
        saved = dict(kernels.LAUNCHES)
        b = x.shape[0]

        def score():
            kernels.score_int8(params, x, packed)

        w = (params.w_int8.float() * params.w_scale)[None, :]

        def library():
            torch.nn.functional.linear(x, w, params.bias.reshape(1))

        s_ms = time_ms(score, 200)
        s_plain = time_ms(lambda: kernels.score_int8_plain(params, x), 200)
        s_lib = time_ms(library, 200)
        s_host = host_us(score, 200)
        s_dev = device_us(score, 50, "score_int8_kernel")
        s_lib_dev = device_us(library, 50)
        s_bytes = b * 8 * 4 + 16 * 4 + b * 4   # x, the params, out
        sb, sby = bound(s_bytes, b * 64)
        score_row = {
            "name": "score_int8", "route": "cuda",
            "source": "flowsentryx_tpu_torch/csrc/score_int8.cu",
            "replaces": "flowsentryx_tpu/ops/pallas_kernels.py:101",
            "launches": launches.get("score_int8", 0),
            "max_abs_err": errs["score_int8"], "ms": s_ms,
            "plain_ms": s_plain, "bound_ms": sb, "bound_by": sby,
            "library_ms": s_lib, "device_ms": s_dev / 1e3,
            "host_us_per_call": s_host, "library_device_ms": s_lib_dev / 1e3,
            "shape": [b, 8]}
        # the report's scan over both served tables, cold: evict the
        # 50 MB L2 before each call by reading 256 MB (a read leaves L2
        # clean; a zero fill would leave dirty lines for the timed call
        # to write back)
        scratch = torch.zeros(64 << 20, dtype=torch.float32, device=dev)
        flush = scratch.sum
        flush()
        tables = {}
        for (scen, _), te in zip(scenarios, engines or []):
            tbl, now = te.table, te._device_now
            n = tbl.capacity
            tracked = int((tbl.key != 0).sum())

            def summary():
                kernels.table_summary_counts(tbl.key, tbl.state, now, 30.0)

            def flushed():
                flush()
                summary()

            # what this run's data needs: every key, the two state words
            # (LAST_SEEN, BLOCKED_UNTIL) of each tracked row, the outputs;
            # at sector granularity, every distinct 32-byte sector holding
            # one of those words (neighbouring rows share sectors)
            out_bytes = 3 * 8 + 4
            tb, tby = bound(n * 4 + tracked * 8 + out_bytes, n + tracked * 4)
            rows = torch.nonzero(tbl.key != 0).flatten()
            addr = tbl.state.data_ptr() + rows * (tbl.state.stride(0) * 4)
            cols = (schema.TableCol.LAST_SEEN, schema.TableCol.BLOCKED_UNTIL)
            words = torch.cat([addr + 4 * int(c) for c in cols])
            sectors = torch.unique(words // 32).numel()
            chunks = torch.unique(words // 64).numel()   # 64 B DRAM bursts
            tables[scen] = {
                "rows": n, "tracked": tracked,
                "ms": time_ms(summary, 30, flush),
                "plain_ms": time_ms(lambda: kernels.table_summary_plain(
                    tbl.key, tbl.state, now, 30.0), 30, flush),
                "device_ms": device_us(flushed, 20,
                                       "table_summary_kernel") / 1e3,
                "host_us_per_call": host_us(summary, 50),
                "bound_ms": tb, "bound_by": tby,
                "state_sectors": sectors,
                "sector_floor_ms": (n * 4 + sectors * 32 + out_bytes)
                / HBM_BYTES_PER_S * 1e3,
                "state_64b_chunks": chunks,
                "chunk64_floor_ms": (n * 4 + chunks * 64 + out_bytes)
                / HBM_BYTES_PER_S * 1e3,
                "stream_floor_ms": (n * (4 + 48) + out_bytes)
                / HBM_BYTES_PER_S * 1e3}
        kernels.LAUNCHES.update(saved)   # timing launches do not count
        main = tables.get("mixed_l34_1m", {})
        summary_row = {
            "name": "table_summary", "route": "cuda",
            "source": "flowsentryx_tpu_torch/csrc/table_summary.cu",
            "replaces": "flowsentryx_tpu/ops/pallas_kernels.py:166",
            "launches": launches.get("table_summary", 0),
            "max_abs_err": errs["table_summary"],
            **{k: main.get(k) for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "device_ms",
                "host_us_per_call", "sector_floor_ms")},
            "library_ms": None, "tables": tables}
        rows = [score_row, summary_row]
        served["kernels"] = rows
        return {"ok": bool(tables), "card": card,
                "library_call": {"score_int8": "torch.nn.functional.linear "
                                 "(float logistic-regression matvec)",
                                 "table_summary": None},
                "kernels": rows}

    timing_phase()

    if FAILED:
        print(f"chip_smoke: failed phases: {FAILED}", file=sys.stderr)
        return 1
    emit({"kernels": served["kernels"]})
    print(smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
