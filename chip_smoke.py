#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one GPU and hold its kernels to their
plain versions.

    python3 chip_smoke.py            # from the repository root, one card

Phases (each prints one JSON line; any failure exits non-zero and the
final ``{"ok": true, ...}`` line is never printed):

1. ``nvidia-smi`` name and power limit; build the three kernels from
   ``flowsentryx_tpu_torch/csrc/`` (one ``nvcc`` per source, in
   parallel) into ``build/kernels/``.
2. ``score_int8`` kernel vs its plain version on the card, exact:
   golden params over the model-mode decode grid (every u8 code of every
   feature) plus 2^16 random rows and 2^16 heavy-tailed raw48 rows (up
   to ~2^32: the kernel's log1p is XLA's), then the log1p artifact
   ``artifacts/logreg_int8.npz`` the same way; and for each params the
   decoded B=2048 serving batches of both scenarios, the shape the main
   path hands the scorer; ragged batches of 1, 15, 2047 and 2049 rows;
   and the packed output table against the plain output stage.
3. ``table_summary`` kernel vs plain, exact: an empty 2^20-row table, a
   random fill at 2^20 rows, a row count that is no multiple of 1024,
   and (after phase 5) the real table the served run left.
4. ``raw_decode_and_sum``: ``segment_sum_seq`` vs its plain version,
   exact, on the byte lanes of a crafted raw48 batch (one source with
   300 records of 65,535 B, whose lane-order f32 sum differs from the
   exact sum), of a served ``mixed_l34_1m`` batch and of ragged random
   segments; the scorer's device ``log1p`` vs ``xla_log1p`` on the card
   over every non-negative float32; ``xla_log1p``,
   ``xla_sigmoid`` and the ``mlp``/``multiclass``/``logreg_float``
   scorers give the same bits on the card as on the host.
5. Serve: ``Engine(device="cuda")`` (singles, every dispatch one CUDA
   graph replay) at capacity 2^20, B=2048 over ``syn_benign_mix`` and
   ``mixed_l34_1m``; launch counters are zeroed just before and read
   just after: ``score_int8`` launched once per batch served,
   ``table_summary`` once per report.
6. ``step_graph_vs_eager``: a multi-batch stream of each scenario at
   2^20 rows / B=2048 through the captured single step and through the
   eager step on a second table (the eager step's first batch run under
   ``torch.cuda.set_sync_debug_mode("error")``): outputs, table bytes and
   stats equal after every batch.
7. ``megastep_vs_singles``: each rung g in {2, 4, 8} captured and
   replayed twice (a ``mixed_l34_1m`` group, then a multi-source flood
   group whose merged K=8 wire overflows) against 2g eager singles:
   table, stats, stacked verdicts and block arrays equal, and the merged
   wire equals ``merge_verdict_wires`` of the singles' wires.
8. ``serve_mega_auto``: both scenarios through ``Engine(mega_n="auto")``
   at full width from a deep backlog whose tail fills smaller rungs
   (``MEGA_BATCHES`` = 23 x 8 + 6): group histogram, records/s, stage
   times, ``score_int8`` launches equal to the batches served, and the
   device memory held after ``warm()`` by singles and by the four graphs
   of ``auto``.
9. ``raw48_graph_vs_eager``: the captured raw48 single step with
   ``artifacts/mlp_robust.npz`` and the eviction sweep on (a 10 ms ttl,
   so the stream frees rows) against the eager step at 2^20 rows /
   B=2048, the batch counter set to 2^32 - 3 so that its u32 wrap falls
   inside the stream: outputs, table bytes and stats after every batch.
10. ``serve_raw48_mlp``: ``Engine(device="cuda")`` with the ``mlp``
    artifact (the default wire rule picks raw48) at 2^20 rows / B=2048
    over ``mixed_l34_1m`` and ``syn_benign_mix``, eviction at ttl 0.25 s
    every 32 batches (32,768-row windows); launches in this path's own
    window: ``segment_sum_seq`` once per batch, ``score_int8`` never,
    ``table_summary`` once per report; ``evicted > 0`` on
    ``mixed_l34_1m`` (``syn_benign_mix``'s sources never idle past the
    ttl).  Then the captured raw48 step with and without the sweep:
    device ops and busy ms per batch (``torch.profiler``), the largest
    ops, event ms per batch.
11. ``overflow_under_graphs``: the multi-source flood at ``verdict_k=8``
    and ``readback_depth=8`` through singles and ``mega_n=4`` on the card
    against the CPU engine: blacklist with untils, stats and table digest
    equal, and overflowed wires fell back (``fallback_sinks > 0``).
12. Cross-check: a shorter pregenerated corpus of each scenario through
    the CUDA engine (singles and ``mega_n="auto"``) and through
    ``Engine(device="cpu")`` (the plain versions): stats, blacklist and a
    digest of the whole table must be equal; and the XLA:CPU rounding
    helpers (``xla_exp``, ``xla_exp2``, ``fma32``, ``recip_mul``) give the
    same bits on the card as on the host.
13. ``cross_check_families``: a 24-batch multi-source flood at 10 M
    records/s (blocks) with the sweep on at a 1 ms ttl (evictions)
    through the CUDA and the CPU engine for ``mlp`` and
    ``multiclass`` (raw48), ``logreg_float`` (compact16, singles and
    ``auto``) and ``logreg_int8`` with ``wire="raw48"``: stats
    (``evicted`` > 0 included), blacklist with untils (more than 8
    blocked), table digest and summary equal.

Then the timing line per kernel (``segment_sum_seq`` on the byte lanes
of a served raw48 batch, ``index_add_`` its library call; the scorer
also with the log1p artifact on raw48 rows): ``ms`` (CUDA events, host
launch gaps included), ``device_ms`` (the kernel's own time from
``torch.profiler``),
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

import dataclasses
import functools
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
GRAPH_BATCHES = 24
MEGA_BATCHES = 23 * 8 + 6      # top-rung groups, then a 4 and a 2
OVERFLOW_BATCHES = 24
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
        ArraySource, CollectSink, Engine, Scenario, TrafficGen,
        TrafficSource, TrafficSpec,
    )
    from flowsentryx_tpu_torch.core import device as fdev
    from flowsentryx_tpu_torch.models import logreg, mlp, multiclass
    from flowsentryx_tpu_torch.models.registry import load_artifact
    from flowsentryx_tpu_torch.ops import agg, fused, graph, kernels

    dev = torch.device("cuda")
    card = smi_line()
    emit({"phase": "card", "nvidia_smi": card,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0)})
    artifact = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "artifacts", "logreg_int8.npz")
    mlp_path = os.path.join(os.path.dirname(artifact), "mlp_robust.npz")
    mc_path = os.path.join(os.path.dirname(artifact), "multiclass.npz")
    errs = {"score_int8": 0.0, "table_summary": 0.0, "segment_sum_seq": 0.0}

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
            # raw48 feature words as the scorer meets them undecoded:
            # heavy-tailed values up to ~2^32 (XLA's log1p, not log1pf)
            heavy_x = torch.from_numpy(np.exp(rng.uniform(
                0, 22, (1 << 16, 8))).astype(np.float32)).to(dev)
            res[name] = {"grid_rows": grid.shape[0],
                         "grid_mismatches": compare_scores(params, grid),
                         "raw_rows": raw_x.shape[0],
                         "raw_mismatches": compare_scores(params, raw_x),
                         "raw_heavy_mismatches": compare_scores(params,
                                                                heavy_x)}
            mismatches += [res[name]["grid_mismatches"],
                           res[name]["raw_mismatches"],
                           res[name]["raw_heavy_mismatches"]]
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

    def heavy_records():
        """One B = 2048 raw48 batch: source 1 sends 300 records of
        65,535 B (its f32 byte sum passes 2^24 and depends on the order),
        the other sources ragged runs of random sizes."""
        r = np.random.default_rng(SEED + 1)
        rec = np.zeros(BATCH, schema.FLOW_RECORD_DTYPE)
        rec["ts_ns"] = 5 * 10 ** 9 + np.arange(BATCH) * 100
        keys = r.integers(2, 200, BATCH)
        keys[r.choice(BATCH, 300, replace=False)] = 1
        rec["saddr"] = keys
        rec["pkt_len"] = np.where(keys == 1, 65535, r.integers(40, 65536,
                                                               BATCH))
        rec["feat"] = r.integers(0, 1 << 32, (BATCH, 8), dtype=np.uint64)
        return rec

    def raw_wire(rec):
        return schema.wire_to_tensor(schema.encode_raw(
            rec, BATCH, int(rec["ts_ns"][0]))).to(dev)

    def byte_segments(raw):
        """The raw step's byte lanes and segment ids of a wire batch on
        the card: decode, the records sorted by source (the step's sort
        puts each flow's records in one run, in lane order), dense
        segment ids from 0."""
        fb = schema.decode_raw(raw)
        key = torch.where(fb.valid, fb.key, agg.INVALID_KEY)
        key_s, order = torch.sort(key, stable=True)
        seg = torch.cumsum(agg.run_heads(key_s), 0) - 1
        v = torch.where(fb.valid[order], fb.pkt_len[order], 0.0)
        return v.contiguous(), seg.contiguous(), fb.key[order]

    def ragged_segments(b, seed):
        r = np.random.default_rng(seed)
        lens = r.integers(1, 60, b)
        seg = np.repeat(np.arange(b), lens)[:b]
        v = r.integers(40, 1 << 16, b).astype(np.float32)
        return (torch.from_numpy(v).to(dev),
                torch.from_numpy(seg.astype(np.int64)).to(dev))

    def compare_segsum(v, seg, n):
        got = kernels.segment_sum_seq(v, seg, n)
        want = agg.segment_sum_seq_plain(v, seg, n)
        torch.cuda.synchronize()
        errs["segment_sum_seq"] = max(errs["segment_sum_seq"],
                                      float((got - want).abs().max()))
        return got, int((got.view(torch.int32) != want.view(torch.int32))
                        .sum())

    def same_bits(fn, x):
        """``fn`` on the card and on the host over the same inputs:
        mismatching values (float results by their bits)."""
        a, b_ = fn(x.to(dev)).cpu(), fn(x.cpu())
        if a.dtype == torch.float32:
            a, b_ = a.view(torch.int32), b_.view(torch.int32)
        return int((a != b_).sum())

    @phase("raw_decode_and_sum")
    def raw_phase():
        res = {"tolerance": "exact (0 mismatches)"}
        bad = []
        # segment_sum_seq against its plain version: the crafted heavy
        # batch, a served mixed_l34_1m batch, and ragged random segments
        mixed = TrafficSource(TrafficSpec(
            scenario=Scenario.MIXED_L34_1M, rate_pps=1e6, seed=SEED),
            total=BATCH).poll(BATCH)
        seg_cases = {"heavy_300x65535": byte_segments(raw_wire(
            heavy_records()))[:2],
            "mixed_l34_1m": byte_segments(raw_wire(mixed))[:2]}
        for b in (1, 255, 2048, 4099):
            seg_cases[f"ragged_{b}"] = ragged_segments(b, b)
        res["segment_sum_seq"] = {}
        for label, (v, seg) in seg_cases.items():
            got, m = compare_segsum(v, seg, v.shape[0])
            res["segment_sum_seq"][label] = {
                "lanes": v.shape[0], "segments": int(seg[-1]) + 1,
                "longest": int(torch.bincount(seg).max()), "mismatches": m}
            bad.append(m)
        # the order is visible: source 1's lane-order sum is not its
        # exact sum
        v, seg, keys = byte_segments(raw_wire(heavy_records()))
        got = kernels.segment_sum_seq(v, seg, BATCH)
        s1 = int(seg[keys == 1][0])
        exact = float(v[seg == s1].double().sum())
        res["heavy_source"] = {"lane_order_f32": float(got[s1]),
                               "exact": exact,
                               "differs": float(got[s1]) != exact}
        bad.append(int(float(got[s1]) == exact))
        # the scorer's log1p (a device function of score_int8.cu) against
        # the plain xla_log1p on the card, every non-negative float32
        chunk, n_all, mism = 1 << 26, 1 << 31, 0
        for lo in range(0, n_all, chunk):
            x = torch.arange(lo, lo + chunk, device=dev).to(
                torch.int32).view(torch.float32)
            mism += int((kernels.score_log1p(x).view(torch.int32)
                         != fdev.xla_log1p(x).view(torch.int32)).sum())
        res["score_log1p_vs_plain"] = {"values": n_all, "mismatches": mism}
        bad.append(mism)
        # the XLA:CPU helpers and the model families give the same bits
        # on the card as on the host
        wide = torch.from_numpy(np.concatenate([
            np.exp(rng.uniform(0, 22, 1 << 21)), rng.uniform(0, 1, 1 << 20),
            rng.uniform(-30, 30, 1 << 20)]).astype(np.float32))
        host_card = {
            "xla_log1p": same_bits(fdev.xla_log1p, wide.abs()),
            "xla_sigmoid": same_bits(fdev.xla_sigmoid, wide),
        }
        feats = torch.from_numpy(np.where(
            rng.random((1 << 15, 8)) < 0.2, 0.0,
            np.exp(rng.uniform(0, 22, (1 << 15, 8)))).astype(np.float32))
        for fam, path, mod, fns in (
                ("mlp", mlp_path, mlp, ("logits", "classify_batch")),
                ("multiclass", mc_path, multiclass,
                 ("class_probs", "classify_batch", "attack_class")),
                ("logreg_float", artifact, logreg, ("classify_float",))):
            p = {d: load_artifact(fam, path, d) for d in ("cuda", "cpu")}
            for fn in fns:
                f = getattr(mod, fn)
                host_card[f"{fam}.{fn}"] = same_bits(
                    lambda x, f=f: f(p[x.device.type], x), feats)
        res["card_vs_host"] = host_card
        bad += list(host_card.values())
        return {"ok": not any(bad), **res}

    raw_phase()

    cfg = FsxConfig(table=TableConfig(capacity=TABLE_CAP, salt=SEED & 0xFFFFFFFF),
                    batch=BatchConfig(max_batch=BATCH))
    scenarios = (("syn_benign_mix", "logreg_int8"),
                 ("mixed_l34_1m", "logreg_int8_pallas"))

    def engine_for(scen, model, total, device, params=None, records=None,
                   mega_n=0, c=None):
        """An engine over ``total`` generated records of ``scen``, or
        over a pregenerated ``records`` array (the generator's draws
        depend on the poll size, and a grouping engine polls more)."""
        c = dataclasses.replace(c or cfg, model=dataclasses.replace(
            cfg.model, name=model))
        src = (ArraySource(records.copy()) if records is not None
               else TrafficSource(TrafficSpec(scenario=Scenario(scen),
                                              rate_pps=1e6, seed=SEED),
                                  total=total))
        return Engine(c, src, CollectSink(), params=params, device=device,
                      mega_n=mega_n)

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
        checks += [r.dispatch["graphs"] == 1 for r in reports]
        # one score_int8 per batch served, one table_summary per report
        checks += [launches["score_int8"] == sum(r.batches for r in reports),
                   launches["table_summary"] == len(reports)]
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

    def same_state(t1, s1, t2, s2):
        return (torch.equal(t1.key, t2.key)
                and torch.equal(t1.state.view(torch.int32),
                                t2.state.view(torch.int32))
                and s1.to_dict() == s2.to_dict())

    def bits(t):
        return t.view(torch.int32) if t.dtype == torch.float32 else t

    def stream(scen, n, params, **spec):
        """``n`` compact16 wire buffers of ``scen`` in the params' model
        mode, ragged fills included (as the batcher seals them)."""
        quant = schema.wire_quant_for(logreg.LogRegParams(
            **logreg.params_to_numpy(params)))
        gen = TrafficGen(TrafficSpec(scenario=Scenario(scen), seed=SEED,
                                     **{"rate_pps": 1e6, **spec}))
        raws, t0 = [], None
        for i in range(n):
            rec = gen.next_records(BATCH - (i % 5) * 131)
            t0 = int(rec["ts_ns"][0]) if t0 is None else t0
            raws.append(schema.encode_compact(rec, BATCH, t0, **quant))
        return raws, quant

    def classify_for(params):
        return functools.partial(kernels.score_int8,
                                 packed=kernels.pack_score_params(params))

    def to_dev(raw):
        return schema.wire_to_tensor(raw).to(dev)

    @phase("step_graph_vs_eager")
    def graph_phase():
        res = {}
        ok = True
        for scen, _ in scenarios:
            params = logreg.golden_params(dev)
            raws, quant = stream(scen, GRAPH_BATCHES, params)
            step = fused.make_compact_step(cfg, classify_for(params), **quant)
            # a capture fails on any host sync: the eager step runs clean
            # with syncs turned into errors (on a throwaway table)
            tx, sx = schema.make_table(TABLE_CAP, dev), schema.make_stats(dev)
            x0 = to_dev(raws[0])      # a blocking upload, before the mode
            torch.cuda.synchronize()
            prev = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
            try:
                step(tx, sx, params, x0)
            finally:
                torch.cuda.set_sync_debug_mode(prev)
            del tx, sx, x0
            tg, sg = schema.make_table(TABLE_CAP, dev), schema.make_stats(dev)
            te, se = schema.make_table(TABLE_CAP, dev), schema.make_stats(dev)
            gr = graph.StepGraph(step, tg, sg, params, (BATCH + 1, 4))
            bad = [] if same_state(tg, sg, te, se) else ["capture"]
            for i, raw in enumerate(raws):
                gr.input.copy_(to_dev(raw), non_blocking=True)
                gr.replay()
                _, _, oe = step(te, se, params, to_dev(raw))
                outs_eq = all(torch.equal(bits(getattr(gr.out, f)),
                                          bits(getattr(oe, f)))
                              for f in ("verdict", "block_key",
                                        "block_until", "now", "wire"))
                if not (outs_eq and same_state(tg, sg, te, se)):
                    bad.append(i)
            ok &= not bad
            res[scen] = {"batches": len(raws), "mismatched_batches": bad,
                         "stats": se.to_dict(),
                         "tracked": int((te.key != 0).sum()),
                         "launches_per_replay": gr.launches,
                         "sync_debug_error_mode": "clean"}
            del gr, tg, sg, te, se
        return {"ok": ok, "tolerance": "byte-equal", **res}

    graph_phase()

    @phase("megastep_vs_singles")
    def mega_phase():
        c8 = dataclasses.replace(cfg, batch=dataclasses.replace(
            cfg.batch, verdict_k=8), limiter=dataclasses.replace(
                cfg.limiter, pps_threshold=200.0))
        params = logreg.golden_params(dev)
        res = {}
        ok = True
        for g in (2, 4, 8):
            mixed, quant = stream("mixed_l34_1m", g, params)
            flood, _ = stream("udp_flood_multi", g, params, rate_pps=1e7,
                              n_attack_ips=64)
            step = fused.make_compact_step(c8, classify_for(params), **quant)
            mega = fused.make_compact_megastep(c8, classify_for(params), g,
                                               **quant)
            tg, sg = schema.make_table(TABLE_CAP, dev), schema.make_stats(dev)
            te, se = schema.make_table(TABLE_CAP, dev), schema.make_stats(dev)
            gr = graph.StepGraph(mega, tg, sg, params, (g, BATCH + 1, 4))
            rows = []
            for group in (mixed, flood):
                gr.input.copy_(to_dev(np.stack(group)), non_blocking=True)
                gr.replay()
                outs = [step(te, se, params, to_dev(raw))[2]
                        for raw in group]
                eq = {f: torch.equal(bits(getattr(gr.out, f)), bits(
                    torch.stack([getattr(o, f) for o in outs])))
                    for f in ("verdict", "block_key", "block_until", "now")}
                eq["merged_wire"] = torch.equal(
                    gr.out.wire, fused.merge_verdict_wires(
                        torch.stack([o.wire for o in outs])))
                eq["table_and_stats"] = same_state(tg, sg, te, se)
                wire = gr.out.wire.cpu().numpy()
                rows.append({"equal": eq, "wire_count": int(wire[16]),
                             "wire_overflow": int(wire[17])})
                ok &= all(eq.values())
            res[f"rung_{g}"] = {"replays": rows,
                                "launches_per_replay": gr.launches}
            ok &= gr.launches["score_int8"] == g
            del gr, tg, sg, te, se
        ok &= any(r["wire_overflow"] for v in res.values()
                  for r in v["replays"])
        return {"ok": ok, "tolerance": "byte-equal", **res}

    mega_phase()

    @phase("serve_mega_auto")
    def mega_serve_phase():
        # device memory after warm(): singles (one graph) and auto (four)
        memory = {}
        for label, mega_n in (("single", 0), ("auto", "auto")):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            e = engine_for("mixed_l34_1m", "logreg_int8_pallas", BATCH,
                           "cuda", mega_n=mega_n)
            built = torch.cuda.memory_allocated()
            e.warm()
            torch.cuda.synchronize()
            memory[label] = {
                "engine_bytes": built - base,
                "graphs_bytes": torch.cuda.memory_allocated() - built,
                "peak_bytes": torch.cuda.max_memory_allocated() - base,
                "graphs": len(e._graphs)}
            del e
        engines = [engine_for(s, m, MEGA_BATCHES * BATCH, "cuda",
                              mega_n="auto") for s, m in scenarios]
        for e in engines:
            e.warm()
        kernels.reset_launches()          # this path's window opens
        reports = [e.run() for e in engines]
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)  # ... and closes
        served["launches_mega_auto"] = launches
        out = {"card": card, "launches": launches, "graph_memory": memory}
        checks = [launches["score_int8"] == sum(r.batches for r in reports),
                  launches["table_summary"] == len(reports)]
        for (s, m), r in zip(scenarios, reports):
            hist = r.dispatch["group_hist"]
            out[s] = {"model": m, "batches": r.batches,
                      "records": r.records, "wall_s": r.wall_s,
                      "records_per_s": r.records_per_s,
                      "stages_ms": r.stages_ms, "dispatch": r.dispatch,
                      "stats": r.stats, "readback": r.readback}
            checks += [r.records == MEGA_BATCHES * BATCH,
                       r.stats["allowed"] + r.stats["dropped"] == r.records,
                       sum(int(g) * n for g, n in hist.items()) == r.batches,
                       len([g for g in hist if int(g) > 1]) >= 2,
                       r.dispatch["graphs"] == 4]
        return {"ok": all(checks), **out}

    mega_serve_phase()

    # -- the raw48 wire: MLP scorer, eviction sweep, lane-order byte sums --

    #: ``fsx serve --model mlp`` with eviction as the reference sizes it
    #: (``ops/fused.py:394-406`` there): ttl 0.25 s, a 32-batch cycle of
    #: 32,768-row windows, ~ttl/4 at the synthetic 1e6 records/s
    raw_cfg = dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, name="mlp"),
        table=dataclasses.replace(cfg.table, evict_ttl_s=0.25,
                                  evict_every=32))
    # a short ttl, so that a 24-batch stream (48 ms) frees rows; and for
    # the 10 M records/s flood (24 batches in 4.9 ms) a shorter one
    short_ttl = dict(evict_ttl_s=0.01, evict_every=8)
    flood_ttl = dict(evict_ttl_s=0.001, evict_every=8)

    def raw_stream(scen, n, **spec):
        """``n`` raw48 wire buffers of ``scen``, ragged fills included."""
        gen = TrafficGen(TrafficSpec(scenario=Scenario(scen), seed=SEED,
                                     **{"rate_pps": 1e6, **spec}))
        raws, t0 = [], None
        for i in range(n):
            rec = gen.next_records(BATCH - (i % 5) * 131)
            t0 = int(rec["ts_ns"][0]) if t0 is None else t0
            raws.append(schema.encode_raw(rec, BATCH, t0))
        return raws

    @phase("raw48_graph_vs_eager")
    def raw_graph_phase():
        c = dataclasses.replace(raw_cfg, table=dataclasses.replace(
            raw_cfg.table, **short_ttl))
        params = mlp.load_params(mlp_path, dev)
        step = fused.make_raw_step(c, mlp.classify_batch)
        raws = raw_stream("mixed_l34_1m", GRAPH_BATCHES)
        tx, sx = schema.make_table(TABLE_CAP, dev), schema.make_stats(dev)
        x0 = to_dev(raws[0])
        torch.cuda.synchronize()
        prev = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            step(tx, sx, params, x0)
        finally:
            torch.cuda.set_sync_debug_mode(prev)
        del tx, sx, x0
        tg, sg = schema.make_table(TABLE_CAP, dev), schema.make_stats(dev)
        te, se = schema.make_table(TABLE_CAP, dev), schema.make_stats(dev)
        gr = graph.StepGraph(step, tg, sg, params,
                             (BATCH + 1, schema.RECORD_WORDS))
        bad = [] if same_state(tg, sg, te, se) else ["capture"]
        # the u32 batch counter wraps inside the stream
        for st in (sg, se):
            st.batches.fill_((1 << 32) - 3)
        for i, raw in enumerate(raws):
            gr.input.copy_(to_dev(raw), non_blocking=True)
            gr.replay()
            _, _, oe = step(te, se, params, to_dev(raw))
            outs_eq = all(torch.equal(bits(getattr(gr.out, f)),
                                      bits(getattr(oe, f)))
                          for f in ("verdict", "block_key", "block_until",
                                    "now", "wire"))
            if not (outs_eq and same_state(tg, sg, te, se)):
                bad.append(i)
        st = se.to_dict()
        out = {"batches": len(raws), "mismatched_batches": bad,
               "table": {"capacity": TABLE_CAP, **short_ttl,
                         "window_rows": fused.evict_window(
                             TABLE_CAP, short_ttl["evict_every"])},
               "stats": st, "tracked": int((te.key != 0).sum()),
               "launches_per_replay": gr.launches,
               "sync_debug_error_mode": "clean"}
        del gr, tg, sg, te, se
        return {"ok": not bad and st["evicted"] > 0
                and st["batches"] > 1 << 32, "tolerance": "byte-equal",
                **out}

    raw_graph_phase()

    def top_ops(prof, n, k=10):
        """Device ms per batch by kernel or copy name, largest first."""
        by = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                name = e.name[:60]
                t, c = by.get(name, (0.0, 0))
                by[name] = (t + e.time_range.elapsed_us(), c + 1)
        top = sorted(by.items(), key=lambda kv: -kv[1][0])[:k]
        return [{"op": name, "ms_per_batch": t / n / 1e3,
                 "calls_per_batch": c / n} for name, (t, c) in top]

    def busy_and_ops(prof):
        """Device busy µs (the union of the kernels' and copies'
        intervals) and their count, from a ``torch.profiler`` run."""
        ev = sorted((e.time_range.start, e.time_range.end)
                    for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA)
        busy, cur = 0.0, None
        for a, b_ in ev:
            if cur is None or a > cur[1]:
                busy += 0.0 if cur is None else cur[1] - cur[0]
                cur = [a, b_]
            else:
                cur[1] = max(cur[1], b_)
        busy += 0.0 if cur is None else cur[1] - cur[0]
        return busy, len(ev)

    def raw_step_profile(n_warm=16, n_prof=16):
        """The captured raw48 MLP step on a 2^20-row table with and
        without the sweep: device ops and busy ms per replay
        (``torch.profiler``) and event ms per replay (unprofiled), over
        ``mixed_l34_1m`` batches already on the card, after ``n_warm``
        replays that fill the table."""
        from torch.profiler import ProfilerActivity, profile

        params = mlp.load_params(mlp_path, dev)
        xs = [to_dev(r) for r in raw_stream("mixed_l34_1m",
                                            n_warm + 2 * n_prof)]
        out = {}
        for label, ttl in (("evict", raw_cfg.table.evict_ttl_s),
                           ("no_evict", 0.0)):
            c = dataclasses.replace(raw_cfg, table=dataclasses.replace(
                raw_cfg.table, evict_ttl_s=ttl))
            t, st = schema.make_table(TABLE_CAP, dev), schema.make_stats(dev)
            gr = graph.StepGraph(fused.make_raw_step(c, mlp.classify_batch),
                                 t, st, params,
                                 (BATCH + 1, schema.RECORD_WORDS))

            def run(batch):
                gr.input.copy_(batch)
                gr.replay()

            for x in xs[:n_warm]:
                run(x)
            torch.cuda.synchronize()
            a, b_ = torch.cuda.Event(True), torch.cuda.Event(True)
            a.record()
            for x in xs[n_warm:n_warm + n_prof]:
                run(x)
            b_.record()
            b_.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for x in xs[n_warm + n_prof:]:
                    run(x)
                torch.cuda.synchronize()
            busy, ops = busy_and_ops(prof)
            out[label] = {"device_ops_per_batch": ops / n_prof,
                          "device_busy_ms_per_batch": busy / n_prof / 1e3,
                          "event_ms_per_batch": a.elapsed_time(b_) / n_prof,
                          "graph_launches_per_replay": gr.launches,
                          "top_ops": top_ops(prof, n_prof)}
            del gr, t, st
        kernels.reset_launches()
        return out

    @phase("serve_raw48_mlp")
    def raw_serve_phase():
        scens = ("mixed_l34_1m", "syn_benign_mix")
        engines = [Engine(raw_cfg, TrafficSource(TrafficSpec(
            scenario=Scenario(s), rate_pps=1e6, seed=SEED),
            total=SERVE_BATCHES * BATCH), CollectSink(),
            params=load_artifact("mlp", mlp_path, "cuda"), device="cuda")
            for s in scens]
        for e in engines:
            e.warm()
        kernels.reset_launches()          # this path's window opens
        reports = [e.run() for e in engines]
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)  # ... and closes
        served["launches_raw48_mlp"] = launches
        out = {"card": card, "launches": launches,
               "table": {"capacity": TABLE_CAP,
                         "evict_ttl_s": raw_cfg.table.evict_ttl_s,
                         "evict_every": raw_cfg.table.evict_every,
                         "window_rows": fused.evict_window(
                             TABLE_CAP, raw_cfg.table.evict_every)}}
        checks = [launches["segment_sum_seq"] == sum(r.batches
                                                     for r in reports),
                  launches["score_int8"] == 0,
                  launches["table_summary"] == len(reports)]
        for s, e, r in zip(scens, engines, reports):
            out[s] = {"model": "mlp", "wire": r.dispatch["wire"],
                      "batches": r.batches, "records": r.records,
                      "wall_s": r.wall_s, "records_per_s": r.records_per_s,
                      "stages_ms": r.stages_ms, "stats": r.stats,
                      "evicted": r.stats["evicted"],
                      "blocked_sources": r.blocked_sources, "table": r.table,
                      "readback": r.readback}
            checks += [e.wire == r.dispatch["wire"] == schema.WIRE_RAW48,
                       r.records == SERVE_BATCHES * BATCH,
                       r.stats["allowed"] + r.stats["dropped"] == r.records,
                       r.dispatch["graphs"] == 1]
        # mixed_l34_1m's one-shot sources idle past the ttl and are
        # freed; syn_benign_mix's 5,120 sources all stay active
        checks.append(out["mixed_l34_1m"]["evicted"] > 0)
        del engines
        out["step_profile"] = raw_step_profile()
        return {"ok": all(checks), **out}

    raw_serve_phase()

    @phase("overflow_under_graphs")
    def overflow_phase():
        c = dataclasses.replace(
            cfg, batch=dataclasses.replace(cfg.batch, verdict_k=8,
                                           readback_depth=8),
            limiter=dataclasses.replace(cfg.limiter, pps_threshold=200.0,
                                        bps_threshold=1e9))
        recs = TrafficGen(TrafficSpec(
            scenario=Scenario.UDP_FLOOD_MULTI, rate_pps=1e7,
            n_attack_ips=64, attack_fraction=0.8, seed=SEED)
        ).next_records(OVERFLOW_BATCHES * BATCH)
        runs = {}
        for label, device, mega_n in (("cuda_single", "cuda", 0),
                                      ("cuda_mega4", "cuda", 4),
                                      ("cpu_single", "cpu", 0)):
            e = engine_for("udp_flood_multi", "logreg_int8", None, device,
                           records=recs, mega_n=mega_n, c=c)
            e.warm()
            r = e.run()
            runs[label] = {"stats": r.stats,
                           "blacklist": sorted(e.sink.blocked.items()),
                           "digest": digest(e),
                           "readback": r.readback,
                           "group_hist": r.dispatch["group_hist"]}
        want = runs["cpu_single"]
        res = {}
        ok = True
        for label in ("cuda_single", "cuda_mega4"):
            got = runs[label]
            same = {k: got[k] == want[k]
                    for k in ("stats", "blacklist", "digest")}
            ok &= all(same.values()) and got["readback"]["fallback_sinks"] > 0
            res[label] = {"equal": same, "readback": got["readback"],
                          "group_hist": got["group_hist"]}
        ok &= len(want["blacklist"]) > 8
        return {"ok": ok, "blocked": len(want["blacklist"]),
                "stats": want["stats"], **res}

    @phase("cross_check_cpu")
    def cross_phase():
        res = {}
        ok = True
        for s, m in scenarios:
            recs = TrafficGen(TrafficSpec(scenario=Scenario(s), rate_pps=1e6,
                                          seed=SEED)
                              ).next_records(CROSS_BATCHES * BATCH)
            for label, params in (("golden", None),
                                  ("log1p_artifact", "artifact")):
                runs = {}
                tables = {}
                for run, device, mega_n in (("cuda", "cuda", 0),
                                            ("cuda_auto", "cuda", "auto"),
                                            ("cpu", "cpu", 0)):
                    p = (logreg.load_params(artifact, device)
                         if params else None)
                    e = engine_for(s, m, None, device, p, records=recs,
                                   mega_n=mega_n)
                    r = e.run()
                    runs[run] = (r.stats, sorted(e.sink.blocked.items()),
                                 digest(e), r.table)
                    tables[run] = schema.table_to_numpy(e.table)
                same = {"stats": runs["cuda"][0] == runs["cpu"][0],
                        "blacklist": runs["cuda"][1] == runs["cpu"][1],
                        "table_digest": runs["cuda"][2] == runs["cpu"][2],
                        "table_summary": runs["cuda"][3] == runs["cpu"][3],
                        "auto_equals_cpu": runs["cuda_auto"] == runs["cpu"]}
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

    overflow_phase()
    cross_phase()

    @phase("cross_check_families")
    def families_phase():
        """A shorter corpus through the CUDA engine and the CPU engine for
        every family the port adds, each with the sweep on (a short ttl,
        so rows are freed inside the corpus): stats with ``evicted``,
        blacklist with untils, table digest and summary equal."""
        c = dataclasses.replace(cfg, table=dataclasses.replace(
            cfg.table, **flood_ttl), limiter=dataclasses.replace(
                cfg.limiter, pps_threshold=200.0, bps_threshold=1e9))
        recs = TrafficGen(TrafficSpec(
            scenario=Scenario.UDP_FLOOD_MULTI, rate_pps=1e7,
            n_attack_ips=64, attack_fraction=0.8, seed=SEED)
        ).next_records(CROSS_BATCHES // 2 * BATCH)
        cases = (
            ("mlp", lambda d: load_artifact("mlp", mlp_path, d), None,
             (0,)),
            ("multiclass", lambda d: load_artifact("multiclass", mc_path, d),
             None, (0,)),
            ("logreg_float", lambda d: None, None, (0, "auto")),
            ("logreg_int8", lambda d: logreg.load_params(artifact, d),
             schema.WIRE_RAW48, (0,)),
        )
        res = {}
        ok = True
        for model, load, wire, megas in cases:
            cm = dataclasses.replace(c, model=dataclasses.replace(
                c.model, name=model))
            runs = {}
            for device, mega_n in ([("cuda", m) for m in megas]
                                   + [("cpu", 0)]):
                e = Engine(cm, ArraySource(recs.copy()), CollectSink(),
                           params=load(device), device=device,
                           mega_n=mega_n, wire=wire)
                r = e.run()
                runs[f"{device}_{mega_n}"] = {
                    "wire": e.wire, "stats": r.stats,
                    "blacklist": sorted(e.sink.blocked.items()),
                    "digest": digest(e), "table": r.table}
            want = runs.pop("cpu_0")
            same = {k: {f: v[f] == want[f] for f in want}
                    for k, v in runs.items()}
            ok &= all(all(d.values()) for d in same.values())
            ok &= want["stats"]["evicted"] > 0 and len(want["blacklist"]) > 8
            res[model] = {"wire": want["wire"], "equal": same,
                          "stats": want["stats"],
                          "blocked": len(want["blacklist"]),
                          "digest": want["digest"]}
        ok &= [res[m]["wire"] for m, *_ in cases] == [
            "raw48", "raw48", "compact16", "raw48"]
        return {"ok": ok, "batches": CROSS_BATCHES // 2, **flood_ttl, **res}

    families_phase()

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
        mega_launches = served.get("launches_mega_auto", {})
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
            # the serve_mega_auto path's window, and launches per graph
            # replay (the wrapper's host code runs once, at capture)
            "launches_serve_mega_auto": mega_launches.get("score_int8", 0),
            "launches_per_replay": "1 per single, g per rung g",
            "max_abs_err": errs["score_int8"], "ms": s_ms,
            "plain_ms": s_plain, "bound_ms": sb, "bound_by": sby,
            "library_ms": s_lib, "device_ms": s_dev / 1e3,
            "host_us_per_call": s_host, "library_device_ms": s_lib_dev / 1e3,
            "shape": [b, 8]}
        # the log1p artifact on undecoded raw48 feature rows: the kernel's
        # XLA log1p runs on every lane
        lp = logreg.load_params(artifact, dev)
        lp_packed = kernels.pack_score_params(lp)
        xr = torch.from_numpy(np.exp(rng.uniform(0, 22, (b, 8))).astype(
            np.float32)).to(dev)

        def score_raw():
            kernels.score_int8(lp, xr, lp_packed)

        score_row.update({
            "launches_serve_raw48_mlp": served.get(
                "launches_raw48_mlp", {}).get("score_int8", 0),
            "log1p_raw48_rows": {
                "ms": time_ms(score_raw, 200),
                "device_ms": device_us(score_raw, 50,
                                       "score_int8_kernel") / 1e3,
                "plain_ms": time_ms(
                    lambda: kernels.score_int8_plain(lp, xr), 50)}})
        # segment_sum_seq on the byte lanes of a served raw48 batch (the
        # main path's input), and on the crafted heavy batch
        mixed = TrafficSource(TrafficSpec(
            scenario=Scenario.MIXED_L34_1M, rate_pps=1e6, seed=SEED),
            total=BATCH).poll(BATCH)
        v, seg, _ = byte_segments(raw_wire(mixed))
        hv, hseg, _ = byte_segments(raw_wire(heavy_records()))
        acc = torch.zeros(BATCH, dtype=torch.float32, device=dev)

        def segsum():
            kernels.segment_sum_seq(v, seg, BATCH)

        def seglib():
            acc.index_add_(0, seg, v)

        def heavy():
            kernels.segment_sum_seq(hv, hseg, BATCH)

        gb, gby = bound(BATCH * (4 + 8) + BATCH * 4, BATCH)
        seg_row = {
            "name": "segment_sum_seq", "route": "cuda",
            "source": "flowsentryx_tpu_torch/csrc/segment_sum_seq.cu",
            "replaces": None,
            "launches": served.get("launches_raw48_mlp", {}).get(
                "segment_sum_seq", 0),
            "launches_per_replay": "1 per raw48 single replay",
            "max_abs_err": errs["segment_sum_seq"],
            "ms": time_ms(segsum, 200),
            "plain_ms": time_ms(lambda: agg.segment_sum_seq_plain(
                v, seg, BATCH), 20),
            "bound_ms": gb, "bound_by": gby,
            "library_ms": time_ms(seglib, 200),
            "library_call": "Tensor.index_add_ (atomic adds in no fixed "
                            "order: not the lane order's bits)",
            "device_ms": device_us(segsum, 50,
                                   "segment_sum_seq_kernel") / 1e3,
            "host_us_per_call": host_us(segsum, 200),
            "library_device_ms": device_us(seglib, 50) / 1e3,
            "shape": [BATCH], "segments": int(seg[-1]) + 1,
            "longest_segment": int(torch.bincount(seg).max()),
            "heavy_300x65535": {
                "ms": time_ms(heavy, 200),
                "device_ms": device_us(heavy, 50,
                                       "segment_sum_seq_kernel") / 1e3,
                "longest_segment": int(torch.bincount(hseg).max())}}
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
            "launches_serve_mega_auto": mega_launches.get("table_summary", 0),
            "launches_serve_raw48_mlp": served.get(
                "launches_raw48_mlp", {}).get("table_summary", 0),
            "launches_per_replay": "0 (once per report, outside graphs)",
            "max_abs_err": errs["table_summary"],
            **{k: main.get(k) for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "device_ms",
                "host_us_per_call", "sector_floor_ms")},
            "library_ms": None, "tables": tables}
        rows = [score_row, summary_row, seg_row]
        served["kernels"] = rows
        return {"ok": bool(tables), "card": card,
                "library_call": {"score_int8": "torch.nn.functional.linear "
                                 "(float logistic-regression matvec)",
                                 "table_summary": None,
                                 "segment_sum_seq": "Tensor.index_add_"},
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
