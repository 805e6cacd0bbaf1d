#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one GPU and hold its kernels to their
plain versions.

    python3 chip_smoke.py            # from the repository root, one card

Phases (each prints one JSON line; any failure exits non-zero and the
final ``{"ok": true, ...}`` line is never printed).  Engines run with
the defaults a user gets: the sink thread where the host has 3 cores or
more.

1. ``nvidia-smi`` name and power limit; build the four kernels from
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
14. ``serve_shm_ring``: the daemon's production path on the card.  A
    producer writes each scenario's 384 x 2,048 records into a 48-byte
    shm feature ring; ``Engine(ShmRingSource, ShmVerdictSink)`` serves
    them (``logreg_int8`` with ``artifacts/logreg_int8.npz``, compact16)
    at 2^20 rows, singles and ``mega_n="auto"``, 384 whole batches;
    stats, table digest and the verdict-ring records equal the CPU
    engine's over an ``ArraySource`` of the same records;
    ``score_int8`` launches equal the batches.  Records/s, fill /
    dispatch / sink ms per batch and the idle share (the captured step's
    device ms per batch, timed back to back, over the wall) beside the
    generator-fed ``serve`` phase's.
15. ``serve_raw48_ring``: the same for ``artifacts/mlp_robust.npz`` over
    raw48 with the eviction sweep (``segment_sum_seq`` launches equal
    the batches; ``evicted > 0``).
16. ``serve_ingest_workers``: 1 and 2 spawned workers (strict) over
    ``shard_of``-split shard rings into the card engine: one worker
    byte-equal to the inline ring path, two equal to the CPU engine fed
    the batches the card engine dispatched, in its order; stage times
    and the ``ingest`` block.
17. ``daemon_loop``: ``fsxd --sim`` (built with ``make -C daemon``) into
    the card engine for a bounded time, 48-byte records and compact-emit
    records (``fsxd`` writes 16-byte records only from a compact-emit
    kernel image, so a relay thread writes them from its 48-byte ring as
    that kernel would); the engine drops, the daemon receives verdicts,
    blacklists and suppresses, no verdict is lost; the compact-emit
    batches the card dispatched give the same wires and state on the
    CPU.
18. ``checkpoint_restore``: 192 batches on the card, checkpoint (twice:
    the first generation becomes ``.prev``), a fresh card engine with
    its graphs captured restores in place (pointers unchanged) and
    serves 192 more: equal to 384 uninterrupted on the card and on the
    CPU; the ``.prev`` checkpoint loads with the reference's ``(lo,
    hi)`` stats pairs; after a flipped byte the restore falls back to
    ``.prev`` and still ends equal.
19. ``latency_plane``: both scenarios through the 48-byte shm ring
    (``logreg_int8.npz``, 2^20 rows, B=2048, 384 batches), singles and
    ``auto``, each with the sink thread on and off: stats, table digest,
    blacklist and verdict-ring bytes equal the CPU engine's;
    ``latency.negatives == 0``; the seal -> verdict histogram counts
    every record; ``score_int8`` launches equal the batches.  Then one
    spawned ingest worker (the seal stamp from the slot header), equal
    to the inline ring.  Prints p50/p99/p99.9 and the stage split.
20. ``slo_pulse``: the reference's pulse tier — ``PacedSource`` pulses
    of 96 records every 7.5 ms (12.8 k records/s mean, each pulse
    released at once), a drain-tuned 5 ms deadline, ``mega_n="auto"`` —
    ``slo_us`` 0 and 2,000 in turns, 4 pairs of 1 s trials on two warm
    engines: each arm ends equal to the CPU engine fed the batches it
    dispatched, and arms that dispatched the same batch partition (a
    host stall can merge two pulses into one batch) end byte-equal;
    each arm's arrival -> verdict p50/p99/p99.9 and the share of records
    past 2 ms; then a saturated drain from the ring, ``slo_us`` 2,000
    against 0 (0, 2000, 2000, 0): the records/s ratio, equal state.
21. ``predict_pulse``: the same pulse with ``--predict --slo-us 2000``,
    4 trials: the state equals the CPU replay of its batches, and the
    ``slo_us=0`` arm's where the partitions match; the governor
    locks a forecast; its report per trial (onset hits and misses,
    holds, pre-warms).
22. ``watchdog_stall``: ``torch.cuda._sleep`` (~5 s) enqueued on the
    step's stream ahead of a run with ``watchdog_s=0.5``, with the sink
    thread and without: a soft trip, then ``WatchdogStall`` within 4 s,
    health ``failed``; a run with the default watchdog is byte-equal to
    one with it off.
23. ``hot_swap_live``: ``logreg_int8.npz`` swapped for a second artifact
    derived here with numpy (the same input observer, other weights and
    bias) after 192 of 384 batches from the 48-byte ring, singles and
    ``auto``: stats, table digest, blacklist and verdict-ring bytes equal
    the CPU engine swapped at the same batch index; the graphs are the
    same objects, none captured again, the params and the scorer's
    buffer keep their addresses, and the kernel with the swapped-in pack
    equals its plain version; the host µs of a swap on the dispatch
    thread.  Then ``watch_artifact`` over a 768-batch drain whose
    watched file is replaced atomically mid-drain (exactly one swap,
    equal to the CPU replay at its index), in turns with drains that
    swap nothing (records/s); and raw48 ``mlp_robust.npz`` swapped for
    the family's default ``PRNGKey(0)`` params against the CPU engine.
24. ``sim_kernel_tier``: ``mixed_l34_1m`` through the simulated kernel
    tier of the committed plan ``artifacts/logreg_int8_plan.npz``: the
    escalation block equals the CPU engine's with the tier, the state
    equals the CPU engine fed the batches the card dispatched,
    ``score_int8`` launches equal those batches; records/s and the
    escalation ratio beside the same stream without the tier.
25. ``pcap_serve``: a classic pcap of 100,000 frames built here with
    ``struct``, ``cli pcap`` into a record file, then ``cli serve
    --records`` on the card and on the CPU: equal stats, blacklist size
    and table summary.
26. ``verdict_k_full_fetch``: ``verdict_k`` 0 (the full block arrays every
    batch) and 4 (a wire that overflows) under graphs, singles and
    ``auto``, against the CPU engine; D2H bytes per batch.
27. ``profile_trace``: ``cli serve --profile DIR --batches 64`` on the card;
    the trace names ``table_summary_kernel`` and ``score_int8_kernel``
    (or the graph launches that hold it).
28. ``restore_2p20``: ``Engine.restore`` of the served ``mixed_l34_1m``
    table's checkpoint into a card engine whose graphs are captured, at
    2^20 rows, timed three times; equal to the source, pointers kept.

29. ``score_stages``: the scorer's input stage (``score_quant_u8``) and
    tail (``score_tail``), check entries built from the kernel's own
    device functions, against their plain versions on the card, exactly:
    golden params and ``logreg_int8.npz`` over the model-mode decode
    grid, 2^20 random u32 values and ``compile_plan``'s replay edges; the
    tail over each params' whole reachable accumulator range; and
    ``score_int8`` at the evaluation shapes B = 65,536 and 45,407.
30. ``train_qat_deployed``: the deployed recipe (``fsx train --data
    fixture --slow-weight 4``) at full size on the card: the 2,520,798-row
    fixture (its sha256 pinned to the reference's), QAT 200 epochs on
    2,016,639 rows (``gemv_seq`` once per epoch: the weight gradient's
    FMA chain, held to its plain version at that shape); the artifact
    within the reference's cross-trainer tolerances of
    ``artifacts/logreg_int8.npz``, test F1 within 0.003 of
    its recorded 0.938693 (``artifacts/logreg_int8.json``), the test
    split scored through ``score_int8`` in 8 launches, byte-equal to the
    plain version; fixture, train, epoch and evaluate times, an epoch's
    device ops and busy ms (``torch.profiler``), and host ms per epoch
    with and without the per-epoch ``float(loss)``.
31. ``train_mlp_robust`` and 32. ``train_multiclass``: ``stress``'s robust
    MLP (v2 fixture 300,000 rows plus two shift-augmented copies, 80
    epochs) and expert heads (60 epochs) on the card, held to
    ``MODEL_METRICS_r05.json`` (clean F1 within 0.01; binary F1 and
    per-class recall within 0.02); ms per step and total seconds.
33. ``distill_compile``: ``compile_plan`` on the card through the stage
    entries for golden params, ``logreg_int8.npz`` (equal to the
    committed ``artifacts/logreg_int8_plan.npz``) and the artifact phase
    30 trained, each equal to the CPU compile; the served lane
    (``score_int8``) bands the reference's ``--emulate`` corpus as each
    plan does (0 mismatches); card and CPU compile seconds.
34. ``train_distill_serve``: the trained artifact served on the card
    (2^20 rows, B = 2048, ``syn_benign_mix``, 64 batches of records)
    behind the simulated kernel tier of its fresh plan: escalation,
    stats, blacklist and table digest equal the CPU engine on the same
    drains; ``score_int8`` once per batch, ``table_summary`` once.

35. ``device_loop_serve``: both scenarios from the 48-byte ring
    (``logreg_int8.npz``, 2^20 rows, B=2048, 384 batches) through
    ``mega_n="auto"`` with the drain ring at depths 2 and 4, in turns with
    ``auto`` (auto, 2, 4, 4, 2, auto): stats, table digest and
    verdict-ring bytes equal the CPU engine's and ``auto``'s without the
    ring; ``score_int8`` launches equal the batches; at least 2 full
    rounds; the report's ``device_loop`` block, the graphs' node counts
    and capture seconds, the uploads' overlap with the replays measured
    on the card (CUDA events on both streams), and each graph's launch
    (single, rungs, round): host µs of a launch into an idle card and
    back to back, device ms per launch and per batch, beside its node
    count.  Then the reference's oracle: a round's per-slot wires equal
    sequential top-rung megasteps' over the same slots (and the state);
    and the flood at ``verdict_k=8`` through ``mega_n=4`` and a depth-2
    ring, equal to the CPU engine with wires overflowing inside rounds.
36. ``device_loop_sealed``: one spawned worker (a 32-slot sealed
    queue) into the ring (``auto``, depth 2): one host copy per batch, the upload overlap
    (the report's and the card's) above 0, equal to the inline singles
    ring path.
37. ``device_loop_auto``: ``calibrate_ring_depth`` at full width
    (candidates 2, 4, 8): each candidate's measurement, the depth chosen,
    and the card memory back at its level once the throwaway engines are
    gone.
38. ``boot_cold_cached``: two fresh ``cli serve --mega auto
    --device-loop 2 --compile-cache DIR`` processes over the same record
    file, each with an empty kernel build directory
    (``FSX_KERNEL_BUILD``): a cold boot (every library built and stored)
    and a cached ``--tiered-warm`` boot (every library loaded from the
    cache, no nvcc, the fill complete with no ``fill_error``); the same
    signature digest, stats and table; import s, boot-to-serving s, time
    to first verdict and the fill's end for both.
39. ``tiered_partial_ladder``: the fill held, both scenarios from the
    ring through the single step and the top rung only, equal to
    ``auto`` and the CPU engine (stats, digest, verdict-ring bytes), in
    turns with full-warm ``auto`` engines (records/s).
40. ``cluster_parity``: two rank processes (``cluster.runner.engine_main``
    under ``ClusterSupervisor``, each its own CUDA context, ``auto``,
    2^20 rows, B=2048) drain a prefilled 2-shard ``syn_benign_mix``
    fan-out against the CPU engine with two workers on the same records
    and epoch: stats and tracked rows additive, each rank's published
    blacklist equal to the CPU engine's blocks it owns, merged digests
    converged with no seq gaps; each rank's ``score_int8`` launches (its
    own window, zeroed after warm, in its report) equal its batches.
41. ``cluster_serve``: ``cli cluster --engines 2 --shards 2 --mega auto
    --drain`` over each prefilled scenario (1,536 x 2,048 records), in
    turns with one card engine with two workers (single, cluster,
    cluster, single; ``--pin-cores off``), then once pinned (``auto``):
    the fleet's records/s (total over the slowest rank's drain wall)
    against the single engine's, each rank's device ms per batch and
    idle share at the solo per-graph device times, card memory per
    context (``nvidia-smi --query-compute-apps``) and each rank's boot.
42. ``cluster_crash_restart``: two ranks serve a trickle-fed fan-out with
    checkpoints every 0.25 s; rank 1's process group is SIGKILLed once it
    has published blocks; its context's memory is released, gen 1
    restores its checkpoint (kill -> SERVING seconds), the survivor
    serves every record of its shard and merged gen 0's wires.
43. ``status_monitor_fleet``: ``cli status`` and ``cli monitor --count 2
    --interval 0.1 --alert-p99-us 1 --alert-degraded`` (subprocesses)
    over the rank reports of the last ``cluster_serve`` fleet: the merged
    seal -> verdict count is the ranks' sum, the latency, predict, boot
    and health merges equal the supervisor's ``aggregate()`` of that
    fleet, the p99 alert fires, the degraded alert fires exactly when a
    rank is not healthy, and the drained feature ring's backlog is 0.
44. ``scenario_suite`` (after ``train_distill_serve``): the five BASELINE
    configs (``benchmarks.run_suite(scale=1.0, names=[config])``, one
    launch window per config: the token bucket at 2^14 rows, the
    sliding window at 2^16, offline scoring at B=8192, the online mix,
    1M sources at B=16,384 over 2^20 rows) on the card, every untimed
    field equal to the CPU engine's at the same scale; in each config's
    window ``score_int8`` launches equal its batches and
    ``table_summary`` launches once (its one report); then per config a
    warmed engine
    on the same records: records/s, the captured step's device ms per
    batch over the config's own batches, idle share, the fill's host ms
    per batch and the generator's own records/s, memory after
    ``warm()``, and ``score_int8`` (at B=8192 and 16,384) and
    ``table_summary`` (at 2^14 and 2^16 rows) against their plain
    versions.

Then the timing line per kernel (``segment_sum_seq`` on the byte lanes
of a served raw48 batch, ``index_add_`` its library call; the scorer
also with the log1p artifact on raw48 rows, and at the training path's
evaluation chunk, B = 65,536 rows, with the trained artifact, and at
the suite's B = 8192 and 16,384 with ``logreg_int8.npz``;
``gemv_seq`` on the QAT epoch's operands at 2,016,639 rows, its plain
version on the host, ``torch.mv`` its library call): ``ms`` (CUDA events, host
launch gaps included), ``device_ms`` (the kernel's own time from
``torch.profiler``),
``host_us_per_call`` (the wrapper's enqueue time), the plain version,
one library call where one exists (event and profiler time), and the
bound from this run's inputs (for ``table_summary``: every key plus the
two state words of each tracked row, which is what the kernel must
read; beside it the counts of distinct 32-byte sectors and 64-byte
chunks that hold those words, counted on this run's table),
``table_summary`` on both served tables and on the suite's 2^14- and
2^16-row tables; then the card line, and last the ``ok`` line.  The script imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import hashlib
import json
import os
import shutil
import subprocess
import sys
import threading
import time
import traceback
import types

#: Card peaks used for the bound (NVIDIA H100 SXM data sheet).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
SEED = 20261016
REPO = os.path.dirname(os.path.abspath(__file__))
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

    from flowsentryx_tpu_torch import benchmarks
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
    errs = {"score_int8": 0.0, "table_summary": 0.0, "segment_sum_seq": 0.0,
            "gemv_seq": 0.0}

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
        served["serve_reports"] = dict(zip((s for s, _ in scenarios),
                                           reports))
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
        served["overflow"] = (c, recs, want)
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

    # -- the production serve path: daemon rings, ingest workers,
    # -- checkpoint/restore ---------------------------------------------------

    from flowsentryx_tpu_torch.engine import checkpoint as ckpt
    from flowsentryx_tpu_torch.engine.shm import (
        ShmRing, ShmRingSource, ShmVerdictSink,
    )
    from flowsentryx_tpu_torch.ingest import ShardedIngest

    shm_dir = os.path.join(REPO, "build", "shm")
    shutil.rmtree(shm_dir, ignore_errors=True)
    os.makedirs(shm_dir)
    ring_cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, name="logreg_int8"))
    ring_scen = ("mixed_l34_1m", "syn_benign_mix")
    ring_recs = {s: TrafficGen(TrafficSpec(
        scenario=Scenario(s), rate_pps=1e6, seed=SEED)
    ).next_records(SERVE_BATCHES * BATCH) for s in ring_scen}
    #: ``syn_benign_mix`` blocks sources (its flood sources repeat), so
    #: the ingest and checkpoint phases carry a blacklist through it;
    #: ``mixed_l34_1m``'s one-shot sources fill the table instead
    blk = "syn_benign_mix"

    @contextlib.contextmanager
    def cpu_threads(n=2):
        """The plain CPU reference runs with ``n`` threads: at this size
        torch's default pool (one per core) costs ~5x in thread
        hand-offs (66 vs 13 ms per 2,048-record batch, measured)."""
        prev = torch.get_num_threads()
        torch.set_num_threads(n)
        try:
            yield
        finally:
            torch.set_num_threads(prev)

    class Recording(Engine):
        """Keeps a host copy of every batch it dispatches and of every
        verdict wire it sinks, in order (for the CPU replay)."""

        def start_log(self):
            self.log, self.wires = [], []

        def _launch(self, rung, x, *a, **kw):
            if getattr(self, "log", None) is not None:
                rows = x.cpu().numpy().view(np.uint32)
                self.log += [r.copy() for r in (rows if rows.ndim == 3
                                                 else rows[None])]
            super()._launch(rung, x, *a, **kw)

        def _sink_one(self, g):
            if getattr(self, "wires", None) is not None and g.wire is not None:
                if g.event is not None:
                    g.event.synchronize()
                self.wires.append(g.wire.cpu().numpy().copy())
            super()._sink_one(g)

    class ListSealed:
        """A sealed-batch source over recorded wire buffers, in order:
        the CPU engine fed the batches the card engine dispatched."""

        provides_sealed = True

        def __init__(self, bufs, precompact=False):
            self.bufs, self.i, self.t0_ns = bufs, 0, 1
            self.precompact = precompact

        def start(self, *a):
            pass

        def poll_batches_into(self, dst, max_batches, **timers):
            out = []
            while (len(out) < min(max_batches, len(dst))
                   and self.i < len(self.bufs)):
                b = self.bufs[self.i]
                dst[len(out)] = b
                out.append(types.SimpleNamespace(
                    n_records=int(b[-1, 0]), t_enqueue=time.perf_counter()))
                self.i += 1
            return out

        def exhausted(self):
            return self.i >= len(self.bufs)

    class TeeSink:
        """The verdict ring and a blacklist dict, both fed every update."""

        def __init__(self, path):
            self.ring, self.collect = ShmVerdictSink(path), CollectSink()

        t0_ns = property(lambda self: self.ring.t0_ns,
                         lambda self, v: setattr(self.ring, "t0_ns", v))

        def apply(self, upd):
            self.ring.apply(upd)
            self.collect.apply(upd)

    def verdict_ring(label):
        path = os.path.join(shm_dir, f"{label}.vring")
        return path, ShmRing.create(path, 1 << 18,
                                    schema.VERDICT_RECORD_DTYPE)

    def feature_ring(label, recs, dtype=schema.FLOW_RECORD_DTYPE):
        """The producer: every record written into a fresh ring before
        the engine drains it, so batch boundaries are whole batches."""
        path = os.path.join(shm_dir, f"{label}.fring")
        ring = ShmRing.create(path, 1 << 20, dtype)
        assert ring.produce(recs) == len(recs)
        return path

    def per_batch(r):
        """Host ms per batch of each stage (its mean times its count over
        the batches), and records/s."""
        return {"records_per_s": r.records_per_s, "wall_s": r.wall_s,
                **{f"{k}_ms_per_batch": v["mean"] * v["n"] / max(r.batches, 1)
                   for k, v in r.stages_ms.items() if v}}

    def cpu_ring_run(label, c, params, recs, **kw):
        vpath, vring = verdict_ring(label)
        sink = TeeSink(vpath)
        e = Engine(c, ArraySource(recs.copy()), sink, params=params,
                   device="cpu", **kw)
        with cpu_threads():
            r = e.run()
        return {"stats": r.stats, "digest": digest(e), "batches": r.batches,
                "blocked": sorted(sink.collect.blocked.items()),
                "verdicts": vring.consume(1 << 18).tobytes(),
                "dropped": sink.ring.dropped}

    def step_busy_ms(c, params, recs, n=64):
        """Device ms per batch of the captured single compact16 step,
        replayed back to back over real batches (a graph launch enqueues
        in ~0.13 ms, well under the step, so the events read the
        device's busy time)."""
        e = Engine(c, ArraySource(recs[:0]), CollectSink(), params=params,
                   device="cuda")
        e.warm()
        gr = e._graphs[0]
        quant = e.quant
        xs = [to_dev(schema.encode_compact(recs[i * BATCH:(i + 1) * BATCH],
                                           BATCH, int(recs["ts_ns"][0]),
                                           **quant)) for i in range(n)]
        for x in xs[:8]:
            gr.input.copy_(x)
            gr.replay()
        torch.cuda.synchronize()
        a, b_ = torch.cuda.Event(True), torch.cuda.Event(True)
        a.record()
        for x in xs:
            gr.input.copy_(x)
            gr.replay()
        b_.record()
        b_.synchronize()
        return a.elapsed_time(b_) / n

    def idle_share(r, busy_ms):
        return 1.0 - busy_ms * r.batches / max(r.wall_s * 1e3, 1e-9)

    @phase("serve_shm_ring")
    def ring_phase():
        params = logreg.load_params(artifact, "cuda")
        busy = step_busy_ms(ring_cfg, params, ring_recs["mixed_l34_1m"])
        served["compact_busy_ms"] = busy
        out, checks = {"card": card, "batches": SERVE_BATCHES,
                       "model": "logreg_int8 + artifacts/logreg_int8.npz",
                       "step_busy_ms_per_batch": busy}, []
        served["ring_cpu"], served["ring_single"] = {}, {}
        served["ring_auto"] = {}
        for scen in ring_scen:
            recs = ring_recs[scen]
            res = {}
            for label, mega_n in (("single", 0), ("auto", "auto")):
                fpath = feature_ring(f"ring_{label}", recs)
                vpath, vring = verdict_ring(f"ring_{label}")
                sink = ShmVerdictSink(vpath)
                e = Engine(ring_cfg, ShmRingSource(fpath), sink,
                           params=params, device="cuda", mega_n=mega_n)
                e.warm()
                kernels.reset_launches()          # this path's window opens
                r = e.run(max_batches=SERVE_BATCHES)
                torch.cuda.synchronize()
                launches = dict(kernels.LAUNCHES)  # ... and closes
                verdicts = vring.consume(1 << 18)
                res[label] = {"report": r, "digest": digest(e),
                              "verdicts": verdicts, "launches": launches}
                checks += [r.batches == SERVE_BATCHES,
                           r.records == SERVE_BATCHES * BATCH,
                           launches["score_int8"] == r.batches,
                           launches["table_summary"] == 1,
                           sink.dropped == 0,
                           e.wire == schema.WIRE_COMPACT16]
            cpu = cpu_ring_run("ring_cpu", ring_cfg,
                               logreg.load_params(artifact, "cpu"), recs)
            served["ring_cpu"][scen] = cpu
            served["ring_single"][scen] = res["single"]
            served["ring_auto"][scen] = res["auto"]
            gen = served.get("serve_reports", {}).get(scen)
            out[scen] = {"generator_serve": (
                {**per_batch(gen), "idle_share": idle_share(gen, busy),
                 "model": dict(scenarios)[scen] + " (golden)"}
                if gen else None)}
            for label, run in res.items():
                r = run["report"]
                same = {"stats": r.stats == cpu["stats"],
                        "table_digest": run["digest"] == cpu["digest"],
                        "verdict_ring": run["verdicts"].tobytes()
                        == cpu["verdicts"]}
                checks += list(same.values())
                out[scen][label] = {
                    **per_batch(r), "idle_share": idle_share(r, busy),
                    "launches": run["launches"], "equal_cpu": same,
                    "group_hist": r.dispatch["group_hist"],
                    "verdict_records": len(run["verdicts"]),
                    "stats": r.stats}
            if scen == blk:
                checks.append(len(res["single"]["verdicts"]) > 0)
        served["launches_ring"] = {
            s: served["ring_single"][s]["launches"] for s in ring_scen}
        return {"ok": all(checks), **out}

    ring_phase()

    @phase("serve_raw48_ring")
    def raw_ring_phase():
        params = load_artifact("mlp", mlp_path, "cuda")
        fpath = feature_ring("raw_ring", ring_recs["mixed_l34_1m"])
        vpath, vring = verdict_ring("raw_ring")
        sink = ShmVerdictSink(vpath)
        e = Engine(raw_cfg, ShmRingSource(fpath), sink, params=params,
                   device="cuda")
        e.warm()
        kernels.reset_launches()              # this path's window opens
        r = e.run(max_batches=SERVE_BATCHES)
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)      # ... and closes
        served["launches_raw48_ring"] = launches
        verdicts = vring.consume(1 << 18)
        cpu = cpu_ring_run("raw_ring_cpu", raw_cfg,
                           load_artifact("mlp", mlp_path, "cpu"),
                           ring_recs["mixed_l34_1m"])
        same = {"stats": r.stats == cpu["stats"],
                "table_digest": digest(e) == cpu["digest"],
                "verdict_ring": verdicts.tobytes() == cpu["verdicts"]}
        checks = [*same.values(), e.wire == schema.WIRE_RAW48,
                  r.batches == SERVE_BATCHES,
                  launches["segment_sum_seq"] == r.batches,
                  launches["score_int8"] == 0,
                  launches["table_summary"] == 1,
                  r.stats["evicted"] > 0, sink.dropped == 0]
        return {"ok": all(checks), "card": card, **per_batch(r),
                "launches": launches, "equal_cpu": same, "stats": r.stats,
                "verdict_records": len(verdicts)}

    raw_ring_phase()

    def sealed_run(label, n_workers, recs, record=False, mega_n=0,
                   trace=False, queue_slots=8, **kw):
        """Serve ``recs`` split by ``shard_of`` over ``n_workers`` shard
        rings through spawned workers (strict) into the card engine,
        drain-on-stop; returns the report, the engine, the sink, the
        verdict records and the launches of this path's window.  ``kw``
        goes to the engine (``device_loop``); ``trace`` turns its H2D
        trace on for the run; ``queue_slots`` sizes each worker's sealed
        queue."""
        base = os.path.join(shm_dir, label)
        sh = schema.shard_of(recs["saddr"], n_workers)
        for k in range(n_workers):
            ring = ShmRing.create(schema.shard_ring_path(base, k, n_workers),
                                  1 << 20, schema.FLOW_RECORD_DTYPE)
            assert ring.produce(recs[sh == k]) == int((sh == k).sum())
        vpath, vring = verdict_ring(label)
        sink = TeeSink(vpath)
        src = ShardedIngest(base, n_workers, strict=True, precompact=False,
                            queue_slots=queue_slots)
        cls = Recording if record else Engine
        try:
            e = cls(ring_cfg, src, sink, params=logreg.load_params(
                artifact, "cuda"), device="cuda", mega_n=mega_n, **kw)
            e.warm()
            src.wait_ready()
            deadline = time.monotonic() + 60
            while src.t0_ns is None:      # the epoch handshake, then stop
                src.poll_batches(0)
                assert time.monotonic() < deadline, "no t0 handshake"
                time.sleep(0.005)
            src.request_stop()            # drain every ring, then exit
            if record:
                e.start_log()
            if trace:
                e.trace_h2d = []
            kernels.reset_launches()      # this path's window opens
            r = e.run()
            torch.cuda.synchronize()
            launches = dict(kernels.LAUNCHES)   # ... and closes
        finally:
            src.close()
        r = r._replace(ingest=src.ingest_stats())
        return r, e, sink, vring.consume(1 << 18), launches

    def ingest_summary(ing):
        return {"n_workers": ing["n_workers"], "strict": ing["strict"],
                "crashed": ing["crashed"],
                "dropped_tail_batches": ing["dropped_tail_batches"],
                "dropped_emit_batches": ing["dropped_emit_batches"],
                "bad_wire_slots": ing["bad_wire_slots"],
                "quarantined_batches": ing["quarantined_batches"],
                "workers": {k: {f: w[f] for f in (
                    "batches", "records", "seq_gaps", "seq_missing",
                    "dead", "fill_ms", "queue_ms")}
                    for k, w in ing["workers"].items()}}

    def replay_cpu(bufs, precompact=False, c=ring_cfg, params=None):
        """The CPU engine fed the recorded batches, in order."""
        e = Recording(c, ListSealed(bufs, precompact), CollectSink(),
                      params=params or logreg.load_params(artifact, "cpu"),
                      device="cpu")
        e.start_log()
        with cpu_threads():
            r = e.run()
        return r, e

    @phase("serve_ingest_workers")
    def ingest_phase():
        out, checks = {"card": card}, []
        busy = served.get("compact_busy_ms")
        recs = ring_recs[blk]
        # one worker: byte-equal to the inline ring path (same records)
        r1, e1, s1, v1, l1 = sealed_run("ingest1", 1, recs)
        inline = served.get("ring_single", {}).get(blk)
        same1 = {"stats": inline is not None
                 and r1.stats == inline["report"].stats,
                 "table_digest": inline is not None
                 and digest(e1) == inline["digest"],
                 "verdict_ring": inline is not None
                 and v1.tobytes() == inline["verdicts"].tobytes()}
        checks += [*same1.values(), r1.batches == SERVE_BATCHES,
                   l1["score_int8"] == r1.batches, s1.ring.dropped == 0,
                   r1.ingest["workers"]["0"]["seq_gaps"] == 0]
        out["scenario"] = blk
        out["workers_1"] = {**per_batch(r1), "launches": l1,
                            "equal_inline_ring": same1,
                            "ingest": ingest_summary(r1.ingest)}
        # two workers: equal to the CPU engine fed the same batches
        r2, e2, s2, v2, l2 = sealed_run("ingest2", 2, recs, record=True)
        rc, ec = replay_cpu(e2.log)
        same2 = {"stats": r2.stats == rc.stats,
                 "table_digest": digest(e2) == digest(ec),
                 "blacklist": sorted(s2.collect.blocked.items())
                 == sorted(ec.sink.blocked.items()),
                 "wires": len(e2.wires) == len(ec.wires) and all(
                     np.array_equal(a, b_) for a, b_ in zip(e2.wires,
                                                            ec.wires))}
        checks += [*same2.values(), r2.records == len(recs),
                   l2["score_int8"] == r2.batches, s2.ring.dropped == 0,
                   all(w["seq_gaps"] == 0 and not w["dead"]
                       for w in r2.ingest["workers"].values())]
        out["workers_2"] = {**per_batch(r2), "batches": r2.batches,
                            "launches": l2, "equal_cpu_replay": same2,
                            "ingest": ingest_summary(r2.ingest)}
        if busy:
            for k, r in (("workers_1", r1), ("workers_2", r2)):
                out[k]["idle_share"] = idle_share(r, busy)
        served["launches_ingest"] = {"1": l1, "2": l2}
        return {"ok": all(checks), **out}

    ingest_phase()

    # -- the drain ring and the boot path (device_loop, tiered warm,
    # -- compile cache) -------------------------------------------------------

    from flowsentryx_tpu_torch.engine.engine import calibrate_ring_depth

    def h2d_overlap(trace):
        """The H2D overlap measured on the card from an engine's
        ``trace_h2d``: of the uploads' time on the copy stream, the share
        that a replay on the step's stream covered (CUDA events)."""
        iv = {"h2d": [], "compute": []}
        if trace:
            base = trace[0][1]
            for kind, a, b_ in trace:
                iv[kind].append((base.elapsed_time(a), base.elapsed_time(b_)))
        tot = sum(b_ - a for a, b_ in iv["h2d"])
        ov = sum(max(0.0, min(b_, c1) - max(a, c0))
                 for a, b_ in iv["h2d"] for c0, c1 in iv["compute"])
        return {"uploads": len(iv["h2d"]), "h2d_ms": tot,
                "overlapped_ms": ov, "fraction": ov / tot if tot else 0.0}

    def launch_costs(e, reps=10):
        """Every graph of the served engine (after its checks) replayed
        on its last input: host µs of one launch into an idle card
        (synchronized before each), host µs per launch back to back
        (where the launch queue can push back), and device ms per launch
        and per batch (CUDA events around back-to-back replays), beside
        the graph's node count: a round's launch against the R top-rung
        launches it replaces."""
        out = {}
        for key, g in sorted(e._graphs.items()):
            for _ in range(2):
                g.replay()
            torch.cuda.synchronize()
            idle = []
            for _ in range(reps):
                torch.cuda.synchronize()
                t = time.perf_counter()
                g.replay()
                idle.append(time.perf_counter() - t)
            torch.cuda.synchronize()
            hs = []
            a, b_ = torch.cuda.Event(True), torch.cuda.Event(True)
            a.record()
            for _ in range(reps):
                t = time.perf_counter()
                g.replay()
                hs.append(time.perf_counter() - t)
            b_.record()
            b_.synchronize()
            ms = a.elapsed_time(b_) / reps
            out[e._label(key)] = {
                "nodes": g.nodes, "batches": e._chunks(key),
                "idle_host_us_per_launch": float(np.median(idle)) * 1e6,
                "host_us_per_launch": float(np.median(hs)) * 1e6,
                "device_ms_per_launch": ms,
                "device_ms_per_batch": ms / e._chunks(key)}
        return out

    def ring_engine(label, recs, depth, **kw):
        fpath = feature_ring(label, recs)
        vpath, vring = verdict_ring(label)
        sink = ShmVerdictSink(vpath)
        e = Engine(ring_cfg, ShmRingSource(fpath), sink,
                   params=logreg.load_params(artifact, "cuda"),
                   device="cuda", mega_n="auto", device_loop=depth, **kw)
        return e, sink, vring

    @phase("device_loop_serve")
    def ring_serve_phase():
        out, checks = {"card": card, "batches": SERVE_BATCHES,
                       "model": "logreg_int8 + artifacts/logreg_int8.npz"}, []
        busy = served.get("compact_busy_ms")
        # in turns: auto, ring 2, ring 4, ring 4, ring 2, auto
        order = (0, 2, 4, 4, 2, 0)
        for scen in ring_scen:
            cpu, auto = served["ring_cpu"][scen], served["ring_auto"][scen]
            out[scen] = {"records_per_s_in_turns": {}}
            for depth in order:
                label = f"ring{depth}" if depth else "auto"
                e, sink, vring = ring_engine(label, ring_recs[scen], depth)
                e.warm()
                e.trace_h2d = [] if depth else None
                kernels.reset_launches()          # this path's window opens
                r = e.run(max_batches=SERVE_BATCHES)
                torch.cuda.synchronize()
                launches = dict(kernels.LAUNCHES)  # ... and closes
                trace, e.trace_h2d = e.trace_h2d, None
                verdicts = vring.consume(1 << 18).tobytes()
                same = {"stats_cpu": r.stats == cpu["stats"],
                        "digest_cpu": digest(e) == cpu["digest"],
                        "verdict_ring_cpu": verdicts == cpu["verdicts"],
                        "stats_auto": r.stats == auto["report"].stats,
                        "digest_auto": digest(e) == auto["digest"],
                        "verdict_ring_auto":
                            verdicts == auto["verdicts"].tobytes()}
                checks += [*same.values(), r.batches == SERVE_BATCHES,
                           launches["score_int8"] == r.batches,
                           launches["table_summary"] == 1,
                           sink.dropped == 0]
                out[scen]["records_per_s_in_turns"].setdefault(
                    label, []).append(r.records_per_s)
                if depth:
                    checks.append(r.dispatch["device_loop"]["rounds"] >= 2)
                if label not in out[scen]:
                    out[scen][label] = {
                        **per_batch(r), "launches": launches,
                        "equal": same,
                        "device_loop": r.dispatch["device_loop"],
                        "group_hist": r.dispatch["group_hist"],
                        "graph_nodes": r.dispatch["graph_nodes"],
                        "capture_s": {k: v["seconds"] for k, v in
                                      r.boot["variants"].items()}}
                    if depth:
                        out[scen][label].update(
                            device_h2d_overlap=h2d_overlap(trace),
                            launch_cost=launch_costs(e))
                    if busy:
                        out[scen][label]["idle_share"] = idle_share(r, busy)
                del e
                torch.cuda.empty_cache()
        # the reference's oracle: a round's per-slot wires equal those of
        # sequential top-rung megasteps over the same slots
        params = logreg.load_params(artifact, "cuda")
        er, _, _ = ring_engine("oracle_r", ring_recs[blk][:0], 2)
        em, _, _ = ring_engine("oracle_m", ring_recs[blk][:0], 0)
        er.warm()
        em.warm()
        raws, _ = stream(blk, 32, params)
        wires_equal, blocked = True, 0
        for k in range(2):
            slots = np.stack(raws[16 * k:16 * (k + 1)]).reshape(
                2, 8, BATCH + 1, -1)
            gr = er._graphs[-1]
            gr.input.copy_(to_dev(slots))
            gr.replay()
            for s_ in range(2):
                g8 = em._graphs[8]
                g8.input.copy_(to_dev(slots[s_]))
                g8.replay()
                wires_equal &= torch.equal(gr.out.wire[s_], g8.out.wire)
                blocked += int(g8.out.wire[2 * 64].item())
        oracle = {"wires_equal": bool(wires_equal), "blocks": blocked,
                  "state_equal": same_state(er.table, er.stats, em.table,
                                            em.stats)}
        checks += [oracle["wires_equal"], oracle["state_equal"]]
        out["slot_wires_vs_megasteps"] = oracle
        del er, em
        # a wire that overflows inside a round: the flood at verdict_k=8
        c, recs, want = served["overflow"]
        e = Engine(c, ArraySource(recs.copy()), CollectSink(),
                   params=logreg.golden_params("cuda"), device="cuda",
                   mega_n=4, device_loop=2)
        e.warm()
        r = e.run()
        same = {"stats": r.stats == want["stats"],
                "blacklist": sorted(e.sink.blocked.items())
                == want["blacklist"], "digest": digest(e) == want["digest"]}
        checks += [*same.values(), r.readback["fallback_sinks"] > 0,
                   r.dispatch["device_loop"]["rounds"] >= 1]
        out["overflow_in_round"] = {"equal_cpu": same,
                                    "readback": r.readback,
                                    "device_loop": r.dispatch["device_loop"]}
        return {"ok": all(checks), **out}

    ring_serve_phase()

    @phase("device_loop_sealed")
    def ring_sealed_phase():
        """One spawned worker (a 32-slot sealed queue) -> arena staging
        -> the ring: one host copy per batch, the upload overlap on the
        card, equal to the inline singles ring path."""
        # a sealed queue of 32 slots: room for two rounds of backlog (a
        # short poll flushes the uploaded slots, as in the reference)
        r, e, sink, v, launches = sealed_run(
            "ring_sealed", 1, ring_recs[blk], mega_n="auto",
            device_loop=2, trace=True, queue_slots=32)
        trace, e.trace_h2d = e.trace_h2d, None
        ov = h2d_overlap(trace)
        inline = served["ring_single"][blk]
        same = {"stats": r.stats == inline["report"].stats,
                "table_digest": digest(e) == inline["digest"],
                "verdict_ring": v.tobytes()
                == inline["verdicts"].tobytes()}
        d = r.dispatch
        checks = [*same.values(), d["host_copies_per_batch"] == 1.0,
                  d["device_loop"]["rounds"] >= 1,
                  d["device_loop"]["h2d"]["overlap_fraction"] > 0,
                  ov["fraction"] > 0, launches["score_int8"] == r.batches,
                  sink.ring.dropped == 0]
        return {"ok": all(checks), "card": card, **per_batch(r),
                "equal_inline_singles": same, "launches": launches,
                "host_copies_per_batch": d["host_copies_per_batch"],
                "device_loop": d["device_loop"],
                "device_h2d_overlap": ov,
                "group_hist": d["group_hist"],
                "ingest": ingest_summary(r.ingest)}

    ring_sealed_phase()

    @phase("device_loop_auto")
    def ring_auto_phase():
        """``--device-loop auto``'s calibration at full width: each
        candidate's drain and the depth chosen; the card's memory is
        back where it was once the throwaway engines are gone."""
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        t = time.perf_counter()
        depth, detail = calibrate_ring_depth(
            ring_cfg, params=logreg.load_params(artifact, "cuda"),
            mega_n="auto", device="cuda")
        wall = time.perf_counter() - t
        torch.cuda.synchronize()
        left = torch.cuda.memory_allocated() - before
        return {"ok": depth in (2, 4, 8) and left < (64 << 20),
                "card": card, "depth": depth, "detail": detail,
                "wall_s": wall, "bytes_left_allocated": left}

    ring_auto_phase()

    boot_dir = os.path.join(REPO, "build", "boot")
    shutil.rmtree(boot_dir, ignore_errors=True)
    os.makedirs(boot_dir)

    @phase("boot_cold_cached")
    def boot_phase():
        """Fresh ``cli serve`` processes, each with an empty kernel build
        directory: a cold boot into an empty cache directory, then a
        cached ``--tiered-warm`` boot; the same records."""
        rec_path = os.path.join(boot_dir, "records.bin")
        with open(rec_path, "wb") as f:
            f.write(ring_recs[blk][:96 * BATCH].tobytes())
        cache_dir = os.path.join(boot_dir, "cache")
        legs = {}
        for leg, extra in (("cold", []), ("cached", ["--tiered-warm"])):
            env = {**os.environ, "FSX_KERNEL_BUILD":
                   os.path.join(boot_dir, leg, "kernels")}
            argv = [sys.executable, "-m", "flowsentryx_tpu_torch.cli",
                    "serve", "--records", rec_path, "--artifact", artifact,
                    "--mega", "auto", "--device-loop", "2",
                    "--compile-cache", cache_dir, "--json", *extra]
            t = time.perf_counter()
            p = subprocess.run(argv, capture_output=True, text=True,
                               env=env, cwd=REPO, timeout=300)
            wall = time.perf_counter() - t
            if p.returncode != 0:
                raise RuntimeError(f"{leg} boot exited {p.returncode}: "
                                   f"{p.stderr[-2000:]}")
            rep = json.loads(p.stdout.strip().splitlines()[-1])
            legs[leg] = {"process_wall_s": wall, "boot": rep["boot"],
                         "stats": rep["stats"], "table": rep["table"],
                         "batches": rep["batches"],
                         "records_per_s": rep["records_per_s"]}
        cold, cached = legs["cold"]["boot"], legs["cached"]["boot"]
        n = len(kernels.LAUNCHES)
        checks = [cold["cache"]["misses"] == n, cold["cache"]["stores"] == n,
                  cached["cache"]["hits"] == n,
                  cached["cache"]["misses"] == 0,
                  all(k["source"] == "cache"
                      for k in cached["kernels"].values()),
                  all(k["source"] == "build"
                      for k in cold["kernels"].values()),
                  cached["tiered"] is True, "fill_error" not in cached,
                  cached["fill_pending"] == [],
                  "fill_done_s" in cached,
                  cold["cache"]["sig_digest"] == cached["cache"]["sig_digest"],
                  legs["cold"]["stats"] == legs["cached"]["stats"],
                  legs["cold"]["table"] == legs["cached"]["table"]]
        summary = {leg: {"import_s": v["boot"]["import_s"],
                         "serving_ready_s": v["boot"]["serving_ready_s"],
                         "time_to_first_verdict_s":
                             v["boot"]["time_to_first_verdict_s"],
                         "fill_done_s": v["boot"].get("fill_done_s"),
                         "process_wall_s": v["process_wall_s"],
                         "kernel_s": max(k["seconds"] for k in
                                         v["boot"]["kernels"].values())}
                   for leg, v in legs.items()}
        return {"ok": all(checks), "card": card, "summary": summary,
                "legs": legs}

    boot_phase()

    @phase("tiered_partial_ladder")
    def tiered_phase():
        """The fill held: serving on the single step and the top rung
        only, byte-identical to the full warm (``auto`` from the ring)
        and the CPU engine; records/s in turns with full-warm ``auto``
        engines."""
        out, checks = {"card": card}, []
        for scen in ring_scen:
            out[scen] = {"records_per_s_in_turns": {}}
            # in turns with the full warm: tiered, full, full, tiered
            for tiered in (True, False, False, True):
                label = "tiered_held" if tiered else "full_warm"
                e, sink, vring = ring_engine(f"tiered_{scen}",
                                             ring_recs[scen], 0)
                if tiered:
                    e._warm_worker = lambda: None
                t = time.perf_counter()
                e.warm(tiered=tiered)
                ready_s = time.perf_counter() - t
                kernels.reset_launches()          # this path's window opens
                r = e.run(max_batches=SERVE_BATCHES)
                torch.cuda.synchronize()
                launches = dict(kernels.LAUNCHES)  # ... and closes
                verdicts = vring.consume(1 << 18).tobytes()
                auto, cpu = (served["ring_auto"][scen],
                             served["ring_cpu"][scen])
                hist = {int(g): n for g, n in
                        r.dispatch["group_hist"].items()}
                same = {"stats": r.stats == auto["report"].stats
                        == cpu["stats"],
                        "digest": digest(e) == auto["digest"]
                        == cpu["digest"],
                        "verdict_ring": verdicts == cpu["verdicts"]}
                checks += [*same.values(),
                           launches["score_int8"] == r.batches]
                if tiered:
                    checks += [set(hist) <= {1, 8},
                               r.dispatch["graphs"] == 2]
                out[scen]["records_per_s_in_turns"].setdefault(
                    label, []).append(r.records_per_s)
                out[scen].setdefault(label, {
                    **per_batch(r), "equal": same, "group_hist": hist,
                    "warm_s": ready_s, "launches": launches,
                    "boot": r.boot})
                del e
        return {"ok": all(checks), **out}

    tiered_phase()

    # -- the cluster: N engine processes on one card (cli cluster) ------------

    from flowsentryx_tpu_torch.cluster import (
        StatusBlock, VerdictMailbox, mailbox_path, status_path,
    )
    from flowsentryx_tpu_torch.core import wire
    from flowsentryx_tpu_torch.cluster.supervisor import ClusterSupervisor
    from flowsentryx_tpu_torch.cluster.gossip import map_digest
    from flowsentryx_tpu_torch.parallel.layout import cluster_rank_of

    cl_dir = os.path.join(REPO, "build", "cluster")
    shutil.rmtree(cl_dir, ignore_errors=True)
    os.makedirs(cl_dir)
    cl_cfg_path = os.path.join(cl_dir, "cfg.json")
    with open(cl_cfg_path, "w") as f:
        f.write(ring_cfg.to_json())

    def fan_out(base, recs, n_shards=2, slots=1 << 20):
        """The daemon's IP-hash fan-out, prefilled: shard k of ``base``
        holds the records ``shard_of`` routes there."""
        sh = schema.shard_of(recs["saddr"], n_shards)
        rings = []
        for k in range(n_shards):
            ring = ShmRing.create(schema.shard_ring_path(base, k, n_shards),
                                  slots, schema.FLOW_RECORD_DTYPE)
            assert ring.produce(recs[sh == k]) == int((sh == k).sum())
            rings.append(ring)
        return [int((sh == k).sum()) for k in range(n_shards)], rings

    def compute_apps():
        """``nvidia-smi --query-compute-apps``: ``[pid, used MiB]`` per
        context (in a container every pid may read the same, so contexts
        are told apart by count and memory, not by pid)."""
        out = subprocess.run(
            ["nvidia-smi", "--query-compute-apps=pid,used_memory",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=60).stdout
        apps = []
        for line in out.strip().splitlines():
            pid, _, mib = line.partition(",")
            try:
                apps.append([int(pid), float(mib)])
            except ValueError:
                continue
        return sorted(apps)

    def rank_specs(base, n=2, **extra):
        return [{"device": "cuda", "cfg_json": ring_cfg.to_json(),
                 "ring_base": base, "workers": 1, "total_shards": n,
                 "artifact": artifact, "mega": "auto", **extra}
                for _ in range(n)]

    def single_two_workers(base):
        """One card engine with two workers over the same prefilled
        fan-out, drained in one timed run (the cluster's comparison)."""
        src = ShardedIngest(base, 2, precompact=False)
        sink = CollectSink()
        try:
            e = Engine(ring_cfg, src, sink, params=logreg.load_params(
                artifact, "cuda"), device="cuda", mega_n="auto")
            mem0 = torch.cuda.memory_reserved()
            e.warm()
            mem = torch.cuda.memory_reserved() - mem0
            src.wait_ready()
            deadline = time.monotonic() + 60
            while src.t0_ns is None:      # the epoch handshake, then stop
                src.poll_batches(0)
                assert time.monotonic() < deadline, "no t0 handshake"
                time.sleep(0.005)
            src.request_stop()
            kernels.reset_launches()      # this path's window opens
            r = e.run()
            torch.cuda.synchronize()
            launches = dict(kernels.LAUNCHES)   # ... and closes
        finally:
            src.close()
        return r, e, sink, launches, mem

    def busy_ms(hist, costs):
        """Device ms a dispatch histogram needs at the solo per-graph
        device times (CUDA events, back-to-back replays)."""
        per = {1: costs.get("single", {}).get("device_ms_per_launch", 0.0)}
        for label, c in costs.items():
            if label.startswith("mega"):
                per[c["batches"]] = c["device_ms_per_launch"]
        return sum(n * per.get(int(g), 0.0) for g, n in hist.items())

    @phase("cluster_parity")
    def cluster_parity_phase():
        """Two rank processes on the card (``engine_main``, drain mode,
        each its own CUDA context) against the port's CPU engine with two
        workers on the same prefilled fan-out and epoch."""
        recs = ring_recs[blk]
        t0 = int(recs["ts_ns"].min())
        counts, _ = fan_out(os.path.join(cl_dir, "parity"), recs)
        sup = ClusterSupervisor(
            os.path.join(cl_dir, "parity.plane"),
            rank_specs(os.path.join(cl_dir, "parity"), drain=True,
                       gossip_quiesce_s=4.0), t0_ns=t0)
        sup.boot()
        agg = sup.run(max_seconds=300)
        reps = {r["rank"]: r for r in agg["reports"]}
        # the CPU engine with two workers, the same records and epoch
        fan_out(os.path.join(cl_dir, "parity_cpu"), recs)
        src = ShardedIngest(os.path.join(cl_dir, "parity_cpu"), 2,
                            precompact=False)
        sink = CollectSink()
        try:
            ec = Engine(ring_cfg, src, sink, params=logreg.load_params(
                artifact, "cpu"), device="cpu", mega_n="auto", t0_ns=t0)
            src.set_t0(t0)
            src.request_stop()
            with cpu_threads():
                rc = ec.run()
        finally:
            src.close()
        owner = cluster_rank_of(np.array(list(sink.blocked), np.uint32), 2)
        checks = [agg["failed_ranks"] == [], agg["restarts"] == [0, 0],
                  sorted(reps) == [0, 1], rc.records == len(recs)]
        out = {"card": card, "records": len(recs), "per_shard": counts,
               "scenario": blk, "ranks": {}}
        for r in range(2):
            rep = reps.get(r, {}).get("report", {})
            cl = rep.get("cluster") or {}
            peer = (reps.get(1 - r, {}).get("report", {}).get("cluster")
                    or {})
            part = {k: np.float32(u).view(np.uint32).item()
                    for (k, u), o in zip(sink.blocked.items(), owner)
                    if o == r}
            launches = reps.get(r, {}).get("launches", {})
            same = {"records": rep.get("records") == counts[r],
                    "published_blacklist": cl.get("published_digest")
                    == map_digest(part),
                    "merged_converged": cl.get("merged_digest")
                    == peer.get("published_digest"),
                    "no_seq_gaps": cl.get("rx_seq_gaps") == 0,
                    "score_int8_per_batch": launches.get("score_int8")
                    == rep.get("batches"),
                    "table_summary": launches.get("table_summary", 0) >= 1,
                    "on_card": (rep.get("device") or {}).get("type")
                    == "cuda"}
            checks += same.values()
            out["ranks"][r] = {"equal": same, "batches": rep.get("batches"),
                               "launches": launches,
                               "group_hist": (rep.get("dispatch") or {}).get(
                                   "group_hist"),
                               "gossip": cl, "pid": reps[r].get("pid")
                               if r in reps else None}
        stats_sum = {f: sum(reps[r]["report"]["stats"][f] for r in reps)
                     for f in rc.stats} if len(reps) == 2 else {}
        tracked = sum(reps[r]["report"]["table"]["tracked"] for r in reps)
        checks += [stats_sum == rc.stats, tracked == rc.table["tracked"],
                   bool(sink.blocked)]
        out.update({"stats_additive": stats_sum == rc.stats,
                    "tracked_additive": tracked == rc.table["tracked"],
                    "cpu_blocked": len(sink.blocked)})
        served["launches_cluster"] = {
            f"cluster_parity/r{r}": out["ranks"][r]["launches"]
            for r in range(2)}
        return {"ok": all(checks), **out}

    cluster_parity_phase()

    @phase("cluster_serve")
    def cluster_serve_phase():
        """``cli cluster --engines 2 --shards 2 --mega auto --drain`` at
        full width over each prefilled scenario, in turns with one card
        engine with two workers over the same fan-out (single, cluster,
        cluster, single; ``--pin-cores off``, the single engine being
        unpinned too), then once with the default ``--pin-cores auto``
        on ``mixed_l34_1m``: records/s (the fleet's: total records over
        the slowest rank's drain wall), each rank's device ms per batch
        and idle share at the solo per-graph device times, the card's
        idle share, card memory per context, and each rank's boot."""
        out = {"card": card, "turns": {}, "batches": 4 * SERVE_BATCHES}
        checks = []
        for scen in ring_scen:
            # four times the ring phases' stream: the drain walls must
            # dwarf the ranks' start skew (a 384-batch drain takes ~0.3 s)
            long_recs = TrafficGen(TrafficSpec(
                scenario=Scenario(scen), rate_pps=1e6, seed=SEED)
            ).next_records(4 * SERVE_BATCHES * BATCH)
            res = out["turns"][scen] = {"cluster": [], "single": []}
            costs = None
            legs = ["single", "cluster", "cluster", "single"]
            if scen == "mixed_l34_1m":
                legs.append("cluster_pin_auto")
            for leg in legs:
                recs = long_recs.copy()
                base = os.path.join(cl_dir, f"serve_{scen}")
                if leg == "single":
                    counts, _ = fan_out(base, recs, slots=1 << 21)
                    r, e, sink, launches, mem = single_two_workers(base)
                    if costs is None:
                        costs = launch_costs(e)
                    busy = busy_ms(r.dispatch["group_hist"], costs)
                    checks += [r.records == len(recs),
                               launches["score_int8"] == r.batches]
                    res["single"].append({
                        "records_per_s": r.records_per_s,
                        "wall_s": r.wall_s, "batches": r.batches,
                        "group_hist": r.dispatch["group_hist"],
                        "device_ms_per_batch": busy / max(r.batches, 1),
                        "idle_share": 1 - busy / max(r.wall_s * 1e3, 1e-9),
                        "allocator_mib_after_warm": mem / 2**20,
                        "launches": launches})
                    del e
                    continue
                # the fleet's epoch is stamped at its boot: records after it
                recs["ts_ns"] += np.uint64(
                    time.clock_gettime_ns(time.CLOCK_MONOTONIC)
                    + 300 * 10**9 - int(recs["ts_ns"][0]))
                counts, _ = fan_out(base, recs, slots=1 << 21)
                plane = f"{base}.plane"
                shutil.rmtree(plane, ignore_errors=True)
                argv = [sys.executable, "-m", "flowsentryx_tpu_torch.cli",
                        "cluster", "--engines", "2", "--shards", "2",
                        "--mega", "auto", "--drain", "--feature-ring", base,
                        "--artifact", artifact, "--config", cl_cfg_path,
                        "--cluster-dir", plane, "--pin-cores",
                        "auto" if leg == "cluster_pin_auto" else "off"]
                free0 = torch.cuda.mem_get_info()[0]
                t = time.perf_counter()
                p = subprocess.Popen(argv, cwd=REPO, stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True)
                apps, fleet_mib = [], None
                ready = [os.path.join(plane, f"ready_r{r}") for r in (0, 1)]
                while p.poll() is None:
                    # card memory of the two contexts, once both are warm
                    if not apps and all(map(os.path.exists, ready)):
                        apps = compute_apps()
                        fleet_mib = (free0 - torch.cuda.mem_get_info()[0]
                                     ) / 2**20
                    time.sleep(0.05)
                so, se = p.communicate()
                wall = time.perf_counter() - t
                if p.returncode != 0:
                    raise RuntimeError(f"cli cluster exited {p.returncode}: "
                                       f"{se[-3000:]}")
                agg = json.loads(so)
                # the last fleet's plane stays for status_monitor_fleet
                served["fleet"] = {"plane": plane, "base": base, "agg": agg}
                reps = {x["rank"]: x for x in agg["reports"]}
                fleet_busy = 0.0
                ranks = {}
                for r in range(2):
                    rep = reps[r]["report"]
                    cl = rep["cluster"]
                    hist = rep["dispatch"]["group_hist"]
                    busy = busy_ms(hist, costs) if costs else None
                    fleet_busy += busy or 0.0
                    checks += [rep["records"] == counts[r],
                               reps[r]["launches"]["score_int8"]
                               == rep["batches"],
                               reps[r]["launches"]["table_summary"] >= 1,
                               cl["merged_digest"] == reps[1 - r]["report"][
                                   "cluster"]["published_digest"],
                               cl["rx_seq_gaps"] == 0,
                               rep["device"]["type"] == "cuda"]
                    b = rep["boot"] or {}
                    ranks[r] = {
                        "records": rep["records"], "wall_s": rep["wall_s"],
                        "records_per_s": rep["records_per_s"],
                        "batches": rep["batches"], "group_hist": hist,
                        "device_ms_per_batch": (busy / max(rep["batches"], 1)
                                                if busy is not None
                                                else None),
                        "idle_share": (1 - busy / max(rep["wall_s"] * 1e3,
                                                      1e-9)
                                       if busy is not None else None),
                        "launches": reps[r]["launches"],
                        "pid": reps[r]["pid"],
                        "boot": {k: b.get(k) for k in (
                            "import_s", "serving_ready_s",
                            "time_to_first_verdict_s", "kernels",
                            "captures")},
                        "gossip": {k: cl[k] for k in (
                            "published_sources", "merged_sources",
                            "tx_wires", "rx_wires", "tx_dropped")}}
                checks += [agg["failed_ranks"] == [],
                           agg["records"] == len(recs)]
                res.setdefault(leg, []).append({
                    "records_per_s": agg["aggregate_records_per_s"],
                    "max_wall_s": agg["max_wall_s"],
                    "process_wall_s": wall,
                    "card_idle_share": (1 - fleet_busy
                                        / max(agg["max_wall_s"] * 1e3, 1e-9)
                                        if costs else None),
                    "compute_apps_mib": apps,
                    "card_mib_per_context": (fleet_mib / 2
                                             if fleet_mib is not None
                                             else None),
                    "ranks": ranks,
                    "health": agg["health"]["state"]})
                served.setdefault("launches_cluster", {})[
                    f"cluster_serve/{scen}/{leg}/{len(res[leg])}"] = {
                    k: sum(reps[r]["launches"][k] for r in (0, 1))
                    for k in reps[0]["launches"]}
            c = [x["records_per_s"] for x in res["cluster"]]
            s = [x["records_per_s"] for x in res["single"]]
            res["fleet_over_single"] = (sum(c) / len(c)) / (sum(s) / len(s))
        return {"ok": all(checks), **out}

    cluster_serve_phase()

    @phase("status_monitor_fleet")
    def fleet_read_phase():
        """``cli status`` and ``cli monitor`` over the rank reports the
        last ``cluster_serve`` fleet wrote (each a subprocess, as an
        operator runs them): the merged seal -> verdict count equals the
        sum of the ranks', the merges equal the supervisor's
        ``aggregate()`` of that fleet, the p99 alert fires, and the
        degraded alert fires exactly when a rank is not healthy."""
        fleet = served["fleet"]
        plane, agg = fleet["plane"], fleet["agg"]
        glob = os.path.join(plane, "report_r*_g*.json")
        ring0 = schema.shard_ring_path(fleet["base"], 0, 2)
        cli_argv = [sys.executable, "-m", "flowsentryx_tpu_torch.cli"]
        t = time.perf_counter()
        st = subprocess.run(cli_argv + [
            "status", "--engine-report", glob, "--feature-ring", ring0,
            "--verdict-ring", os.path.join(plane, "no_verdict_ring")],
            cwd=REPO, capture_output=True, text=True, timeout=120)
        status_s = time.perf_counter() - t
        if st.returncode != 0:
            raise RuntimeError(f"cli status exited {st.returncode}: "
                               f"{st.stderr[-2000:]}")
        status = json.loads(st.stdout)
        history = os.path.join(plane, "monitor.jsonl")
        t = time.perf_counter()
        mo = subprocess.run(cli_argv + [
            "monitor", "--count", "2", "--interval", "0.1",
            "--alert-p99-us", "1", "--alert-degraded",
            "--engine-report", glob, "--out", history],
            cwd=REPO, capture_output=True, text=True, timeout=120)
        monitor_s = time.perf_counter() - t
        if mo.returncode != 0:
            raise RuntimeError(f"cli monitor exited {mo.returncode}: "
                               f"{mo.stderr[-2000:]}")
        records = [json.loads(x) for x in mo.stdout.splitlines()]
        ranks = {r["rank"]: r["report"] for r in agg["reports"]}
        rank_n = sum(rep["latency"]["seal_to_verdict"]["n"]
                     for rep in ranks.values())
        merged = status["latency"]["seal_to_verdict_us"]
        boot = status.get("boot") or {}
        degraded = status["health"]["state"] != "healthy"
        with open(history) as f:
            logged = [json.loads(x) for x in f]
        same = {
            "seal_to_verdict_n_is_ranks_sum": merged["n"] == rank_n,
            "latency_equals_aggregate":
                merged == agg["latency"]["seal_to_verdict"],
            "predict_equals_aggregate": status.get("predict")
            == agg["predict"],
            "boot_equals_aggregate": list(boot.get("per_report", {})
                                          .values())
            == list((agg["boot"] or {}).get("per_rank", {}).values())
            and all(boot.get(k) == agg["boot"][k] for k in (
                "cache_hits", "cache_misses", "cache_stores",
                "max_serving_ready_s")),
            "health_equals_aggregate": status["health"]["state"]
            == agg["health"]["state"],
            "feature_ring_drained": status["feature_ring"]["backlog"] == 0
            and status["feature_ring"]["produced"] > 0,
            "two_records": len(records) == 2 and logged == records,
            "p99_alert_fired": all(any(a.startswith("engine p99 latency")
                                       for a in r.get("alerts", ()))
                                   for r in records),
            "degraded_alert_iff_degraded": all(
                any(a.startswith("engine health") for a in r.get(
                    "alerts", ())) == degraded for r in records),
            "kernel_key_says_no_maps": all(
                list(r["kernel"]) == ["error"] for r in records),
            "monitor_equals_status": all(
                r["latency"] == status["latency"]
                and r["health"] == status["health"] for r in records)}
        return {"ok": all(same.values()), "card": card, "checks": same,
                "reports": sorted(os.path.basename(p) for p in
                                  status["latency"]["per_report"]),
                "merged_seal_to_verdict_us": merged,
                "ranks_records": sum(rep["records"]
                                     for rep in ranks.values()),
                "per_rank_p99_us": agg["latency"]["per_rank_p99"],
                "health": status["health"]["state"],
                "alerts": records[0].get("alerts") if records else None,
                "status_s": status_s, "monitor_s": monitor_s}

    fleet_read_phase()

    @phase("cluster_crash_restart")
    def crash_phase():
        """Two rank processes serve a live, trickle-fed fan-out with
        checkpoints every 0.25 s; rank 1's process group is SIGKILLed
        mid-serve.  Its context's card memory is released, the
        supervisor restarts it at gen 1 from its checkpoint (the time
        from the kill to the new generation SERVING), the survivor
        serves every record of its shard meanwhile, and still holds the
        dead rank's blocks (it merged gen 0's wires: more than gen 1
        ever sent)."""
        recs = ring_recs[blk]
        t0 = int(recs["ts_ns"].min())
        base = os.path.join(cl_dir, "crash")
        sh = schema.shard_of(recs["saddr"], 2)
        parts = [recs[sh == k] for k in range(2)]
        rings = [ShmRing.create(schema.shard_ring_path(base, k, 2), 1 << 20,
                                schema.FLOW_RECORD_DTYPE) for k in range(2)]
        plane = os.path.join(cl_dir, "crash.plane")
        sup = ClusterSupervisor(plane, rank_specs(
            base, chunk_s=0.1, gossip_quiesce_s=4.0, checkpoint_every=0.25),
            t0_ns=t0)
        for r, spec in enumerate(sup.specs):
            spec["checkpoint"] = os.path.join(cl_dir, f"crash_ckpt_r{r}.npz")
        sup.boot()
        status = [StatusBlock(status_path(plane, r)) for r in range(2)]
        produced, cursor = [0, 0], [0, 0]
        pre_kill = [int(0.4 * len(p)) for p in parts]
        checks, out = [], {"card": card, "scenario": blk}

        def feed(n, cap=None):
            for k, ring in enumerate(rings):
                lim = len(parts[k]) if cap is None else cap[k]
                part = parts[k][cursor[k]:min(cursor[k] + n, lim)]
                if len(part):
                    wrote = ring.produce(part)
                    cursor[k] += wrote
                    produced[k] += wrote

        try:
            feed(BATCH * 8, pre_kill)
            ckpt1 = sup.specs[1]["checkpoint"]
            deadline = time.monotonic() + 240
            # killable: serving, its pre-kill budget served, blocks
            # published to rank 0 and a checkpoint on disk
            to_r0 = VerdictMailbox(mailbox_path(plane, 1, 0))
            while not (status[1].ctl_get("c_state") == wire.CSTATE_SERVING
                       and status[1].ctl_get("c_records") >= pre_kill[1]
                       and to_r0.published() > 0
                       and os.path.exists(ckpt1)):
                assert time.monotonic() < deadline, "rank 1 never killable"
                if (status[1].ctl_get("c_records") >= pre_kill[1]
                        and not to_r0.published()):
                    # no block yet: feed rank 1 on, up to 80% of its shard
                    pre_kill[1] = min(len(parts[1]) * 4 // 5,
                                      pre_kill[1] + 4 * BATCH)
                sup.poll()
                feed(BATCH, pre_kill)
                time.sleep(0.05)
            apps_before = compute_apps()
            free_before = torch.cuda.mem_get_info()[0]
            pid1 = status[1].ctl_get("c_pid")
            r0_before = status[0].ctl_get("c_records")
            t_kill = time.perf_counter()
            sup.kill(1)
            sup.poll()                    # the corpse seen, respawn queued
            # the killed context gone from the card and its memory free
            # again (before gen 1 creates its own)
            apps_after, t_rel = apps_before, None
            free_after = free_before
            while time.perf_counter() - t_kill < 3.0:
                apps_after = compute_apps()
                free_after = torch.cuda.mem_get_info()[0]
                if (len(apps_after) == len(apps_before) - 1
                        and free_after > free_before):
                    t_rel = time.perf_counter() - t_kill
                    break
                time.sleep(0.05)
            # the survivor serves the outage window's traffic
            t_serving = None
            spawned = False
            deadline = time.monotonic() + 240
            while time.monotonic() < deadline:
                sup.poll()
                feed(BATCH)
                st1 = status[1].ctl_get("c_state")
                if (not spawned and sup.restarts[1] >= 1
                        and status[1].ctl_get("c_gen") == 1
                        and st1 == wire.CSTATE_SPAWNING):
                    spawned = True
                if spawned and st1 == wire.CSTATE_SERVING:
                    t_serving = time.perf_counter() - t_kill
                    break
                time.sleep(0.01)
            r0_during = status[0].ctl_get("c_records")
            feed(len(recs))
            deadline = time.monotonic() + 120
            while (status[0].ctl_get("c_records") < produced[0]
                   or rings[1].readable()) and time.monotonic() < deadline:
                sup.poll()
                time.sleep(0.05)
            sup.request_stop()
            agg = sup.run(drain_timeout_s=120)
        finally:
            sup.close()
        reps = {(r["rank"], r["gen"]): r for r in agg["reports"]}
        r0 = reps.get((0, 0), {}).get("report", {})
        g1 = reps.get((1, 1), {})
        cl0 = r0.get("cluster") or {}
        cl1 = (g1.get("report") or {}).get("cluster") or {}
        checks += [agg["restarts"] == [0, 1], agg["failed_ranks"] == [],
                   t_serving is not None, t_rel is not None,
                   bool(g1.get("restored")),
                   (g1.get("report") or {}).get("records", 0) > 0,
                   r0.get("records") == produced[0],
                   r0_during > r0_before,
                   rings[1].readable() == 0,
                   cl0.get("merged_sources", 0) > 0,
                   cl0.get("rx_wires", 0) > cl1.get("tx_wires", 0),
                   r0.get("blocked_sources", 0) > 0]
        out.update({
            "produced": produced, "restarts": agg["restarts"],
            "kill_to_serving_s": t_serving,
            "kill_to_memory_released_s": t_rel,
            "compute_apps_mib_before": apps_before,
            "compute_apps_mib_after_kill": apps_after,
            # nvidia-smi's per-process memory in a container may repeat
            # one value per line; the card's free memory is the measure
            "released_mib": (free_after - free_before) / 2**20,
            "killed_pid": pid1,
            "card_free_mib_before_kill": free_before / 2**20,
            "card_free_mib_after_kill": free_after / 2**20,
            "survivor_records": r0.get("records"),
            "survivor_records_before_kill": r0_before,
            "survivor_records_during_outage": r0_during - r0_before,
            "gen1_restored": g1.get("restored"),
            "gen1_records": (g1.get("report") or {}).get("records"),
            "gen1_boot": {k: ((g1.get("report") or {}).get("boot") or {})
                          .get(k) for k in ("import_s", "serving_ready_s",
                                            "time_to_first_verdict_s")},
            "survivor_gossip": cl0, "gen1_gossip": cl1})
        served.setdefault("launches_cluster", {}).update({
            f"cluster_crash_restart/r{r}g{g}": rep.get("launches", {})
            for (r, g), rep in reps.items()})
        return {"ok": all(checks), **out}

    crash_phase()

    def build_daemon():
        """``make -C daemon`` (into ``daemon/build/``); if the compiler
        trips ``-Werror``, once more with the Makefile's flags without
        it; without ``make``, the Makefile's ``g++`` line by hand."""
        ddir = os.path.join(REPO, "daemon")
        relaxed = "-O2 -std=c++17 -Wall -Wextra -I../kern"
        if shutil.which("make"):
            tries = [(["make", "-C", ddir], "make"),
                     (["make", "-C", ddir, f"CXXFLAGS={relaxed}"],
                      f"make CXXFLAGS={relaxed}")]
        else:
            os.makedirs(os.path.join(ddir, "build"), exist_ok=True)
            line = ["g++", *relaxed.split(), "fsxd.cpp", "-o",
                    "build/fsxd", "-lpthread"]
            tries = [(line, " ".join(line))]
        for cmd, label in tries:
            r = subprocess.run(cmd, cwd=ddir, capture_output=True,
                               text=True, timeout=300)
            if r.returncode == 0:
                return label
        raise RuntimeError(f"daemon build failed: {r.stderr[-2000:]}")

    def kernel_compact(rec, now_ns):
        """48-byte records as a compact-emit kernel writes them: minifloat
        features, length in 8-byte units, flags, the low 16 bits of the µs
        clock (the last record stamped ``now_ns``)."""
        out = np.zeros(len(rec), schema.COMPACT_RECORD_DTYPE)
        q = schema.quantize_feat_minifloat(rec["feat"])
        out["w0"] = rec["saddr"]
        out["w1"] = q[:, 0] | q[:, 1] << 8 | q[:, 2] << 16 | q[:, 3] << 24
        out["w2"] = q[:, 4] | q[:, 5] << 8 | q[:, 6] << 16 | q[:, 7] << 24
        len8 = np.minimum((rec["pkt_len"].astype(np.uint32) + 4) >> 3, 2047)
        ts = (np.uint64(now_ns) - (rec["ts_ns"][-1] - rec["ts_ns"])) // 1000
        out["w3"] = (len8 | (rec["flags"].astype(np.uint32) & 0x1F) << 11
                     | (ts & np.uint64(0xFFFF)).astype(np.uint32) << 16)
        return out

    @phase("daemon_loop")
    def daemon_phase():
        flags = build_daemon()
        fsxd = os.path.join(REPO, "daemon", "build", "fsxd")
        dcfg = dataclasses.replace(
            cfg, batch=dataclasses.replace(cfg.batch, deadline_us=2000,
                                           readback_depth=2),
            limiter=dataclasses.replace(cfg.limiter, pps_threshold=300.0,
                                        bps_threshold=1e12, block_s=1e6),
            model=dataclasses.replace(cfg.model, ml_block_s=1e6))
        out, checks = {"card": card, "make": flags}, []
        for mode in ("48B", "compact"):
            fring = os.path.join(shm_dir, f"fsxd_{mode}.fring")
            vring = os.path.join(shm_dir, f"fsxd_{mode}.vring")
            proc = subprocess.Popen(
                [fsxd, "--sim", "--duration", "6", "--rate", "2e5",
                 "--attack-ips", "16", "--attack-fraction", "0.8",
                 "--feature-ring", fring, "--verdict-ring", vring,
                 "--seed", "7"], stdout=subprocess.PIPE,
                stderr=subprocess.DEVNULL, text=True)
            stop = threading.Event()
            relayed = [0]
            try:
                src_path = fring
                if mode == "compact":
                    # fsxd emits 16-byte records only from a compact-emit
                    # kernel image (--bpf); the relay writes what that
                    # kernel writes, from the daemon's 48-byte ring
                    src_path = fring + ".c16"
                    ShmRing.create(src_path, 1 << 16,
                                   schema.COMPACT_RECORD_DTYPE)

                    def relay():
                        a = ShmRing.wait_for(fring, schema.FLOW_RECORD_DTYPE)
                        b_ = ShmRing(src_path, schema.COMPACT_RECORD_DTYPE)
                        while not stop.is_set():
                            rec = a.consume(4096)
                            if len(rec):
                                c16 = kernel_compact(rec, time.clock_gettime_ns(
                                    time.CLOCK_MONOTONIC))
                                done = 0
                                while done < len(c16) and not stop.is_set():
                                    n = b_.produce(c16[done:])
                                    done += n
                                    if not n:      # ring full: yield
                                        time.sleep(0.0002)
                                relayed[0] += done
                            else:
                                time.sleep(0.0002)

                    th = threading.Thread(target=relay, daemon=True)
                    th.start()
                sink = ShmVerdictSink(vring)
                e = Recording(dcfg, ShmRingSource(src_path), sink,
                              device="cuda")
                e.warm()
                e.start_log()
                r = e.run(max_seconds=7)
                torch.cuda.synchronize()
            finally:
                stop.set()
                so, _ = proc.communicate(timeout=30)
            d = json.loads(so.strip().splitlines()[-1])
            res = {"engine": {"batches": r.batches, "records": r.records,
                              "stats": r.stats, "wire": e.wire,
                              "precompact": e.precompact,
                              "quant": e.quant},
                   "daemon": {k: d.get(k) for k in (
                       "produced", "dropped_ring_full", "verdicts",
                       "blacklisted", "suppressed")},
                   "sink_dropped": sink.dropped}
            checks += [r.stats["dropped"] > 0, d["verdicts"] > 0,
                       d["blacklisted"] > 0, d["suppressed"] > 0,
                       sink.dropped == 0, r.batches > 0]
            if mode == "compact":
                res["relayed"] = relayed[0]
                rc, ec = replay_cpu(e.log, precompact=True, c=dcfg,
                                    params=logreg.golden_params("cpu"))
                same = {"stats": r.stats == rc.stats,
                        "table_digest": digest(e) == digest(ec),
                        "wires": len(e.wires) == len(ec.wires) and all(
                            np.array_equal(a, b_)
                            for a, b_ in zip(e.wires, ec.wires))}
                res["equal_cpu_step"] = same
                checks += [*same.values(), e.precompact,
                           e.wire == schema.WIRE_COMPACT16]
            out[mode] = res
        return {"ok": all(checks), **out}

    daemon_phase()

    @phase("checkpoint_restore")
    def checkpoint_phase():
        half = SERVE_BATCHES // 2 * BATCH
        path = os.path.join(shm_dir, "ckpt.npz")
        params = logreg.load_params(artifact, "cuda")

        def card_engine(recs):
            return Engine(ring_cfg, ArraySource(recs.copy()), CollectSink(),
                          params=params, device="cuda")

        recs = ring_recs[blk]
        e1 = card_engine(recs[:half])
        e1.warm()
        e1.run()
        e1.checkpoint(path)
        e1.checkpoint(path)            # the first generation -> .prev
        ck = ckpt.load_checkpoint(ckpt.prev_path(path))
        pairs_ok = (all(v.dtype == np.uint32 and v.shape == (2,)
                        for v in ck.stats.values())
                    and ck.stats["batches"].tolist() == [SERVE_BATCHES // 2,
                                                         0])
        full = card_engine(recs)
        full.run()
        want_card = (full.stats.to_dict(), digest(full),
                     sorted(full.sink.blocked.items()))
        cpu = served.get("ring_cpu", {}).get(blk, {})
        out, checks = {"card": card, "scenario": blk}, [pairs_ok]
        for label in ("clean", "corrupt_to_prev"):
            if label == "corrupt_to_prev":
                raw = bytearray(open(path, "rb").read())
                raw[len(raw) // 2] ^= 0x5A
                open(path, "wb").write(bytes(raw))
            e2 = card_engine(recs[half:])
            e2.warm()                  # graphs captured before the restore
            ptrs = (e2.table.key_rows.data_ptr(),
                    e2.table.state_rows.data_ptr(),
                    e2.stats.batches.data_ptr())
            info = e2.restore(path)
            same_ptrs = ptrs == (e2.table.key_rows.data_ptr(),
                                 e2.table.state_rows.data_ptr(),
                                 e2.stats.batches.data_ptr())
            restored = e2.stats.to_dict()["batches"]
            kernels.reset_launches()
            r = e2.run()
            torch.cuda.synchronize()
            launches = dict(kernels.LAUNCHES)
            blocked = sorted({**e1.sink.blocked, **e2.sink.blocked}.items())
            got = (e2.stats.to_dict(), digest(e2), blocked)
            same = {"card_uninterrupted": got == want_card,
                    "cpu_stats": r.stats == cpu.get("stats"),
                    "cpu_digest": got[1] == cpu.get("digest"),
                    "cpu_blacklist": blocked == cpu.get("blocked")}
            checks.append(len(blocked) > 0)
            checks += [*same.values(), same_ptrs,
                       restored == SERVE_BATCHES // 2,
                       launches["score_int8"] == r.batches,
                       info["fallback_from"] == (
                           path if label == "corrupt_to_prev" else None)]
            out[label] = {"equal": same, "pointers_unchanged": same_ptrs,
                          "restored_batches": restored,
                          "served_after": r.batches, "info": info,
                          "launches": launches}
        out["prev_stats_pairs"] = {k: v.tolist()
                                   for k, v in ck.stats.items()}
        return {"ok": all(checks), **out}

    checkpoint_phase()

    # -- the latency plane, latency-budget dispatch, the watchdog -------------

    from flowsentryx_tpu_torch.benchmarks import (
        paced_latency_run, summarize_latencies,
    )
    from flowsentryx_tpu_torch.engine import PacedSource, health
    from flowsentryx_tpu_torch.engine.watchdog import WatchdogStall

    def lat_summary(r):
        """The engine's seal -> verdict block: µs percentiles, the stage
        split's p50/p99, negatives (and the budget's misses)."""
        lat = r.latency
        return {"seal_to_verdict_us": lat["seal_to_verdict"],
                "stages_us": {k: {q: v.get(q) for q in ("p50", "p99")}
                              for k, v in lat["stages"].items()},
                "negatives": lat["negatives"],
                "compute_is_wall": lat["compute_is_wall"],
                **({"slo": lat["slo"]} if "slo" in lat else {})}

    def chunks(r):
        """Batches the run dispatched, masked pre-warms included (each
        launches the scorer once per batch)."""
        return sum(int(g) * c for g, c in r.dispatch["group_hist"].items())

    @phase("latency_plane")
    def latency_phase():
        params = logreg.load_params(artifact, "cuda")
        out, checks = {"card": card, "batches": SERVE_BATCHES}, []
        served["launches_latency"] = {}
        for scen in ring_scen:
            cpu = served.get("ring_cpu", {}).get(scen)
            recs = ring_recs[scen]
            out[scen] = {}
            for label, mega_n in (("single", 0), ("auto", "auto")):
                for st in (True, False):
                    tag = f"{label}/{'sink_thread' if st else 'inline_sink'}"
                    fpath = feature_ring(f"lat_{label}", recs)
                    vpath, vring = verdict_ring(f"lat_{label}")
                    sink = TeeSink(vpath)
                    e = Engine(ring_cfg, ShmRingSource(fpath), sink,
                               params=params, device="cuda", mega_n=mega_n,
                               sink_thread=st)
                    e.warm()
                    kernels.reset_launches()      # this path's window opens
                    r = e.run(max_batches=SERVE_BATCHES)
                    torch.cuda.synchronize()
                    launches = dict(kernels.LAUNCHES)   # ... and closes
                    served["launches_latency"][f"{scen}/{tag}"] = launches
                    verdicts = vring.consume(1 << 18)
                    same = {"stats": cpu is not None
                            and r.stats == cpu["stats"],
                            "table_digest": cpu is not None
                            and digest(e) == cpu["digest"],
                            "blacklist": cpu is not None
                            and sorted(sink.collect.blocked.items())
                            == cpu["blocked"],
                            "verdict_ring": cpu is not None
                            and verdicts.tobytes() == cpu["verdicts"]}
                    lat = r.latency
                    checks += [*same.values(), lat["negatives"] == 0,
                               lat["seal_to_verdict"]["n"] == r.records,
                               r.records == SERVE_BATCHES * BATCH,
                               launches["score_int8"] == r.batches,
                               launches["table_summary"] == 1,
                               r.readback["sink_thread"] is st,
                               r.health["state"] == "healthy"]
                    out[scen][tag] = {
                        **per_batch(r), "equal_cpu": same,
                        "launches": launches, **lat_summary(r),
                        "sink_occupancy": r.readback["sink_occupancy"],
                        "group_hist": r.dispatch["group_hist"]}
        # one spawned worker: the batches carry the worker's shm seal
        # stamp (CLOCK_MONOTONIC, the perf_counter clock) minus its fill
        r1, e1, s1, v1, l1 = sealed_run("lat_ingest1", 1, ring_recs[blk])
        inline = served.get("ring_single", {}).get(blk)
        same1 = {"stats": inline is not None
                 and r1.stats == inline["report"].stats,
                 "table_digest": inline is not None
                 and digest(e1) == inline["digest"],
                 "verdict_ring": inline is not None
                 and v1.tobytes() == inline["verdicts"].tobytes()}
        lat = r1.latency
        checks += [*same1.values(), lat["negatives"] == 0,
                   lat["seal_to_verdict"]["n"] == r1.records,
                   l1["score_int8"] == r1.batches]
        served["launches_latency"]["ingest_1"] = l1
        out["ingest_1_worker"] = {"scenario": blk, **per_batch(r1),
                                  "equal_inline_ring": same1,
                                  "launches": l1, **lat_summary(r1),
                                  "health": r1.health}
        return {"ok": all(checks), **out}

    latency_phase()

    #: The reference's pulse tier: 96-record pulses every 7.5 ms (12.8 k
    #: records/s mean), each pulse's records released at once, a
    #: drain-tuned 5 ms batcher deadline against a 2 ms budget.
    PULSE_PERIOD_S, PULSE_RECORDS, PULSE_TRIAL_S = 0.0075, 96, 1.0
    SLO_US = 2000
    pulse_cfg = dataclasses.replace(ring_cfg, batch=dataclasses.replace(
        ring_cfg.batch, deadline_us=5000))
    pulse_pool = ring_recs[blk]

    def pulse_engine(slo_us, predict=False):
        e = Recording(pulse_cfg, ArraySource(pulse_pool[:0]), CollectSink(),
                      params=logreg.load_params(artifact, "cuda"),
                      device="cuda", mega_n="auto", slo_us=slo_us,
                      predict=predict)
        e.warm()
        e.start_log()
        return e

    def partition(e):
        """The valid-record count of every batch the engine dispatched,
        in order (the governor's masked pre-warms left out)."""
        return [n for n in (int(b[-1, 0]) for b in e.log) if n]

    def arm_checks(arms):
        """The batch partition of a paced arm is the host's timing (a
        host stall past the 2.5 ms between the 5 ms deadline and the
        next pulse merges two pulses into one batch).  Each arm must
        equal the CPU engine fed the batches it dispatched; arms that
        dispatched the same partition must be byte-equal."""
        out, checks = {}, []
        for k, e in arms.items():
            rc, ec = replay_cpu(e.log, c=pulse_cfg)
            same = {"stats": e.stats.to_dict() == ec.stats.to_dict(),
                    "table_digest": digest(e) == digest(ec),
                    "blacklist": sorted(e.sink.blocked.items())
                    == sorted(ec.sink.blocked.items())}
            checks += same.values()
            out[str(k)] = {"equal_cpu_replay": same,
                           "batches": len(e.log)}
        keys = list(arms)
        for a in keys[1:]:
            ident = partition(arms[keys[0]]) == partition(arms[a])
            equal = pulse_state(arms[keys[0]]) == pulse_state(arms[a])
            out[f"{keys[0]}_vs_{a}"] = {"partition_identical": ident,
                                        "state_equal": equal}
            if ident:
                checks.append(equal)
        return out, checks

    def pulse_trial(e):
        n = PULSE_RECORDS * int(PULSE_TRIAL_S / PULSE_PERIOD_S)
        src = PacedSource(pulse_pool, rate_pps=PULSE_RECORDS / PULSE_PERIOD_S,
                          total=n, burst_period_s=PULSE_PERIOD_S,
                          duty_cycle=1e-7)
        lats, wall, r = paced_latency_run(e, src, max_seconds=30.0)
        s = summarize_latencies(lats)
        s["miss_fraction_2ms"] = float((lats > SLO_US * 1e-6).mean())
        return r, s

    def pulse_state(e):
        return (e.stats.to_dict(), digest(e), sorted(e.sink.blocked.items()))

    @phase("slo_pulse")
    def slo_phase():
        arms = {0: pulse_engine(0), SLO_US: pulse_engine(SLO_US)}
        trials = {k: [] for k in arms}
        batches = {k: [] for k in arms}
        served_chunks = 0
        kernels.reset_launches()                  # this path's window opens
        for pair in range(4):
            order = (0, SLO_US) if pair % 2 == 0 else (SLO_US, 0)
            for k in order:
                r, s = pulse_trial(arms[k])
                served_chunks += chunks(r)
                batches[k].append(r.batches)
                trials[k].append({**s, "engine": lat_summary(r),
                                  "batches": r.batches,
                                  "group_hist": r.dispatch["group_hist"]})
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)          # ... and closes
        served["launches_slo_pulse"] = launches
        served["pulse_arm_slo0"] = arms[0]
        equal, checks = arm_checks(arms)
        med = {k: {q: float(np.median([t[q] for t in v]))
                   for q in ("p50_ms", "p99_ms", "p999_ms",
                             "miss_fraction_2ms")}
               for k, v in trials.items()}
        checks += [launches["score_int8"] == served_chunks,
                  all(t["engine"]["negatives"] == 0
                      for v in trials.values() for t in v),
                  all(t["n"] == t["engine"]["seal_to_verdict_us"]["n"]
                      for v in trials.values() for t in v)]
        # the saturated drain: an existing backlog is never capped
        recs = ring_recs[blk]
        steady, steady_state = {0: [], SLO_US: []}, {}
        for k in (0, SLO_US, SLO_US, 0):
            fpath = feature_ring(f"steady_{k}", recs)
            e = Engine(ring_cfg, ShmRingSource(fpath), CollectSink(),
                       params=logreg.load_params(artifact, "cuda"),
                       device="cuda", mega_n="auto", slo_us=k)
            e.warm()
            r = e.run(max_batches=SERVE_BATCHES)
            steady[k].append(r.records_per_s)
            steady_state.setdefault(k, (r.stats, digest(e)))
        ratio = float(np.mean(steady[SLO_US]) / np.mean(steady[0]))
        checks.append(steady_state[0] == steady_state[SLO_US])
        return {"ok": all(checks), "card": card, "slo_us": SLO_US,
                "pulse": {"period_ms": PULSE_PERIOD_S * 1e3,
                          "records": PULSE_RECORDS,
                          "deadline_us": pulse_cfg.batch.deadline_us,
                          "trial_s": PULSE_TRIAL_S},
                "state": equal, "batches": batches,
                "median_per_arm": med, "trials": trials,
                "launches": launches, "dispatched_chunks": served_chunks,
                "rung_ewma_ms": arms[SLO_US]._rung_ewma_s and {
                    str(g): v * 1e3
                    for g, v in arms[SLO_US]._rung_ewma_s.items()},
                "steady_records_per_s": steady,
                "steady_ratio_slo_over_0": ratio,
                "steady_state_equal": steady_state[0] == steady_state[SLO_US]}

    slo_phase()

    @phase("predict_pulse")
    def predict_phase():
        e = pulse_engine(SLO_US, predict=True)
        trials, served_chunks = [], 0
        kernels.reset_launches()                  # this path's window opens
        for _ in range(4):
            r, s = pulse_trial(e)
            served_chunks += chunks(r)
            trials.append({**s, "engine": lat_summary(r),
                           "batches": r.batches, "predict": r.predict,
                           "group_hist": r.dispatch["group_hist"]})
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)          # ... and closes
        served["launches_predict_pulse"] = launches
        arm0 = served.get("pulse_arm_slo0")
        equal, checks = arm_checks({0: arm0, "predict": e} if arm0
                                   else {"predict": e})
        checks += [arm0 is not None, launches["score_int8"] == served_chunks,
                  all(t["engine"]["negatives"] == 0 for t in trials),
                  any(t["predict"]["forecasts"] > 0 for t in trials)]
        med = {q: float(np.median([t[q] for t in trials]))
               for q in ("p50_ms", "p99_ms", "p999_ms", "miss_fraction_2ms")}
        return {"ok": all(checks), "card": card, "slo_us": SLO_US,
                "state": equal, "median": med, "trials": trials,
                "launches": launches, "dispatched_chunks": served_chunks}

    predict_phase()

    @phase("watchdog_stall")
    def watchdog_phase():
        params = logreg.load_params(artifact, "cuda")
        recs = ring_recs[blk][:96 * BATCH]
        out, checks = {"card": card}, []
        for st in (True, False):
            e = Engine(ring_cfg, ArraySource(recs.copy()), CollectSink(),
                       params=params, device="cuda", watchdog_s=0.5,
                       sink_thread=st)
            e.warm()
            # wedge the step's stream: every replay queues behind ~5 s
            torch.cuda._sleep(int(5.0 * 2e9))
            t = time.perf_counter()
            err = None
            try:
                e.run()
            except WatchdogStall as exc:
                err = exc
            back_s = time.perf_counter() - t
            wd = e._watchdog.to_dict()
            state = health.engine_health(watchdog=wd)["state"]
            torch.cuda.synchronize()
            # the abandoned sink thread drains once the stream moves on
            for th in threading.enumerate():
                if th.name == "fsx-sink":
                    th.join(timeout=30)
            checks += [err is not None, wd["soft_trips"] == 1,
                       wd["hard_tripped"], state == "failed",
                       back_s < 4.0]
            out["sink_thread" if st else "inline_sink"] = {
                "raised": repr(err), "returned_after_s": back_s,
                "watchdog": wd, "health": state}
        res = {}
        for wd in (None, 0.0):
            e = Engine(ring_cfg, ArraySource(recs.copy()), CollectSink(),
                       params=params, device="cuda", watchdog_s=wd)
            e.warm()
            r = e.run()
            res[wd] = (r.stats, digest(e), sorted(e.sink.blocked.items()),
                       r.health)
        checks += [res[None] == res[0.0],
                   res[None][3]["state"] == "healthy"]
        out["defaults_equal_disabled"] = res[None] == res[0.0]
        return {"ok": all(checks), **out}

    watchdog_phase()

    # -- the live model swap, the simulated kernel tier, pcap,
    # -- --verdict-k, the profiler, a restore at 2^20 rows --------------------

    from flowsentryx_tpu_torch import cli
    from flowsentryx_tpu_torch.distill import SimKernelTier, load_plan
    from flowsentryx_tpu_torch.models.registry import get_model

    plan_path = os.path.join(os.path.dirname(artifact),
                             "logreg_int8_plan.npz")

    def derived_params(device="cpu"):
        """A second int8 artifact made from the seed with numpy:
        ``logreg_int8.npz``'s input observer (``in_scale``, ``in_zp``,
        ``log1p``), other weights and bias."""
        h = dict(np.load(artifact))
        r = np.random.default_rng(SEED + 7)
        h["w_int8"] = r.integers(-127, 128, 8).astype(np.int8)
        h["bias"] = np.float32(h["bias"] + r.normal())
        return logreg.params_from_numpy(h, device)

    def state_of(e):
        """Stats, table digest and blacklist (a tee sink's collector)."""
        sink = getattr(e.sink, "collect", e.sink)
        return {"stats": e.stats.to_dict(), "digest": digest(e),
                "blocked": sorted(sink.blocked.items())}

    def cpu_swapped(c, recs, boot, new, k, label=None, **kw):
        """The CPU engine over the same records, swapped after batch
        ``k`` (with a verdict ring when ``label`` names one)."""
        vring, sink = None, CollectSink()
        if label:
            vpath, vring = verdict_ring(label)
            sink = TeeSink(vpath)
        e = Engine(c, ArraySource(recs.copy()), sink, params=boot,
                   device="cpu", **kw)
        with cpu_threads():
            e.run(max_batches=k)
            e.hot_swap(new)
            e.run()
        out = state_of(e)
        if label:
            out["verdicts"] = vring.consume(1 << 18).tobytes()
        return out

    WATCH_BATCHES, WATCH_AT = 768, 256

    @phase("hot_swap_live")
    def hot_swap_phase():
        boot, new = logreg.load_params(artifact), derived_params()
        new_dev = derived_params("cuda")
        recs = ring_recs[blk]
        half = SERVE_BATCHES // 2
        out = {"card": card, "scenario": blk, "batches": SERVE_BATCHES,
               "artifacts": "logreg_int8.npz -> derived (same observer)"}
        checks = []
        served["launches_hot_swap"] = {}
        cpu_at: dict = {}
        x = serving_batch(new_dev, blk)
        codes = torch.arange(256, dtype=torch.float32, device=dev)
        # 1. a swap at a batch index, from the 48-byte ring, singles and
        #    auto, against the CPU engine swapped at the same index
        for label, mega_n in (("single", 0), ("auto", "auto")):
            fpath = feature_ring(f"swap_{label}", recs)
            vpath, vring = verdict_ring(f"swap_{label}")
            sink = TeeSink(vpath)
            e = Engine(ring_cfg, ShmRingSource(fpath), sink, params=boot,
                       device="cuda", mega_n=mega_n)
            e.warm()
            graphs, n_cap = dict(e._graphs), graph.CAPTURES
            ptrs = [t.data_ptr() for t in e.params]
            args_ptr = e.score_params.args_ptr
            kernels.reset_launches()          # this path's window opens
            e.run(max_batches=half)
            t = time.perf_counter()
            e.hot_swap(new)
            swap_host_us = (time.perf_counter() - t) * 1e6
            r = e.run(max_batches=SERVE_BATCHES)
            torch.cuda.synchronize()
            launches = dict(kernels.LAUNCHES)  # ... and closes
            served["launches_hot_swap"][label] = launches
            verdicts = vring.consume(1 << 18)
            k = e._swap_at[0]
            if k not in cpu_at:
                cpu_at[k] = cpu_swapped(ring_cfg, recs, boot, new, k,
                                        label="swap_cpu")
            cpu = cpu_at[k]
            got = state_of(e)
            same = {"stats": got["stats"] == cpu["stats"],
                    "table_digest": got["digest"] == cpu["digest"],
                    "blacklist": got["blocked"] == cpu["blocked"],
                    "verdict_ring": verdicts.tobytes() == cpu["verdicts"]}
            kept = {"graphs_same_objects": e._graphs == graphs,
                    "captures_unchanged": graph.CAPTURES == n_cap,
                    "params_pointers": ptrs == [t.data_ptr()
                                                for t in e.params],
                    "args_pointer": e.score_params.args_ptr == args_ptr}
            # the swapped-in pack is the new model's, kernel == plain
            pack_ok = {
                "table": torch.equal(e.score_params.table,
                                     logreg.score_from_code(new_dev, codes)),
                "kernel_equals_plain": torch.equal(
                    kernels.score_int8(e.params, x, e.score_params),
                    kernels.score_int8_plain(new_dev, x))}
            checks += [*same.values(), *kept.values(), *pack_ok.values(),
                       e._hot_swaps == 1, r.records == SERVE_BATCHES * BATCH,
                       launches["score_int8"] == r.batches,
                       sink.ring.dropped == 0]
            # idle engine: the host cost of a swap, alternating models
            ts = []
            for i in range(20):
                t = time.perf_counter()
                e.hot_swap(new if i % 2 == 0 else boot)
                ts.append((time.perf_counter() - t) * 1e6)
            torch.cuda.synchronize()
            out[label] = {
                "swap_at_batch": k, "equal_cpu": same, "kept": kept,
                "swapped_pack": pack_ok, "launches": launches,
                "swap_host_us_mid_drain": swap_host_us,
                "swap_host_us_idle_p50": sorted(ts)[10],
                "swap_host_us_idle_max": max(ts),
                "group_hist": r.dispatch["group_hist"]}
        nosw = served.get("ring_cpu", {}).get(blk, {})
        out["swap_changed_state"] = (
            bool(cpu_at) and nosw.get("digest")
            not in {c["digest"] for c in cpu_at.values()})
        checks.append(out["swap_changed_state"])
        # 2. a live swap through watch_artifact: the watched file is
        #    replaced atomically mid-drain (the throttle skipped), in
        #    turns with drains that watch nothing
        big = TrafficGen(TrafficSpec(scenario=Scenario(blk), rate_pps=1e6,
                                     seed=SEED + 3)).next_records(
                                         WATCH_BATCHES * BATCH)
        live = os.path.join(shm_dir, "live_artifact.npz")
        rates = {"none": [], "swap": []}
        watch = {}
        for turn, swap in enumerate((False, True, True, False)):
            e = Engine(ring_cfg, ArraySource(big.copy()), CollectSink(),
                       params=boot, device="cuda")
            e.warm()
            th = None
            if swap:
                logreg.save_params(boot, live)
                e.watch_artifact(live)

                def push(e=e):
                    # a pusher that naps, not spins: a spinning thread
                    # would take the GIL from the dispatch and sink
                    # threads and slow the drain it is compared on
                    while e._batches_launched < WATCH_AT:
                        time.sleep(1e-3)
                    tmp = logreg.save_params(new, live + ".tmp.npz")
                    os.replace(tmp, live)
                    t_ns = time.time_ns() + 10**9
                    os.utime(live, ns=(t_ns, t_ns))
                    e._watch_next = 0.0       # skip the 0.5 s throttle

                th = threading.Thread(target=push)
                th.start()
            r = e.run()
            if th is not None:
                th.join()
            rates["swap" if swap else "none"].append(r.records_per_s)
            if swap and turn == 1:
                k = e._swap_at[0] if e._swap_at else -1
                cpu = cpu_swapped(ring_cfg, big, boot, new, k)
                got = state_of(e)
                same = {f: got[f] == cpu[f]
                        for f in ("stats", "digest", "blocked")}
                checks += [*same.values(), e._hot_swaps == 1,
                           WATCH_AT <= k < WATCH_BATCHES]
                watch = {"swaps": e._hot_swaps, "swap_at_batch": k,
                         "equal_cpu": same}
        out["watch_artifact"] = {
            **watch, "batches": WATCH_BATCHES,
            "records_per_s_in_turns": rates,
            "rate_ratio_swap_over_none": (
                sum(rates["swap"]) / max(sum(rates["none"]), 1e-9))}
        # 3. raw48: mlp_robust.npz swapped for the family's default
        #    PRNGKey(0) params (the same shapes), against the CPU engine
        c_mlp = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, name="mlp"))
        recs48 = ring_recs["mixed_l34_1m"][:48 * BATCH]
        m_boot = load_artifact("mlp", mlp_path)
        m_new = get_model("mlp").init("cpu")
        e = Engine(c_mlp, ArraySource(recs48.copy()), CollectSink(),
                   params=m_boot, device="cuda")
        e.warm()
        n_cap = graph.CAPTURES
        e.run(max_batches=24)
        e.hot_swap(m_new)
        e.run()
        cpu = cpu_swapped(c_mlp, recs48, m_boot, m_new, e._swap_at[0])
        got = state_of(e)
        same = {f: got[f] == cpu[f] for f in ("stats", "digest", "blocked")}
        checks += [*same.values(), e.wire == schema.WIRE_RAW48,
                   graph.CAPTURES == n_cap]
        out["raw48_mlp"] = {"swap_at_batch": e._swap_at[0],
                            "equal_cpu": same, "wire": e.wire}
        return {"ok": all(checks), **out}

    hot_swap_phase()

    class LoggedTier(SimKernelTier):
        """The simulated tier, logging the size of every drain it
        filters: its counters depend on that partition (a source
        dropped in one drain is a blacklist hit only in later drains)."""

        def filter(self, records):
            self.polls.append(len(records))
            return super().filter(records)

    class PolledAs(ArraySource):
        """An array source that hands out the logged drain sizes, in
        order: a second engine drains exactly as the first did."""

        def __init__(self, records, sizes):
            super().__init__(records)
            self.sizes = list(sizes)

        def poll(self, max_records):
            return super().poll(self.sizes.pop(0) if self.sizes
                                else max_records)

    @phase("sim_kernel_tier")
    def tier_phase():
        scen = "mixed_l34_1m"
        recs = ring_recs[scen]
        plan = load_plan(plan_path)
        params = logreg.load_params(artifact)

        def tier():
            t = LoggedTier(plan, block_s=ring_cfg.model.ml_block_s)
            t.polls = []
            return t

        out = {"card": card, "scenario": scen, "input_records": len(recs),
               "plan": "artifacts/logreg_int8_plan.npz"}
        e0 = Engine(ring_cfg, ArraySource(recs.copy()), CollectSink(),
                    params=params, device="cuda")
        e0.warm()
        r0 = e0.run()
        e = Recording(ring_cfg, ArraySource(recs.copy()), CollectSink(),
                      params=params, device="cuda", kernel_tier=tier())
        e.warm()
        e.start_log()
        kernels.reset_launches()              # this path's window opens
        r = e.run()
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)      # ... and closes
        served["launches_sim_tier"] = launches
        esc = r.escalation
        # the CPU engine with the tier, drained in the card's drain sizes
        # (the deadline flush makes the card's partition the host's
        # timing): the same escalation block; the step's state equals the
        # CPU engine fed the batches the card dispatched
        c = Engine(ring_cfg, PolledAs(recs.copy(), e.kernel_tier.polls),
                   CollectSink(), params=params, device="cpu",
                   kernel_tier=tier())
        with cpu_threads():
            rc = c.run()
        rr, er = replay_cpu(e.log)

        def no_hz(d):
            return {k: v for k, v in d.items() if k != "kernel_drop_hz"}

        same = {"escalation": no_hz(esc) == no_hz(rc.escalation),
                "drains": c.kernel_tier.polls == e.kernel_tier.polls,
                "stats": e.stats.to_dict() == er.stats.to_dict(),
                "table_digest": digest(e) == digest(er),
                "blacklist": sorted(e.sink.blocked.items())
                == sorted(er.sink.blocked.items())}
        checks = [*same.values(), esc["records_in"] == len(recs),
                  esc["escalated"] == r.records,
                  launches["score_int8"] == chunks(r) == len(e.log)]
        polls = e.kernel_tier.polls
        out.update({
            "equal": same, "escalation": esc,
            "cpu_escalation": rc.escalation, "launches": launches,
            "drains": len(polls),
            "with_tier": {**per_batch(r),
                          "input_records_per_s": esc["records_in"]
                          / max(r.wall_s, 1e-9),
                          "batches": r.batches},
            "without_tier": {**per_batch(r0), "batches": r0.batches}})
        return {"ok": all(checks), **out}

    tier_phase()

    def pcap_frames(n, seed):
        """A classic capture's frames, built with ``struct``: 48 UDP
        flood sources at most of the packets, 2,000 benign UDP and TCP
        SYN sources, and IPv6 flows (the fold of the source words)."""
        import struct

        r = np.random.default_rng(seed)

        def eth(proto=0x0800):
            return b"\x02" * 6 + b"\x04" * 6 + struct.pack(">H", proto)

        def ip4(saddr, proto, l4, plen):
            hdr = bytes([0x45, 0]) + struct.pack(">H", plen - 14) \
                + b"\x00" * 4 + bytes([64, proto]) + b"\x00\x00" \
                + struct.pack("<I", saddr) + b"\x01\x02\x03\x04"
            p = eth() + hdr + l4
            return p + b"X" * max(0, plen - len(p))

        out = []
        for _ in range(n):
            u = r.random()
            if u < 0.7:
                plen = int(r.integers(60, 1400))
                out.append(ip4(0x0A000000 + int(r.integers(0, 48)), 17,
                               struct.pack(">HHHH", 1234, 53, plen - 34, 0),
                               plen))
            elif u < 0.85:
                plen = int(r.integers(60, 600))
                out.append(ip4(0x0B000000 + int(r.integers(0, 2000)), 17,
                               struct.pack(">HHHH", 999, 443, plen - 34, 0),
                               plen))
            elif u < 0.95:
                out.append(ip4(0x0C000000 + int(r.integers(0, 2000)), 6,
                               struct.pack(">HH", 1234, 80) + b"\x00" * 9
                               + b"\x02" + b"\x00" * 6, 74))
            else:
                words = [int(w) for w in r.integers(0, 1 << 32, 3)]
                words.append(int(r.integers(0, 64)))
                plen = 120
                hdr = b"\x60\x00\x00\x00" + struct.pack(">H", plen - 54) \
                    + bytes([17, 64]) + b"".join(
                        struct.pack("<I", w) for w in words) + b"\xaa" * 16
                p = eth(0x86DD) + hdr + struct.pack(">HHHH", 1, 443,
                                                    plen - 54, 0)
                out.append(p + b"X" * (plen - len(p)))
        blob = struct.pack("<IHHiIII", 0xA1B2C3D4, 2, 4, 0, 0, 65535, 1)
        parts = [blob]
        for i, f in enumerate(out):       # 2 µs apart
            us = i * 2
            parts.append(struct.pack("<IIII", 1000 + us // 10**6,
                                     us % 10**6, len(f), len(f)) + f)
        return b"".join(parts)

    def cli_json(argv):
        """``cli.main(argv)`` in this process; its JSON stdout."""
        import io

        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
        lines = buf.getvalue().strip().splitlines()
        return rc, (json.loads(lines[-1]) if lines else None)

    PCAP_FRAMES = 100_000

    @phase("pcap_serve")
    def pcap_phase():
        cap = os.path.join(shm_dir, "capture.pcap")
        rec_path = os.path.join(shm_dir, "capture.records")
        t = time.perf_counter()
        with open(cap, "wb") as f:
            f.write(pcap_frames(PCAP_FRAMES, SEED + 11))
        build_s = time.perf_counter() - t
        t = time.perf_counter()
        rc, meta = cli_json(["pcap", cap, rec_path, "--emit-all"])
        pcap_s = time.perf_counter() - t
        conf = os.path.join(shm_dir, "pcap_fsx.json")
        with open(conf, "w") as f:
            json.dump({"table": {"capacity": TABLE_CAP,
                                 "salt": SEED & 0xFFFFFFFF},
                       "batch": {"max_batch": BATCH},
                       "limiter": {"pps_threshold": 200.0,
                                   "bps_threshold": 1e9}}, f)
        argv = ["serve", "--records", rec_path, "--config", conf,
                "--artifact", artifact, "--json"]
        warm = Engine.warm

        def warm_then_open(self):
            warm(self)
            kernels.reset_launches()          # this path's window opens
            # (after the CLI's warm: the capture's eager warm-ups and the
            # masked warm dispatch are not traffic)

        Engine.warm = warm_then_open
        try:
            rc_card, card_rep = cli_json(argv)
        finally:
            Engine.warm = warm
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)      # ... and closes
        served["launches_pcap"] = launches
        with cpu_threads():
            rc_cpu, cpu_rep = cli_json(argv + ["--device", "cpu"])
        same = {k: card_rep[k] == cpu_rep[k]
                for k in ("stats", "blocked_sources", "table", "records")}
        checks = [rc == 0, rc_card == 0, rc_cpu == 0, *same.values(),
                  meta["packets_emitted"] == PCAP_FRAMES,
                  card_rep["device"]["type"] == "cuda",
                  card_rep["blocked_sources"] > 0,
                  launches["score_int8"] == card_rep["batches"]]
        return {"ok": all(checks), "card": card, "frames": PCAP_FRAMES,
                "capture_bytes": os.path.getsize(cap),
                "build_s": build_s, "cli_pcap_s": pcap_s, "pcap": meta,
                "equal_cpu": same, "launches": launches,
                "card_serve": {k: card_rep[k] for k in (
                    "batches", "records", "records_per_s", "stats",
                    "blocked_sources")}}

    pcap_phase()

    @phase("verdict_k_full_fetch")
    def verdict_k_phase():
        recs = TrafficGen(TrafficSpec(
            scenario=Scenario.UDP_FLOOD_MULTI, rate_pps=1e7,
            n_attack_ips=64, attack_fraction=0.8, seed=SEED + 5)
        ).next_records(OVERFLOW_BATCHES * BATCH)
        out, checks = {"card": card, "batches": OVERFLOW_BATCHES}, []
        served["launches_verdict_k"] = {}
        for k in (0, 4):
            c = dataclasses.replace(
                ring_cfg, batch=dataclasses.replace(ring_cfg.batch,
                                                    verdict_k=k),
                limiter=dataclasses.replace(ring_cfg.limiter,
                                            pps_threshold=200.0,
                                            bps_threshold=1e9))
            runs = {}
            for label, device, mega_n in (("cuda_single", "cuda", 0),
                                          ("cuda_auto", "cuda", "auto"),
                                          ("cpu_single", "cpu", 0)):
                e = Engine(c, ArraySource(recs.copy()), CollectSink(),
                           params=logreg.load_params(artifact),
                           device=device, mega_n=mega_n)
                e.warm()
                kernels.reset_launches()
                with (cpu_threads() if device == "cpu"
                      else contextlib.nullcontext()):
                    r = e.run()
                if device == "cuda":
                    torch.cuda.synchronize()
                    served["launches_verdict_k"][f"k{k}/{label}"] = dict(
                        kernels.LAUNCHES)
                runs[label] = {"state": state_of(e), "readback": r.readback,
                               "batches": r.batches,
                               "group_hist": r.dispatch["group_hist"]}
            want = runs["cpu_single"]["state"]
            res = {}
            for label in ("cuda_single", "cuda_auto"):
                rb = runs[label]["readback"]
                same = {f: runs[label]["state"][f] == want[f]
                        for f in ("stats", "digest", "blocked")}
                checks += [*same.values(), rb["fallback_sinks"] > 0]
                if k == 0:
                    checks += [rb["mode"] == "full",
                               rb["compact_sinks"] == 0]
                res[label] = {"equal_cpu": same,
                              "d2h_bytes_per_batch": rb["bytes_per_batch"],
                              "fallback_sinks": rb["fallback_sinks"],
                              "compact_sinks": rb["compact_sinks"],
                              "group_hist": runs[label]["group_hist"]}
            checks.append(len(want["blocked"]) > 8)
            out[f"verdict_k_{k}"] = {**res, "blocked": len(want["blocked"])}
        return {"ok": all(checks), **out}

    verdict_k_phase()

    @phase("profile_trace")
    def profile_phase():
        import glob

        pdir = os.path.join(REPO, "build", "profile")
        shutil.rmtree(pdir, ignore_errors=True)
        rc, rep = cli_json(["serve", "--profile", pdir, "--batches", "64",
                            "--table-capacity", str(TABLE_CAP), "--json"])
        traces = sorted(glob.glob(os.path.join(pdir, "*.pt.trace.json")))
        seen: dict = {}
        size = 0
        if traces:
            size = os.path.getsize(traces[-1])
            with open(traces[-1]) as f:
                events = json.load(f).get("traceEvents", [])
            kern = [ev.get("name", "") for ev in events
                    if ev.get("cat") == "kernel"]
            seen = {"kernel_events": len(kern),
                    "table_summary_kernel": sum(
                        "table_summary_kernel" in n for n in kern),
                    "score_int8_kernel": sum(
                        "score_int8_kernel" in n for n in kern),
                    "graph_launches": sum(
                        ev.get("name", "") == "cudaGraphLaunch"
                        for ev in events)}
        ok = (rc == 0 and bool(traces) and rep["batches"] == 64
              and seen.get("table_summary_kernel", 0) >= 1
              and (seen.get("score_int8_kernel", 0) >= 64
                   or seen.get("graph_launches", 0) >= 64))
        return {"ok": ok, "card": card, "trace": traces[-1:],
                "trace_bytes": size, "seen": seen,
                "score_int8_named": seen.get("score_int8_kernel", 0) > 0}

    profile_phase()

    @phase("restore_2p20")
    def restore_phase():
        engines = served.get("engines") or []
        src = engines[-1]                     # mixed_l34_1m: the fuller table
        path = os.path.join(shm_dir, "restore_2p20.npz")
        t = time.perf_counter()
        src.checkpoint(path)
        save_s = time.perf_counter() - t
        e = Engine(src.cfg, ArraySource(ring_recs["mixed_l34_1m"][:0]),
                   CollectSink(), device="cuda")
        e.warm()                              # graphs captured first
        n_cap = graph.CAPTURES
        ptrs = (e.table.key_rows.data_ptr(), e.table.state_rows.data_ptr())
        times = []
        for _ in range(3):
            t = time.perf_counter()
            info = e.restore(path)
            times.append(time.perf_counter() - t)
        checks = [digest(e) == digest(src),
                  e.stats.to_dict() == src.stats.to_dict(),
                  ptrs == (e.table.key_rows.data_ptr(),
                           e.table.state_rows.data_ptr()),
                  graph.CAPTURES == n_cap, info["crc_checked"]]
        return {"ok": all(checks), "card": card,
                "rows": src.cfg.table.capacity,
                "tracked": int((src.table.key != 0).sum()),
                "file_bytes": os.path.getsize(path), "save_s": save_s,
                "restore_s": times, "equal_source": checks[0]}

    restore_phase()

    # -- training and the distill compiler ------------------------------------

    from flowsentryx_tpu_torch.distill import parity
    from flowsentryx_tpu_torch.distill import plan as dplan
    from flowsentryx_tpu_torch.train import (
        data as tdata, evaluate, fixture as tfixture, qat, stress,
    )

    chip_dir = os.path.join(REPO, "build", "chip")
    os.makedirs(chip_dir, exist_ok=True)
    with open(os.path.join(REPO, "MODEL_METRICS_r05.json")) as f:
        metrics_r05 = json.load(f)
    with open(os.path.join(os.path.dirname(artifact),
                           "logreg_int8.json")) as f:
        deployed_meta = json.load(f)

    def on_host(params):
        return logreg.params_from_numpy(logreg.params_to_numpy(params))

    @phase("score_stages")
    def stages_phase():
        """The scorer's input stage and tail alone (check entries) against
        their plain versions on the card, and the kernel at the
        evaluation shapes."""
        out, checks = {"card": card}, []
        saved = dict(kernels.LAUNCHES)
        for name, params in (("golden", logreg.golden_params(dev)),
                             ("logreg_int8.npz",
                              logreg.load_params(artifact, dev))):
            packed = kernels.pack_score_params(params)
            grid = decoded_grid(params, 1 << 14).reshape(-1)
            u32 = torch.from_numpy(rng.integers(
                0, 1 << 32, 1 << 20, dtype=np.int64)).to(dev).float()
            edges = torch.from_numpy(dplan.validation_edges(
                dplan.compile_plan(on_host(params), validate=False)
            ).astype(np.int64)).to(dev).float()
            row = {}
            for label, x in (("decode_grid", grid), ("u32_random", u32),
                             ("validate_edges", edges)):
                got = kernels.score_quant_u8(params, x.contiguous(), packed)
                want = kernels.score_quant_u8_plain(params, x)
                row[label] = {"n": x.numel(),
                              "mismatches": int((got != want).sum())}
            w = params.w_int8.cpu().numpy().astype(np.int64)
            contrib = (np.arange(256)[None, :] - int(params.in_zp)) * w[:, None]
            acc = torch.arange(int(contrib.min(1).sum()),
                               int(contrib.max(1).sum()) + 1,
                               dtype=torch.int32, device=dev)
            got = kernels.score_tail(params, acc, packed)
            row["tail_acc_range"] = {
                "n": acc.numel(), "range": [int(acc[0]), int(acc[-1])],
                "mismatches": int((got.view(torch.int32) != logreg
                                   .score_from_acc(params, acc)
                                   .view(torch.int32)).sum())}
            for b in (65_536, 45_407):
                X, _ = tfixture.cicids_fixture(n=b, seed=b)
                x = torch.from_numpy(X).to(dev)
                got = kernels.score_int8(params, x, packed)
                want = kernels.score_int8_plain(params, x)
                row[f"score_int8_b{b}"] = {
                    "mismatches": int((got.view(torch.int32)
                                       != want.view(torch.int32)).sum())}
            torch.cuda.synchronize()
            out[name] = row
            checks += [v["mismatches"] == 0 for v in row.values()]
        kernels.LAUNCHES.update(saved)     # comparisons do not count
        return {"ok": all(checks), **out}

    stages_phase()

    #: sha256 of the deployed recipe's fixture (X, y, y_class bytes of
    #: ``cicids_fixture(N_CLEANED, seed=0, return_classes=True)``), as
    #: the reference's numpy builds it.
    FIXTURE_SHA256 = ("419dca72e3dff66385a6252122ffb05de317c4f25125082d17"
                      "0bcf447edd4e8d")
    trained_path = os.path.join(chip_dir, "trained_logreg_int8.npz")

    @phase("train_qat_deployed")
    def qat_phase():
        """``fsx train --data fixture --slow-weight 4`` at full size on the
        card, against the committed ``artifacts/logreg_int8.npz``."""
        out, checks = {"card": card}, []
        t = time.perf_counter()
        X, y, yc = tfixture.cicids_fixture(tfixture.N_CLEANED, seed=0,
                                           return_classes=True)
        out["fixture_s"] = time.perf_counter() - t
        h = hashlib.sha256()
        for a in (X, y, yc):
            h.update(a.tobytes())
        out["fixture_sha256"] = h.hexdigest()
        if h.hexdigest() != FIXTURE_SHA256:
            out["fixture_error"] = ("this numpy builds another fixture "
                                    f"(numpy {np.__version__}): the artifact "
                                    "comparison below is not meaningful")
        checks.append(h.hexdigest() == FIXTURE_SHA256)
        Xtr, Xte, ytr, yte = tdata.train_test_split(X, y)
        ctr = tdata.train_test_split(yc, y)[0]
        sw = 1.0 + (ctr == tfixture.CLASS_SLOW) * 3.0
        out.update(train_n=len(Xtr), test_n=len(Xte))
        torch.cuda.synchronize()
        kernels.reset_launches()           # the training path's window
        t = time.perf_counter()
        res = qat.train_logreg_qat(Xtr, ytr, epochs=200, sample_weight=sw,
                                   device=dev)
        torch.cuda.synchronize()
        out["train_s"] = time.perf_counter() - t
        served["launches_train_qat"] = dict(kernels.LAUNCHES)   # closes
        out["launches"] = served["launches_train_qat"]
        checks.append(out["launches"]["gemv_seq"] == 200)
        served["train_qat_epochs"] = len(res.losses)
        out["epoch_host_ms"] = out["train_s"] / len(res.losses) * 1e3
        out["final_loss"] = float(res.losses[-1])
        p = logreg.params_to_numpy(res.params)
        ref = logreg.params_to_numpy(logreg.load_params(artifact))
        dw = int(np.abs(p["w_int8"].astype(int)
                        - ref["w_int8"].astype(int)).max())
        out["artifact"] = {k: v.tolist() for k, v in p.items()}
        out["vs_committed"] = {
            "w_int8_max_code_diff": dw,
            "in_scale_rel": float(abs(p["in_scale"] - ref["in_scale"])
                                  / ref["in_scale"]),
            "out_scale_rel": float(abs(p["out_scale"] - ref["out_scale"])
                                   / ref["out_scale"]),
            "in_zp": [int(p["in_zp"]), int(ref["in_zp"])],
            "out_zp": [int(p["out_zp"]), int(ref["out_zp"])]}
        checks += [dw <= 1, out["vs_committed"]["in_scale_rel"] <= 1e-6,
                   out["vs_committed"]["out_scale_rel"] <= 1e-2]
        logreg.save_params(res.params, trained_path)
        # evaluation: the test split through score_int8, 65,536-row chunks
        served_p = logreg.load_params(trained_path, dev)
        kernels.reset_launches()           # this path's window opens
        torch.cuda.synchronize()
        t = time.perf_counter()
        scores = evaluate.score_chunks(evaluate.int8_classify(served_p),
                                       served_p, Xte)
        out["evaluate_s"] = time.perf_counter() - t
        served["launches_train_eval"] = dict(kernels.LAUNCHES)  # closes
        m = evaluate.confusion(scores, yte)
        want_f1 = deployed_meta["fixture_test_metrics"]["f1"]
        out["test"] = m
        out["reference_f1"] = want_f1
        checks.append(abs(m["f1"] - want_f1) <= 0.003)
        checks.append(served["launches_train_eval"]["score_int8"]
                      == -(-len(Xte) // 65536))
        # the card's scores byte-equal to the plain version's on the card
        saved = dict(kernels.LAUNCHES)
        xd = torch.from_numpy(Xte).to(dev)
        plain = np.concatenate([
            kernels.score_int8_plain(served_p, xd[s:s + 65536]).cpu().numpy()
            for s in range(0, len(Xte), 65536)])
        kernels.LAUNCHES.update(saved)
        out["scores_bytes_equal_plain"] = scores.tobytes() == plain.tobytes()
        checks.append(out["scores_bytes_equal_plain"])
        # one epoch of each phase under the profiler: device ops and busy
        # ms; then 20 quantize epochs with and without the per-epoch
        # float(loss) (the reference's one host sync per epoch)
        from torch.profiler import ProfilerActivity, profile

        Xd = fdev.xla_log1p(torch.from_numpy(Xtr).to(dev))
        yd = torch.from_numpy(ytr).to(dev)
        swd = torch.from_numpy(sw.astype(np.float32)).to(dev)
        st = qat.new_state(dev)
        st, _ = qat.qat_epoch(st, Xd, yd, False, swd)
        st, _ = qat.qat_epoch(st, Xd, yd, True, swd)
        torch.cuda.synchronize()
        prof_out = {}
        for quantize in (False, True):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                st, loss = qat.qat_epoch(st, Xd, yd, quantize, swd)
                float(loss)
            evs = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
            prof_out["quantize" if quantize else "warmup"] = {
                "device_ops": len(evs),
                "device_busy_ms": sum(e.time_range.elapsed_us()
                                      for e in evs) / 1e3}
        out["epoch_profile"] = prof_out
        # gemv_seq against its plain version at the path's shape: the
        # quantize epoch's dL/dy and quantized inputs, 2,016,639 rows
        saved = dict(kernels.LAUNCHES)
        p_, xq, _, _ = qat._forward(st.w, st.b, st.obs_in, st.obs_out, Xd,
                                    True)
        gy = qat.loss_terms(p_, yd, swd)[1]
        xq = xq.contiguous()
        got = kernels.gemv_seq(gy, xq)
        t = time.perf_counter()
        want = kernels.gemv_seq_plain(gy.cpu(), xq.cpu())
        plain_s = time.perf_counter() - t
        kernels.LAUNCHES.update(saved)
        errs["gemv_seq"] = float((got.cpu() - want).abs().max())
        out["gemv_seq_vs_plain"] = {
            "rows": int(xq.shape[0]), "bits_equal": torch.equal(
                got.cpu().view(torch.int32), want.view(torch.int32)),
            "plain_host_s": plain_s}
        checks.append(out["gemv_seq_vs_plain"]["bits_equal"])
        served["gemv_inputs"] = (gy, xq, plain_s)
        for sync in (True, False):
            losses = []
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(20):
                st, loss = qat.qat_epoch(st, Xd, yd, True, swd)
                losses.append(float(loss) if sync else loss)
            torch.cuda.synchronize()
            out[f"epoch_host_ms_{'with' if sync else 'without'}_sync"] = (
                (time.perf_counter() - t) / 20 * 1e3)
        return {"ok": all(checks), **out}

    qat_phase()

    Xt9, yt9, ct9 = stress.fixture_variant("v2", 300_000, seed=9)
    Xe8, ye8, ce8 = stress.fixture_variant("v2", 300_000, seed=8)

    @phase("train_mlp_robust")
    def mlp_phase():
        """``stress``'s robust detector recipe on the card: v2 fixture
        (300,000 rows, seed 9) plus two shift-augmented copies, 80 epochs;
        clean F1 on seed 8 against MODEL_METRICS_r05.json."""
        steps = []
        torch.cuda.synchronize()
        t = time.perf_counter()
        _, cell = stress.robust_mlp(Xt9, yt9, Xe8, ye8, ce8, device=dev,
                                    step_log=steps)
        torch.cuda.synchronize()
        total = time.perf_counter() - t
        want = metrics_r05["robust_detector_mlp"]["clean"]["f1"]
        return {"ok": abs(cell["f1"] - want) <= 0.01, "card": card,
                "clean": cell, "reference_f1": want, "steps": len(steps),
                "total_s": total, "ms_per_step": total / len(steps) * 1e3}

    mlp_phase()

    @phase("train_multiclass")
    def mc_phase():
        """The expert heads of the slow-recall headline (60 epochs) on the
        card: binary F1 and per-class recall within 0.02 of the
        reference's."""
        steps = []
        torch.cuda.synchronize()
        t = time.perf_counter()
        _, rep = stress.expert_heads(Xt9, ct9, Xe8, ce8, device=dev,
                                     step_log=steps)
        torch.cuda.synchronize()
        total = time.perf_counter() - t
        want = metrics_r05["slow_recall_headline"]["models"]["expert_heads"]
        diffs = {"binary_f1": abs(rep["binary"]["f1"]
                                  - want["binary"]["f1"])}
        for c, v in want["per_class"].items():
            diffs[f"recall_{c}"] = abs(rep["per_class"][c]["recall"]
                                       - v["recall"])
        return {"ok": max(diffs.values()) <= 0.02, "card": card,
                "report": {k: rep[k] for k in ("per_class", "macro_f1",
                                               "binary")},
                "diff_vs_reference": diffs, "steps": len(steps),
                "total_s": total, "ms_per_step": total / len(steps) * 1e3}

    mc_phase()

    trained_plan_path = os.path.join(chip_dir, "trained_plan.npz")

    def same_plan(a, b):
        strip = lambda m: {k: v for k, v in m.items() if k != "backend"}  # noqa
        return (dplan.pack_blob(a) == dplan.pack_blob(b)
                and all(np.array_equal(getattr(a, f), getattr(b, f))
                        for f in ("w", "qbase", "bounds_m1"))
                and all(getattr(a, f) == getattr(b, f)
                        for f in ("acc_drop", "acc_pass", "t_lo", "t_hi",
                                  "in_zp", "w_sum"))
                and strip(a.meta) == strip(b.meta))

    @phase("distill_compile")
    def distill_phase():
        """``compile_plan`` on the card (the scorer's stage entries)
        against the committed plan and the CPU compile, and the served
        lane's bands against each plan over the reference's corpus."""
        out, checks = {"card": card}, []
        committed = dplan.load_plan(plan_path)
        saved = dict(kernels.LAUNCHES)
        cases = (("golden", logreg.golden_params(dev), None),
                 ("logreg_int8.npz", logreg.load_params(artifact, dev),
                  committed),
                 ("trained", logreg.load_params(trained_path, dev), None))
        for name, params, want in cases:
            torch.cuda.synchronize()
            t = time.perf_counter()
            p_card = dplan.compile_plan(params)
            torch.cuda.synchronize()
            card_s = time.perf_counter() - t
            t = time.perf_counter()
            with cpu_threads():
                p_cpu = dplan.compile_plan(on_host(params))
            cpu_s = time.perf_counter() - t
            chk = parity.served_band_check(params, p_card,
                                           parity.corpus(p_card))
            row = {"compile_s_card": card_s, "compile_s_cpu": cpu_s,
                   "backend": p_card.meta["backend"],
                   "equal_cpu_compile": same_plan(p_card, p_cpu),
                   "band_check": chk}
            if want is not None:
                row["equal_committed_plan"] = same_plan(p_card, want)
                checks.append(row["equal_committed_plan"])
            checks += [row["equal_cpu_compile"], chk["ok"],
                       p_card.meta["backend"].startswith("cuda")]
            if name == "trained":
                dplan.save_plan(p_card, trained_plan_path)
            out[name] = row
        kernels.LAUNCHES.update(saved)     # the band checks do not count
        return {"ok": all(checks), **out}

    distill_phase()

    @phase("train_distill_serve")
    def tds_phase():
        """The trained artifact served on the card behind the simulated
        kernel tier of its fresh plan: ``syn_benign_mix``, 64 batches of
        records at 2^20 rows, B = 2048, against the CPU engine on the same
        drains."""
        recs = TrafficGen(TrafficSpec(
            scenario=Scenario.SYN_BENIGN_MIX, rate_pps=1e6, seed=SEED + 8)
        ).next_records(64 * BATCH)
        tplan = load_plan(trained_plan_path)

        def tier():
            t = LoggedTier(tplan, block_s=ring_cfg.model.ml_block_s)
            t.polls = []
            return t

        params = logreg.load_params(trained_path, dev)
        e = Recording(ring_cfg, ArraySource(recs.copy()), CollectSink(),
                      params=params, device="cuda", kernel_tier=tier())
        e.warm()
        e.start_log()
        kernels.reset_launches()              # this path's window opens
        r = e.run()
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)      # ... and closes
        served["launches_train_distill_serve"] = launches
        host = logreg.load_params(trained_path, "cpu")
        c = Engine(ring_cfg, PolledAs(recs.copy(), e.kernel_tier.polls),
                   CollectSink(), params=host, device="cpu",
                   kernel_tier=tier())
        with cpu_threads():
            rc = c.run()
        rr, er = replay_cpu(e.log, params=host)

        def no_hz(d):
            return {k: v for k, v in d.items() if k != "kernel_drop_hz"}

        same = {"escalation": no_hz(r.escalation) == no_hz(rc.escalation),
                "drains": c.kernel_tier.polls == e.kernel_tier.polls,
                "stats": e.stats.to_dict() == er.stats.to_dict(),
                "table_digest": digest(e) == digest(er),
                "blacklist": sorted(e.sink.blocked.items())
                == sorted(er.sink.blocked.items())}
        checks = [*same.values(), r.records > 0,
                  launches["score_int8"] == chunks(r) == len(e.log),
                  launches["table_summary"] == 1]
        return {"ok": all(checks), "card": card, "equal": same,
                "escalation": r.escalation, "launches": launches,
                "batches": r.batches, "records": r.records,
                "stats": r.stats, **per_batch(r)}

    tds_phase()

    # -- the BASELINE scenario suite at full scale ---------------------------

    #: The untimed fields of a suite result (``wall_s``, ``mpps`` and
    #: ``stages_ms`` are timings).
    timing_fields = ("wall_s", "mpps", "stages_ms")

    def untimed(res):
        return {k: v for k, v in res.items() if k not in timing_fields}

    def config_batch(sb, params, n):
        """``n`` compact16 wire batches of the config's own traffic, at its
        B, in the params' model mode, on the card (a fresh generator: the
        run's first ``n`` batches)."""
        b = sb.cfg.batch.max_batch
        quant = schema.wire_quant_for(logreg.LogRegParams(
            **logreg.params_to_numpy(params)))
        src = TrafficSource(sb.traffic, total=n * b)
        recs = [src.poll(b) for _ in range(n)]
        t0 = int(recs[0]["ts_ns"][0])
        return [to_dev(schema.encode_compact(r, b, t0, **quant))
                for r in recs]

    @phase("scenario_suite")
    def scenario_phase():
        """The five BASELINE configs through ``benchmarks.run_suite`` on
        the card at full scale (the main path of ``bench --scenarios``),
        against the CPU engine on the same records; then, per config, a
        warmed engine: records/s, its single step's device ms per batch
        over the config's own batches, idle share, memory after
        ``warm()``, and the host's generator alone."""
        suite = benchmarks.scenario_suite(1.0)
        # each config through ``run_suite`` (``bench --scenarios --only``)
        # in its own window, zeroed just before and read just after
        card_res, per_config = [], {}
        for sb in suite:
            torch.cuda.synchronize()
            kernels.reset_launches()
            card_res += benchmarks.run_suite(scale=1.0, names=[sb.name],
                                             device="cuda")
            torch.cuda.synchronize()
            per_config[sb.name] = dict(kernels.LAUNCHES)
        launches = {k: sum(w.get(k, 0) for w in per_config.values())
                    for k in kernels.LAUNCHES}
        with cpu_threads():
            cpu_res = benchmarks.run_suite(scale=1.0, device="cpu")
        batches = sum(r["batches"] for r in card_res)
        checks = [len(card_res) == len(suite)]
        checks += [per_config[r["scenario"]]["score_int8"] == r["batches"]
                   and per_config[r["scenario"]]["table_summary"] == 1
                   for r in card_res]
        out = {"card": card, "scale": 1.0, "cpu_scale": 1.0,
               "launches": launches, "launches_per_config": per_config,
               "batches": batches,
               "tolerance": "every untimed field equal (exact)",
               "configs": {}}
        params, _ = benchmarks._serving_params()
        for sb, res, ref in zip(suite, card_res, cpu_res):
            b = sb.cfg.batch.max_batch
            same = untimed(res) == untimed(ref)
            checks += [same, res["packets"] == sb.packets,
                       res["stats"]["allowed"] + res["stats"]["dropped"]
                       == res["packets"]]
            # a warmed engine over the same records
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            e = Engine(sb.cfg, TrafficSource(sb.traffic, total=sb.packets),
                       CollectSink(), params=params, readback_depth=32,
                       device="cuda")
            built = torch.cuda.memory_allocated()
            e.warm()
            torch.cuda.synchronize()
            memory = {"engine_bytes": built - base,
                      "graphs_bytes": torch.cuda.memory_allocated() - built,
                      "peak_bytes": torch.cuda.max_memory_allocated() - base,
                      "reserved_bytes": torch.cuda.memory_reserved()}
            kernels.reset_launches()      # this engine's window opens
            r = e.run()
            torch.cuda.synchronize()
            w_launches = dict(kernels.LAUNCHES)   # ... and closes
            checks += [r.stats == res["stats"], r.table == res["table"],
                       w_launches["score_int8"] == r.batches,
                       w_launches["table_summary"] == 1]
            # the report's scan on this table, against its plain version
            summary = compare_summary(e.table.key, e.table.state,
                                      e._device_now, sb.cfg.table.stale_s)
            checks.append(summary["equal"])
            served.setdefault("scenario_tables", {})[sb.name] = (
                e.table.key.clone(), e.table.state.clone(), e._device_now)
            # the captured single step over the config's own batches
            xs = config_batch(sb, e.params, min(r.batches, 16))
            gr = e._graphs[0]
            for x in xs[:4]:
                gr.input.copy_(x)
                gr.replay()
            torch.cuda.synchronize()
            a, b_ = torch.cuda.Event(True), torch.cuda.Event(True)
            a.record()
            for x in xs:
                gr.input.copy_(x)
                gr.replay()
            b_.record()
            b_.synchronize()
            step_ms = a.elapsed_time(b_) / len(xs)
            # the scorer at this B on a decoded batch, against its plain
            # version
            feat = schema.decode_compact(xs[0], **e.quant).feat.contiguous()
            mism = compare_scores(e.params, feat)
            checks.append(mism == 0)
            if b != BATCH:    # the kernels line times the larger B
                served.setdefault("scenario_feats", {})[b] = (
                    e.params, e.score_params, feat, sb.name, res["batches"])
            # the host's generator alone, at the engine's poll size
            g = TrafficSource(sb.traffic, total=sb.packets)
            t = time.perf_counter()
            while not g.exhausted():
                g.poll(b)
            gen_s = time.perf_counter() - t
            fill = r.stages_ms.get("fill") or {}
            out["configs"][sb.name] = {
                "suite_result": res, "equal_to_cpu": same,
                "B": b, "table_rows": sb.cfg.table.capacity,
                "warmed": {
                    "records_per_s": r.records_per_s, "wall_s": r.wall_s,
                    "batches": r.batches,
                    "step_device_ms_per_batch": step_ms,
                    "step_batches_timed": len(xs),
                    "idle_share": idle_share(r, step_ms),
                    "fill_ms_per_batch": fill.get("mean", 0.0)
                    * fill.get("n", 0) / max(r.batches, 1),
                    "dispatch": {k: r.dispatch[k] for k in (
                        "graphs", "graph_nodes", "dispatches")},
                    "readback": r.readback, "launches": w_launches,
                    "stats_equal_suite": r.stats == res["stats"]},
                "generator_records_per_s": sb.packets / max(gen_s, 1e-9),
                "memory_after_warm": memory,
                "table_summary_vs_plain": summary,
                "score_int8_vs_plain": {"shape": list(feat.shape),
                                        "mismatches": mism}}
            del e, gr, xs
        served["launches_scenario_suite"] = launches
        served["launches_scenario_configs"] = per_config
        return {"ok": all(checks), **out}

    scenario_phase()

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

    def dev_ms(calls, reps, name=None):
        """The kernels' own device time per call (ms) from
        ``torch.profiler``: kernels whose name holds ``name`` (all kernels
        when None); None when the trace holds none of them (not
        measured).  A torch kernel closes the window: without one, the
        trace has dropped the last launches of a library loaded with
        ``ctypes``.  Only that closing kernel, the last one on the
        stream, is left out, so every kernel of ``calls`` counts whatever
        its name; a window whose last kernel is not the closing one is
        not measured."""
        from torch.profiler import ProfilerActivity, profile

        tail = torch.zeros(1, device=dev)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                calls()
            tail.add_(1)                  # CUDAFunctorOnSelf_add
            torch.cuda.synchronize()
        evs = [ev for ev in prof.events()
               if ev.device_type == torch.autograd.DeviceType.CUDA]
        if not evs:
            return None
        last = max(evs, key=lambda ev: ev.time_range.start)
        if "CUDAFunctorOnSelf_add" not in last.name:
            return None
        evs = [ev.time_range.elapsed_us() for ev in evs if ev is not last
               and (name is None or name in ev.name)]
        return sum(evs) / reps / 1e3 if evs else None

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
        s_dev = dev_ms(score, 50, "score_int8_kernel")
        s_lib_dev = dev_ms(library, 50)
        # x, the ScoreArgs struct (read from device memory), out
        s_bytes = b * 8 * 4 + kernels.SCORE_ARGS_WORDS * 4 + b * 4
        sb, sby = bound(s_bytes, b * 64)
        score_row = {
            "name": "score_int8", "route": "cuda",
            "source": "flowsentryx_tpu_torch/csrc/score_int8.cu",
            "design": "parameters, weights and output table in a device "
                      "buffer (ScorePack), staged per block into shared "
                      "memory",
            "replaces": "flowsentryx_tpu/ops/pallas_kernels.py:101",
            "launches": launches.get("score_int8", 0),
            # the serve_mega_auto path's window, and launches per graph
            # replay (the wrapper's host code runs once, at capture)
            "launches_serve_mega_auto": mega_launches.get("score_int8", 0),
            "launches_per_replay": "1 per single, g per rung g",
            "max_abs_err": errs["score_int8"], "ms": s_ms,
            "plain_ms": s_plain, "bound_ms": sb, "bound_by": sby,
            "library_ms": s_lib, "device_ms": s_dev,
            "host_us_per_call": s_host, "library_device_ms": s_lib_dev,
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
                "device_ms": dev_ms(score_raw, 50, "score_int8_kernel"),
                "plain_ms": time_ms(
                    lambda: kernels.score_int8_plain(lp, xr), 50)}})
        # the evaluation chunk of the training path: B = 65,536 fixture
        # rows through the trained (log1p) artifact
        ep = logreg.load_params(trained_path if os.path.exists(trained_path)
                                else artifact, dev)
        ep_packed = kernels.pack_score_params(ep)
        x65 = torch.from_numpy(tfixture.cicids_fixture(
            n=65_536, seed=65_536)[0]).to(dev)
        w65 = (ep.w_int8.float() * ep.w_scale)[None, :]

        def score65():
            kernels.score_int8(ep, x65, ep_packed)

        def library65():
            torch.nn.functional.linear(x65, w65, ep.bias.reshape(1))

        b65 = x65.shape[0]
        # x read once, the ScoreArgs struct once, out written once; ops:
        # per row 8 quantizations (log1p ~40 flops, a division) + the dot
        e65, e65by = bound(b65 * 8 * 4 + kernels.SCORE_ARGS_WORDS * 4
                           + b65 * 4, b65 * 8 * 48)
        score_row["b65536"] = {
            "shape": [b65, 8], "params": os.path.basename(
                trained_path if os.path.exists(trained_path) else artifact),
            "launches_train_eval": served.get(
                "launches_train_eval", {}).get("score_int8", 0),
            "ms": time_ms(score65, 200),
            "device_ms": dev_ms(score65, 50, "score_int8_kernel"),
            "host_us_per_call": host_us(score65, 200),
            "plain_ms": time_ms(lambda: kernels.score_int8_plain(ep, x65),
                                20),
            "bound_ms": e65, "bound_by": e65by,
            "peak": "H100 SXM data sheet: 3.35 TB/s HBM, 67 TFLOP/s fp32",
            "library_ms": time_ms(library65, 200),
            "library_device_ms": dev_ms(library65, 50)}
        # the suite's larger batches: B = 8192 (config 3) and 16,384
        # (config 5), decoded from each config's own traffic
        suite_launches = served.get("launches_scenario_suite", {})
        config_launches = served.get("launches_scenario_configs", {})
        for bs, (sp, spk, xs_, scen_name, n_batches) in sorted(served.get(
                "scenario_feats", {}).items()):
            ws = (sp.w_int8.float() * sp.w_scale)[None, :]

            def score_b(sp=sp, spk=spk, xs_=xs_):
                kernels.score_int8(sp, xs_, spk)

            def library_b(xs_=xs_, ws=ws, sp=sp):
                torch.nn.functional.linear(xs_, ws, sp.bias.reshape(1))

            sbb, sbby = bound(bs * 8 * 4 + kernels.SCORE_ARGS_WORDS * 4
                              + bs * 4, bs * 64)
            score_row[f"b{bs}"] = {
                "shape": [bs, 8], "scenario": scen_name,
                "params": "logreg_int8.npz",
                # this config's own window in the suite's run
                "launches": config_launches.get(scen_name, {}).get(
                    "score_int8", 0),
                "batches": n_batches,
                "mismatches_vs_plain": compare_scores(sp, xs_),
                "ms": time_ms(score_b, 200),
                "device_ms": dev_ms(score_b, 50, "score_int8_kernel"),
                "host_us_per_call": host_us(score_b, 200),
                "plain_ms": time_ms(lambda sp=sp, xs_=xs_:
                                    kernels.score_int8_plain(sp, xs_), 50),
                "bound_ms": sbb, "bound_by": sbby,
                "library_ms": time_ms(library_b, 200),
                "library_device_ms": dev_ms(library_b, 50)}
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
            "device_ms": dev_ms(segsum, 50, "segment_sum_seq_kernel"),
            "host_us_per_call": host_us(segsum, 200),
            "library_device_ms": dev_ms(seglib, 50),
            "shape": [BATCH], "segments": int(seg[-1]) + 1,
            "longest_segment": int(torch.bincount(seg).max()),
            "heavy_300x65535": {
                "ms": time_ms(heavy, 200),
                "device_ms": dev_ms(heavy, 50, "segment_sum_seq_kernel"),
                "longest_segment": int(torch.bincount(hseg).max())}}
        # the report's scan over both served tables, cold: evict the
        # 50 MB L2 before each call by reading 256 MB (a read leaves L2
        # clean; a zero fill would leave dirty lines for the timed call
        # to write back)
        scratch = torch.zeros(64 << 20, dtype=torch.float32, device=dev)
        flush = scratch.sum
        flush()
        tables = {}
        # the served 2^20-row tables, then the suite's 2^14- and 2^16-row
        # ones (configs 1 and 2) as their engines left them
        scans = [(scen, te.table.key, te.table.state, te._device_now)
                 for (scen, _), te in zip(scenarios, engines or [])]
        for name, (k_, st_, now_) in served.get("scenario_tables",
                                                 {}).items():
            if name.startswith(("config1", "config2")):
                scans.append((f"{name}_2^{k_.shape[0].bit_length() - 1}",
                              k_, st_, now_))
        for scen, key_t, state_t, now in scans:
            tbl = types.SimpleNamespace(key=key_t, state=state_t,
                                        capacity=key_t.shape[0])
            n = tbl.capacity
            tracked = int((tbl.key != 0).sum())

            def summary():
                kernels.table_summary_counts(tbl.key, tbl.state, now, 30.0)

            def flushed():
                flush()
                summary()

            # what this run's data needs: every key, the two state words
            # (LAST_SEEN, BLOCKED_UNTIL) of each tracked row, the outputs;
            # beside it the counts of distinct 32-byte sectors and 64-byte
            # chunks that hold one of those words (neighbouring rows share
            # them), counted on this run's table
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
                "device_ms": dev_ms(flushed, 20, "table_summary_kernel"),
                "host_us_per_call": host_us(summary, 50),
                "bound_ms": tb, "bound_by": tby,
                "state_sectors": sectors, "state_64b_chunks": chunks}
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
            "launches_scenario_suite": suite_launches.get(
                "table_summary", 0),
            "launches_per_replay": "0 (once per report, outside graphs)",
            "max_abs_err": errs["table_summary"],
            **{k: main.get(k) for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "device_ms",
                "host_us_per_call")},
            "library_ms": None, "tables": tables}
        # gemv_seq on the training path's operands (the quantize epoch's
        # dL/dy and quantized inputs, 2,016,639 rows)
        gemv_row = {"name": "gemv_seq", "route": "cuda",
                    "source": "flowsentryx_tpu_torch/csrc/gemv_seq.cu",
                    "replaces": None,
                    "launches": served.get("launches_train_qat", {}).get(
                        "gemv_seq", 0),
                    "launches_per_epoch": served.get(
                        "launches_train_qat", {}).get("gemv_seq", 0)
                    / max(served.get("train_qat_epochs", 0), 1),
                    "max_abs_err": errs["gemv_seq"]}
        if "gemv_inputs" in served:
            gy, xq, plain_s = served["gemv_inputs"]
            n_rows = xq.shape[0]

            def gemv():
                kernels.gemv_seq(gy, xq)

            def gemv_lib():
                torch.mv(xq.t(), gy)

            gb2, gby2 = bound(n_rows * 9 * 4 + 8 * 4, n_rows * 8 * 2)
            gemv_row.update({
                "ms": time_ms(gemv, 10), "plain_ms": plain_s * 1e3,
                "plain_where": "host numpy (the serial chain)",
                "bound_ms": gb2, "bound_by": gby2,
                "library_ms": time_ms(gemv_lib, 20),
                "library_call": "torch.mv(xq.t(), gy) (another order: not "
                                "the reference's bits)",
                "device_ms": dev_ms(gemv, 5, "gemv_seq_kernel"),
                "host_us_per_call": host_us(gemv, 10),
                "shape": [int(n_rows), 8]})
        else:
            gemv_row.update({"ms": None, "plain_ms": None, "bound_ms": None,
                             "bound_by": None, "library_ms": None})
        kernels.LAUNCHES.update(saved)
        rows = [score_row, summary_row, seg_row, gemv_row]
        # launches on the production serve paths, each counted in its
        # own window (zeroed just before the run, read just after)
        windows = {
            **{f"serve_shm_ring/{s}": w for s, w in
               served.get("launches_ring", {}).items()},
            "serve_raw48_ring": served.get("launches_raw48_ring", {}),
            **{f"serve_ingest_workers/{n}": w for n, w in
               served.get("launches_ingest", {}).items()},
            **{f"latency_plane/{k}": w for k, w in
               served.get("launches_latency", {}).items()},
            "slo_pulse": served.get("launches_slo_pulse", {}),
            "predict_pulse": served.get("launches_predict_pulse", {}),
            **{f"hot_swap_live/{k}": w for k, w in
               served.get("launches_hot_swap", {}).items()},
            "sim_kernel_tier": served.get("launches_sim_tier", {}),
            "pcap_serve": served.get("launches_pcap", {}),
            **{f"verdict_k_full_fetch/{k}": w for k, w in
               served.get("launches_verdict_k", {}).items()},
            "train_qat_deployed/train": served.get(
                "launches_train_qat", {}),
            "train_qat_deployed/evaluate": served.get(
                "launches_train_eval", {}),
            "train_distill_serve": served.get(
                "launches_train_distill_serve", {}),
            "scenario_suite": served.get("launches_scenario_suite", {}),
            # each cluster rank's own window, read from its report
            **served.get("launches_cluster", {})}
        for row in rows:
            row["launches_serve_paths"] = {
                k: w.get(row["name"], 0) for k, w in windows.items()}
        served["kernels"] = rows
        suite_equal = not any(v.get("mismatches_vs_plain") for k, v in
                              score_row.items() if k.startswith("b")
                              and isinstance(v, dict))
        return {"ok": bool(tables) and suite_equal, "card": card,
                "library_call": {"score_int8": "torch.nn.functional.linear "
                                 "(float logistic-regression matvec)",
                                 "table_summary": None,
                                 "segment_sum_seq": "Tensor.index_add_",
                                 "gemv_seq": "torch.mv"},
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
