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
24. ``sim_kernel_tier``: ``SIM_TIER_BATCHES`` x 2,048 records of
    ``mixed_l34_1m`` through the simulated kernel tier of the committed
    plan ``artifacts/logreg_int8_plan.npz``: the
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
    --drain`` over each prefilled scenario (768 x 2,048 records, cut from
    1,536 so the whole script stays under ~780 s), in
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

45. ``chaos_campaign``: ``chaos.run_campaign(seed=17, quick=False,
    device="cuda")`` at the campaign's own shapes (4,096 rows, B=64, 24
    batches) and the same campaign on the CPU: every invariant of the
    thirteen single-host faults holds, the four plants are caught by
    their invariants with their controls holding, ``truncate_fraction``,
    ``flip_offsets``, ``kill_at_s``, ``kill_after_slots``, ``to_gen`` and
    the slot scenario's ``records`` equal the CPU campaign's, and in the
    phase's window ``score_int8``
    launched once per batch the campaign's engine dispatched and
    ``table_summary`` once per report; the campaign's and each
    scenario's wall, ``recovery_s`` and the watchdog's ``elapsed_s``.
46. ``chaos_engine_2p20``: the three engine-side scenarios at full
    width (``chaos_engine_drive``): ``FsxConfig()`` (2^20 rows, B=2048,
    K=64, the default ``logreg_int8`` params), a 1-worker
    ``ShardedIngest`` over a ring of 64 x 2,048 ``mixed_l34_1m`` records
    (BASELINE config 5's traffic, seed 17), ``readback_depth=4``, the
    sink thread on.  A bad-magic, a poisoned and a seq-gapped sealed
    slot in the drain, with exact record conservation; after it the
    blacklist (keys and until bits), stats and table digest equal the
    CPU engine's under the same corruptions; the ``.prev`` fallback
    restore keeps the table's and the stats' device pointers and
    captures nothing, and 8 more batches through the captured graph
    equal the CPU engine's; then the wedged sink trips the watchdog
    within 10 x 0.4 s and the engine is dropped.  The drain's records/s
    and idle share, checkpoint and restore seconds, the trip time,
    memory after ``warm()``, and launches against batches and reports.
47-50. The elastic fleet (``rebalance_phases``), at the production table
    (2^20 rows), B=2048, K=64, the default ``logreg_int8`` params,
    ``--mega auto``, 3 shards with one ring each (3 ranks provisioned, 2
    live, shard 2 folded onto rank 0), config 5's traffic from seed 17,
    routed by the shard assignment (``Feeder``, the producer-side
    fence).  47. ``handoff_engine_2p20`` (``handoff_engine_drive``): a
    donor (shards 0 and 2, ~205,000 rows) and a recipient (shard 1) on
    the card hand shard 2 over in place, extract, adopt, drop, under the
    graphs captured at ``warm()``; every table, count and 8 more
    batches each equal the CPU engines', pointers kept, no capture, and
    ``table_summary``'s ``tracked`` moves by the rows moved; the three
    calls' ms.  48. ``rebalance_live`` (``rebalance_live_drive``): card
    ranks, shard 2 from rank 0 to rank 1 under a trickle: rows shipped =
    adopted, one flip, layout generation 1, both ranks serving during
    it, every record served; fence -> lift, the donor's serving gap,
    records/s before, during, after.  49. ``rebalance_grow``
    (``rebalance_grow_drive``): an ``ElasticPolicy(2, 3)`` fleet with
    ``--tiered-warm`` and a compile cache grows on a ring backlog; rank
    2 (a third context) loads its kernels from the pre-warmed cache,
    serves, takes shard 2, serves records routed to it; the decision's
    signals, spawn -> SERVING, cache hits, its card memory.  50.
    ``rebalance_kill_retry`` (``rebalance_kill_retry_drive``): the
    donor dies mid-ship (``handoff_crash_midship``), the abort, gen 1
    from its checkpoint, a retry; rank 1 SIGKILLed after the flip, a
    second supervisor's ``boot(adopt=True)`` census, rank 1's new
    generation adopting every shipped row from the spool, each
    generation once at the stop-drain.  Each rank's launch window (its
    report's): ``score_int8`` once per batch, ``table_summary`` once per
    run.  51. ``multihost_fleet`` (``multihost_drive``): two loopback
    hosts (``ClusterSupervisor(net=...)``, host 1 a process of its own
    booted 2 s later) of 2 card ranks each at 2^20 rows, B=2048, over one
    ``syn_benign_mix`` stream split by IP-hash over 4 shards, 192 batches
    per rank, gossiping within a host over shm and across hosts over UDP
    (epoch-rebased): records served, every key one host blocked in the
    other host's canonical maps with the originator's ``until_wall_us``,
    each host's union digest equal to the fleet's, ``rx_dup`` and
    ``epoch_skew_dropped`` 0; then host 1's supervisor and ranks are
    SIGKILLed and host 0's federation announces it dead within 6 s, the
    fleet FAILED (``hosts_dead:1``) and host 0's ranks alive.

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
import signal
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
#: ``cluster_serve``'s stream, in SERVE_BATCHES: short enough that the
#: whole script, the elastic fleet's phases included, stays under ~780 s
CLUSTER_SERVE_DEPTH = 2
#: ``sim_kernel_tier``'s stream (the simulated tier and its CPU twin run
#: at ~56 k records/s on the host): half of SERVE_BATCHES since the
#: multi-host phase came, 384 before
SIM_TIER_BATCHES = SERVE_BATCHES // 2
CROSS_BATCHES = 48
GRAPH_BATCHES = 24
MEGA_BATCHES = 23 * 8 + 6      # top-rung groups, then a 4 and a 2
OVERFLOW_BATCHES = 24
RAGGED_B = (1, 15, 2047, 2049)
#: config 5's records the fleet phases serve before the handoff (the
#: donor then tracks ~205,000 rows, half in the moving shard), and after
RB_PRE = 192 * BATCH
RB_MORE = 96 * BATCH
#: the fleet phases' live load while a handoff or a restart is on
TRICKLE_BATCHES_PER_S = 20

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


def track_runs(eng) -> dict:
    """Wrap ``eng.run`` to keep each run's report and the batches it
    dispatched (the engine's own group histogram, read also when the run
    raises, as the watchdog's does)."""
    seen = {"reports": [], "dispatched": []}
    real = eng.run

    def run(*a, **kw):
        try:
            rep = real(*a, **kw)
            seen["reports"].append(rep)
            return rep
        finally:
            seen["dispatched"].append(
                sum(g * n for g, n in eng._group_hist.items()))

    eng.run = run
    return seen


@contextlib.contextmanager
def cpu_threads(n=2):
    """The plain CPU reference runs with ``n`` threads: at this size
    torch's default pool (one per core) costs ~5x in thread hand-offs
    (66 vs 13 ms per 2,048-record batch, measured)."""
    import torch

    prev = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(prev)


def join_sink_threads(timeout_s: float = 30.0) -> None:
    """Join the sink threads a watchdog trip abandoned (released, they
    drain their group and exit)."""
    for th in threading.enumerate():
        if th.name == "fsx-sink":
            th.join(timeout=timeout_s)


def chaos_engine_drive(device: str, cfg, recs, tail, root: str,
                       watchdog: bool) -> dict:
    """The chaos campaign's three engine-side scenarios on one engine of
    ``cfg`` on ``device``, over a 1-worker ``ShardedIngest`` whose ring
    holds ``recs``, in the campaign's order: the corrupted drain
    (``scenario_slot_corruption``), the ``.prev`` fallback restore
    (``scenario_ckpt_fallback``), then ``tail`` through the engine, and
    with ``watchdog`` the wedged sink (``scenario_watchdog``), after which
    the engine is dropped.  On the card the engine is warmed first and
    the launch window opens after ``warm()``; returns the scenarios'
    results with the state after each step."""
    import hashlib
    from pathlib import Path

    import numpy as np
    import torch

    from flowsentryx_tpu_torch.chaos import campaign as chaos
    from flowsentryx_tpu_torch.core import schema, wire
    from flowsentryx_tpu_torch.engine import ArraySource, CollectSink, Engine
    from flowsentryx_tpu_torch.engine.shm import ShmRing
    from flowsentryx_tpu_torch.ingest import ShardedIngest
    from flowsentryx_tpu_torch.ops import graph, kernels

    def state(e, sink):
        k, st = schema.table_to_numpy(e.table)
        black = sorted((int(key), int(np.float32(u).view(np.uint32)))
                       for key, u in sink.blocked.items())
        return {"digest": hashlib.sha256(k.tobytes() + st.tobytes())
                .hexdigest()[:16], "stats": e.stats.to_dict(),
                "tracked": int((k != 0).sum()), "blacklist": black}

    cuda = torch.device(device).type == "cuda"
    tmp = Path(root)
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    base = str(tmp / "fring")
    ring = ShmRing.create(wire.shard_ring_path(base, 0, 1),
                          1 << (2 * len(recs) - 1).bit_length(),
                          wire.FLOW_RECORD_DTYPE)
    assert ring.produce(recs) == len(recs)
    src = ShardedIngest(base, 1, queue_slots=16, precompact=False,
                        t0_grace_s=0.2, quarantine_dir=str(tmp / "quarantine"))
    sink = CollectSink()
    out = {}
    try:
        if cuda:
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
        eng = Engine(cfg, src, sink, readback_depth=4, sink_thread=True,
                     device=device)
        runs = track_runs(eng)
        if cuda:
            built = torch.cuda.memory_allocated()
            eng.warm()
            torch.cuda.synchronize()
            # this engine's own bytes: what the process held before it
            # was built is not counted
            out["memory_after_warm"] = {
                "engine_bytes": built - base,
                "graphs_bytes": torch.cuda.memory_allocated() - built}
            kernels.reset_launches()          # the window opens
        n_cap = graph.CAPTURES
        ptrs = [eng.table.key_rows.data_ptr(), eng.table.state_rows.data_ptr(),
                *(getattr(eng.stats, f).data_ptr()
                  for f in schema.GlobalStats._fields)]
        rng = np.random.default_rng(17)
        out["slot"] = chaos.scenario_slot_corruption(eng, src, recs, rng, tmp)
        slot_rep = runs["reports"][-1]
        out["slot_run"] = {"records": slot_rep.records,
                           "batches": slot_rep.batches,
                           "wall_s": slot_rep.wall_s,
                           "records_per_s": slot_rep.records_per_s}
        out["after_slot"] = state(eng, sink)
        # the fallback restore, its two checkpoints and restore timed
        times = {"checkpoint_s": [], "restore_s": []}
        for name, key in (("checkpoint", "checkpoint_s"),
                          ("restore", "restore_s")):
            real = getattr(eng, name)

            def timed(path, real=real, key=key):
                t = time.perf_counter()
                res = real(path)
                times[key].append(time.perf_counter() - t)
                return res

            setattr(eng, name, timed)
        out["fallback"] = chaos.scenario_ckpt_fallback(eng, tmp, rng)
        out["fallback_times"] = times
        out["after_restore"] = state(eng, sink)
        out["pointers_kept"] = ptrs == [
            eng.table.key_rows.data_ptr(), eng.table.state_rows.data_ptr(),
            *(getattr(eng.stats, f).data_ptr()
              for f in schema.GlobalStats._fields)]
        # more batches through the restored engine (on the card: the
        # graphs captured before the restore)
        tail_sink = CollectSink()
        eng.reset_stream(ArraySource(tail.copy()), sink=tail_sink)
        tail_rep = eng.run()
        out["tail_run"] = {"records": tail_rep.records,
                           "batches": tail_rep.batches}
        out["after_tail"] = state(eng, tail_sink)
        out["no_new_capture"] = graph.CAPTURES == n_cap
        if watchdog:
            out["watchdog"] = chaos.scenario_watchdog(eng, rng)
        if cuda:
            torch.cuda.synchronize()
            out["launches"] = dict(kernels.LAUNCHES)   # ... and closes
        out["dispatched"] = list(runs["dispatched"])
        out["reports"] = len(runs["reports"])
        del eng
    finally:
        src.close()
        join_sink_threads()
    return out


# ---------------------------------------------------------------------------
# the self-reshaping fleet: drives shared by the card phases and the CPU
# tests (each on ``device``)
# ---------------------------------------------------------------------------

class Feeder:
    """The daemon's fan-out, routed by the shard assignment: each record's
    shard goes to the ring ``rebalance.assigned_ring_of`` names under the
    layout published now (reloaded every round, so a flip reroutes the
    next feed), and the records of a shard named by the handoff in flight
    (``handoff.json``) are held back until it ends: the producer-side
    fence.  A full ring keeps the rest back too (backpressure, no loss)."""

    def __init__(self, cluster_dir: str, rings: list, recs, total: int):
        import numpy as np

        from flowsentryx_tpu_torch.core import wire

        self.cluster_dir = cluster_dir
        self.rings = rings
        self.recs = recs
        self.total = total
        self.shard = wire.shard_of(recs["saddr"], total)
        self.cursor = 0
        self.produced = 0
        self.deferred = np.zeros(0, dtype=recs.dtype)
        self.deferred_shard = np.zeros(0, np.uint32)

    def _route(self, part, shard) -> int:
        import numpy as np

        from flowsentryx_tpu_torch.cluster import rebalance as rb

        asg = rb.ShardAssignment.load(self.cluster_dir)
        owners = asg.owners if asg is not None else tuple(range(self.total))
        moving: set = set()
        hp = rb.handoff_json_path(self.cluster_dir)
        if hp.exists():
            try:
                moving = set(json.loads(hp.read_text()).get("shards", ()))
            except (OSError, ValueError):
                pass   # mid-replace: the next round reads it whole
        hold = np.isin(shard, np.fromiter(moving, np.uint32, len(moving)))
        if hold.any():
            self.deferred = np.concatenate([self.deferred, part[hold]])
            self.deferred_shard = np.concatenate(
                [self.deferred_shard, shard[hold]])
            part, shard = part[~hold], shard[~hold]
        wrote = 0
        for s in sorted(set(int(x) for x in shard)):
            ring = self.rings[rb.assigned_ring_of(s, owners, 1)]
            sub = part[shard == np.uint32(s)]
            n = ring.produce(sub)
            if n < len(sub):
                rest = sub[n:]
                self.deferred = np.concatenate([self.deferred, rest])
                self.deferred_shard = np.concatenate(
                    [self.deferred_shard, np.full(len(rest), s, np.uint32)])
            wrote += n
        self.produced += wrote
        return wrote

    def feed(self, n: int, *, recycle: bool = False) -> int:
        import numpy as np

        wrote = 0
        if len(self.deferred):
            part, shard = self.deferred, self.deferred_shard
            self.deferred = np.zeros(0, dtype=self.recs.dtype)
            self.deferred_shard = np.zeros(0, np.uint32)
            wrote += self._route(part, shard)
        if len(self.deferred) >= n:
            return wrote   # the rings are full: hold no more
        if recycle and self.cursor >= len(self.recs):
            self.cursor = 0   # a load phase replays the corpus
        end = min(self.cursor + n, len(self.recs))
        if end > self.cursor:
            part = self.recs[self.cursor:end]
            shard = self.shard[self.cursor:end]
            self.cursor = end
            wrote += self._route(part, shard)
        return wrote

    @property
    def exhausted(self) -> bool:
        return self.cursor >= len(self.recs) and not len(self.deferred)


def handoff_engine_drive(device: str, cfg, donor_recs, recip_recs,
                         tail_d, tail_r, shards=(2,), total: int = 3
                         ) -> dict:
    """One handoff between two engines in one process, no fleet: a donor
    and a recipient on ``device`` serve their own records, then the donor
    extracts ``shards`` of ``total``, the recipient adopts the rows, the
    donor drops them, and each serves its ``tail`` (on the card through
    the graphs captured before the handoff).  Returns the state after
    each step, the counts, the three calls' seconds, whether the table
    pointers held and whether anything was captured."""
    import hashlib

    import numpy as np
    import torch

    from flowsentryx_tpu_torch.core import schema
    from flowsentryx_tpu_torch.engine import ArraySource, CollectSink, Engine
    from flowsentryx_tpu_torch.ops import graph, kernels

    cuda = torch.device(device).type == "cuda"

    def tables(e):
        return schema.table_to_numpy(e.table)

    def digest(k, st):
        return hashlib.sha256(k.tobytes() + st.tobytes()).hexdigest()[:16]

    def tracked(e):
        return kernels.table_summary(e.table, now=e._device_now,
                                     stale_s=e.cfg.table.stale_s)["tracked"]

    def ptrs(e):
        return [e.table.key_rows.data_ptr(), e.table.state_rows.data_ptr()]

    engines, reps = [], []
    for recs in (donor_recs, recip_recs):
        e = Engine(cfg, ArraySource(recs.copy()), CollectSink(),
                   device=device)
        if cuda:
            e.warm()
        engines.append(e)
    donor, recip = engines
    if cuda:
        torch.cuda.synchronize()
        kernels.reset_launches()          # the window opens
    runs = [track_runs(e) for e in engines]
    for e in engines:
        reps.append(e.run())
    out = {"served": [{"records": r.records, "batches": r.batches,
                       "tracked": r.table["tracked"]} for r in reps]}
    before = [tables(e) for e in engines]
    out["digest_before"] = [digest(*t) for t in before]
    tracked_before = [tracked(e) for e in engines]
    p0 = [ptrs(e) for e in engines]
    n_cap = graph.CAPTURES
    times = {}
    t = time.perf_counter()
    keys, states = donor.extract_span_rows(list(shards), total)
    times["extract_s"] = time.perf_counter() - t
    t = time.perf_counter()
    inserted, dropped = recip.adopt_rows(keys, states)
    times["adopt_s"] = time.perf_counter() - t
    t = time.perf_counter()
    n_drop = donor.drop_span_rows(list(shards), total)
    times["drop_s"] = time.perf_counter() - t
    after = [tables(e) for e in engines]
    tracked_after = [tracked(e) for e in engines]
    out.update({
        "rows_moved": int(len(keys)),
        "moved_digest": digest(keys, states),
        "inserted": inserted, "dropped": dropped, "rows_dropped": n_drop,
        "digest_after": [digest(*t) for t in after],
        "tracked_before": tracked_before, "tracked_after": tracked_after,
        "times_s": times,
        "pointers_kept": [ptrs(e) for e in engines] == p0,
        "no_new_capture": graph.CAPTURES == n_cap,
        # the moved rows left the donor's table and landed in the
        # recipient's, byte for byte (on the host, from the fetched tables)
        "donor_lost_the_span": int((before[0][0] != 0).sum()
                                   - (after[0][0] != 0).sum()) == len(keys),
        "recipient_holds_the_rows": bool(np.isin(
            keys, after[1][0]).all()),
    })
    tail_sinks = []
    for e, tail in zip(engines, (tail_d, tail_r)):
        ts = CollectSink()
        e.reset_stream(ArraySource(tail.copy()), sink=ts)
        r = e.run()
        tail_sinks.append(ts)
        reps.append(r)
    out["tail"] = [{"records": r.records, "batches": r.batches}
                   for r in reps[2:]]
    out["after_tail"] = [{
        "digest": digest(*tables(e)), "stats": e.stats.to_dict(),
        "blacklist": sorted((int(k), int(np.float32(u).view(np.uint32)))
                            for k, u in s.blocked.items())}
        for e, s in zip(engines, tail_sinks)]
    out["no_new_capture_after_tail"] = graph.CAPTURES == n_cap
    out["dispatched"] = [sum(r["dispatched"]) for r in runs]
    out["reports"] = len(reps)
    out["summaries"] = 4          # tracked(), before and after, per engine
    if cuda:
        torch.cuda.synchronize()
        out["launches"] = dict(kernels.LAUNCHES)   # ... and closes
    del engines, donor, recip
    return out


def _fleet_specs(device: str, cfg, base: str, n: int, total: int,
                 **extra) -> list:
    return [{"device": device, "cfg_json": cfg.to_json(), "ring_base": base,
             "workers": 1, "total_shards": total, "chunk_s": 0.1,
             "gossip_quiesce_s": 2.0, "mega": "auto", **extra}
            for _ in range(n)]


def _make_rings(base: str, total: int, slots: int) -> list:
    from flowsentryx_tpu_torch.core import wire
    from flowsentryx_tpu_torch.engine.shm import ShmRing

    return [ShmRing.create(wire.shard_ring_path(base, k, total), slots,
                           wire.FLOW_RECORD_DTYPE) for k in range(total)]


def _wait_serving(sup, status, ranks, timeout_s: float) -> bool:
    from flowsentryx_tpu_torch.core import wire

    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        sup.poll()
        if all(status[r].ctl_get("c_state") == wire.CSTATE_SERVING
               for r in ranks):
            return True
        time.sleep(0.02)
    return False


def _served(status, ranks) -> int:
    return sum(status[r].ctl_get("c_records") for r in ranks)


class Trickle:
    """Feeds ``feeder`` at ``rate`` records/s of wall time, however often
    :meth:`tick` is called (the fleet phases' live load)."""

    def __init__(self, feeder: Feeder, rate: float):
        self.feeder, self.rate = feeder, rate
        self.t = time.perf_counter()

    def tick(self) -> int:
        now = time.perf_counter()
        n = int((now - self.t) * self.rate)
        if n <= 0:
            return self.feeder.feed(0)
        self.t += n / self.rate
        return self.feeder.feed(n)


def compute_apps() -> list:
    """``nvidia-smi --query-compute-apps``: ``[pid, used MiB]`` per
    context (in a container every pid may read the same, so contexts are
    told apart by count and memory, not by pid)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60).stdout
    apps = []
    for line in out.strip().splitlines():
        pid, _, mib = line.partition(",")
        try:
            apps.append([int(pid), float(mib)])
        except ValueError:
            continue
    return sorted(apps)


def _drain_fleet(sup, status, feeder, rings, ranks, timeout_s: float,
                 feed: int) -> dict:
    """Feed out the corpus, wait for the rings to empty, stop-drain the
    fleet and aggregate."""
    deadline = time.monotonic() + timeout_s
    while not feeder.exhausted and time.monotonic() < deadline:
        sup.poll()
        feeder.feed(feed)
        time.sleep(0.01)
    while (any(r.readable() for r in rings)
           and time.monotonic() < deadline):
        sup.poll()
        time.sleep(0.02)
    sup.request_stop()
    while (len(sup._done) + len(sup._failed) < len(sup._active)
           and time.monotonic() < deadline + 120):
        sup.poll()
        time.sleep(0.02)
    sup.close()
    agg = sup.aggregate()
    agg["rings_left"] = [r.readable() for r in rings]
    return agg


def _rebalance_of(agg: dict, rank: int, gen: int | None = None) -> dict:
    best: dict = {}
    for rep in agg["reports"]:
        if rep.get("rank") == rank and (gen is None or rep.get("gen") == gen):
            best = rep.get("report", {}).get("rebalance") or best
    return best


def _rank_windows(agg: dict) -> dict:
    """Each rank report's launch window against its batches and runs."""
    out = {}
    for rep in agg["reports"]:
        r = rep.get("report") or {}
        out[f"r{rep['rank']}g{rep['gen']}"] = {
            "launches": rep.get("launches", {}), "batches": r.get("batches"),
            "runs": rep.get("runs"), "records": r.get("records"),
            "device": (r.get("device") or {}).get("type")}
    return out


def _windows_ok(windows: dict, device: str) -> bool:
    """On the card: ``score_int8`` once per dispatched batch and
    ``table_summary`` once per run (its report) in every rank's window."""
    if device != "cuda":
        return True
    return all(w["device"] == "cuda"
               and w["launches"].get("score_int8") == w["batches"]
               and w["launches"].get("table_summary") == w["runs"]
               for w in windows.values())


def rebalance_live_drive(device: str, root: str, cfg, recs, pre: int,
                         timeout_s: float = 240.0) -> dict:
    """Phase A of the reference's rebalance smoke on ``device``: a fleet
    provisioned at 3 ranks boots 2 (shard 2 folded onto rank 0), serves
    the first ``pre`` records routed by the :class:`Feeder`, then moves
    shard 2 from rank 0 to rank 1 through the whole protocol while a
    trickle keeps flowing, then serves the rest and drains."""
    import numpy as np

    from flowsentryx_tpu_torch.cluster import rebalance as rb
    from flowsentryx_tpu_torch.cluster.mailbox import StatusBlock, status_path
    from flowsentryx_tpu_torch.cluster.supervisor import ClusterSupervisor
    from flowsentryx_tpu_torch.core import wire

    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    total, batch = 3, cfg.batch.max_batch
    base = os.path.join(root, "ring")
    plane = os.path.join(root, "plane")
    rings = _make_rings(base, total, 1 << (len(recs) - 1).bit_length())
    sup = ClusterSupervisor(plane, _fleet_specs(device, cfg, base, 3, total),
                            t0_ns=int(recs["ts_ns"].min()),
                            heartbeat_timeout_s=60.0, n_live=2)
    sup.boot()
    status = [StatusBlock(status_path(plane, r)) for r in range(3)]
    feeder = Feeder(plane, rings, recs, total)
    out, checks = {}, {}
    try:
        t = time.perf_counter()
        checks["serving"] = _wait_serving(sup, status, (0, 1), timeout_s)
        out["boot_s"] = time.perf_counter() - t
        # the donor's rows before the handoff: the sources of its shards
        sh = wire.shard_of(recs["saddr"][:pre], total)
        out["donor_sources"] = int(len(np.unique(
            recs["saddr"][:pre][(sh == 0) | (sh == 2)])))
        out["moving_sources"] = int(len(np.unique(
            recs["saddr"][:pre][sh == 2])))
        t = time.perf_counter()
        feeder.feed(pre)
        deadline = time.monotonic() + timeout_s
        while (_served(status, (0, 1)) < feeder.produced
               and time.monotonic() < deadline):
            sup.poll()
            feeder.feed(0)   # the held-back tail, when a ring was full
            time.sleep(0.005)
        wall = time.perf_counter() - t
        out["before"] = {"records": feeder.produced, "wall_s": wall,
                         "records_per_s": feeder.produced / max(wall, 1e-9)}
        checks["prefill_served"] = _served(status, (0, 1)) == feeder.produced
        # the handoff, with a trickle of every shard meanwhile (the
        # feeder holds shard 2 back while it is fenced)
        served0 = [status[r].ctl_get("c_records") for r in (0, 1)]
        t_fence = time.perf_counter()
        hid = sup.start_handoff([2], donor=0, recipient=1)
        last_hb = status[0].ctl_get("c_hbeat")
        gap_s = t_shipped = None
        deadline = time.monotonic() + timeout_s
        trickle = Trickle(feeder, TRICKLE_BATCHES_PER_S * batch)
        next_poll = 0.0
        while sup._handoff is not None and time.monotonic() < deadline:
            if time.perf_counter() >= next_poll:
                sup.poll()
                trickle.tick()
                next_poll = time.perf_counter() + 0.01
            ack = status[0].ctl_get("c_handoff")
            if t_shipped is None and rb._phase_of(ack, hid) >= wire.HP_SHIPPED:
                now_ns = time.clock_gettime_ns(time.CLOCK_MONOTONIC)
                t_shipped = time.perf_counter() - t_fence
                # the donor ticks its heartbeat while it serves and not
                # while it extracts and ships: its last beat before the
                # ack is where its serving stopped
                gap_s = (now_ns - last_hb) * 1e-9
            elif t_shipped is None:
                last_hb = status[0].ctl_get("c_hbeat")
            time.sleep(0.001)
        t_lift = time.perf_counter() - t_fence
        served1 = [status[r].ctl_get("c_records") for r in (0, 1)]
        during = sum(served1) - sum(served0)
        out["handoff"] = {
            "id": hid, "fence_to_lift_s": t_lift,
            "fence_to_shipped_s": t_shipped, "donor_serving_gap_s": gap_s,
            "served_per_rank": [b - a for a, b in zip(served0, served1)],
            "records_per_s": during / max(t_lift, 1e-9)}
        checks["handoff_completed"] = sup._handoff is None
        checks["both_ranks_served_during"] = all(
            b > a for a, b in zip(served0, served1))
        checks["one_flip_no_abort"] = (
            sup.rebalance_counters["flips"] == 1
            and sup.rebalance_counters["aborts"] == 0)
        asg = rb.ShardAssignment.load(plane)
        out["layout"] = {"generation": asg.generation,
                         "owners": list(asg.owners)}
        checks["layout_gen1_shard2_rank1"] = (asg.generation == 1
                                              and asg.owners[2] == 1)
        # the rest of the corpus at once, served by the new layout
        t = time.perf_counter()
        n0 = _served(status, (0, 1))
        feeder.feed(len(recs))
        deadline = time.monotonic() + timeout_s
        while (_served(status, (0, 1)) < feeder.produced
               and time.monotonic() < deadline):
            sup.poll()
            feeder.feed(0)
            time.sleep(0.005)
        wall = time.perf_counter() - t
        n = _served(status, (0, 1)) - n0
        out["after"] = {"records": n, "wall_s": wall,
                        "records_per_s": n / max(wall, 1e-9)}
        agg = _drain_fleet(sup, status, feeder, rings, (0, 1), timeout_s,
                           batch * 16)
    finally:
        sup.close()
    donor, recip = _rebalance_of(agg, 0), _rebalance_of(agg, 1)
    out["conservation"] = {k: v.get(k, 0) for v, k in (
        (donor, "rows_shipped"), (recip, "rows_adopted"),
        (recip, "adopt_dropped"), (donor, "rows_dropped_post_flip"),
        (donor, "handoffs_donated"), (recip, "handoffs_adopted"))}
    out["rebalance_counters"] = dict(sup.rebalance_counters)
    checks["rows_conserved"] = (
        donor.get("rows_shipped", 0) > 0
        and donor.get("rows_shipped") == recip.get("rows_adopted")
        and not recip.get("adopt_dropped"))
    checks["every_record_served"] = (agg["records"] == feeder.produced
                                     and not any(agg["rings_left"]))
    checks["no_failed_rank"] = (agg["failed_ranks"] == []
                                and not any(agg["restarts"]))
    out["records"] = {"produced": feeder.produced, "served": agg["records"]}
    out["windows"] = _rank_windows(agg)
    checks["launch_windows"] = _windows_ok(out["windows"], device)
    out["boots"] = {f"r{r['rank']}": {k: (r["report"].get("boot") or {})
                                      .get(k) for k in (
        "import_s", "reconcile_s", "serving_ready_s")}
        for r in agg["reports"]}
    return {"ok": all(checks.values()), "checks": checks, **out}


def rebalance_grow_drive(device: str, root: str, cfg, recs,
                         timeout_s: float = 300.0) -> dict:
    """Phase B on ``device``: an ``ElasticPolicy(min_engines=2,
    max_engines=3)`` fleet with ``--tiered-warm`` and a compile cache (so
    the pre-warm child runs) under a ring backlog the feeder keeps above
    the grow bar: the policy decides GROW from the ring cursors, rank 2
    spawns, serves, takes half the hottest span, and serves the records
    routed to it.  On the card the boot's processes build the kernels
    into a fresh ``FSX_KERNEL_BUILD`` directory (storing them in the
    cache), and rank 2 spawns with another, empty one: it loads every
    kernel from the cache the pre-warm child filled."""
    from flowsentryx_tpu_torch.cluster import rebalance as rb
    from flowsentryx_tpu_torch.cluster.elastic import ElasticPolicy
    from flowsentryx_tpu_torch.cluster.mailbox import StatusBlock, status_path
    from flowsentryx_tpu_torch.cluster.supervisor import ClusterSupervisor
    from flowsentryx_tpu_torch.core import wire

    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    total, batch = 3, cfg.batch.max_batch
    base = os.path.join(root, "ring")
    plane = os.path.join(root, "plane")
    rings = _make_rings(base, total, 1 << 18)
    policy = ElasticPolicy(min_engines=2, max_engines=3, grow_backlog=64.0,
                           shrink_backlog=0.0, skew_ratio=1e9,
                           hysteresis_ticks=2, cooldown_s=2.0)
    specs = _fleet_specs(device, cfg, base, 3, total, tiered_warm=True,
                         compile_cache=os.path.join(root, "cache"))
    sup = ClusterSupervisor(plane, specs, t0_ns=int(recs["ts_ns"].min()),
                            heartbeat_timeout_s=60.0, n_live=2,
                            elastic=policy)
    env_build = os.environ.get("FSX_KERNEL_BUILD")
    os.environ["FSX_KERNEL_BUILD"] = os.path.join(root, "kbuild_boot")
    try:
        sup.boot()
    finally:
        # the spare spawns later with an empty build directory
        os.environ["FSX_KERNEL_BUILD"] = os.path.join(root, "kbuild_spare")
    status = [StatusBlock(status_path(plane, r)) for r in range(3)]
    feeder = Feeder(plane, rings, recs, total)
    out, checks = {}, {}
    mem = {}
    try:
        checks["serving"] = _wait_serving(sup, status, (0, 1), timeout_s)
        t = time.perf_counter()
        if sup._prewarm_proc is not None:
            sup._prewarm_proc.join(timeout=timeout_s)
            out["prewarm_exitcode"] = sup._prewarm_proc.exitcode
        out["prewarm_wait_s"] = time.perf_counter() - t
        checks["prewarm_done"] = out.get("prewarm_exitcode") == 0
        if device == "cuda":
            import torch

            mem["free_before_grow"] = torch.cuda.mem_get_info()[0]
            out["compute_apps_before_grow"] = compute_apps()
        t_spawn = t_serving = None
        deadline = time.monotonic() + timeout_s
        grown = False
        while time.monotonic() < deadline:
            sup.poll()
            plan = sup.elastic_tick()
            if (t_spawn is None and plan is not None
                    and plan["action"] == "grow" and 2 in sup._active):
                t_spawn = time.perf_counter()
                out["grow_decision"] = plan
            feeder.feed(batch * 64, recycle=True)
            if (t_spawn is not None and t_serving is None
                    and status[2].ctl_get("c_state") == wire.CSTATE_SERVING):
                t_serving = time.perf_counter() - t_spawn
                if device == "cuda":
                    mem["free_rank2_serving"] = torch.cuda.mem_get_info()[0]
                    out["compute_apps_rank2_serving"] = compute_apps()
            if (t_serving is not None and sup._handoff is None
                    and sup.rebalance_counters["flips"] >= 1):
                grown = True
                break
            time.sleep(0.01)
        out["spawn_to_serving_s"] = t_serving
        out["grow_to_flip_s"] = (time.perf_counter() - t_spawn
                                 if t_spawn else None)
        # the decision and the spawn are one elastic tick
        out["decision_to_spawn_s"] = 0.0 if t_spawn else None
        checks["grew_and_flipped"] = grown
        asg = rb.ShardAssignment.load(plane)
        out["owners"] = list(asg.owners)
        checks["rank2_owns_a_shard"] = 2 in set(asg.owners)
        growths = [d for d in policy.decisions if d["action"] == "grow"]
        checks["grow_logged_with_signals"] = bool(growths) and (
            "backlog_per_engine" in growths[-1]["signals"])
        checks["executed"] = sup.elastic_executed >= 1
        checks["prewarm_spawned"] = sup.prewarm_spawned == 1
        n_rec = feeder.produced
        # replay no more: feed out the corpus and drain
        agg = _drain_fleet(sup, status, feeder, rings, (0, 1, 2), timeout_s,
                           batch * 16)
    finally:
        sup.close()
        if env_build is None:
            os.environ.pop("FSX_KERNEL_BUILD", None)
        else:
            os.environ["FSX_KERNEL_BUILD"] = env_build
    r2 = [rep for rep in agg["reports"] if rep.get("rank") == 2]
    r2rep = r2[-1]["report"] if r2 else {}
    checks["rank2_served_records"] = bool(r2rep.get("records"))
    if device == "cuda":
        # every kernel of rank 2 came out of the pre-warmed cache
        cache2 = (r2rep.get("boot") or {}).get("cache") or {}
        checks["rank2_cache_hits"] = (cache2.get("hits", 0) > 0
                                      and cache2.get("misses", 1) == 0)
    checks["no_failed_rank"] = (agg["failed_ranks"] == []
                                and not any(agg["restarts"]))
    checks["every_record_served"] = (agg["records"] == feeder.produced
                                     and not any(agg["rings_left"]))
    boot2 = r2rep.get("boot") or {}
    out.update({
        "records": {"produced": feeder.produced, "served": agg["records"],
                    "at_grow": n_rec},
        "rank2": {"records": r2rep.get("records"),
                  "batches": r2rep.get("batches"),
                  "boot": {k: boot2.get(k) for k in (
                      "import_s", "reconcile_s", "serving_ready_s",
                      "time_to_first_verdict_s")},
                  "cache": boot2.get("cache")},
        "cache_hits_rank2": (boot2.get("cache") or {}).get("hits"),
        "elastic": {k: v for k, v in (agg.get("elastic") or {}).items()
                    if k != "decisions"},
        "rebalance_counters": dict(sup.rebalance_counters),
        "rank2_rebalance": _rebalance_of(agg, 2)})
    if mem:
        out["card_mib_rank2_context"] = (
            mem["free_before_grow"] - mem.get("free_rank2_serving",
                                              mem["free_before_grow"])) / 2**20
    out["windows"] = _rank_windows(agg)
    checks["launch_windows"] = _windows_ok(out["windows"], device)
    return {"ok": all(checks.values()), "checks": checks, **out}


def rebalance_kill_retry_drive(device: str, root: str, cfg, recs,
                               ckpt_every: float,
                               timeout_s: float = 300.0,
                               trickle_batches_per_s: float = 8.0) -> dict:
    """Phase C on ``device``, then a re-attach.  The donor carries
    ``handoff_crash_midship`` and dies halfway through its ship: the
    supervisor aborts (the donor keeps the span), respawns it at gen 1
    from its checkpoint (every ``ckpt_every`` s), and a retry commits.
    Then rank 1, the recipient, is SIGKILLed right after the fence lifts,
    this supervisor stops supervising, and a second one boots with
    ``adopt=True``: it adopts rank 0 untouched and respawns rank 1 at
    gen+1.  Rank 1 checkpoints only at its exit, so the adopted rows' one
    durable copy is the staged spool: the new generation's boot-time
    reconcile must adopt every shipped row from it (exact conservation
    across the recipient's death after the flip).  The stop-drain then
    accounts every generation once."""
    from flowsentryx_tpu_torch.cluster import rebalance as rb
    from flowsentryx_tpu_torch.cluster.mailbox import StatusBlock, status_path
    from flowsentryx_tpu_torch.cluster.supervisor import ClusterSupervisor
    from flowsentryx_tpu_torch.core import wire

    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    total, batch = 3, cfg.batch.max_batch
    base = os.path.join(root, "ring")
    plane = os.path.join(root, "plane")
    rings = _make_rings(base, total, 1 << (len(recs) - 1).bit_length())
    specs = _fleet_specs(device, cfg, base, 3, total)
    for r, spec in enumerate(specs):
        spec["checkpoint"] = os.path.join(root, f"ckpt_r{r}.npz")
    specs[0]["checkpoint_every"] = ckpt_every
    specs[0]["handoff_crash_midship"] = True
    t0_ns = int(recs["ts_ns"].min())
    sup = ClusterSupervisor(plane, specs, t0_ns=t0_ns,
                            heartbeat_timeout_s=60.0, n_live=2)
    sup.boot()
    status = [StatusBlock(status_path(plane, r)) for r in range(3)]
    feeder = Feeder(plane, rings, recs, total)
    out, checks = {}, {}
    sup_b = None
    try:
        checks["serving"] = _wait_serving(sup, status, (0, 1), timeout_s)
        feeder.feed(len(recs) // 4)
        deadline = time.monotonic() + timeout_s
        ck0 = specs[0]["checkpoint"]
        while ((not os.path.exists(ck0)
                or _served(status, (0, 1)) < feeder.produced)
               and time.monotonic() < deadline):
            sup.poll()
            feeder.feed(0)
            time.sleep(0.01)
        # a slower trickle: it must last through two restarts
        trickle = Trickle(feeder, trickle_batches_per_s * batch)
        checks["donor_checkpointed"] = os.path.exists(ck0)
        t_fence = time.perf_counter()
        hid = sup.start_handoff([2], donor=0, recipient=1)
        disarmed, t_dead, t_abort, t_gen1 = False, None, None, None
        spawned = False
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            p0 = sup._procs[0]
            if not disarmed and p0 is not None and not p0.is_alive():
                # the corpse is seen: disarm the chaos spec before the
                # poll that respawns it, so gen 1 ships cleanly
                specs[0]["handoff_crash_midship"] = False
                disarmed, t_dead = True, time.perf_counter()
            sup.poll()
            trickle.tick()
            if t_abort is None and sup.rebalance_counters["aborts"]:
                t_abort = time.perf_counter()
            # the corpse's state reads SERVING until gen 1 stamps
            # SPAWNING: gen 1 serves once it was seen spawning
            st0 = status[0].ctl_get("c_state")
            if disarmed and status[0].ctl_get("c_gen") == 1:
                spawned = spawned or st0 == wire.CSTATE_SPAWNING
                if spawned and st0 == wire.CSTATE_SERVING:
                    t_gen1 = time.perf_counter()
                    break
            time.sleep(0.005)
        out["crash"] = {
            "fence_to_death_s": (t_dead - t_fence) if t_dead else None,
            "death_to_abort_s": (t_abort - t_dead)
            if t_abort and t_dead else None,
            "death_to_gen1_serving_s": (t_gen1 - t_dead)
            if t_gen1 and t_dead else None}
        checks["donor_died_and_restarted"] = (disarmed
                                              and sup.restarts[0] == 1
                                              and t_gen1 is not None)
        checks["one_abort"] = sup.rebalance_counters["aborts"] == 1
        checks["abort_moved_nothing"] = (
            rb.ShardAssignment.load(plane).generation == 0)
        t = time.perf_counter()
        hid2 = sup.start_handoff([2], donor=0, recipient=1)
        deadline = time.monotonic() + timeout_s
        while sup._handoff is not None and time.monotonic() < deadline:
            sup.poll()
            trickle.tick()
            time.sleep(0.01)
        out["retry"] = {"id": hid2, "fence_to_lift_s":
                        time.perf_counter() - t}
        checks["retry_committed"] = (sup._handoff is None
                                     and sup.rebalance_counters["flips"] == 1)
        checks["recipient_inserted"] = rb._phase_of(
            status[1].ctl_get("c_handoff"), hid2) == wire.HP_INSERTED
        spool = rb.load_spool(rb.staged_path(plane, 1))
        out["retry"]["spool_rows"] = (None if spool is None
                                      else int(len(spool["keys"])))
        # the re-attach: SIGKILL rank 1, and this supervisor stops
        # supervising; a second one adopts the live plane
        gen0_before = status[0].ctl_get("c_gen")
        gen1_before = status[1].ctl_get("c_gen")
        t_kill = time.perf_counter()
        sup.kill(1)
        sup_b = ClusterSupervisor(plane, specs, heartbeat_timeout_s=60.0,
                                  n_live=2)
        sup_b.boot(adopt=True)
        out["census"] = {"adopted": sorted(sup_b._adopted),
                         "restarts": list(sup_b.restarts),
                         "gens": list(sup_b._gen)}
        checks["census"] = (sup_b._adopted == {0}
                            and sup_b.restarts[:2] == [0, 1]
                            and sup_b._gen[1] == gen1_before + 1
                            and sup_b._gen[0] == gen0_before)
        t_serving, spawned = None, False
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            sup_b.poll()
            trickle.tick()
            st1 = status[1].ctl_get("c_state")
            if status[1].ctl_get("c_gen") == gen1_before + 1:
                spawned = spawned or st1 == wire.CSTATE_SPAWNING
                if spawned and st1 == wire.CSTATE_SERVING:
                    t_serving = time.perf_counter() - t_kill
                    break
            time.sleep(0.005)
        out["census"]["kill_to_serving_s"] = t_serving
        checks["rank1_reserved"] = t_serving is not None
        agg = _drain_fleet(sup_b, status, feeder, rings, (0, 1), timeout_s,
                           batch * 4)
    finally:
        if sup_b is not None:
            sup_b.close()
        sup.close()
    keys = [(r["rank"], r["gen"]) for r in agg["reports"]]
    out["reports"] = sorted(keys)
    checks["each_generation_once"] = len(set(keys)) == len(keys)
    checks["no_failed_rank"] = agg["failed_ranks"] == []
    checks["rank0_untouched"] = (status[0].ctl_get("c_gen") == gen0_before
                                 and agg["adopted_ranks"] == [])
    donor = _rebalance_of(agg, 0, gen=1)
    g1 = [r for r in agg["reports"] if r["rank"] == 1
          and r["gen"] == gen1_before + 1]
    recip = _rebalance_of(agg, 1, gen=gen1_before + 1)
    reconciled = g1[0].get("reconciled") or {} if g1 else {}
    out["conservation"] = {
        "rows_shipped": donor.get("rows_shipped", 0),
        "rows_staged": sup.rebalance_counters["rows_shipped"],
        "spool_rows": out["retry"]["spool_rows"],
        "reconcile_adopted_rows": reconciled.get("adopted_rows"),
        "rows_adopted": recip.get("rows_adopted", 0),
        "adopt_dropped": recip.get("adopt_dropped", 0)}
    checks["retry_conserved"] = (
        donor.get("rows_shipped", 0) > 0
        and donor.get("rows_shipped")
        == sup.rebalance_counters["rows_shipped"]
        == out["retry"]["spool_rows"]
        == reconciled.get("adopted_rows")
        and not recip.get("adopt_dropped"))
    gen1 = [r for r in agg["reports"] if r["rank"] == 0 and r["gen"] == 1]
    checks["gen1_restored"] = bool(gen1) and bool(gen1[0].get("restored"))
    # the new generations served records of their own
    checks["new_generations_served"] = all(
        (r.get("report") or {}).get("records", 0) > 0
        for r in agg["reports"])
    out["rebalance_counters"] = dict(sup.rebalance_counters)
    out["records"] = {"produced": feeder.produced, "served": agg["records"]}
    out["windows"] = _rank_windows(agg)
    checks["launch_windows"] = _windows_ok(out["windows"], device)
    return {"ok": all(checks.values()), "checks": checks, **out}


def rebalance_phases(card: str, served: dict) -> None:
    """The self-reshaping fleet on the card: ``handoff_engine_2p20``,
    ``rebalance_live``, ``rebalance_grow`` and ``rebalance_kill_retry``,
    at the production table (2^20 rows, 8 probes), B=2048, K=64, the
    default ``logreg_int8`` params, one ring per rank over 3 shards (3
    ranks provisioned, 2 live, shard 2 folded onto rank 0), traffic of
    BASELINE config 5 (``mixed_l34_1m``) from seed 17.  Each fleet rank's
    launch window is its report's; ``served["launches_cluster"]`` keeps
    them for the kernels line."""
    import torch

    from flowsentryx_tpu_torch import benchmarks
    from flowsentryx_tpu_torch.core import wire
    from flowsentryx_tpu_torch.core.config import FsxConfig
    from flowsentryx_tpu_torch.engine import TrafficGen

    root = os.path.join(REPO, "build", "rebalance")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    suite5 = next(sb for sb in benchmarks.scenario_suite(1.0)
                  if sb.name.startswith("config5"))
    spec = dataclasses.replace(suite5.traffic, seed=17)
    cfg = FsxConfig()
    recs = TrafficGen(spec).next_records(RB_PRE + RB_MORE)
    windows = served.setdefault("launches_cluster", {})

    def keep(name, res):
        for k, w in res.get("windows", {}).items():
            windows[f"{name}/{k}"] = w["launches"]
        return res

    @phase("handoff_engine_2p20")
    def handoff_engine_phase():
        """``handoff_engine_drive`` on the card and on the CPU: the donor
        serves config 5's records of shards 0 and 2 (at least 200,000
        rows, half in shard 2), the recipient those of shard 1; extract,
        adopt and drop of shard 2 in place; 8 more batches each."""
        sh = wire.shard_of(recs["saddr"], 3)
        pre_sh = sh[:RB_PRE]
        d_all = recs[(sh == 0) | (sh == 2)]
        r_all = recs[sh == 1]
        n_d = int(((pre_sh == 0) | (pre_sh == 2)).sum())
        n_r = int((pre_sh == 1).sum())
        tail = 8 * BATCH
        args = (d_all[:n_d], r_all[:n_r], d_all[n_d:n_d + tail],
                r_all[n_r:n_r + tail])
        got = handoff_engine_drive("cuda", cfg, *args)
        join_sink_threads()
        with cpu_threads():
            want = handoff_engine_drive("cpu", cfg, *args)
        same = {k: got[k] == want[k] for k in (
            "served", "digest_before", "rows_moved", "moved_digest",
            "inserted", "dropped", "rows_dropped", "digest_after",
            "tracked_before", "tracked_after", "tail", "after_tail")}
        launches = got["launches"]
        checks = {
            **{f"equal_cpu_{k}": v for k, v in same.items()},
            "pointers_kept": got["pointers_kept"],
            "no_new_capture": got["no_new_capture"]
            and got["no_new_capture_after_tail"],
            "donor_tracks_200k": got["tracked_before"][0] >= 200_000,
            "tracked_moved_by_the_rows": (
                got["tracked_before"][0] - got["tracked_after"][0]
                == got["rows_dropped"] == got["rows_moved"]
                and got["tracked_after"][1] - got["tracked_before"][1]
                == got["inserted"] == got["rows_moved"]),
            "none_dropped": got["dropped"] == 0,
            "donor_lost_the_span": got["donor_lost_the_span"],
            "recipient_holds_the_rows": got["recipient_holds_the_rows"],
            "score_int8_per_batch": launches["score_int8"]
            == sum(got["dispatched"]),
            "table_summary_per_report": launches["table_summary"]
            == got["reports"] + got["summaries"]}
        served["launches_handoff_engine_2p20"] = launches
        return {"ok": all(checks.values()), "card": card, "checks": checks,
                "rows": cfg.table.capacity, "B": cfg.batch.max_batch,
                "rows_moved": got["rows_moved"],
                "ms": {k[:-2]: v * 1e3 for k, v in got["times_s"].items()},
                "cpu_ms": {k[:-2]: v * 1e3
                           for k, v in want["times_s"].items()},
                "tracked_before": got["tracked_before"],
                "tracked_after": got["tracked_after"],
                "served": got["served"], "launches": launches,
                "dispatched": got["dispatched"]}

    handoff_engine_phase()

    @phase("rebalance_live")
    def live_phase():
        """``rebalance_live_drive`` on the card (the reference smoke's
        phase A with card ranks)."""
        res = keep("rebalance_live", rebalance_live_drive(
            "cuda", os.path.join(root, "live"), cfg, recs, pre=RB_PRE))
        return {"card": card, **res}

    live_phase()

    @phase("rebalance_grow")
    def grow_phase():
        """``rebalance_grow_drive`` on the card (phase B): the third CUDA
        context spawned by a GROW."""
        res = keep("rebalance_grow", rebalance_grow_drive(
            "cuda", os.path.join(root, "grow"), cfg, recs))
        return {"card": card, **res}

    grow_phase()

    @phase("rebalance_kill_retry")
    def kill_phase():
        """``rebalance_kill_retry_drive`` on the card (phase C, then the
        re-attach)."""
        res = keep("rebalance_kill_retry", rebalance_kill_retry_drive(
            "cuda", os.path.join(root, "kill"), cfg, recs, ckpt_every=1.0))
        return {"card": card, **res}

    kill_phase()
    torch.cuda.synchronize()


# -- the multi-host fleet: two loopback hosts, UDP gossip, the federation -----

#: The multi-host phase's engines per host and hosts (4 card contexts).
MH_ENGINES = 2
MH_HOSTS = 2
#: Host 1's supervisor boots this long after host 0's, so every
#: cross-host merge rebases by a non-zero epoch delta.
MH_HOST_GAP_S = 2.0


def _free_base_ports(n_hosts: int, n_engines: int) -> list:
    """``n_hosts`` UDP base ports on 127.0.0.1, each with its
    ``base+1..base+n_engines`` free too (probed by binding them all; the
    kernel picks the bases)."""
    import socket

    held, bases = [], []
    try:
        while len(bases) < n_hosts:
            s0 = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            s0.bind(("127.0.0.1", 0))
            base = s0.getsockname()[1]
            group = [s0]
            try:
                for r in range(1, n_engines + 1):
                    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
                    group.append(s)
                    s.bind(("127.0.0.1", base + r))
            except OSError:
                for s in group:
                    s.close()
                continue
            held += group
            bases.append(base)
    finally:
        for s in held:
            s.close()
    return bases


def multihost_host(args_path: str) -> None:
    """Host 1 of :func:`multihost_drive`: its own supervisor process (own
    session, so a SIGKILL of its group is the host's death), supervising
    its ranks until it is killed or its deadline passes."""
    from flowsentryx_tpu_torch.cluster.supervisor import ClusterSupervisor
    from flowsentryx_tpu_torch.sync import tuning

    with open(args_path) as f:
        a = json.load(f)
    sup = ClusterSupervisor(a["plane"], a["specs"], net=a["net"],
                            heartbeat_timeout_s=60.0)
    sup.boot()
    deadline = time.monotonic() + a["deadline_s"]
    try:
        while time.monotonic() < deadline:
            sup.poll()
            time.sleep(tuning.SUPERVISOR_POLL_S)
    finally:
        sup.close(timeout_s=5.0)


def _read_report(path: str):
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None       # not written yet, or caught mid-write


def multihost_drive(device: str, root: str, cfg, artifact: str | None,
                    batches: int = 192, seed: int = SEED,
                    timeout_s: float = 240.0) -> dict:
    """Two hosts of ``MH_ENGINES`` ranks each on loopback, over one
    ``syn_benign_mix`` stream split by the daemon's IP-hash over four
    shards (shards 0-1 to host 0's rings, 2-3 to host 1's), each rank
    serving ``batches`` batches of ``cfg`` on ``device``.

    Host 0's supervisor runs in this process; host 1's is a child
    process in its own session (:func:`multihost_host`), booted
    ``MH_HOST_GAP_S`` later, so the hosts' epochs differ.  Both fleets
    run in drain mode and start together; after its drain each rank
    merges the network leg until its canonical map holds still for two
    resync intervals, writes its report (its ``net_map`` and its own
    keys included) and keeps gossiping until stopped.  Then host 1's
    supervisor and engines are SIGKILLed: host 0's federation must
    announce the death within ``NET_HOST_TIMEOUT_S +
    NET_BEACON_INTERVAL_S`` and fold the fleet FAILED while its own
    ranks keep running; host 0 then stop-drains."""
    import numpy as np

    from flowsentryx_tpu_torch.cluster.mailbox import StatusBlock, status_path
    from flowsentryx_tpu_torch.cluster.supervisor import ClusterSupervisor
    from flowsentryx_tpu_torch.cluster.transport import map_digest
    from flowsentryx_tpu_torch.core import wire
    from flowsentryx_tpu_torch.engine import Scenario, TrafficGen, TrafficSpec
    from flowsentryx_tpu_torch.sync import tuning

    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    n, B = MH_ENGINES, cfg.batch.max_batch
    per_rank = batches * B
    bases = _free_base_ports(MH_HOSTS, n)
    hosts = [["127.0.0.1", p] for p in bases]
    planes = [os.path.join(root, f"h{h}", "plane") for h in range(MH_HOSTS)]
    ring_bases = [os.path.join(root, f"h{h}", "ring")
                  for h in range(MH_HOSTS)]
    slots = 1 << (per_rank - 1).bit_length()
    for h in range(MH_HOSTS):
        os.makedirs(os.path.join(root, f"h{h}"))
    rings = [_make_rings(ring_bases[h], n, slots) for h in range(MH_HOSTS)]
    settle_s = 2 * tuning.NET_RESYNC_INTERVAL_S
    specs, nets = [], []
    for h in range(MH_HOSTS):
        nets.append({"hosts": hosts, "host_id": h, "engines_per_host": n,
                     "listen": None})
        sp = _fleet_specs(device, cfg, ring_bases[h], n, n, drain=True,
                          artifact=artifact, net_settle_s=settle_s)
        for r, s in enumerate(sp):
            s["ready_token"] = os.path.join(planes[h], f"ready_r{r}")
            s["start_token"] = os.path.join(planes[h], "start")
        specs.append(sp)
    out, checks = {"ports": bases}, {}
    sup = ClusterSupervisor(planes[0], specs[0], net=nets[0],
                            heartbeat_timeout_s=60.0)
    child = None
    host1_pids: list = []

    def kill_host1() -> None:
        for pid in ([child.pid] if child is not None else []) + host1_pids:
            try:
                os.killpg(pid, signal.SIGKILL)
            except OSError:
                pass

    try:
        t_boot0 = time.monotonic()
        sup.boot()
        args_path = os.path.join(root, "host1.json")
        with open(args_path, "w") as f:
            json.dump({"plane": planes[1], "specs": specs[1], "net": nets[1],
                       "deadline_s": timeout_s + 120.0}, f)
        while time.monotonic() < t_boot0 + MH_HOST_GAP_S:
            sup.poll()
            time.sleep(0.02)
        log = open(os.path.join(root, "host1.log"), "wb")
        child = subprocess.Popen(
            [sys.executable, "-c",
             "import sys; sys.path.insert(0, sys.argv[2]); import chip_smoke; "
             "chip_smoke.multihost_host(sys.argv[1])", args_path, REPO],
            cwd=REPO, stdout=log, stderr=subprocess.STDOUT,
            start_new_session=True)
        log.close()
        deadline = time.monotonic() + timeout_s
        tokens = [s["ready_token"] for sp in specs for s in sp]
        status = [[None] * n for _ in range(MH_HOSTS)]
        while time.monotonic() < deadline:
            sup.poll()
            for h in range(MH_HOSTS):
                for r in range(n):
                    p = status_path(planes[h], r)
                    if status[h][r] is None and os.path.exists(
                            os.path.join(planes[h], "plane.json")):
                        status[h][r] = StatusBlock(p)
            if all(os.path.exists(t) for t in tokens) or sup._failed \
                    or child.poll() is not None:
                break
            time.sleep(0.02)
        checks["all_ranks_warm"] = all(os.path.exists(t) for t in tokens)
        t0w = [status[h][0].ctl_get("c_t0_wall") for h in range(MH_HOSTS)]
        out["t0_wall_ns"] = t0w
        out["epoch_delta_s"] = (t0w[1] - t0w[0]) * 1e-9
        checks["epoch_delta_nonzero"] = out["epoch_delta_s"] >= MH_HOST_GAP_S
        # spawn (the epoch stamp, just before the spawns) -> warm (ready)
        out["spawn_to_ready_s"] = {
            f"h{h}r{r}": (os.stat(specs[h][r]["ready_token"]).st_mtime_ns
                          - t0w[h]) * 1e-9
            for h in range(MH_HOSTS) for r in range(n)
            if os.path.exists(specs[h][r]["ready_token"])}
        if device == "cuda":
            out["compute_apps"] = compute_apps()
        # the traffic, stamped now (after both epochs): one stream, the
        # daemon's IP-hash over four shards, host h rank r = shard 2h+r
        gen = TrafficGen(TrafficSpec(scenario=Scenario("syn_benign_mix"),
                                     rate_pps=1e6, seed=seed))
        recs = gen.next_records(int(MH_HOSTS * n * per_rank * 1.3))
        recs["ts_ns"] += np.uint64(time.clock_gettime_ns(
            time.CLOCK_MONOTONIC) - int(recs["ts_ns"][0]))
        sh = wire.shard_of(recs["saddr"], MH_HOSTS * n)
        offered = {}
        for h in range(MH_HOSTS):
            for r in range(n):
                part = recs[sh == h * n + r][:per_rank]
                assert len(part) == per_rank, "short shard"
                assert rings[h][r].produce(part) == per_rank
                offered[f"h{h}r{r}"] = len(part)
        out["offered"] = offered
        t_start = time.monotonic()
        for h in range(MH_HOSTS):
            open(specs[h][0]["start_token"], "w").close()
        serving_at = {}
        reports = {}
        while time.monotonic() < deadline and len(reports) < MH_HOSTS * n:
            sup.poll()
            for h in range(MH_HOSTS):
                for r in range(n):
                    key = f"h{h}r{r}"
                    if (key not in serving_at and status[h][r].ctl_get(
                            "c_state") == wire.CSTATE_SERVING):
                        serving_at[key] = time.monotonic() - t_start
                    if key not in reports:
                        rep = _read_report(os.path.join(
                            planes[h], f"report_r{r}_g0.json"))
                        if rep and "net_settle" in rep:
                            reports[key] = rep
            if sup._failed or child.poll() is not None:
                break
            time.sleep(0.02)
        out["start_to_serving_s"] = serving_at
        checks["all_reports"] = len(reports) == MH_HOSTS * n
        host1_pids = [status[1][r].ctl_get("c_pid") for r in range(n)]
        # -- the gates of the serve and of convergence ----------------------
        keys = sorted(reports)
        rep_of = {k: reports[k]["report"] for k in keys}
        settle = {k: reports[k]["net_settle"] for k in keys}
        net_of = {k: (rep_of[k].get("cluster") or {}).get("net") or {}
                  for k in keys}
        out["records"] = {k: rep_of[k].get("records") for k in keys}
        checks["records_equal_offered"] = (
            len(keys) == MH_HOSTS * n
            and all(rep_of[k].get("records") == offered[k] for k in keys))
        own = {k: dict(map(tuple, settle[k]["own_map"])) for k in keys}
        seen = {k: dict(map(tuple, settle[k]["net_map"])) for k in keys}
        every = {}
        for k in keys:
            every.update(own[k])
        unions = []
        for h in range(MH_HOSTS):
            u = {}
            for r in range(n):
                u.update(seen.get(f"h{h}r{r}", {}))
            unions.append(u)
        out["blocked_per_host"] = [
            sum(len(own.get(f"h{h}r{r}", {})) for r in range(n))
            for h in range(MH_HOSTS)]
        checks["both_hosts_block"] = all(out["blocked_per_host"])
        cross = True
        for k in keys:
            for k2 in keys:
                if k2[:2] != k[:2]:
                    cross &= all(seen[k2].get(key) == us
                                 for key, us in own[k].items())
        checks["cross_host_keys_equal_untils"] = cross and bool(keys)
        out["digests"] = {"union_h0": map_digest(unions[0]),
                          "union_h1": map_digest(unions[1]),
                          "all_own": map_digest(every)}
        checks["union_digests_equal"] = (
            bool(every) and unions[0] == unions[1] == every
            and out["digests"]["union_h0"] == out["digests"]["union_h1"])
        checks["settled"] = all(settle[k]["settled"] for k in keys)
        drain_end = max((settle[k]["drain_end_wall_ns"] for k in keys),
                        default=0)
        changed = max((settle[k]["changed_wall_ns"] for k in keys),
                      default=0)
        out["drain_end_to_digest_equal_s"] = max(0, changed - drain_end) * 1e-9
        checks["converged_within_bound"] = (
            out["drain_end_to_digest_equal_s"]
            <= 4 * tuning.NET_RESYNC_INTERVAL_S)
        out["net"] = {k: {c: net_of[k].get(c) for c in (
            "tx_wires", "tx_pkts", "rx_pkts", "rx_wires", "rx_dup",
            "rx_gap", "reorder_evict", "tx_drop", "rx_overflow",
            "epoch_skew_dropped", "epoch_skew_max", "resyncs",
            "hellos_rx", "peers_seen", "net_sources")} for k in keys}
        checks["no_dup_no_skew_drop"] = all(
            net_of[k].get("rx_dup") == 0
            and net_of[k].get("epoch_skew_dropped") == 0 for k in keys)
        out["windows"] = {k: {"launches": reports[k].get("launches", {}),
                              "batches": rep_of[k].get("batches"),
                              "runs": reports[k].get("runs"),
                              "records": rep_of[k].get("records"),
                              "device": (rep_of[k].get("device") or {})
                              .get("type")} for k in keys}
        checks["launch_windows"] = _windows_ok(out["windows"], device)
        # -- the death of host 1 --------------------------------------------
        pre_tx = {r: net_of.get(f"h0r{r}", {}).get("tx_pkts", 0)
                  for r in range(n)}
        t_kill = time.monotonic()
        kill_host1()
        child.wait(timeout=30)
        announced = None
        bound = tuning.NET_HOST_TIMEOUT_S + tuning.NET_BEACON_INTERVAL_S
        while time.monotonic() < t_kill + bound + 5.0:
            sup.poll()
            if 1 in sup._dead_hosts_announced:
                announced = time.monotonic() - t_kill
                break
            time.sleep(0.01)
        out["death_to_announced_s"] = announced
        checks["death_announced_within_bound"] = (announced is not None
                                                  and announced <= bound)
        agg = sup.aggregate()
        out["hosts"] = agg["hosts"]
        out["health"] = {"state": agg["health"]["state"],
                         "reasons": agg["health"]["reasons"]}
        checks["fleet_failed_hosts_dead"] = (
            agg["health"]["state"] == "failed"
            and "hosts_dead:1" in agg["health"]["reasons"]
            and agg["hosts"]["dead"] == [1])
        now_ns = time.clock_gettime_ns(time.CLOCK_MONOTONIC)
        hb_age = [(now_ns - status[0][r].ctl_get("c_hbeat")) * 1e-9
                  for r in range(n)]
        out["host0_heartbeat_age_s"] = hb_age
        checks["host0_ranks_alive"] = (
            all(p is not None and p.is_alive() for p in sup._procs)
            and agg["restarts"] == [0] * n and agg["failed_ranks"] == []
            and all(a < 1.0 for a in hb_age))
        # host 0 stop-drains: the hold ends, each rank reports its plane
        t_stop = time.monotonic()
        sup.request_stop()
        while (len(sup._done) + len(sup._failed) < len(sup._active)
               and time.monotonic() < t_stop + 60.0):
            sup.poll()
            time.sleep(0.02)
        out["stop_to_done_s"] = time.monotonic() - t_stop
        sup.close()
        final = sup.aggregate()
        checks["host0_done"] = final["failed_ranks"] == [] and len(
            sup._done) == n
        post = {}
        for rep in final["reports"]:
            net = ((rep.get("report") or {}).get("cluster") or {}).get(
                "net") or {}
            post[f"h0r{rep['rank']}"] = {
                "tx_pkts_after_death": net.get("tx_pkts", 0)
                - pre_tx.get(rep["rank"], 0),
                "tx_sock_drops": net.get("tx_sock_drops"),
                "tx_drop": net.get("tx_drop")}
        out["sends_to_dead_host"] = post
    finally:
        kill_host1()
        if child is not None:
            try:
                child.wait(timeout=10)
            except subprocess.TimeoutExpired:
                pass
        sup.close(timeout_s=10.0)
    return {"ok": all(checks.values()), "checks": checks, **out}


def multihost_phase(card: str, served: dict) -> None:
    """The multi-host fleet on the card: ``multihost_drive`` at the
    production table (2^20 rows, 8 probes), B=2048, K=64,
    ``logreg_int8.npz``, ``--mega auto``, 2 hosts x 2 ranks, 192 batches
    each; every rank's launch window goes to the kernels line."""
    from flowsentryx_tpu_torch.core.config import FsxConfig

    @phase("multihost_fleet")
    def mh_phase():
        res = multihost_drive(
            "cuda", os.path.join(REPO, "build", "multihost"), FsxConfig(),
            os.path.join(REPO, "artifacts", "logreg_int8.npz"))
        windows = served.setdefault("launches_cluster", {})
        for k, w in res.get("windows", {}).items():
            windows[f"multihost_fleet/{k}"] = w["launches"]
        return {"card": card, **res}

    mh_phase()


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
        out = {"card": card, "turns": {},
               "batches": CLUSTER_SERVE_DEPTH * SERVE_BATCHES}
        checks = []
        for scen in ring_scen:
            # a multiple of the ring phases' stream: the drain walls must
            # dwarf the ranks' start skew (a 384-batch drain takes ~0.3 s)
            long_recs = TrafficGen(TrafficSpec(
                scenario=Scenario(scen), rate_pps=1e6, seed=SEED)
            ).next_records(CLUSTER_SERVE_DEPTH * SERVE_BATCHES * BATCH)
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
            join_sink_threads()
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
        m_boot = load_artifact("mlp", mlp_path, "cpu")
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
        recs = ring_recs[scen][:SIM_TIER_BATCHES * BATCH]
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

    # -- the chaos campaign (fsx chaos) on the card ---------------------------

    chaos_root = os.path.join(REPO, "build", "chaos")

    @phase("chaos_campaign")
    def chaos_campaign_phase():
        """``run_campaign(seed=17, quick=False, device="cuda")`` at the
        campaign's own shapes (4,096 rows, B=64, 24 batches), against the
        same campaign with ``device="cpu"``: every invariant holds, every
        plant is caught with its control holding, the seeded fields are
        the CPU campaign's, and ``score_int8`` launched once per batch the
        campaign's engine dispatched."""
        from flowsentryx_tpu_torch.chaos import campaign as chaos

        shutil.rmtree(chaos_root, ignore_errors=True)
        fleet = {}
        real = chaos.build_engine_fleet

        def probe(*a, **kw):
            built = real(*a, **kw)
            fleet["runs"] = track_runs(built[0])
            return built

        chaos.build_engine_fleet = probe
        try:
            torch.cuda.synchronize()
            kernels.reset_launches()          # the window opens
            rep = chaos.run_campaign(seed=17, quick=False, device="cuda",
                                     workdir=os.path.join(chaos_root, "card"))
            torch.cuda.synchronize()
            launches = dict(kernels.LAUNCHES)   # ... and closes
        finally:
            chaos.build_engine_fleet = real
            join_sink_threads()
        with cpu_threads():
            ref = chaos.run_campaign(seed=17, quick=False, device="cpu",
                                     workdir=os.path.join(chaos_root, "cpu"))
        seeded = {"ckpt_truncate": "truncate_fraction",
                  "ckpt_bitflip": "flip_offsets", "engine_kill": "kill_at_s",
                  "handoff_kill_midship": "kill_after_slots",
                  "layout_flip_lost": "to_gen",
                  "net_loss_burst": "burst_index",
                  "net_stale_epoch": "injected_skew_s",
                  "shm_bad_magic+poison_batch+shm_seq_gap": "records"}
        by_fault = {r["fault"]: r for r in rep["faults"]}
        ref_by_fault = {r["fault"]: r for r in ref["faults"]}
        same_seeded = {f: by_fault[f][k] == ref_by_fault[f][k]
                       for f, k in seeded.items()}
        catchers = {"split_atomicity": "sink_crash_atomicity",
                    "crc_skipped": "corrupt_ckpt_refused",
                    "backoff_removed": "crash_loop_parks",
                    "dup_suppression_removed": "no_double_apply",
                    "epoch_rebase_skipped": "epoch_rebase_exact",
                    "conservation_removed": "handoff_rows_conserved"}
        plants = {p["plant"]: p["caught"] and p.get("control_holds", True)
                  and p["caught_by"] == catchers[p["plant"]]
                  for p in rep["planted_regressions"]}
        dispatched = sum(fleet["runs"]["dispatched"])
        reports = len(fleet["runs"]["reports"])
        checks = [rep["ok"], ref["ok"], rep["device"] == "cuda",
                  all(i["ok"] for r in rep["faults"]
                      for i in r["invariants"]),
                  len(plants) == len(catchers) and all(plants.values()),
                  all(same_seeded.values()), dispatched > 0,
                  launches["score_int8"] == dispatched,
                  launches["table_summary"] == reports]
        served["launches_chaos_campaign"] = launches
        served["batches_chaos"] = {"chaos_campaign": dispatched}
        return {"ok": all(checks), "card": card, "rows": 1 << 12, "B": 64,
                "wall_s": rep["wall_s"], "cpu_wall_s": ref["wall_s"],
                "scenario_wall_s": {r["fault"]: r["wall_s"]
                                    for r in rep["faults"]},
                "recovery_s": by_fault["engine_kill"]["recovery_s"],
                "watchdog_elapsed_s": by_fault["sink_wedge"]["elapsed_s"],
                "invariants_checked": rep["invariants_checked"],
                "plants_caught": plants, "seeded_equal_cpu": same_seeded,
                "records": by_fault[
                    "shm_bad_magic+poison_batch+shm_seq_gap"]["records"],
                "launches": launches, "batches_dispatched": dispatched,
                "dispatched_per_run": fleet["runs"]["dispatched"],
                "reports": reports}

    chaos_campaign_phase()

    @phase("chaos_engine_2p20")
    def chaos_engine_phase():
        """The three engine-side scenarios at full width: ``FsxConfig()``
        (2^20 rows, 8 probes, B=2048, K=64, the default ``logreg_int8``
        params), a 1-worker ``ShardedIngest`` over a ring of 64 x 2,048
        ``mixed_l34_1m`` records (BASELINE config 5's traffic, seed 17),
        ``readback_depth=4``, the sink thread on; the same drive on the
        CPU engine (no wedge) is the reference after each step."""
        suite5 = next(sb for sb in benchmarks.scenario_suite(1.0)
                      if sb.name.startswith("config5"))
        spec = dataclasses.replace(suite5.traffic, seed=17)
        recs_all = TrafficGen(spec).next_records(72 * BATCH)
        recs, tail = recs_all[:64 * BATCH], recs_all[64 * BATCH:]
        cfg = FsxConfig()
        busy = step_busy_ms(cfg, None, recs)     # outside the window
        got = chaos_engine_drive("cuda", cfg, recs, tail,
                                 os.path.join(chaos_root, "e2p20_card"),
                                 watchdog=True)
        with cpu_threads():
            want = chaos_engine_drive("cpu", cfg, recs, tail,
                                      os.path.join(chaos_root, "e2p20_cpu"),
                                      watchdog=False)
        same = {k: got[k] == want[k] for k in (
            "after_slot", "after_restore", "after_tail")}
        wd = got["watchdog"]
        launches = got["launches"]
        dispatched = sum(got["dispatched"])
        slot_run = got["slot_run"]
        checks = [got["slot"]["ok"], got["fallback"]["ok"], wd["ok"],
                  want["slot"]["ok"], want["fallback"]["ok"],
                  got["slot"]["records"] == want["slot"]["records"],
                  got["slot"]["records"]["produced"] == len(recs),
                  *same.values(), got["pointers_kept"],
                  got["no_new_capture"],
                  got["tail_run"]["batches"] == 8,
                  launches["score_int8"] == dispatched,
                  launches["table_summary"] == got["reports"] == 2]
        served["launches_chaos_engine_2p20"] = launches
        served.setdefault("batches_chaos", {})["chaos_engine_2p20"] = (
            dispatched)
        slot_obj = types.SimpleNamespace(batches=slot_run["batches"],
                                         wall_s=slot_run["wall_s"])
        return {"ok": all(checks), "card": card, "rows": cfg.table.capacity,
                "B": BATCH, "ring_records": len(recs),
                "traffic": "mixed_l34_1m (BASELINE config 5), seed 17",
                "invariants": {k: [(i["name"], i["ok"])
                                   for i in got[k]["invariants"]]
                               for k in ("slot", "fallback", "watchdog")},
                "records": got["slot"]["records"],
                "equal_cpu": same,
                "blacklist_keys": len(got["after_tail"]["blacklist"]),
                "tracked_after_slot": got["after_slot"]["tracked"],
                "stats_after_tail": got["after_tail"]["stats"],
                "corrupted_drain": {
                    **slot_run, "step_busy_ms_per_batch": busy,
                    "idle_share": idle_share(slot_obj, busy)},
                "checkpoint_s": got["fallback_times"]["checkpoint_s"],
                "restore_s": got["fallback_times"]["restore_s"],
                "cpu_restore_s": want["fallback_times"]["restore_s"],
                "pointers_kept": got["pointers_kept"],
                "no_new_capture": got["no_new_capture"],
                "watchdog_trip_s": wd["elapsed_s"],
                "watchdog_bound_s": 10 * 0.4,
                "memory_after_warm": got["memory_after_warm"],
                "launches": launches, "batches_dispatched": dispatched,
                "dispatched_per_run": got["dispatched"],
                "reports": got["reports"]}

    chaos_engine_phase()

    # -- the self-reshaping fleet on the card ----------------------------------

    rebalance_phases(card, served)
    multihost_phase(card, served)

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
            "chaos_campaign": served.get("launches_chaos_campaign", {}),
            "chaos_engine_2p20": served.get("launches_chaos_engine_2p20",
                                            {}),
            "handoff_engine_2p20": served.get(
                "launches_handoff_engine_2p20", {}),
            # each cluster rank's own window, read from its report
            **served.get("launches_cluster", {})}
        for row in rows:
            row["launches_serve_paths"] = {
                k: w.get(row["name"], 0) for k, w in windows.items()}
        # the batches each chaos window's engine dispatched (score_int8
        # launches once per batch there)
        score_row["batches_chaos"] = served.get("batches_chaos", {})
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
