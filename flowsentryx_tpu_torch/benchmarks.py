"""The five BASELINE configs as runnable scenarios, and the per-record
latency methodology (a paced open-loop run and its percentile summary).

Counterpart of ``flowsentryx_tpu/benchmarks.py``: the scenario suite
(``scenario_suite``, ``run_scenario``, ``run_suite``; ``fsx bench
--scenarios``) and the methodology half (``paced_latency_run``,
``summarize_latencies``).  Each scenario runs the real engine loop
(batcher -> fused step -> writeback) over its generator traffic and
reports throughput, drop attribution, per-stage host times and, where
ground truth exists, detection precision and recall on *sources*.  The
suite runs on the card unless ``device="cpu"`` is given.
``chip_smoke.py`` runs the suite at full scale and measures the card's
feature -> verdict latency with the methodology.

| # | BASELINE config                                   | Scenario            |
|---|---------------------------------------------------|---------------------|
| 1 | token-bucket, single-source ICMP flood            | icmp_flood_single   |
| 2 | sliding+fixed window, multi-source UDP flood      | udp_flood_multi     |
| 3 | offline batch inference on flow features          | offline_batch       |
| 4 | online SYN+benign mix, micro-batched inference    | syn_benign_mix      |
| 5 | mixed L3/L4 at line rate, 1M concurrent IPs       | mixed_l34_1m        |
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path

import numpy as np

from flowsentryx_tpu_torch.core.config import (
    BatchConfig,
    FsxConfig,
    LimiterConfig,
    LimiterKind,
    TableConfig,
)
from flowsentryx_tpu_torch.engine.traffic import (
    Scenario,
    TrafficGen,
    TrafficSpec,
)


def _cfg(limiter: LimiterConfig, capacity: int, batch: int) -> FsxConfig:
    return FsxConfig(
        limiter=limiter,
        table=TableConfig(capacity=capacity),
        batch=BatchConfig(max_batch=batch),
    )


@dataclasses.dataclass(frozen=True)
class ScenarioBench:
    name: str
    cfg: FsxConfig
    traffic: TrafficSpec
    packets: int


def scenario_suite(scale: float = 1.0) -> list[ScenarioBench]:
    """The five configs; ``scale`` multiplies packet counts (at least one
    2,048-record batch each)."""
    n = lambda k: max(2048, int(k * scale))
    return [
        ScenarioBench(
            name="config1_icmp_flood_single_token_bucket",
            cfg=_cfg(
                LimiterConfig(kind=LimiterKind.TOKEN_BUCKET,
                              bucket_rate_pps=1000.0, bucket_burst=2000.0),
                capacity=1 << 14, batch=2048,
            ),
            traffic=TrafficSpec(
                scenario=Scenario.ICMP_FLOOD_SINGLE, rate_pps=1e7,
                attack_fraction=0.9, seed=101,
            ),
            packets=n(262_144),
        ),
        ScenarioBench(
            name="config2_udp_flood_multi_sliding_window",
            cfg=_cfg(
                LimiterConfig(kind=LimiterKind.SLIDING_WINDOW,
                              pps_threshold=500.0, bps_threshold=1e9),
                capacity=1 << 16, batch=2048,
            ),
            traffic=TrafficSpec(
                scenario=Scenario.UDP_FLOOD_MULTI, rate_pps=1e7,
                n_attack_ips=256, attack_fraction=0.8, seed=102,
            ),
            packets=n(262_144),
        ),
        ScenarioBench(
            name="config3_offline_batch_inference",
            cfg=_cfg(  # ML only: limiter thresholds out of reach
                LimiterConfig(pps_threshold=1e12, bps_threshold=1e15),
                capacity=1 << 14, batch=8192,
            ),
            traffic=TrafficSpec(
                scenario=Scenario.OFFLINE_BATCH, rate_pps=1e7,
                attack_fraction=0.5, seed=103,
            ),
            packets=n(262_144),
        ),
        ScenarioBench(
            name="config4_syn_benign_mix_online",
            cfg=_cfg(
                LimiterConfig(pps_threshold=2000.0, bps_threshold=1e9),
                capacity=1 << 16, batch=2048,
            ),
            traffic=TrafficSpec(
                scenario=Scenario.SYN_BENIGN_MIX, rate_pps=1e7, seed=104,
            ),
            packets=n(262_144),
        ),
        ScenarioBench(
            name="config5_mixed_l34_1m_ips",
            cfg=_cfg(
                LimiterConfig(pps_threshold=1000.0, bps_threshold=125e6),
                capacity=1 << 20, batch=16384,
            ),
            traffic=TrafficSpec(
                scenario=Scenario.MIXED_L34_1M, rate_pps=1e7,
                attack_fraction=0.8, seed=105,
            ),
            packets=n(1_048_576),
        ),
    ]


def _source_quality(gen_spec: TrafficSpec, blocked: set[int]) -> dict:
    """Source-level detection quality: a fresh generator with the same
    seed reproduces the exact IP pools, giving ground truth without
    retaining per-packet labels."""
    gen = TrafficGen(gen_spec)
    attack = set(int(k) for k in gen.attack_ips)
    benign = set(int(k) for k in gen.benign_ips)
    tp = len(blocked & attack)
    fp = len(blocked & benign)
    fn = len(attack - blocked)
    precision = tp / (tp + fp) if tp + fp else 0.0
    recall = tp / (tp + fn) if tp + fn else 0.0
    return {
        "attack_sources": len(attack),
        "benign_sources": len(benign),
        "blocked_attack": tp,
        "blocked_benign": fp,
        "source_precision": round(precision, 4),
        "source_recall": round(recall, 4),
    }


def _serving_params():
    """The repo's trained artifact when present (``artifacts/``, host
    tensors the engine moves to its device), else None -> the model's
    default init (the golden weights)."""
    from flowsentryx_tpu_torch.models import logreg

    p = Path(__file__).resolve().parents[1] / "artifacts" / "logreg_int8.npz"
    if p.exists():
        return logreg.load_params(str(p)), p.name
    return None, "golden (default init)"


def run_scenario(sb: ScenarioBench, device=None) -> dict:
    """One scenario through a fresh engine on ``device`` (None: the card,
    raising without one).  ``wall_s`` and ``mpps`` include the engine's
    self-warm inside ``run()`` (kernel load and graph capture on the
    card), as the reference's include its compile."""
    from flowsentryx_tpu_torch.engine import CollectSink, Engine
    from flowsentryx_tpu_torch.engine.sources import TrafficSource

    sink = CollectSink()
    src = TrafficSource(sb.traffic, total=sb.packets)
    params, params_src = _serving_params()
    # Deep readback queue: verdicts land in bulk every 32 batches,
    # amortizing the per-fetch sync cost (a writeback delay of ~32 batch
    # periods is well inside the blacklist TTL).
    eng = Engine(sb.cfg, src, sink, params=params, readback_depth=32,
                 device=device)
    t0 = time.perf_counter()
    rep = eng.run()
    wall = time.perf_counter() - t0
    out = {
        "scenario": sb.name,
        "params": params_src,
        "packets": rep.records,
        "batches": rep.batches,
        "wall_s": round(wall, 3),
        "mpps": round(rep.records / wall / 1e6, 3),
        "stats": rep.stats,
        "table": rep.table,
        "stages_ms": rep.stages_ms,
    }
    out.update(_source_quality(TrafficSpec(**dataclasses.asdict(sb.traffic)),
                               set(sink.blocked)))
    # Packet-level mitigation: under the young-flow vote a rotating-source
    # flood (config 5) has its malicious records dropped per record
    # without its sources ever being condemned, so source recall is tiny
    # while mitigation is high.  An UPPER BOUND on attack-packet recall:
    # per-record drops of mis-scored benign records count too.
    frac = sb.traffic.attack_fraction
    if frac > 0 and rep.records:
        out["packet_mitigation_upper_bound"] = round(
            min(rep.stats["dropped"] / (rep.records * frac), 1.0), 4)
    return out


def run_suite(scale: float = 1.0, names: list[str] | None = None,
              device=None) -> list[dict]:
    """The configs whose name contains one of ``names`` (all without),
    each through :func:`run_scenario` on ``device``."""
    results = []
    for sb in scenario_suite(scale):
        if names and not any(n in sb.name for n in names):
            continue
        results.append(run_scenario(sb, device=device))
    return results


def paced_latency_run(eng, src, readback_depth=None, max_seconds=6.0):
    """Open-loop paced run through a warmed engine: rebind the stream
    (:meth:`~flowsentryx_tpu_torch.engine.Engine.reset_stream`), attach
    the reap hook that pairs each sunk record with its scheduled arrival
    (:class:`~flowsentryx_tpu_torch.engine.sources.PacedSource`
    ``.pop_scheduled``), run, and return ``(latencies_s, wall_s,
    EngineReport)``.  The report carries the engine's own seal -> verdict
    histogram (``latency``), to hold against the hook's arrival -> sunk
    numbers.  The caller warms the engine outside the paced clock (the
    open-loop clock starts at the first poll, so a capture inside the
    run would read as queueing)."""
    eng.reset_stream(src, readback_depth=readback_depth)
    lats: list = []
    eng.on_reap = lambda n, t, s=src, out=lats: out.extend(
        t - s.pop_scheduled(n))
    t0 = time.perf_counter()
    rep = eng.run(max_seconds=max_seconds)
    wall = time.perf_counter() - t0
    return np.asarray(lats), wall, rep


def summarize_latencies(lats_s) -> dict:
    """Percentile summary (ms) of a :func:`paced_latency_run` latency
    array."""
    a = np.asarray(lats_s, np.float64) * 1e3
    if not len(a):
        return {"n": 0}
    return {
        "n": int(len(a)),
        "p50_ms": round(float(np.percentile(a, 50)), 3),
        "p90_ms": round(float(np.percentile(a, 90)), 3),
        "p99_ms": round(float(np.percentile(a, 99)), 3),
        "p999_ms": round(float(np.percentile(a, 99.9)), 3),
        "max_ms": round(float(a.max()), 3),
    }


def run_scaling(
    device_counts: tuple[int, ...] = (1, 2, 4, 8),
    capacity: int = 1 << 20,
    batch: int = 16384,
    iters: int = 20,
    devices=None,
) -> dict:
    """Step time against the mesh size at full table capacity (``bench
    --scaling``; the reference's keys).

    The single-shard raw48 step at n = 1 and the IP-hash-sharded raw48
    step (``parallel/step.py``) beyond, over the same ``mixed_l34_1m``
    traffic, then the compact16 step and its 4-chunk megastep on the
    same mesh.  ``devices`` lists the devices a mesh may take (default:
    the visible cards); ``[dev] * 8`` lays every mesh's shards on
    ``dev``, the one-device counterpart of the reference's virtual CPU
    devices, where the curve shows what n shards cost one device.  A
    count beyond ``devices`` is skipped, as the reference skips it.

    Each variant's first call is its "compile" (on the card the capture
    of its CUDA graph; on the CPU the first eager call), then
    ``max(iters, 25)`` timed calls, the first third discarded and the
    median kept.  On the card a call is one graph replay and a
    synchronize; ``device_step_ms`` adds the replays' CUDA-event time."""
    import functools

    import torch

    from flowsentryx_tpu_torch.core import schema
    from flowsentryx_tpu_torch.models.registry import get_model
    from flowsentryx_tpu_torch.ops import fused, graph, kernels
    from flowsentryx_tpu_torch.parallel import make_mesh
    from flowsentryx_tpu_torch.parallel import step as pstep

    pool = ([torch.device(d) for d in devices] if devices is not None
            else [torch.device("cuda", i)
                  for i in range(torch.cuda.device_count())])
    n_timed = max(iters, 25)

    def time_step(fn, feeds, dev, table, stats, params):
        """``(compile_s, steady median s, warm-up max s, device ms or
        None)`` of ``fn`` over ``feeds`` (device tensors)."""
        cuda = dev.type == "cuda"
        t0 = time.perf_counter()
        if cuda:
            gr = graph.StepGraph(fn, table, stats, params,
                                 tuple(feeds[0].shape))
            gr.input.copy_(feeds[0])
            gr.replay()
            torch.cuda.synchronize(dev)
        else:
            fn(table, stats, params, feeds[0])
        compile_s = time.perf_counter() - t0
        times, ev_ms = [], []
        for i in range(n_timed):
            t = time.perf_counter()
            if cuda:
                gr.input.copy_(feeds[i % len(feeds)])
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                gr.replay()
                e1.record()
                torch.cuda.synchronize(dev)
                ev_ms.append(e0.elapsed_time(e1))
            else:
                fn(table, stats, params, feeds[i % len(feeds)])
            times.append(time.perf_counter() - t)
        k = len(times) // 3
        return (compile_s, float(np.median(times[k:])), max(times[:k]),
                float(np.median(ev_ms[k:])) if cuda else None)

    results = []
    for n in device_counts:
        if n > len(pool):
            results.append({"devices": n, "skipped": "not enough devices"})
            continue
        dev = pool[0]
        cfg = _cfg(LimiterConfig(), capacity, batch)
        spec = get_model(cfg.model.name)
        params = spec.init(dev)
        classify = spec.classify_batch
        if classify is kernels.score_int8:
            classify = functools.partial(
                classify, packed=kernels.pack_score_params(params))
        # the wire quantizer reads the params' observer on the host
        quant = schema.wire_quant_for(spec.init("cpu"))
        mesh = make_mesh(n, devices=pool) if n > 1 else None

        def table():
            return (schema.make_table(capacity, dev) if mesh is None
                    else pstep.make_sharded_table(cfg, mesh))

        if mesh is None:
            step = fused.make_raw_step(cfg, classify)
            cstep = fused.make_compact_step(cfg, classify, **quant)
            mstep = fused.make_compact_megastep(cfg, classify, 4, **quant)
        else:
            step = pstep.make_sharded_raw_step(cfg, classify, mesh)
            cstep = pstep.make_sharded_compact_step(cfg, classify, mesh,
                                                    **quant)
            mstep = pstep.make_sharded_compact_megastep(cfg, classify,
                                                        mesh, 4, **quant)
        gen = TrafficGen(TrafficSpec(scenario=Scenario.MIXED_L34_1M,
                                     rate_pps=1e7, seed=42))
        raws = [schema.wire_to_tensor(schema.encode_raw(
            gen.next_records(batch), batch, t0_ns=0)).to(dev)
            for _ in range(4)]
        compile_s, dt, warm_max, dev_ms = time_step(
            step, raws, dev, table(), schema.make_stats(dev), params)
        row = {
            "devices": n,
            "compile_s": round(compile_s, 2),
            "step_ms": round(dt * 1e3, 2),
            "warmup_max_ms": round(warm_max * 1e3, 1),
            "records_per_s": round(batch / dt, 0),
            "mpps": round(batch / dt / 1e6, 3),
        }
        if dev_ms is not None:
            row["device_step_ms"] = round(dev_ms, 4)
        # the compact16 single step and its 4-chunk megastep on the same
        # mesh: the megastep's ms per chunk against the single step shows
        # what one dispatch of four saves
        craws = torch.stack([schema.wire_to_tensor(schema.encode_compact(
            gen.next_records(batch), batch, t0_ns=0, **quant)).to(dev)
            for _ in range(4)])
        _, cdt, _, _ = time_step(cstep, list(craws), dev, table(),
                                 schema.make_stats(dev), params)
        mega_compile_s, mdt, _, _ = time_step(
            mstep, [craws], dev, table(), schema.make_stats(dev), params)
        row["compact_step_ms"] = round(cdt * 1e3, 2)
        row["mega4_compile_s"] = round(mega_compile_s, 2)
        row["mega4_ms_per_chunk"] = round(mdt / 4 * 1e3, 2)
        results.append(row)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    base = next((r for r in results
                 if r.get("devices") == 1 and "step_ms" in r), None)
    return {
        "capacity": capacity,
        "batch": batch,
        "iters": n_timed,
        "warmup_discarded": "first third, by median",
        "backend": pool[0].type if pool else None,
        "mesh": "shards of one device" if len(set(pool)) == 1 else None,
        # the reference's collectives, here tensor ops over the shards
        "collectives_per_step": {"all_gather": 1, "psum": 3},
        "results": results,
        "serialization_ratio_8x": round(
            results[-1]["step_ms"] / base["step_ms"], 2)
        if base and "step_ms" in results[-1] else None,
    }
