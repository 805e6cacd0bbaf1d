"""The port's CUDA kernels and engine on the card, against their plain
versions.  Every test here needs an NVIDIA GPU and skips without one
(the kernels have no CPU mode).  The file imports no JAX, so it runs on
a machine with the card alone:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import functools
import hashlib
import os
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from flowsentryx_tpu_torch.core import config, schema
from flowsentryx_tpu_torch.engine import (
    ArraySource, CollectSink, Engine, Scenario, TrafficGen, TrafficSource,
    TrafficSpec,
)
from flowsentryx_tpu_torch.core.device import xla_log1p
from flowsentryx_tpu_torch.models import logreg, mlp
from flowsentryx_tpu_torch.ops import agg, fused, graph, kernels

ART = Path(__file__).resolve().parents[1] / "artifacts"
ARTIFACT = str(ART / "logreg_int8.npz")
pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("name", ["golden", "log1p"])
@pytest.mark.parametrize("b", [1, 7, 15, 2047, 2048, 2049, 4099])
def test_score_int8_kernel_matches_plain(cuda, name, b):
    tp = (logreg.golden_params(cuda) if name == "golden"
          else logreg.load_params(ARTIFACT, cuda))
    x = torch.from_numpy(np.random.default_rng(b).uniform(
        0, 2e6, (b, 8)).astype(np.float32)).to(cuda)
    n0 = kernels.LAUNCHES["score_int8"]
    got = kernels.score_int8(tp, x)
    assert kernels.LAUNCHES["score_int8"] == n0 + 1
    want = kernels.score_int8_plain(tp, x)
    assert torch.equal(got, want)


@pytest.mark.parametrize("name", ["golden", "log1p"])
def test_score_int8_packed_table_equals_plain_output(cuda, name):
    """The kernel's output stage is a table lookup by the output code;
    the table must be the plain output stage for all 256 codes."""
    tp = (logreg.golden_params(cuda) if name == "golden"
          else logreg.load_params(ARTIFACT, cuda))
    packed = kernels.pack_score_params(tp)
    codes = torch.arange(256, dtype=torch.float32, device=cuda)
    assert torch.equal(packed.table, logreg.score_from_code(tp, codes))
    assert list(packed.args.table) == packed.table.cpu().tolist()


def test_score_int8_wrapper_refuses_bad_inputs(cuda):
    tp = logreg.golden_params(cuda)
    x = torch.zeros(16, 8, device=cuda)
    with pytest.raises(ValueError):
        kernels.score_int8(tp, x.double())
    with pytest.raises(ValueError):
        kernels.score_int8(tp, torch.zeros(16, 7, device=cuda))
    with pytest.raises(ValueError):
        kernels.score_int8(tp, torch.zeros(8, 16, device=cuda).t())


def _summary_case(cuda, n, occupancy):
    rng = np.random.default_rng(n)
    key = np.where(rng.random(n) < occupancy,
                   rng.integers(1, 1 << 32, n, dtype=np.uint64), 0
                   ).astype(np.uint32)
    state = np.zeros((n, schema.NUM_TABLE_COLS), np.float32)
    state[:, schema.TableCol.LAST_SEEN] = rng.uniform(0, 100, n)
    state[:, schema.TableCol.BLOCKED_UNTIL] = np.where(
        rng.random(n) < 0.3, rng.uniform(80, 200, n), 0)
    return (torch.from_numpy(key.view(np.int32)).to(cuda),
            torch.from_numpy(state).to(cuda))


@pytest.mark.parametrize("occupancy", [0.005, 0.47])
@pytest.mark.parametrize("n", [1, 4, 13, 1003, (1 << 20) - 3, 1 << 20])
def test_table_summary_ragged_and_occupancy(cuda, n, occupancy):
    """Row counts that end in a partial 4-row key group and a partial
    256-row warp step, and the sparse (0.5 %) and half-full (47 %)
    occupancies of the served tables."""
    k, s = _summary_case(cuda, n, occupancy)
    got = kernels.table_summary_counts(k, s, 90.0, 30.0)
    want = kernels.table_summary_plain(k, s, 90.0, 30.0)
    assert torch.equal(got[0], want[0])
    assert float(got[1]) == float(want[1])


def test_table_summary_wrapper_refuses_bad_inputs(cuda):
    k, s = _summary_case(cuda, 1 << 12, 0.5)
    with pytest.raises(ValueError):
        kernels.table_summary_counts(k.long(), s, 90.0, 30.0)
    with pytest.raises(ValueError):
        kernels.table_summary_counts(k, s.double(), 90.0, 30.0)
    with pytest.raises(ValueError):
        kernels.table_summary_counts(k[::2], s[::2], 90.0, 30.0)


def test_table_summary_refuses_a_key_view_not_16_byte_aligned(cuda):
    """The kernel reads keys as 16-byte words: a key view that starts 4
    bytes into its buffer raises; the same rows copied to an aligned
    tensor (the state view stays as it is) give the plain answer."""
    k, s = _summary_case(cuda, (1 << 16) + 1, 0.47)
    assert k[1:].data_ptr() % 16 == 4
    with pytest.raises(ValueError, match="16-byte aligned"):
        kernels.table_summary_counts(k[1:], s[1:], 90.0, 30.0)
    got = kernels.table_summary_counts(k[1:].clone(), s[1:], 90.0, 30.0)
    want = kernels.table_summary_plain(k[1:], s[1:], 90.0, 30.0)
    assert torch.equal(got[0], want[0])
    assert float(got[1]) == float(want[1])


@pytest.mark.parametrize("n", [1000, (1 << 20) - 3, 1 << 20])
def test_table_summary_kernel_matches_plain(cuda, n):
    rng = np.random.default_rng(n)
    key = np.where(rng.random(n) < 0.5,
                   rng.integers(1, 1 << 32, n, dtype=np.uint64), 0
                   ).astype(np.uint32)
    state = np.zeros((n, schema.NUM_TABLE_COLS), np.float32)
    state[:, schema.TableCol.LAST_SEEN] = rng.uniform(0, 100, n)
    state[:, schema.TableCol.BLOCKED_UNTIL] = np.where(
        rng.random(n) < 0.3, rng.uniform(80, 200, n), 0)
    k = torch.from_numpy(key.view(np.int32)).to(cuda)
    s = torch.from_numpy(state).to(cuda)
    n0 = kernels.LAUNCHES["table_summary"]
    got = kernels.table_summary_counts(k, s, 90.0, 30.0)
    assert kernels.LAUNCHES["table_summary"] == n0 + 1
    want = kernels.table_summary_plain(k, s, 90.0, 30.0)
    assert torch.equal(got[0], want[0])
    assert float(got[1]) == float(want[1])


def _digest(e):
    k, st = schema.table_to_numpy(e.table)
    return hashlib.sha256(k.tobytes() + st.tobytes()).hexdigest()


def _compact_batches(params, n, b, scenario="mixed_l34_1m", seed=3):
    """``n`` compact16 ``[B+1, 4]`` wire buffers of a scenario, in the
    params' model mode, with ragged fills."""
    quant = schema.wire_quant_for(logreg.LogRegParams(
        **logreg.params_to_numpy(params)))
    gen = TrafficGen(TrafficSpec(scenario=Scenario(scenario), seed=seed,
                                 rate_pps=1e6))
    out, t0 = [], None
    for i in range(n):
        rec = gen.next_records(b - (i % 5) * 131)
        t0 = int(rec["ts_ns"][0]) if t0 is None else t0
        out.append(schema.encode_compact(rec, b, t0, **quant))
    return out, quant


def _step_fixture(cuda, cap=1 << 14, b=2048, verdict_k=64, pps=300.0):
    cfg = config.FsxConfig(
        limiter=config.LimiterConfig(pps_threshold=pps),
        table=config.TableConfig(capacity=cap, salt=0x5EED),
        batch=config.BatchConfig(max_batch=b, verdict_k=verdict_k))
    params = logreg.load_params(ARTIFACT, cuda)
    packed = kernels.pack_score_params(params)
    classify = functools.partial(kernels.score_int8, packed=packed)
    return cfg, params, classify


def _same_state(t1, s1, t2, s2):
    assert torch.equal(t1.key, t2.key)
    assert torch.equal(t1.state.view(torch.int32), t2.state.view(torch.int32))
    assert s1.to_dict() == s2.to_dict()


def _same_out(o1, o2):
    for f in ("verdict", "block_key", "block_until", "now", "wire"):
        a, b = getattr(o1, f), getattr(o2, f)
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b), f


def test_eager_step_runs_without_a_host_sync(cuda):
    """A capture fails on any host sync: the eager step must run clean
    under ``set_sync_debug_mode("error")`` (masked and real batches)."""
    cfg, params, classify = _step_fixture(cuda)
    step = fused.make_compact_step(cfg, classify, **_compact_batches(
        params, 1, 2048)[1])
    table, stats = schema.make_table(1 << 14, cuda), schema.make_stats(cuda)
    raws, _ = _compact_batches(params, 2, 2048)
    raws.insert(0, np.zeros_like(raws[0]))
    devs = [schema.wire_to_tensor(r).to(cuda) for r in raws]
    torch.cuda.synchronize()
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for d in devs:
            step(table, stats, params, d)
    finally:
        torch.cuda.set_sync_debug_mode(prev)
    torch.cuda.synchronize()
    assert stats.to_dict()["batches"] == 2


def test_step_graph_replay_equals_eager_step(cuda):
    """One captured single step replayed over a 12-batch stream against
    the eager step on a second table: every output, the table and the
    stats equal after each batch."""
    cfg, params, classify = _step_fixture(cuda)
    raws, quant = _compact_batches(params, 12, 2048)
    step = fused.make_compact_step(cfg, classify, **quant)
    tg, sg = schema.make_table(1 << 14, cuda), schema.make_stats(cuda)
    te, se = schema.make_table(1 << 14, cuda), schema.make_stats(cuda)
    gr = graph.StepGraph(step, tg, sg, params, (2049, 4))
    _same_state(tg, sg, te, se)      # warm-ups and capture changed nothing
    for raw in raws:
        gr.input.copy_(schema.wire_to_tensor(raw).to(cuda))
        gr.replay()
        _, _, oe = step(te, se, params, schema.wire_to_tensor(raw).to(cuda))
        _same_out(gr.out, oe)
        _same_state(tg, sg, te, se)
    assert se.to_dict()["dropped"] > 0


@pytest.mark.parametrize("g", [2, 4, 8])
def test_rung_graph_equals_singles(cuda, g):
    """Rung ``g`` replayed twice against 2g eager singles: table, stats,
    the stacked verdicts and block arrays, and the merged wire equal to
    ``merge_verdict_wires`` of the singles' wires."""
    cfg, params, classify = _step_fixture(cuda, verdict_k=8)
    raws, quant = _compact_batches(params, 2 * g, 2048, "udp_flood_multi")
    step = fused.make_compact_step(cfg, classify, **quant)
    mega = fused.make_compact_megastep(cfg, classify, g, **quant)
    tg, sg = schema.make_table(1 << 14, cuda), schema.make_stats(cuda)
    te, se = schema.make_table(1 << 14, cuda), schema.make_stats(cuda)
    gr = graph.StepGraph(mega, tg, sg, params, (g, 2049, 4))
    for r in range(2):
        group = np.stack(raws[r * g:(r + 1) * g])
        gr.input.copy_(schema.wire_to_tensor(group).to(cuda))
        gr.replay()
        outs = [step(te, se, params, schema.wire_to_tensor(raw).to(cuda))[2]
                for raw in raws[r * g:(r + 1) * g]]
        for f in ("verdict", "block_key", "block_until", "now"):
            want = torch.stack([getattr(o, f) for o in outs])
            got = getattr(gr.out, f)
            if got.dtype == torch.float32:
                got, want = got.view(torch.int32), want.view(torch.int32)
            assert torch.equal(got, want), f
        merged = fused.merge_verdict_wires(torch.stack([o.wire for o in outs]))
        assert torch.equal(gr.out.wire, merged)
        _same_state(tg, sg, te, se)


@pytest.mark.parametrize("g", [0, 1, 2, 8])
def test_graph_launch_counts(cuda, g):
    """A replay counts one ``score_int8`` launch per batch it holds; the
    capture adds none to ``kernels.LAUNCHES`` (its warm-ups are real
    launches, recorded on the graph as ``warmup_launches``)."""
    cfg, params, classify = _step_fixture(cuda)
    quant = _compact_batches(params, 1, 2048)[1]
    fn = (fused.make_compact_step(cfg, classify, **quant) if g == 0
          else fused.make_compact_megastep(cfg, classify, g, **quant))
    shape = (2049, 4) if g == 0 else (g, 2049, 4)
    table, stats = schema.make_table(1 << 14, cuda), schema.make_stats(cuda)
    n0 = dict(kernels.LAUNCHES)
    gr = graph.StepGraph(fn, table, stats, params, shape)
    per = max(g, 1)
    assert gr.launches == {"score_int8": per, "table_summary": 0,
                           "segment_sum_seq": 0, "gemv_seq": 0}
    assert gr.warmup_launches["score_int8"] == graph.WARMUPS * per
    assert kernels.LAUNCHES == n0
    n1 = kernels.LAUNCHES["score_int8"]
    for _ in range(3):
        gr.replay()
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["score_int8"] == n1 + 3 * per
    assert kernels.LAUNCHES["table_summary"] == n0["table_summary"]


def test_warm_captures_every_rung_and_changes_nothing(cuda):
    cfg = config.FsxConfig(table=config.TableConfig(capacity=1 << 14),
                           batch=config.BatchConfig(max_batch=2048))
    e = Engine(cfg, TrafficSource(TrafficSpec(), total=2048), CollectSink(),
               device=cuda, mega_n="auto")
    e.warm()
    assert sorted(e._graphs) == [0, 2, 4, 8]
    assert e.stats.to_dict() == schema.make_stats().to_dict()
    assert not e.table.key.any() and not e.table.state.any()
    n0 = kernels.LAUNCHES["score_int8"]
    r = e.run()
    assert r.dispatch["graphs"] == 4 and r.dispatch["group_hist"] == {"1": 1}
    assert kernels.LAUNCHES["score_int8"] == n0 + 1
    assert r.stats["allowed"] + r.stats["dropped"] == 2048


@pytest.mark.parametrize("mega_n", [0, 4, "auto"])
def test_overflow_fallback_under_graphs(cuda, mega_n):
    """The multi-source flood at ``verdict_k=2`` with ``readback_depth=4``:
    overflowed wires are reaped after later replays have overwritten the
    graphs' static outputs, so the fallback must read the dispatch's own
    copy of its block arrays.  Blacklist (keys and untils), stats and
    table equal the CPU engine's."""
    cfg = config.FsxConfig(
        limiter=config.LimiterConfig(pps_threshold=200.0, bps_threshold=1e9),
        table=config.TableConfig(capacity=1 << 12),
        batch=config.BatchConfig(max_batch=512, verdict_k=2,
                                 readback_depth=4))
    recs = TrafficGen(TrafficSpec(
        scenario=Scenario.UDP_FLOOD_MULTI, rate_pps=1e7, n_attack_ips=32,
        attack_fraction=0.8, seed=17)).next_records(512 * 24)
    out = {}
    for device in ("cuda", "cpu"):
        e = Engine(cfg, ArraySource(recs.copy()), CollectSink(),
                   device=device, mega_n=mega_n)
        e.warm()
        r = e.run()
        out[device] = (r.stats, e.sink.blocked, _digest(e), r.table,
                       r.readback["fallback_sinks"], r.dispatch["group_hist"])
    assert out["cuda"] == out["cpu"]
    assert out["cuda"][4] > 0 and len(out["cuda"][1]) > 2


@pytest.mark.parametrize("mega_n", [0, 4])
def test_overflow_fallback_reads_each_dispatchs_own_blocks(cuda, mega_n):
    """Twelve overflowing dispatches enqueued back to back before any is
    sunk (``readback_depth=4``), so every overflowed dispatch is read
    after at least four later replays of the same graph: a sink that
    read the graph's static block arrays would apply later batches'
    blocks.  The blacklist and stats equal the CPU engine's."""
    cfg = config.FsxConfig(
        limiter=config.LimiterConfig(pps_threshold=200.0, bps_threshold=1e9),
        table=config.TableConfig(capacity=1 << 14),
        batch=config.BatchConfig(max_batch=2048, verdict_k=2,
                                 readback_depth=4))
    params = logreg.load_params(ARTIFACT)
    raws, _ = _compact_batches(params, 12 * max(mega_n, 1), 2048,
                               "udp_flood_multi", seed=17)
    out = {}
    for device in ("cuda", "cpu"):
        e = Engine(cfg, ArraySource(np.empty(0)), CollectSink(),
                   params=params, device=device, mega_n=mega_n)
        e.warm()
        for i in range(12):
            if mega_n:
                e._dispatch_mega([(r, 0.0) for r in
                                  raws[i * mega_n:(i + 1) * mega_n]])
            else:
                e._dispatch(raws[i])
        e._reap(0)
        out[device] = (e.stats.to_dict(), e.sink.blocked, _digest(e),
                       e._sink_fallback)
    assert out["cuda"] == out["cpu"]
    assert out["cuda"][3] >= 4


@pytest.mark.parametrize("scenario", ["syn_benign_mix", "mixed_l34_1m"])
def test_cuda_engine_equals_cpu_engine(cuda, scenario):
    cfg = config.FsxConfig(table=config.TableConfig(capacity=1 << 14,
                                                    salt=99),
                           batch=config.BatchConfig(max_batch=2048))
    out = {}
    for device in ("cuda", "cpu"):
        src = TrafficSource(TrafficSpec(scenario=Scenario(scenario),
                                        seed=5), total=12 * 2048)
        e = Engine(cfg, src, CollectSink(),
                   params=logreg.load_params(ARTIFACT, device),
                   device=device)
        r = e.run()
        out[device] = (r.stats, e.sink.blocked, _digest(e), r.table)
    assert out["cuda"] == out["cpu"]


# -- the raw48 slice: segment_sum_seq, the scorer's log1p, the raw step ------


def _ragged_segments(rng, b, heavy=300):
    """Sorted segment ids with ragged lengths and one ``heavy``-lane
    segment of 65,535-byte records (its f32 sum passes 2^24 and depends
    on the order), dense from 0 as the step makes them."""
    lens = [heavy]
    while sum(lens) < b:
        lens.append(int(rng.integers(1, 60)))
    lens[-1] -= sum(lens) - b
    lens = [n for n in lens if n > 0]
    rng.shuffle(lens)
    seg = np.repeat(np.arange(len(lens)), lens)
    v = rng.integers(40, 1 << 16, b).astype(np.float32)
    v[seg == np.bincount(seg).argmax()] = 65535.0
    return torch.from_numpy(v), torch.from_numpy(seg.astype(np.int64))


@pytest.mark.parametrize("b", [1, 255, 2048, 4097])
def test_segment_sum_seq_kernel_matches_plain(cuda, b):
    """Lane-order f32 sums per segment, bit for bit with the plain
    version, the empty tail ``[S, n)`` zeroed, one launch counted."""
    v, seg = _ragged_segments(np.random.default_rng(b), b,
                              heavy=min(300, b))
    n = b + 5
    want = agg.segment_sum_seq_plain(v, seg, n)
    n0 = kernels.LAUNCHES["segment_sum_seq"]
    got = kernels.segment_sum_seq(v.to(cuda), seg.to(cuda), n)
    assert kernels.LAUNCHES["segment_sum_seq"] == n0 + 1
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))
    # garbage in the output buffer's tail is overwritten
    assert not got[int(seg[-1]) + 1:].any()


def test_segment_sum_seq_order_is_visible(cuda):
    """On the heavy segment the lane-order sum differs from the exact
    sum and from ``index_add_`` in another order: the kernel gives the
    lane order's bits."""
    v, seg = _ragged_segments(np.random.default_rng(0), 2048)
    got = kernels.segment_sum_seq(v.to(cuda), seg.to(cuda), 2048).cpu()
    exact = torch.zeros(2048, dtype=torch.float64).index_add_(
        0, seg, v.double()).float()
    assert (got != exact).any()
    assert torch.equal(got, agg.segment_sum_seq_plain(v, seg, 2048))


def test_segment_sum_seq_wrapper_refuses_bad_inputs(cuda):
    v, seg = _ragged_segments(np.random.default_rng(1), 512)
    v, seg = v.to(cuda), seg.to(cuda)
    with pytest.raises(ValueError):
        kernels.segment_sum_seq(v.double(), seg, 512)
    with pytest.raises(ValueError):
        kernels.segment_sum_seq(v, seg.int(), 512)
    with pytest.raises(ValueError):
        kernels.segment_sum_seq(v[::2], seg[::2], 512)


def test_score_log1p_matches_plain_log1p(cuda):
    """The scorer's device ``log1p`` against :func:`xla_log1p` run by
    torch on the card, over 2^24 consecutive float32 bit patterns around
    each branch point and 2^22 random non-negative ones."""
    rng = np.random.default_rng(4)
    starts = np.array([0.0, 1e-3, 0.41421354, 1.0, 65535.0, 2.0 ** 31],
                      np.float32).view(np.uint32)
    bits = np.concatenate(
        [np.arange(s, s + (1 << 21), dtype=np.uint32) for s in starts]
        + [rng.integers(0, 1 << 31, 1 << 22, dtype=np.uint32)])
    x = torch.from_numpy(bits.view(np.float32)).to(cuda)
    got = kernels.score_log1p(x)
    want = xla_log1p(x)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def _raw_batches(n, b, scenario="mixed_l34_1m", seed=3):
    gen = TrafficGen(TrafficSpec(scenario=Scenario(scenario), seed=seed,
                                 rate_pps=1e6))
    out, t0 = [], None
    for i in range(n):
        rec = gen.next_records(b - (i % 5) * 131)
        t0 = int(rec["ts_ns"][0]) if t0 is None else t0
        out.append(schema.encode_raw(rec, b, t0))
    return out


@pytest.mark.parametrize("family", ["mlp", "logreg_int8"])
def test_raw_step_graph_with_eviction_equals_eager(cuda, family):
    """The captured raw48 single step with the eviction sweep on, across
    the u32 wrap of ``batches``, against the eager step: outputs, table
    and stats after every batch."""
    cfg = config.FsxConfig(
        limiter=config.LimiterConfig(pps_threshold=300.0),
        table=config.TableConfig(capacity=1 << 14, salt=0x5EED,
                                 evict_ttl_s=0.002, evict_every=4),
        batch=config.BatchConfig(max_batch=2048),
        model=config.ModelConfig(name=family))
    if family == "mlp":
        params = mlp.load_params(str(ART / "mlp_robust.npz"), cuda)
        classify = mlp.classify_batch
    else:
        params = logreg.load_params(ARTIFACT, cuda)
        classify = functools.partial(
            kernels.score_int8, packed=kernels.pack_score_params(params))
    step = fused.make_raw_step(cfg, classify)
    tg, sg = schema.make_table(1 << 14, cuda), schema.make_stats(cuda)
    te, se = schema.make_table(1 << 14, cuda), schema.make_stats(cuda)
    gr = graph.StepGraph(step, tg, sg, params, (2049, 12))
    assert gr.launches["segment_sum_seq"] == 1
    for s in (sg, se):
        s.batches.fill_((1 << 32) - 3)
    for raw in _raw_batches(10, 2048):
        gr.input.copy_(schema.wire_to_tensor(raw).to(cuda))
        gr.replay()
        _, _, oe = step(te, se, params, schema.wire_to_tensor(raw).to(cuda))
        _same_out(gr.out, oe)
        _same_state(tg, sg, te, se)
    assert se.to_dict()["evicted"] > 0


@pytest.mark.parametrize("family", ["mlp", "multiclass"])
def test_raw48_cuda_engine_equals_cpu_engine(cuda, family):
    from flowsentryx_tpu_torch.models.registry import load_artifact

    path = str(ART / ("mlp_robust.npz" if family == "mlp"
                      else "multiclass.npz"))
    cfg = config.FsxConfig(
        table=config.TableConfig(capacity=1 << 14, salt=99,
                                 evict_ttl_s=0.003, evict_every=8),
        batch=config.BatchConfig(max_batch=2048),
        model=config.ModelConfig(name=family))
    out = {}
    for device in ("cuda", "cpu"):
        # 24 ms of stream at 1e6 records/s: rows idle past the 3 ms ttl
        src = TrafficSource(TrafficSpec(scenario=Scenario.MIXED_L34_1M,
                                        seed=5, rate_pps=1e6),
                            total=12 * 2048)
        e = Engine(cfg, src, CollectSink(),
                   params=load_artifact(family, path, device), device=device)
        assert e.wire == schema.WIRE_RAW48
        r = e.run()
        out[device] = (r.stats, e.sink.blocked, _digest(e), r.table)
    assert out["cuda"] == out["cpu"]
    assert out["cuda"][0]["evicted"] > 0


# -- the production serve path: rings, sealed batches, checkpoint/restore --


class _ListSealed:
    """A sealed-batch source over prepared wire buffers (in process)."""

    provides_sealed = True
    t0_ns = 1

    def __init__(self, bufs):
        self.bufs, self.i = bufs, 0

    def start(self, *a):
        pass

    def poll_batches_into(self, dst, max_batches, **timers):
        out = []
        while len(out) < min(max_batches, len(dst)) and self.i < len(
                self.bufs):
            dst[len(out)] = self.bufs[self.i]
            out.append(type("SB", (), {
                "n_records": int(self.bufs[self.i][-1, 0]),
                "t_enqueue": time.perf_counter()})())
            self.i += 1
        return out

    def exhausted(self):
        return self.i >= len(self.bufs)


def _ring_cfg(**batch):
    return config.FsxConfig(
        limiter=config.LimiterConfig(pps_threshold=200.0, bps_threshold=1e9),
        table=config.TableConfig(capacity=1 << 14, salt=77),
        batch=config.BatchConfig(max_batch=2048, **batch))


def test_restore_in_place_under_captured_graphs(cuda, tmp_path):
    """A checkpoint restored into an engine whose graphs are already
    captured: the table and stats tensors keep their addresses, and the
    next replays see the restored rows — the run ends equal to the CPU
    engine uninterrupted."""
    params = logreg.load_params(ARTIFACT)
    rec = TrafficGen(TrafficSpec(scenario=Scenario.UDP_FLOOD_MULTI,
                                 rate_pps=1e7, n_attack_ips=32,
                                 seed=23)).next_records(12 * 2048)
    cfg = _ring_cfg()
    half = 6 * 2048
    e1 = Engine(cfg, ArraySource(rec[:half].copy()), CollectSink(),
                params=params, device="cpu")
    e1.run()
    path = e1.checkpoint(str(tmp_path / "c.npz"))
    e2 = Engine(cfg, ArraySource(rec[half:].copy()), CollectSink(),
                params=params, device="cuda")
    e2.warm()
    assert e2._graphs
    ptrs = [t.data_ptr() for t in (e2.table.key_rows, e2.table.state_rows,
                                   *e2.stats)]
    e2.restore(path)
    assert ptrs == [t.data_ptr() for t in (
        e2.table.key_rows, e2.table.state_rows, *e2.stats)]
    assert e2.stats.to_dict()["batches"] == 6
    r2 = e2.run()
    e0 = Engine(cfg, ArraySource(rec.copy()), CollectSink(), params=params,
                device="cpu")
    r0 = e0.run()
    assert r2.stats == r0.stats
    assert {**e1.sink.blocked, **e2.sink.blocked} == e0.sink.blocked
    assert _digest(e2) == _digest(e0)


def test_sealed_stage_slot_reuse_waits_for_its_event(cuda):
    """The sealed loop stages each batch into a pinned arena slot and
    claims a slot again only once the last dispatch staged there has
    finished with it.  With two arena slots and eight batches in flight
    the gate is hit for real: every reclaimed slot's event has fired,
    and the results equal the CPU engine's on the same batches."""
    params = logreg.load_params(ARTIFACT)
    raws, _ = _compact_batches(params, 24, 2048, "udp_flood_multi", seed=5)
    cfg = _ring_cfg(readback_depth=8)
    out = {}
    for device in ("cuda", "cpu"):
        e = Engine(cfg, _ListSealed([r.copy() for r in raws]), CollectSink(),
                   params=params, device=device)
        e._arena = type(e._arena)(2, e._arena.group_max, 2048, 4,
                                  pinned=device == "cuda")
        e._arena_event = [None, None]
        gated = []
        claim = e._claim

        def checked_claim(e=e, claim=claim, gated=gated):
            nxt = (e._arena._cur + 1) % e._arena.slots
            ev = e._arena_event[nxt]
            slot = claim()
            if ev is not None:
                gated.append(ev.query())
            assert e._arena_event[slot] is None
            return slot

        e._claim = checked_claim
        r = e.run()
        out[device] = (r.stats, e.sink.blocked, _digest(e))
        if device == "cuda":
            assert gated and all(gated)
            assert r.dispatch["arena"]["pinned"]
    assert out["cuda"] == out["cpu"]


def test_card_ring_path_equals_cpu(cuda, tmp_path):
    """48-byte records through a shm feature ring into the card engine
    (singles and ``auto``), blocks into a verdict ring: the same stats,
    table and verdict-ring records as the CPU engine over the records."""
    from flowsentryx_tpu_torch.engine.shm import (
        ShmRing, ShmRingSource, ShmVerdictSink,
    )

    rec = TrafficGen(TrafficSpec(scenario=Scenario.UDP_FLOOD_MULTI,
                                 rate_pps=1e7, n_attack_ips=32,
                                 seed=29)).next_records(16 * 2048)
    got = {}
    for label, device, mega_n in (("single", "cuda", 0),
                                  ("auto", "cuda", "auto"),
                                  ("cpu", "cpu", 0)):
        f, v = tmp_path / f"{label}.f", tmp_path / f"{label}.v"
        ShmRing.create(f, 1 << 15, schema.FLOW_RECORD_DTYPE).produce(rec)
        vr = ShmRing.create(v, 1 << 12, schema.VERDICT_RECORD_DTYPE)
        sink = ShmVerdictSink(v)
        e = Engine(_ring_cfg(), ShmRingSource(f), sink,
                   params=logreg.load_params(ARTIFACT), device=device,
                   mega_n=mega_n)
        e.warm()    # the capture's eager warm-ups count launches too
        n0 = kernels.LAUNCHES["score_int8"]
        r = e.run(max_batches=16)
        got[label] = (r.stats, _digest(e), vr.consume(1 << 12).tobytes())
        if device == "cuda":
            assert kernels.LAUNCHES["score_int8"] - n0 == 16
        assert sink.dropped == 0
    assert got["single"] == got["cpu"] == got["auto"]
    assert got["cpu"][2]                      # verdicts were written


def _maps(pid):
    with open(f"/proc/{pid}/maps") as f:
        return f.read()


def test_spawned_worker_never_initialises_cuda(cuda, tmp_path):
    """Workers spawned by a process that already holds a CUDA context:
    while they drain, none has libcuda or libtorch mapped (their import
    closure is numpy only), and the card engine serves their batches
    equal to the CPU engine over the same records."""
    from flowsentryx_tpu_torch.engine.shm import ShmRing
    from flowsentryx_tpu_torch.ingest import ShardedIngest

    torch.zeros(1, device=cuda)                # this process: CUDA is up
    assert "libcuda" in _maps(os.getpid())
    rec = TrafficGen(TrafficSpec(scenario=Scenario.UDP_FLOOD_MULTI,
                                 rate_pps=1e7, n_attack_ips=32,
                                 seed=31)).next_records(8 * 2048)
    base = str(tmp_path / "ring")
    ShmRing.create(base, 1 << 15, schema.FLOW_RECORD_DTYPE).produce(rec)
    src = ShardedIngest(base, 1, strict=True, precompact=False)
    params = logreg.load_params(ARTIFACT)
    try:
        e = Engine(_ring_cfg(), src, CollectSink(), params=params,
                   device="cuda")
        src.wait_ready()
        maps = [_maps(p.pid) for p in src._procs]
        r = e.run(max_batches=8)
    finally:
        src.close()
    assert all("libcuda" not in m and "libtorch" not in m for m in maps)
    e0 = Engine(_ring_cfg(), ArraySource(rec.copy()), CollectSink(),
                params=params, device="cpu")
    r0 = e0.run()
    assert r.stats == r0.stats and e.sink.blocked == e0.sink.blocked
    assert _digest(e) == _digest(e0)
    assert r.ingest["workers"]["0"]["batches"] == 8


class _WireLog(Engine):
    """Keeps a host copy of every verdict wire it sinks, in order."""

    def _sink_one(self, g):
        if g.wire is not None:
            if g.event is not None:
                g.event.synchronize()
            self.wires.append(g.wire.numpy().copy())
        super()._sink_one(g)


def test_sink_thread_never_decodes_an_overwritten_wire(cuda):
    """The sink thread with two arena slots and eight batches in flight
    (``readback_depth=8``): the dispatch thread waits for the sink to
    free an output slot before a replay reuses it, so every wire the
    sink decodes equals the CPU engine's for the same batch, and the
    results are equal."""
    params = logreg.load_params(ARTIFACT)
    raws, _ = _compact_batches(params, 24, 2048, "udp_flood_multi", seed=5)
    cfg = _ring_cfg(readback_depth=8)
    out = {}
    for device in ("cuda", "cpu"):
        e = _WireLog(cfg, _ListSealed([r.copy() for r in raws]),
                     CollectSink(), params=params, device=device,
                     sink_thread=device == "cuda")
        e.wires = []
        e._arena = type(e._arena)(2, e._arena.group_max, 2048, 4,
                                  pinned=device == "cuda")
        e._arena_event = [None, None]
        r = e.run()
        out[device] = (r.stats, e.sink.blocked, _digest(e), e.wires)
        if device == "cuda":
            assert r.readback["sink_thread"] is True
            assert r.latency["negatives"] == 0
            assert r.latency["seal_to_verdict"]["n"] == r.records
    assert out["cuda"][:3] == out["cpu"][:3]
    assert len(out["cuda"][3]) == len(out["cpu"][3]) == 24
    for a, b in zip(out["cuda"][3], out["cpu"][3]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("mega_n", [0, 4])
def test_overflow_fallback_with_sink_thread(cuda, mega_n):
    """Overflowing wires (``verdict_k=2``) sunk on the sink thread: the
    block records come back from device memory on the step's stream,
    and blacklist, stats and table equal the CPU engine's."""
    cfg = config.FsxConfig(
        limiter=config.LimiterConfig(pps_threshold=200.0, bps_threshold=1e9),
        table=config.TableConfig(capacity=1 << 14),
        batch=config.BatchConfig(max_batch=2048, verdict_k=2,
                                 readback_depth=4))
    params = logreg.load_params(ARTIFACT)
    rec = TrafficGen(TrafficSpec(scenario=Scenario.UDP_FLOOD_MULTI,
                                 rate_pps=1e7, n_attack_ips=64,
                                 seed=17)).next_records(16 * 2048)
    out = {}
    for device in ("cuda", "cpu"):
        e = Engine(cfg, ArraySource(rec.copy()), CollectSink(),
                   params=params, device=device, mega_n=mega_n,
                   sink_thread=device == "cuda")
        e.warm()
        r = e.run()
        out[device] = (r.stats, e.sink.blocked, _digest(e))
        if device == "cuda":
            assert r.readback["fallback_sinks"] > 0
    assert out["cuda"] == out["cpu"]


@pytest.mark.parametrize("sink_thread", [False, True])
def test_watchdog_trips_on_a_wedged_stream(cuda, sink_thread):
    """A ``torch.cuda._sleep`` of ~6 s enqueued on the step's stream
    wedges every replay behind it; with ``watchdog_s=0.5`` the dispatch
    thread (polling its events, or waiting on the sink thread) soft-
    trips, then raises :class:`WatchdogStall`, and shutdown gives the
    wedged sink thread at most 2 s: the run returns well before the
    sleep ends.  The health ladder reads failed."""
    from flowsentryx_tpu_torch.engine import health
    from flowsentryx_tpu_torch.engine.watchdog import WatchdogStall

    params = logreg.load_params(ARTIFACT)
    rec = TrafficGen(TrafficSpec(seed=3)).next_records(32 * 2048)
    e = Engine(_ring_cfg(readback_depth=2), ArraySource(rec), CollectSink(),
               params=params, device="cuda", watchdog_s=0.5,
               sink_thread=sink_thread)
    e.warm()
    torch.cuda._sleep(int(6.0 * 2e9))     # cycles: >= 6 s at <= 2 GHz
    t = time.perf_counter()
    with pytest.raises(WatchdogStall):
        e.run()
    assert time.perf_counter() - t < 4.5
    wd = e._watchdog.to_dict()
    assert wd["soft_trips"] == 1 and wd["hard_tripped"]
    assert health.engine_health(watchdog=wd)["state"] == "failed"
    torch.cuda.synchronize()
    for th in threading.enumerate():      # the abandoned sink thread
        if th.name == "fsx-sink":
            th.join(timeout=30)


def test_warm_seeds_ewma_for_every_captured_rung(cuda):
    """Under a budget, ``warm()`` seeds the step-time EWMA of the single
    step and of every captured rung with a timed replay plus its event
    wait; a run does not refine it (a replay's output is never ready
    when the call returns)."""
    params = logreg.load_params(ARTIFACT)
    e = Engine(_ring_cfg(), ArraySource(np.empty(0)), CollectSink(),
               params=params, device="cuda", mega_n="auto", slo_us=2000)
    e.warm()
    assert set(e._graphs) == {0, 2, 4, 8}
    assert set(e._rung_ewma_s) == {1, 2, 4, 8}
    assert all(0 < v < 0.1 for v in e._rung_ewma_s.values())
    seed = dict(e._rung_ewma_s)
    rec = TrafficGen(TrafficSpec(seed=3)).next_records(16 * 2048)
    e.reset_stream(ArraySource(rec))
    r = e.run()
    assert r.dispatch["slo"]["rung_ewma_ms"] == {
        str(k): round(v * 1e3, 4) for k, v in sorted(seed.items())}


# -- the live model swap: the scorer's parameters in device memory ----------


def _derived_params(seed=5, device="cpu"):
    """``logreg_int8.npz``'s input observer with other weights and bias
    (a second artifact the compact16 model wire accepts as a swap)."""
    h = dict(np.load(ARTIFACT))
    rng = np.random.default_rng(seed)
    h["w_int8"] = rng.integers(-127, 128, 8).astype(np.int8)
    h["bias"] = np.float32(h["bias"] + rng.normal())
    return logreg.params_from_numpy(h, device)


@pytest.mark.parametrize("name", ["golden", "log1p"])
def test_score_int8_repacked_in_place_matches_plain(cuda, name):
    """The kernel reads the pack's device buffer: after a repack with
    other params (same buffer, same address) it equals the plain
    version of the new params, and after a repack back the old."""
    tp = (logreg.golden_params(cuda) if name == "golden"
          else logreg.load_params(ARTIFACT, cuda))
    new = _derived_params(device=cuda)
    packed = kernels.pack_score_params(tp)
    ptr = packed.args_ptr
    x = torch.from_numpy(np.random.default_rng(3).uniform(
        0, 2e6, (4099, 8)).astype(np.float32)).to(cuda)
    assert torch.equal(kernels.score_int8(tp, x, packed),
                       kernels.score_int8_plain(tp, x))
    for p in (new, tp, new):
        kernels.repack_score_params(packed, p)
        assert packed.args_ptr == ptr == packed.buf.data_ptr()
        assert torch.equal(kernels.score_int8(p, x, packed),
                           kernels.score_int8_plain(p, x))
        codes = torch.arange(256, dtype=torch.float32, device=cuda)
        assert torch.equal(packed.table, logreg.score_from_code(p, codes))


def test_swap_between_rung_replays_recaptures_nothing(cuda):
    """``mega_n="auto"``: serve, swap, serve on.  The engine's graphs are
    the same objects, none is captured again, the scorer's buffer and the
    params tensors keep their addresses, and the result equals the CPU
    engine (singles) swapped at the same batch index."""
    rec = TrafficGen(TrafficSpec(scenario=Scenario.UDP_FLOOD_MULTI,
                                 rate_pps=1e7, n_attack_ips=32,
                                 seed=29)).next_records(40 * 2048)
    cfg = _ring_cfg()
    e = Engine(cfg, ArraySource(rec.copy()), CollectSink(),
               params=logreg.load_params(ARTIFACT), device="cuda",
               mega_n="auto")
    e.warm()
    graphs = dict(e._graphs)
    n_captures = graph.CAPTURES
    ptrs = [t.data_ptr() for t in e.params] + [e.score_params.args_ptr]
    e.run(max_batches=17)          # whole rung-8 groups: 24 batches
    e.hot_swap(_derived_params())
    r = e.run()
    assert e._hot_swaps == 1 and len(e._swap_at) == 1
    assert e._graphs == graphs and graph.CAPTURES == n_captures
    assert ptrs == [t.data_ptr() for t in e.params] + [
        e.score_params.args_ptr]
    assert r.dispatch["group_hist"].get("8", 0) > 0
    c = Engine(cfg, ArraySource(rec.copy()), CollectSink(),
               params=logreg.load_params(ARTIFACT), device="cpu")
    c.run(max_batches=e._swap_at[0])
    c.hot_swap(_derived_params())
    rc = c.run()
    assert (r.stats, e.sink.blocked, _digest(e)) == (
        rc.stats, c.sink.blocked, _digest(c))


def test_dispatch_before_a_swap_scores_with_the_old_model(cuda):
    """The step's stream is held by a ``torch.cuda._sleep`` while one
    batch is dispatched, the model swapped, and a second batch
    dispatched: the first (still queued at the swap) scores with the old
    model and the second with the new, by stream order.  The card's
    wires and state equal the CPU engine's for that sequence, which
    differs both from swapping before the first batch and from never
    swapping (each batch's model shows in the result)."""
    params = logreg.load_params(ARTIFACT)
    raws, _ = _compact_batches(params, 2, 2048, "udp_flood_multi", seed=7)
    cfg = _ring_cfg()
    out = {}
    for device, swap_at in (("cuda", 1), ("cpu", 1), ("cpu", 0),
                            ("cpu", None)):
        e = _WireLog(cfg, ArraySource(np.zeros(0, schema.FLOW_RECORD_DTYPE)),
                     CollectSink(), params=params, device=device,
                     sink_thread=False)
        e.wires = []
        e.warm()
        if device == "cuda":
            torch.cuda._sleep(int(1e9))       # ~0.5 s of the stream
        for i, raw in enumerate(raws):
            if swap_at == i:
                if device == "cuda":
                    # the first batch is still queued behind the sleep
                    assert not e._inflight[0].event.query()
                e.hot_swap(_derived_params())
            e._dispatch(raw.copy())
        e._reap(0)
        out[(device, swap_at)] = (e.stats.to_dict(), e.sink.blocked,
                                  _digest(e), e.wires)
    assert out[("cuda", 1)][:3] == out[("cpu", 1)][:3]
    for a, b in zip(out[("cuda", 1)][3], out[("cpu", 1)][3]):
        np.testing.assert_array_equal(a, b)
    assert out[("cpu", 1)][:3] != out[("cpu", 0)][:3]
    assert out[("cpu", 1)][:3] != out[("cpu", None)][:3]


def test_swap_from_a_second_thread_mid_drain_equals_cpu_replay(cuda):
    """An operator thread swaps while the card engine drains (sink
    thread on): the swap lands between two dispatches, at the batch
    index it records, and the run equals the CPU engine swapped at that
    index."""
    rec = TrafficGen(TrafficSpec(scenario=Scenario.UDP_FLOOD_MULTI,
                                 rate_pps=1e7, n_attack_ips=32,
                                 seed=31)).next_records(48 * 2048)
    cfg = _ring_cfg()
    new = _derived_params()
    e = Engine(cfg, ArraySource(rec.copy()), CollectSink(),
               params=logreg.load_params(ARTIFACT), device="cuda",
               sink_thread=True)
    e.warm()

    def operator():
        while e._batches_launched < 12:
            time.sleep(0)
        e.hot_swap(new)

    t = threading.Thread(target=operator)
    t.start()
    r = e.run()
    t.join()
    assert e._hot_swaps == 1 and len(e._swap_at) == 1
    k = e._swap_at[0]
    assert 12 <= k < 48
    c = Engine(cfg, ArraySource(rec.copy()), CollectSink(),
               params=logreg.load_params(ARTIFACT), device="cpu",
               sink_thread=False)
    c.run(max_batches=k)
    c.hot_swap(new)
    rc = c.run()
    assert (r.stats, e.sink.blocked, _digest(e)) == (
        rc.stats, c.sink.blocked, _digest(c))


# ---------------------------------------------------------------------------
# The scorer's stage entries, the evaluation shapes, training and distill
# ---------------------------------------------------------------------------


def _u32_probe(params, n_random, seed):
    """u32 feature values as float32: 0..4095, powers of two and their
    neighbours, the distill replay's edges, and uniform u32 draws."""
    from flowsentryx_tpu_torch.distill import plan as dplan

    p = dplan.compile_plan(logreg.params_from_numpy(
        logreg.params_to_numpy(params)), validate=False)
    pw = np.array([1 << k for k in range(32)], np.int64)
    v = np.concatenate([
        np.arange(4096), pw - 1, pw, pw + 1,
        dplan.validation_edges(p).astype(np.int64),
        np.random.default_rng(seed).integers(0, 1 << 32, n_random)])
    v = v[(v >= 0) & (v <= dplan.U32_MAX)]
    return torch.from_numpy(v).float()


@pytest.mark.parametrize("name", ["golden", "log1p"])
def test_score_quant_u8_entry_matches_plain(cuda, name):
    """The kernel's input stage alone equals its plain version
    (``_quantize_u8`` of ``_maybe_log1p``), exactly, and launches count
    nothing."""
    tp = (logreg.golden_params(cuda) if name == "golden"
          else logreg.load_params(ARTIFACT, cuda))
    x = _u32_probe(tp, 1 << 20, 5).to(cuda)
    n0 = dict(kernels.LAUNCHES)
    got = kernels.score_quant_u8(tp, x)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES == n0
    assert torch.equal(got, kernels.score_quant_u8_plain(tp, x))
    assert torch.equal(got.cpu(), kernels.score_quant_u8(
        logreg.params_from_numpy(logreg.params_to_numpy(tp)), x.cpu()))


@pytest.mark.parametrize("name", ["golden", "log1p"])
def test_score_tail_entry_matches_plain(cuda, name):
    """The kernel's tail alone over the whole reachable accumulator
    range equals ``score_from_acc``, exactly."""
    tp = (logreg.golden_params(cuda) if name == "golden"
          else logreg.load_params(ARTIFACT, cuda))
    w = tp.w_int8.cpu().numpy().astype(np.int64)
    zp = int(tp.in_zp)
    contrib = (np.arange(256)[None, :] - zp) * w[:, None]
    acc = torch.arange(int(contrib.min(1).sum()), int(contrib.max(1).sum())
                       + 1, dtype=torch.int32, device=cuda)
    got = kernels.score_tail(tp, acc)
    assert torch.equal(got, logreg.score_from_acc(tp, acc))
    assert torch.equal(got.cpu(), logreg.score_from_acc(
        logreg.params_from_numpy(logreg.params_to_numpy(tp)), acc.cpu()))


@pytest.mark.parametrize("b", [65_536, 45_407])
def test_score_int8_at_evaluation_shapes(cuda, b):
    """``evaluate_model``'s chunk and the fixture test split's last
    chunk: the kernel equals its plain version."""
    from flowsentryx_tpu_torch.train import fixture

    tp = logreg.load_params(ARTIFACT, cuda)
    X, _ = fixture.cicids_fixture(n=b, seed=1)
    x = torch.from_numpy(X).to(cuda)
    assert torch.equal(kernels.score_int8(tp, x),
                       kernels.score_int8_plain(tp, x))


def test_qat_epochs_on_card_match_cpu(cuda):
    """Two warmup and two quantize epochs of ``train_logreg_qat`` on the
    card against the same epochs on the CPU: observers, gradients and
    weights exactly (every sum runs in the reference's order on both:
    ``gemv_seq``, ``xla_batch_sum``); the loss rtol 1e-5 (its per-row
    ``log`` is torch's, whose last bit differs between the two)."""
    from flowsentryx_tpu_torch.train import fixture, qat

    X, y = fixture.cicids_fixture(n=200_000, seed=6)
    states = {}
    for dev in ("cpu", cuda):
        Xd = xla_log1p(torch.from_numpy(X).to(dev))
        yd = torch.from_numpy(y).to(dev)
        st = qat.new_state(dev)
        out = []
        for quantize in (False, False, True, True):
            st, loss = qat.qat_epoch(st, Xd, yd, quantize)
            out.append((st.obs_in.lo.item(), st.obs_in.hi.item(),
                        st.obs_out.lo.item(), st.obs_out.hi.item(),
                        st.b.grad.item(), st.b.item(),
                        st.w.grad.cpu().numpy().copy(),
                        st.w.cpu().numpy().copy(), loss.item()))
        states[str(dev)] = out
    for c, g in zip(states["cpu"], states[str(cuda)]):
        assert c[:6] == g[:6]
        np.testing.assert_array_equal(g[6], c[6])
        np.testing.assert_array_equal(g[7], c[7])
        np.testing.assert_allclose(g[8], c[8], rtol=1e-5)


@pytest.mark.parametrize("name", ["golden", "log1p"])
def test_compile_plan_on_card_equals_cpu(cuda, name):
    """``compile_plan`` through the kernel's stage entries equals the
    compile through their plain versions (blob, arrays, meta but
    ``backend``), and the served lane bands the parity corpus as the
    plan does."""
    from flowsentryx_tpu_torch.distill import parity
    from flowsentryx_tpu_torch.distill import plan as dplan

    tp = (logreg.golden_params(cuda) if name == "golden"
          else logreg.load_params(ARTIFACT, cuda))
    cpu = logreg.params_from_numpy(logreg.params_to_numpy(tp))
    a, b = dplan.compile_plan(tp), dplan.compile_plan(cpu)
    assert dplan.pack_blob(a) == dplan.pack_blob(b)
    assert a.meta["backend"].startswith("cuda") and b.meta["backend"] == "cpu"
    assert {k: v for k, v in a.meta.items() if k != "backend"} == \
        {k: v for k, v in b.meta.items() if k != "backend"}
    chk = parity.served_band_check(tp, a, parity.corpus(a))
    assert chk["ok"], chk


@pytest.mark.parametrize("n,k", [(0, 8), (1, 8), (511, 8), (512, 8),
                                 (513, 8), (100_000, 8), (4099, 3)])
def test_gemv_seq_kernel_matches_plain(cuda, n, k):
    """The QAT weight gradient's FMA chain on the card equals its plain
    version bit for bit (tile edges, a ragged last tile, K < 8)."""
    rng = np.random.default_rng(n + k)
    g = torch.from_numpy((rng.standard_normal(n) * 10.0 ** rng.uniform(
        -3, 3, n)).astype(np.float32))
    m = torch.from_numpy((rng.standard_normal((n, k)) * 3).astype(np.float32))
    n0 = kernels.LAUNCHES["gemv_seq"]
    got = kernels.gemv_seq(g.to(cuda), m.to(cuda))
    assert kernels.LAUNCHES["gemv_seq"] == n0 + 1
    want = kernels.gemv_seq_plain(g, m)
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))



# ---------------------------------------------------------------------------
# the drain ring and the boot path
# ---------------------------------------------------------------------------


def _loop_cfg(verdict_k=64):
    return config.FsxConfig(
        table=config.TableConfig(capacity=1 << 14, salt=0x1CE),
        batch=config.BatchConfig(max_batch=256, verdict_k=verdict_k),
        limiter=config.LimiterConfig(pps_threshold=200.0,
                                     bps_threshold=1e9))


def _flood_recs(n_batches, seed=3):
    return TrafficGen(TrafficSpec(
        scenario=Scenario.UDP_FLOOD_MULTI, rate_pps=1e7, n_attack_ips=32,
        attack_fraction=0.8, seed=seed)).next_records(256 * n_batches)


def _state(e):
    k, st = schema.table_to_numpy(e.table)
    return (e.stats.to_dict(), hashlib.sha256(
        k.tobytes() + st.tobytes()).hexdigest(),
        sorted(e.sink.blocked.items()))


@pytest.mark.parametrize("depth,verdict_k", [(2, 64), (3, 64), (2, 4)])
def test_device_loop_on_card_equals_cpu(cuda, depth, verdict_k):
    """Ring rounds on the card (the R*C steps as one graph, uploads on
    the copy stream) against the CPU engine: equal state and blacklist,
    ``score_int8`` launched once per batch, full rounds fired; at K=4
    slot wires overflow and fall back."""
    recs = _flood_recs(40)
    e = Engine(_loop_cfg(verdict_k), ArraySource(recs.copy()),
               CollectSink(), device="cuda", mega_n=4, device_loop=depth)
    e.warm()
    kernels.reset_launches()
    r = e.run()
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["score_int8"] == r.batches == 40
    c = Engine(_loop_cfg(verdict_k), ArraySource(recs.copy()),
               CollectSink(), device="cpu")
    c.run()
    assert _state(e) == _state(c)
    assert r.dispatch["device_loop"]["rounds"] >= 2
    assert r.dispatch["graph_nodes"]["ring"] is None or (
        r.dispatch["graph_nodes"]["ring"]
        > depth * r.dispatch["graph_nodes"]["mega4"] // 2)
    if verdict_k == 4:
        assert r.readback["fallback_sinks"] > 0


def test_fill_thread_captures_while_replays_run(cuda):
    """A tiered warm's fill captures the remaining rungs and the ring on
    its own thread while the dispatch thread replays the serving tier:
    the launch counts are exactly the served batches' (the fill's
    warm-ups and captures count elsewhere), the state equals the CPU
    engine's, and the fill completes with every graph ready."""
    recs = _flood_recs(96, seed=5)
    e = Engine(_loop_cfg(), ArraySource(recs.copy()), CollectSink(),
               device="cuda", mega_n="auto", device_loop=2)
    e.warm(tiered=True)
    assert e._ready_sizes == (8,) and not e._ring_ready
    kernels.reset_launches()
    r = e.run()
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["score_int8"] == r.batches == 96
    assert kernels.LAUNCHES["table_summary"] == 1
    c = Engine(_loop_cfg(), ArraySource(recs.copy()), CollectSink(),
               device="cpu")
    c.run()
    assert _state(e) == _state(c)
    assert "fill_error" not in r.boot and r.boot["fill_pending"] == []
    assert e._ready_sizes == (8, 4, 2) and e._ring_ready
    assert set(e._graphs) == {0, 8, 4, 2, -1}


def test_compile_cache_hit_loads_a_real_library(cuda, tmp_path,
                                                monkeypatch):
    """A cold build stores each library; a second build directory is
    filled from the cache without nvcc, and the loaded kernel equals its
    plain version."""
    from flowsentryx_tpu_torch.engine.compile_cache import CompileCache

    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "k1")
    cold = CompileCache(tmp_path / "cache", {"k": 1})
    info = kernels.build_all(cache=cold)
    assert all(v["source"] == "build" for v in info.values())
    assert cold.stores == len(info) and cold.misses == len(info)
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "k2")
    monkeypatch.setattr(kernels, "_FNS", {})

    def no_nvcc():
        raise AssertionError("a cached boot must not run nvcc")

    monkeypatch.setattr(kernels, "_nvcc", no_nvcc)
    warm = CompileCache(tmp_path / "cache", {"k": 1})
    info = kernels.build_all(cache=warm)
    assert all(v["source"] == "cache" for v in info.values())
    assert warm.hits == len(info) and warm.misses == 0
    p = logreg.load_params(ARTIFACT, cuda)
    x = torch.rand(2048, 8, device=cuda) * 1e5
    got = kernels.score_int8(p, x)
    assert torch.equal(got, kernels.score_int8_plain(p, x))


def test_cluster_fleet_on_card_equals_cpu_fleet(cuda, tmp_path):
    """Two rank processes on the card (``engine_main``, drain mode, each
    its own CUDA context) against the same fleet on the CPU, over the
    same prefilled 2-shard fan-out and epoch: per-rank stats, table
    summaries and published/merged blacklist digests equal, gossip
    converged, ``score_int8`` once per batch in each card rank."""
    from flowsentryx_tpu_torch.cluster.supervisor import ClusterSupervisor
    from flowsentryx_tpu_torch.core import wire
    from flowsentryx_tpu_torch.engine.shm import ShmRing

    cfg = config.FsxConfig(
        table=config.TableConfig(capacity=1 << 16, salt=0x2F1),
        batch=config.BatchConfig(max_batch=2048),
        limiter=config.LimiterConfig(pps_threshold=200.0, bps_threshold=1e9))
    recs = TrafficGen(TrafficSpec(
        scenario=Scenario.UDP_FLOOD_MULTI, rate_pps=1e7, n_attack_ips=8,
        n_benign_ips=24, attack_fraction=0.8, seed=13)).next_records(2048 * 12)
    t0 = int(recs["ts_ns"][0])
    sh = wire.shard_of(recs["saddr"], 2)
    out = {}
    for dev in ("cuda", "cpu"):
        base = str(tmp_path / f"{dev}_ring")
        for k in range(2):
            ring = ShmRing.create(wire.shard_ring_path(base, k, 2), 1 << 15,
                                  wire.FLOW_RECORD_DTYPE)
            assert ring.produce(recs[sh == k]) == int((sh == k).sum())
        spec = {"device": dev, "cfg_json": cfg.to_json(), "ring_base": base,
                "workers": 1, "total_shards": 2, "artifact": ARTIFACT,
                "mega": "auto", "drain": True}
        sup = ClusterSupervisor(tmp_path / f"{dev}_plane",
                                [dict(spec), dict(spec)], t0_ns=t0)
        sup.boot()
        agg = sup.run(max_seconds=600)
        assert agg["failed_ranks"] == [] and agg["restarts"] == [0, 0]
        out[dev] = {r["rank"]: r for r in agg["reports"]}
    for r in range(2):
        card, cpu = out["cuda"][r], out["cpu"][r]
        assert card["report"]["records"] == int((sh == r).sum())
        for k in ("stats", "table", "batches", "blocked_sources"):
            assert card["report"][k] == cpu["report"][k], k
        for k in ("published_digest", "merged_digest", "rx_seq_gaps"):
            assert card["report"]["cluster"][k] == cpu["report"]["cluster"][k]
        assert card["report"]["cluster"]["merged_digest"] == out["cuda"][
            1 - r]["report"]["cluster"]["published_digest"]
        assert card["launches"]["score_int8"] == card["report"]["batches"]
        assert card["report"]["device"]["type"] == "cuda"


@pytest.mark.parametrize("name", ["config1", "config2", "config3", "config4",
                                  "config5"])
def test_scenario_on_card_equals_cpu(cuda, name):
    """A BASELINE config through ``run_suite`` on the card equals the CPU
    engine's in every untimed field (both limiters included), with one
    ``score_int8`` launch per batch and one ``table_summary`` per report."""
    from flowsentryx_tpu_torch import benchmarks

    kernels.reset_launches()
    [got] = benchmarks.run_suite(scale=0.05, names=[name], device="cuda")
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    [want] = benchmarks.run_suite(scale=0.05, names=[name], device="cpu")
    timing = ("wall_s", "mpps", "stages_ms")
    assert ({k: v for k, v in got.items() if k not in timing}
            == {k: v for k, v in want.items() if k not in timing})
    assert launches["score_int8"] == got["batches"]
    assert launches["table_summary"] == 1


def test_chaos_campaign_on_card(cuda, tmp_path):
    """The quick chaos campaign with its engine on the card: every
    invariant holds and every ported plant is caught."""
    from flowsentryx_tpu_torch.chaos import run_campaign

    rep = run_campaign(seed=17, quick=True, device="cuda", workdir=tmp_path)
    assert rep["device"] == "cuda"
    assert rep["ok"], [(r["fault"], i) for r in rep["faults"]
                       for i in r["invariants"] if not i["ok"]]
    assert all(p["ok"] for p in rep["planted_regressions"])


def test_handoff_in_place_under_graphs_equals_cpu(cuda):
    """``chip_smoke.handoff_engine_drive`` at 2^16 rows: a donor and a
    recipient engine on the card (graphs captured at ``warm()``) hand
    shard 2 of 3 over in place — extract, adopt, drop — and serve 8 more
    batches each through the same graphs.  The table pointers hold, no
    graph is captured, and every table, count and the tails' stats,
    blacklists and digests equal the CPU engines' on the same records."""
    import sys

    sys.path.insert(0, str(ART.parent))
    import chip_smoke

    cfg = config.FsxConfig(table=config.TableConfig(capacity=1 << 16))
    recs = TrafficGen(TrafficSpec(
        scenario=Scenario.MIXED_L34_1M, rate_pps=1e7, n_attack_ips=1024,
        n_benign_ips=4096, attack_fraction=0.8, seed=17)).next_records(
            16 * 2048)
    sh = schema.shard_of(recs["saddr"], 3)
    d, r = recs[(sh == 0) | (sh == 2)], recs[sh == 1]
    tail = 8 * 2048
    args = (d[:-tail], r[:-tail], d[-tail:], r[-tail:])
    got = chip_smoke.handoff_engine_drive("cuda", cfg, *args)
    chip_smoke.join_sink_threads()
    want = chip_smoke.handoff_engine_drive("cpu", cfg, *args)
    assert got["pointers_kept"] and got["no_new_capture"]
    assert got["no_new_capture_after_tail"]
    assert got["rows_moved"] > 0 and got["dropped"] == 0
    assert got["tracked_after"][1] - got["tracked_before"][1] \
        == got["inserted"] == got["rows_moved"]
    for k in ("served", "digest_before", "rows_moved", "moved_digest",
              "inserted", "dropped", "rows_dropped", "digest_after",
              "tracked_before", "tracked_after", "tail", "after_tail"):
        assert got[k] == want[k], k
    assert got["launches"]["score_int8"] == sum(got["dispatched"])
