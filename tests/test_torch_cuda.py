"""The port's CUDA kernels and engine on the card, against their plain
versions.  Every test here needs an NVIDIA GPU and skips without one
(the kernels have no CPU mode).  The file imports no JAX, so it runs on
a machine with the card alone:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import functools
import hashlib
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
    capture itself counts none (its warm-ups are real launches)."""
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
                           "segment_sum_seq": 0}
    assert kernels.LAUNCHES["score_int8"] == (n0["score_int8"]
                                              + graph.WARMUPS * per)
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
                e._dispatch_mega(raws[i * mega_n:(i + 1) * mega_n])
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
