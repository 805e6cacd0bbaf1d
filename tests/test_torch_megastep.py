"""The port's megastep ladder against the JAX reference, byte for byte.

``merge_verdict_wires``, ``pow2_group_sizes`` and ``rung_for_volume``
against the reference functions; the megastep family against the
reference's jitted ``make_compact_megastep_family`` (table, stats,
stacked verdicts and block arrays, merged wire); and the engine's
backlog-triggered grouping (``Engine(mega_n=4)`` and ``"auto"``) against
the reference engine on one pregenerated stream, overflow included.
Tolerance: byte-equal everywhere.
"""

import json
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from flowsentryx_tpu.core import config as jconfig
from flowsentryx_tpu.core import schema as jschema
from flowsentryx_tpu.engine import CollectSink as JCollectSink
from flowsentryx_tpu.engine import Engine as JEngine
from flowsentryx_tpu.engine.sources import ArraySource as JArraySource
from flowsentryx_tpu.engine.traffic import Scenario as JScenario
from flowsentryx_tpu.engine.traffic import TrafficGen as JTrafficGen
from flowsentryx_tpu.engine.traffic import TrafficSpec as JTrafficSpec
from flowsentryx_tpu.models import get_model as jget_model
from flowsentryx_tpu.models import logreg as jlogreg
from flowsentryx_tpu.ops import fused as jfused
from flowsentryx_tpu_torch import cli
from flowsentryx_tpu_torch.core import config, schema
from flowsentryx_tpu_torch.engine import (
    ArraySource, CollectSink, Engine, NullSink, TrafficSource, TrafficSpec,
)
from flowsentryx_tpu_torch.models import logreg
from flowsentryx_tpu_torch.models.registry import get_model
from flowsentryx_tpu_torch.ops import fused

ARTIFACT = str(Path(__file__).resolve().parents[1] / "artifacts"
               / "logreg_int8.npz")
INVALID = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# merge_verdict_wires
# ---------------------------------------------------------------------------

_jpack = jax.jit(jfused.pack_verdict_wire, static_argnums=(4,))
_jmerge = jax.jit(jfused.merge_verdict_wires)


def _wire_stack(rng, g, k, n_blocks, nows, b=32):
    """``[g, 2K+4]`` uint32 wires from the reference's own
    ``pack_verdict_wire`` over padded block arrays with ``n_blocks[i]``
    blocks at random lanes of chunk ``i``."""
    wires = []
    for i in range(g):
        key = np.full(b, INVALID, np.uint32)
        until = np.zeros(b, np.float32)
        lanes = rng.choice(b, n_blocks[i], replace=False)
        key[lanes] = rng.integers(1, INVALID, n_blocks[i], dtype=np.uint64)
        until[lanes] = rng.uniform(0, 500, n_blocks[i]).astype(np.float32)
        wires.append(np.asarray(_jpack(
            key, until, jnp.float32(nows[i]),
            np.uint32(rng.integers(0, 3)), k)))
    return np.stack(wires)


@pytest.mark.parametrize("g", [2, 8])
@pytest.mark.parametrize("case", [
    "sparse", "total_over_k", "chunk_overflow", "all_empty", "now_ties",
    "one_chunk_exactly_k",
])
def test_merge_verdict_wires_matches_reference(g, case):
    rng = np.random.default_rng(zlib.crc32(case.encode()) + g)
    k = 8
    nows = rng.uniform(0, 90, g).astype(np.float32)
    n_blocks = {
        "sparse": [int(i == g - 1) for i in range(g)],
        "total_over_k": [k // 2 + 1] * g,
        "chunk_overflow": [k + 5 if i == 1 else 1 for i in range(g)],
        "all_empty": [0] * g,
        "now_ties": list(rng.integers(0, 3, g)),
        "one_chunk_exactly_k": [k] + [0] * (g - 1),
    }[case]
    if case == "now_ties":
        nows[:] = nows[0]
    wires = _wire_stack(rng, g, k, n_blocks, nows)
    want = np.asarray(_jmerge(wires))
    got = fused.merge_verdict_wires(torch.from_numpy(wires.view(np.int32)))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    count, overflow = int(want[2 * k]), bool(want[2 * k + 1])
    assert count == sum(n_blocks)
    assert overflow == (count > k)


# ---------------------------------------------------------------------------
# the ladder's pure policy
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mega_n", [0, 1, 2, 3, 4, 7, 8, 9, 16, 33])
def test_pow2_group_sizes_and_rung_for_volume(mega_n):
    sizes = fused.pow2_group_sizes(mega_n)
    assert sizes == jfused.pow2_group_sizes(mega_n)
    for ladder in (sizes, (mega_n,) if mega_n else ()):
        for volume in range(0, 2 * mega_n + 3):
            assert (fused.rung_for_volume(volume, ladder)
                    == jfused.rung_for_volume(volume, ladder))


# ---------------------------------------------------------------------------
# the megastep family
# ---------------------------------------------------------------------------


def _cfgs(cap, batch, verdict_k, pps=1000.0, readback_depth=8):
    lim = dict(pps_threshold=pps, bps_threshold=1e9)
    t = dict(capacity=cap)
    bt = dict(max_batch=batch, verdict_k=verdict_k)
    return (jconfig.FsxConfig(limiter=jconfig.LimiterConfig(**lim),
                              table=jconfig.TableConfig(**t),
                              batch=jconfig.BatchConfig(**bt)),
            config.FsxConfig(limiter=config.LimiterConfig(**lim),
                             table=config.TableConfig(**t),
                             batch=config.BatchConfig(
                                 readback_depth=readback_depth, **bt)))


@pytest.mark.parametrize("g,verdict_k", [(2, 64), (4, 64), (4, 2)])
def test_megastep_family_matches_reference(g, verdict_k):
    """Three groups of ``g`` random compact16 batches through the port's
    megastep and the reference's jitted one (cap 2^10, B=128): the table
    and stats after each group, and every stacked output and the merged
    wire, byte for byte.  At K=2 the merged wire overflows."""
    b, cap = 128, 1 << 10
    jcfg, tcfg = _cfgs(cap, b, verdict_k, pps=20.0)
    jp = jlogreg.golden_params()
    tp = logreg.golden_params()
    quant = jschema.wire_quant_for(jp)
    jmega = jfused.make_compact_megastep_family(
        jcfg, jget_model(jcfg.model.name).classify_batch, (g,),
        donate=False, **quant)[g]
    tmega = fused.make_compact_megastep_family(
        tcfg, get_model(tcfg.model.name).classify_batch, (g,), **quant)[g]
    rng = np.random.default_rng(9 + g + verdict_k)
    jt, js = jschema.make_table(cap), jschema.make_stats()
    tt, ts = schema.make_table(cap), schema.make_stats()
    overflowed = 0
    for group in range(3):
        raws = []
        for i in range(g):
            n = b - (i % 3) * 17
            buf = np.zeros(n, dtype=jschema.FLOW_RECORD_DTYPE)
            buf["saddr"] = rng.integers(1, 24, n).astype(np.uint32)
            buf["pkt_len"] = rng.integers(64, 1500, n)
            buf["ts_ns"] = ((group * g + i) * b + np.arange(n)) * 50_000
            buf["feat"] = rng.integers(0, 1 << 22, (n, 8))
            raws.append(jschema.encode_compact(buf, b, t0_ns=0, **quant))
        stacked = np.stack(raws)
        jt, js, jo = jmega(jt, js, jp, jnp.asarray(stacked))
        tt, ts, to = tmega(tt, ts, tp, schema.wire_to_tensor(stacked))
        np.testing.assert_array_equal(to.verdict.numpy(),
                                      np.asarray(jo.verdict))
        np.testing.assert_array_equal(to.block_key.numpy().view(np.uint32),
                                      np.asarray(jo.block_key))
        np.testing.assert_array_equal(
            to.block_until.numpy().view(np.uint32),
            np.asarray(jo.block_until).view(np.uint32))
        np.testing.assert_array_equal(to.now.numpy().view(np.uint32),
                                      np.asarray(jo.now).view(np.uint32))
        np.testing.assert_array_equal(to.wire.numpy().view(np.uint32),
                                      np.asarray(jo.wire))
        assert to.verdict.shape == (g, b) and to.now.shape == (g,)
        key, state = schema.table_to_numpy(tt)
        np.testing.assert_array_equal(key, np.asarray(jt.key))
        np.testing.assert_array_equal(state.view(np.uint32),
                                      np.asarray(jt.state).view(np.uint32))
        ref = schema.stats_to_numpy(ts)
        for f in jschema.GlobalStats._fields:
            np.testing.assert_array_equal(ref[f], np.asarray(getattr(js, f)))
        overflowed += int(np.asarray(jo.wire)[2 * verdict_k + 1])
    assert ts.to_dict()["dropped_rate"] > 0
    if verdict_k == 2:
        assert overflowed > 0


def test_megastep_refuses_other_chunk_counts():
    _, tcfg = _cfgs(1 << 10, 128, 64)
    mega = fused.make_compact_megastep(
        tcfg, get_model("logreg_int8").classify_batch, 4)
    with pytest.raises(ValueError, match="built for 4 chunks"):
        mega(schema.make_table(1 << 10), schema.make_stats(),
             logreg.golden_params(), torch.zeros(3, 129, 4, dtype=torch.int32))


# ---------------------------------------------------------------------------
# the engine's grouping against the reference engine
# ---------------------------------------------------------------------------


def _flood(n_batches, batch, seed):
    return JTrafficGen(JTrafficSpec(
        scenario=JScenario.UDP_FLOOD_MULTI, rate_pps=1e7, n_attack_ips=32,
        attack_fraction=0.8, seed=seed)).next_records(batch * n_batches)


def _engines(recs, batch, verdict_k, mega_n, params=None):
    jcfg, tcfg = _cfgs(1 << 12, batch, verdict_k, pps=200.0,
                       readback_depth=4)
    jsink, tsink = JCollectSink(), CollectSink()
    je = JEngine(jcfg, JArraySource(recs.copy()), jsink, readback_depth=4,
                 mega_n=mega_n, sink_thread=False,
                 params=jlogreg.load_params(ARTIFACT) if params else None)
    te = Engine(tcfg, ArraySource(recs.copy()), tsink, device="cpu",
                mega_n=mega_n,
                params=logreg.load_params(ARTIFACT) if params else None)
    return (je, jsink), (te, tsink)


def _assert_same_result(je, jsink, jr, te, tsink, tr):
    assert tr.records == jr.records and tr.batches == jr.batches
    assert tr.stats == jr.stats
    assert tsink.blocked == jsink.blocked          # keys AND untils
    key, state = schema.table_to_numpy(te.table)
    np.testing.assert_array_equal(key, np.asarray(je.table.key))
    np.testing.assert_array_equal(state.view(np.uint32),
                                  np.asarray(je.table.state).view(np.uint32))
    assert tr.table == jr.table


@pytest.mark.parametrize("mega_n,n_batches,params", [
    (4, 32, False),          # tests/test_engine.py::test_mega_dispatch_...
    ("auto", 28, False),     # 3 full 8-groups + 4: two rungs fire
    ("auto", 23, True),      # 16 + 4 + 2 + 1: the whole ladder and a single
])
def test_engine_mega_matches_reference_engine(mega_n, n_batches, params):
    """The port's grouping engine against the reference's on one stream:
    stats, blacklist with untils, final table, and the SAME dispatch
    shapes (group_hist), summing to the batches served; singles on the
    port give the same result."""
    recs = _flood(n_batches, 256, seed=11)
    (je, jsink), (te, tsink) = _engines(recs, 256, 64, mega_n, params)
    jr, tr = je.run(), te.run()
    _assert_same_result(je, jsink, jr, te, tsink, tr)
    d = tr.dispatch
    assert d["group_hist"] == jr.dispatch["group_hist"]
    assert d["group_sizes"] == jr.dispatch["group_sizes"]
    assert d["mode"] == jr.dispatch["mode"]
    hist = {int(g): n for g, n in d["group_hist"].items()}
    assert sum(g * n for g, n in hist.items()) == tr.batches == n_batches
    assert d["dispatches"] == sum(hist.values()) < n_batches
    if mega_n == "auto":
        assert d["group_sizes"] == [8, 4, 2]
        assert len([g for g in hist if g > 1]) >= 2
    tsingle = CollectSink()
    e1 = Engine(te.cfg, ArraySource(recs.copy()), tsingle, device="cpu",
                params=logreg.load_params(ARTIFACT) if params else None)
    r1 = e1.run()
    assert r1.stats == tr.stats and tsingle.blocked == tsink.blocked
    assert r1.dispatch["group_hist"] == {"1": n_batches}


@pytest.mark.parametrize("mega_n", [4, "auto"])
def test_engine_mega_overflow_matches_reference(mega_n):
    """tests/test_engine.py::test_megastep_parity_with_overflow: at
    ``verdict_k=2`` merged wires overflow and the sink falls back to the
    group's own stacked block arrays; blacklist and stats equal the
    reference's and the no-wire (``verdict_k=0``) run's."""
    recs = _flood(16, 512, seed=17)
    (je, jsink), (te, tsink) = _engines(recs, 512, 2, mega_n)
    jr, tr = je.run(), te.run()
    _assert_same_result(je, jsink, jr, te, tsink, tr)
    assert len(tsink.blocked) > 2
    assert tr.readback["fallback_sinks"] > 0
    assert tr.readback["fallback_sinks"] == jr.readback["fallback_sinks"]
    assert tr.readback["compact_sinks"] == jr.readback["compact_sinks"]
    full_sink = CollectSink()
    full = Engine(_cfgs(1 << 12, 512, 0, pps=200.0, readback_depth=4)[1],
                  ArraySource(recs.copy()), full_sink, device="cpu",
                  mega_n=mega_n)
    rf = full.run()
    assert full_sink.blocked == tsink.blocked and rf.stats == tr.stats
    assert rf.readback["mode"] == "full"


@pytest.mark.parametrize("kwargs,match", [
    (dict(mega_n=1, mega_auto=True), "cap"),
    (dict(mega_n="four"), "auto"),
    (dict(mega_n=-1), ">= 0"),
])
def test_engine_mega_constructor_errors(kwargs, match):
    _, tcfg = _cfgs(1 << 12, 128, 64)
    with pytest.raises(ValueError, match=match):
        Engine(tcfg, TrafficSource(TrafficSpec(), total=128), NullSink(),
               device="cpu", **kwargs)


def test_warm_ladder_changes_nothing():
    """``warm()`` runs one all-masked batch through the single step and
    every rung: table and stats stay empty, counters start at zero."""
    _, tcfg = _cfgs(1 << 12, 256, 64)
    e = Engine(tcfg, TrafficSource(TrafficSpec(), total=256), CollectSink(),
               device="cpu", mega_n="auto")
    e.warm()
    assert e.stats.to_dict() == schema.make_stats().to_dict()
    assert not e.table.key.any() and not e.table.state.any()
    r = e.run()
    assert r.stats["allowed"] + r.stats["dropped"] == 256
    assert r.dispatch["group_hist"] == {"1": 1}


def test_cli_serve_mega_auto_cpu(capsys):
    rc = cli.main(["serve", "--device", "cpu", "--table-capacity", "4096",
                   "--batches", "3", "--mega", "auto", "--json"])
    assert rc == 0
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    d = rep["dispatch"]
    assert d["mode"] == "adaptive" and d["mega_n"] == 8
    assert sum(int(g) * n for g, n in d["group_hist"].items()) \
        == rep["batches"] >= 3
    assert rep["stats"]["allowed"] + rep["stats"]["dropped"] == rep["records"]


def test_cli_serve_rejects_non_integer_mega(capsys):
    with pytest.raises(SystemExit) as exc:
        cli.main(["serve", "--device", "cpu", "--mega", "four"])
    assert exc.value.code == 2
    assert "--mega takes an integer or 'auto'" in capsys.readouterr().err
