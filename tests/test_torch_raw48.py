"""The raw48 wire of the port against the JAX reference, byte for byte.

``decode_raw`` at every field (u32 words of 2^31 and more, the
timestamp's fused rounding), the raw step against the reference's jitted
``make_jitted_raw_step`` over multi-batch generator streams for the
``mlp``, ``multiclass`` and int8-logreg families, the byte sum that
passes 2^24 (where only the reference's lane order gives its bits), the
raw48 batcher, the raw48 engine against the reference engine, and the
command line's ``--config`` and ``--records``.  All inputs are made from
a seed with numpy; capacity 2^12, B = 256.
"""

import json
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
from flowsentryx_tpu.engine import TrafficSource as JTrafficSource
from flowsentryx_tpu.engine.batcher import MicroBatcher as JMicroBatcher
from flowsentryx_tpu.engine.traffic import Scenario as JScenario
from flowsentryx_tpu.engine.traffic import TrafficGen as JTrafficGen
from flowsentryx_tpu.engine.traffic import TrafficSpec as JTrafficSpec
from flowsentryx_tpu.models import get_model as jget_model
from flowsentryx_tpu.models import logreg as jlogreg
from flowsentryx_tpu.models import mlp as jmlp
from flowsentryx_tpu.models import multiclass as jmulticlass
from flowsentryx_tpu.ops import fused as jfused
from flowsentryx_tpu_torch import cli
from flowsentryx_tpu_torch.core import config, schema
from flowsentryx_tpu_torch.core.device import fma32, u32
from flowsentryx_tpu_torch.engine import (
    ArraySource, CollectSink, Engine, Scenario, TrafficSource, TrafficSpec,
)
from flowsentryx_tpu_torch.engine.batcher import MicroBatcher
from flowsentryx_tpu_torch.models import logreg, mlp, multiclass
from flowsentryx_tpu_torch.models.registry import get_model
from flowsentryx_tpu_torch.ops import agg, fused

REPO = Path(__file__).resolve().parents[1]
ART = REPO / "artifacts"
B, CAP = 256, 1 << 12


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype in (np.float32, np.int32) else a


def family_params(family: str):
    """``(model name, reference params, port params)``: the shipped
    artifact of each family, loaded by each package."""
    if family == "mlp":
        jp = jmlp.load_params(str(ART / "mlp_robust.npz"))
        return "mlp", jp, mlp.load_params(str(ART / "mlp_robust.npz"))
    if family == "multiclass":
        path = str(ART / "multiclass.npz")
        return ("multiclass", jmulticlass.load_params(path),
                multiclass.load_params(path))
    path = str(ART / "logreg_int8.npz")
    return "logreg_int8", jlogreg.load_params(path), logreg.load_params(path)


def cfgs(model="mlp", table=None, batch=None, limiter=None):
    t = dict(dict(capacity=CAP, salt=0x5EED), **(table or {}))
    bt = dict(dict(max_batch=B), **(batch or {}))
    lim = dict(limiter or {})
    return (jconfig.FsxConfig(limiter=jconfig.LimiterConfig(**lim),
                              model=jconfig.ModelConfig(name=model),
                              table=jconfig.TableConfig(**t),
                              batch=jconfig.BatchConfig(**bt)),
            config.FsxConfig(limiter=config.LimiterConfig(**lim),
                             model=config.ModelConfig(name=model),
                             table=config.TableConfig(**t),
                             batch=config.BatchConfig(**bt)))


class RawPair:
    """The reference's jitted raw step and the port's, in lockstep over
    ``[B+1, 12]`` wire buffers, compared after each batch: verdicts,
    scores, block arrays, clock, verdict wire, the whole table (every f32
    column by its bits) and the stats."""

    def __init__(self, cfg_pair, jp, tp):
        jcfg, tcfg = cfg_pair
        self.jstep = jfused.make_jitted_raw_step(
            jcfg, jget_model(jcfg.model.name).classify_batch, emit_score=True)
        self.tstep = fused.make_raw_step(
            tcfg, get_model(tcfg.model.name).classify_batch, emit_score=True)
        self.jp, self.tp = jp, tp
        self.jt = jschema.make_table(jcfg.table.capacity)
        self.js = jschema.make_stats()
        self.tt = schema.make_table(tcfg.table.capacity)
        self.ts = schema.make_stats()

    def step(self, raw: np.ndarray):
        self.jt, self.js, jo = self.jstep(self.jt, self.js, self.jp,
                                          jnp.asarray(raw))
        self.tt, self.ts, to = self.tstep(self.tt, self.ts, self.tp,
                                          schema.wire_to_tensor(raw))
        for f in ("verdict", "score", "block_until", "now", "wire"):
            np.testing.assert_array_equal(
                _bits(getattr(to, f).numpy()), _bits(getattr(jo, f)), f)
        np.testing.assert_array_equal(to.block_key.numpy().view(np.uint32),
                                      np.asarray(jo.block_key))
        key, state = schema.table_to_numpy(self.tt)
        np.testing.assert_array_equal(key, np.asarray(self.jt.key))
        diff = state.view(np.uint32) != _bits(self.jt.state)
        assert not diff.any(), (
            f"state columns differ: {np.nonzero(diff.any(axis=0))[0]}")
        ref = schema.stats_to_numpy(self.ts)
        for f in jschema.GlobalStats._fields:
            np.testing.assert_array_equal(ref[f], np.asarray(getattr(self.js,
                                                                     f)), f)
        return jo, to


def raw_stream(scenario, n, b=B, seed=3, **spec):
    """``n`` raw48 wire buffers of a generator scenario, ragged fills
    included."""
    gen = JTrafficGen(JTrafficSpec(scenario=JScenario(scenario), seed=seed,
                                   **{"n_attack_ips": 64, "n_benign_ips": 512,
                                      "rate_pps": 4e4, **spec}))
    out, t0 = [], None
    for i in range(n):
        rec = gen.next_records(b - (i % 4) * 61)
        t0 = int(rec["ts_ns"][0]) if t0 is None else t0
        out.append(jschema.encode_raw(rec, b, t0))
    return out


# -- decode_raw ----------------------------------------------------------------


def _random_wire(rng, b, t0):
    raw = rng.integers(0, 1 << 32, (b + 1, 12), dtype=np.uint64).astype(
        np.uint32)
    # high words near the epoch's: the realistic small dhi, both signs
    raw[: b // 2, 1] = (t0 >> 32) + rng.integers(-3, 4, b // 2)
    raw[b, :3] = (b - 5, t0 & 0xFFFFFFFF, t0 >> 32)
    return raw


@pytest.mark.parametrize("seed", [0, 1])
def test_decode_raw_every_field_matches_jitted(seed):
    """Every field, on random words: half the feature, key and pkt_len
    words are 2^31 or more (the u32 -> f32 trigger: read as int32 they
    would turn negative), and the timestamps cover both the near-epoch
    high words and the wrapped differences."""
    rng = np.random.default_rng(seed)
    raw = _random_wire(rng, 1 << 14, int(rng.integers(0, 1 << 40)))
    assert (raw[:, 4:12] >= 1 << 31).mean() > 0.4
    want = jax.jit(jschema.decode_raw)(raw)
    got = schema.decode_raw(schema.wire_to_tensor(raw))
    np.testing.assert_array_equal(got.key.numpy().astype(np.uint32),
                                  np.asarray(want.key))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    for f in ("feat", "pkt_len", "ts"):
        np.testing.assert_array_equal(_bits(getattr(got, f).numpy()),
                                      _bits(getattr(want, f)), f)
    assert (got.feat.numpy() >= 2.0 ** 31).any()


def test_decode_raw_timestamp_rounding_is_the_fused_one():
    """The timestamp rounding decided against the jitted decode: only
    ``fma(dhi, 2^32 ns, fma(lo, 1e-9, -f32(t0_lo * 1e-9)))`` gives its
    bits; the unfused forms differ on thousands of the same inputs."""
    rng = np.random.default_rng(2)
    t0 = int(rng.integers(0, 1 << 40))
    raw = _random_wire(rng, 1 << 15, t0)
    want = _bits(jax.jit(jschema.decode_raw)(raw).ts)
    w = u32(schema.wire_to_tensor(raw)[:-1])
    lo = w[:, 0].float()
    t0_lo = torch.full_like(lo, float(np.float32(t0 & 0xFFFFFFFF)))
    dhi = (w[:, 1] - (t0 >> 32)) & 0xFFFFFFFF
    dhi = torch.where(dhi >= 1 << 31, dhi - (1 << 32), dhi).float()
    ns, hi = schema._NS, schema._TS_HI_NS
    unfused = dhi * hi + (lo * ns - t0_lo * ns)
    fused_inner = fma32(dhi, hi, lo * ns - t0_lo * ns)
    assert (_bits(unfused.numpy()) != want).sum() > 1000
    assert (_bits(fused_inner.numpy()) != want).sum() > 1000
    np.testing.assert_array_equal(
        _bits(schema.decode_raw(schema.wire_to_tensor(raw)).ts.numpy()), want)


def test_encode_raw_matches_reference():
    rec = JTrafficGen(JTrafficSpec(seed=4)).next_records(300)
    for n in (0, 17, 300):
        np.testing.assert_array_equal(
            schema.encode_raw(rec[:n], 256, 123456789012),
            jschema.encode_raw(rec[:n], 256, 123456789012))


def test_raw48_batcher_matches_reference_batcher():
    """The raw48 seal: records verbatim, metadata row with the epoch;
    buffers equal to the reference batcher's after every seal."""
    rec = JTrafficGen(JTrafficSpec(seed=6)).next_records(5 * B + 37)
    jb = JMicroBatcher(jconfig.BatchConfig(max_batch=B), t0_ns=99,
                       n_buffers=4, wire="raw48")
    tb = MicroBatcher(config.BatchConfig(max_batch=B), t0_ns=99, n_buffers=4,
                      wire=schema.WIRE_RAW48)
    for lo in range(0, len(rec), 173):
        for a, b in zip(jb.add(rec[lo:lo + 173]), tb.add(rec[lo:lo + 173])):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(jb.take(), tb.take())
    assert tb.batches_emitted == jb.batches_emitted == 6


# -- the raw step ---------------------------------------------------------------


@pytest.mark.parametrize("family", ["mlp", "multiclass", "logreg_int8"])
@pytest.mark.parametrize("scenario", ["mixed_l34_1m", "udp_flood_multi",
                                      "syn_benign_mix"])
def test_raw_step_streams(family, scenario):
    """Ten raw48 batches of a generator scenario through the reference's
    jitted raw step and the port's: every output, the table and the
    stats byte-equal after each batch."""
    name, jp, tp = family_params(family)
    p = RawPair(cfgs(name, limiter=dict(pps_threshold=300.0),
                     batch=dict(verdict_k=8),
                     table=dict(stale_s=30.0)), jp, tp)
    for raw in raw_stream(scenario, 10):
        p.step(raw)
    assert p.ts.to_dict()["batches"] == 10


@pytest.mark.parametrize("family", ["mlp", "multiclass"])
def test_raw_step_at_the_serving_batch(family):
    """XLA's summation order may depend on the shape: the jitted step at
    B = 2048, the serving batch, against the port's (scores included)."""
    name, jp, tp = family_params(family)
    p = RawPair(cfgs(name, batch=dict(max_batch=2048),
                     limiter=dict(pps_threshold=300.0)), jp, tp)
    for raw in raw_stream("mixed_l34_1m", 3, b=2048):
        p.step(raw)


def test_raw_step_heavy_tailed_and_high_bit_features():
    """Features straight from u32 words: zeros, heavy-tailed values and
    words of 2^31 and more, through the MLP and multiclass steps."""
    rng = np.random.default_rng(11)
    for family in ("mlp", "multiclass"):
        name, jp, tp = family_params(family)
        p = RawPair(cfgs(name), jp, tp)
        t0 = 10 ** 12
        for i in range(4):
            rec = np.zeros(B, schema.FLOW_RECORD_DTYPE)
            rec["ts_ns"] = t0 + i * 10 ** 6 + np.arange(B) * 1000
            rec["saddr"] = rng.integers(1, 200, B)
            rec["pkt_len"] = rng.integers(40, 1 << 16, B)
            f = np.exp(rng.uniform(0, 22, (B, 8))).astype(np.uint64)
            f[rng.random((B, 8)) < 0.2] = 0
            f[rng.random((B, 8)) < 0.1] |= 1 << 31
            rec["feat"] = np.minimum(f, (1 << 32) - 1).astype(np.uint32)
            p.step(jschema.encode_raw(rec, B, t0))


# -- the ordered byte sum --------------------------------------------------------


def _heavy_flow_batch(b=2048, n_heavy=300):
    """One source sends ``n_heavy`` records of 65,535 B in one batch, the
    others ragged segments of random lengths."""
    rng = np.random.default_rng(21)
    rec = np.zeros(b, schema.FLOW_RECORD_DTYPE)
    rec["ts_ns"] = 5 * 10 ** 9 + np.arange(b) * 100
    keys = rng.integers(2, 60, b)
    keys[rng.choice(b, n_heavy, replace=False)] = 1
    rec["saddr"] = keys
    rec["pkt_len"] = np.where(keys == 1, 65535, rng.integers(40, 65536, b))
    rec["feat"] = rng.integers(0, 1000, (b, 8))
    return rec


def test_segment_sum_seq_plain_adds_in_lane_order():
    """The reference's ``segment_sum`` (an XLA:CPU scatter-add) adds the
    sorted lanes one after another; the plain version gives its bits on
    segments whose f32 sum depends on the order (ragged lengths, one of
    300 x 65,535), where the exact sum and the reversed order differ."""
    rng = np.random.default_rng(5)
    lens = np.concatenate([[300], rng.integers(1, 40, 200)])
    seg = np.repeat(np.arange(len(lens)), lens).astype(np.int32)
    v = np.where(seg == 0, 65535.0, rng.integers(40, 65536, seg.size)
                 ).astype(np.float32)
    v[rng.random(seg.size) < 0.3] = rng.uniform(0, 1e6, 1).astype(np.float32)
    n = seg.size
    want = np.asarray(jax.jit(lambda v, s: jax.ops.segment_sum(
        v, s, num_segments=n))(v, seg))
    got = agg.segment_sum_seq_plain(torch.from_numpy(v),
                                    torch.from_numpy(seg.astype(np.int64)), n)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    exact = np.zeros(n, np.float64)
    np.add.at(exact, seg, v.astype(np.float64))
    assert (exact.astype(np.float32) != want).any()
    rev = agg.segment_sum_seq_plain(torch.from_numpy(v[::-1].copy()),
                                    torch.from_numpy(
                                        (seg.max() - seg[::-1]).astype(
                                            np.int64)), n)
    assert (rev.numpy()[:len(lens)][::-1] != want[:len(lens)]).any()


def test_byte_sum_past_2_24_matches_reference():
    """A 2048-record batch where one flow's bytes pass 2^24: the raw step
    stores the reference's WIN_BPS bits; a sum in another order (here
    the exact sum) would not."""
    rec = _heavy_flow_batch()
    name, jp, tp = family_params("logreg_int8")
    p = RawPair(cfgs(name, batch=dict(max_batch=2048),
                     limiter=dict(pps_threshold=1e6, bps_threshold=1e12)),
                jp, tp)
    p.step(jschema.encode_raw(rec, 2048, int(rec["ts_ns"][0])))
    exact = float(rec["pkt_len"][rec["saddr"] == 1].astype(np.int64).sum())
    assert exact > 2 ** 24
    key, state = schema.table_to_numpy(p.tt)
    row = np.nonzero(key == 1)[0][0]
    stored = state[row, schema.TableCol.WIN_BPS]
    assert stored != np.float32(exact)      # the order is visible
    assert np.float32(stored) == np.asarray(p.jt.state)[row, 3]


# -- the raw48 engine ------------------------------------------------------------


@pytest.mark.parametrize("family,scenario", [
    ("mlp", "mixed_l34_1m"), ("mlp", "udp_flood_multi"),
    ("multiclass", "syn_benign_mix"),
])
def test_raw48_engine_matches_reference_engine(family, scenario):
    """The default wire rule picks raw48 for an observer-less model in
    both engines; stats, blacklist with untils and the table report are
    equal over a ragged generator stream."""
    name, jp, tp = family_params(family)
    jcfg, tcfg = cfgs(name, limiter=dict(pps_threshold=300.0))
    total = 12 * B + 77
    spec = dict(rate_pps=1e5, seed=7)
    jsink, tsink = JCollectSink(), CollectSink()
    je = JEngine(jcfg, JTrafficSource(JTrafficSpec(
        scenario=JScenario(scenario), **spec), total=total), jsink,
        params=jp, sink_thread=False)
    te = Engine(tcfg, TrafficSource(TrafficSpec(
        scenario=Scenario(scenario), **spec), total=total), tsink,
        params=tp, device="cpu")
    assert je.wire == te.wire == schema.WIRE_RAW48
    jr, tr = je.run(), te.run()
    assert tr.batches == jr.batches == 13
    assert tr.stats == jr.stats
    assert tsink.blocked == jsink.blocked
    assert tr.table == jr.table
    assert tr.dispatch["wire"] == "raw48"


def test_raw48_engine_refuses_mega():
    _, tp = family_params("mlp")[1:]
    _, tcfg = cfgs("mlp")
    with pytest.raises(ValueError, match="mega_n requires the compact16"):
        Engine(tcfg, TrafficSource(TrafficSpec(), total=B), CollectSink(),
               params=tp, device="cpu", mega_n="auto")


# -- the command line -----------------------------------------------------------


def _serve(capsys, *argv):
    rc = cli.main(["serve", "--device", "cpu", "--table-capacity", "4096",
                   "--json", *argv])
    out = capsys.readouterr()
    return rc, out.out.strip().splitlines(), out.err


def test_cli_serves_mlp_over_raw48_with_eviction_from_a_config(
        tmp_path, capsys):
    """``--config`` (the reference's JSON) turns the sweep on, the MLP
    artifact picks raw48, and the report carries ``evicted``; the same
    with ``--mega auto`` is refused before boot."""
    conf = tmp_path / "fsx.json"
    conf.write_text('{"table": {"evict_ttl_s": 0.002, "evict_every": 8},'
                    ' "batch": {"max_batch": 256}}')
    args = ("--model", "mlp", "--artifact", str(ART / "mlp_robust.npz"),
            "--config", str(conf), "--scenario", "mixed_l34_1m")
    rc, out, _ = _serve(capsys, *args, "--batches", "12")
    assert rc == 0
    rep = json.loads(out[-1])
    assert rep["dispatch"]["wire"] == "raw48" and rep["batches"] == 12
    assert rep["stats"]["evicted"] > 0
    rc, out, err = _serve(capsys, *args, "--mega", "auto")
    assert rc == 1 and not out
    assert "--mega requires the compact16 wire" in err


def test_cli_replays_a_record_file(tmp_path, capsys):
    """``--records`` replays a raw file of 48-byte records: the report
    equals an engine over the same records."""
    rec = JTrafficGen(JTrafficSpec(seed=12)).next_records(3 * B + 40)
    path = tmp_path / "flows.bin"
    path.write_bytes(rec.tobytes())
    conf = tmp_path / "fsx.json"
    conf.write_text('{"batch": {"max_batch": 256}, "table": {"salt": 7}}')
    rc, out, _ = _serve(capsys, "--records", str(path), "--config",
                        str(conf), "--model", "logreg_float")
    assert rc == 0
    rep = json.loads(out[-1])
    tcfg = config.FsxConfig(table=config.TableConfig(capacity=4096, salt=7),
                            batch=config.BatchConfig(max_batch=256),
                            model=config.ModelConfig(name="logreg_float"))
    want = Engine(tcfg, ArraySource(rec), CollectSink(), device="cpu").run()
    assert rep["records"] == len(rec) and rep["stats"] == want.stats
