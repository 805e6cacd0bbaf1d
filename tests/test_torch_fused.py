"""The port's fused serving step against the JAX reference, byte for byte.

Multi-batch streams run through the reference's jitted step and the
port's step from the same numpy inputs; after every batch the ``[B]``
verdicts, scores, block arrays, the verdict wire, the table's key column
and every f32 state column (``ML_VOTES`` after a vote decay included),
and the stats are compared bit for bit.
The scenarios are those of ``tests/test_fused.py`` (benign pass, flood
and blacklist with expiry, the ML vote / decay / burst, the per-record
gate, a full table, a spoofed key 0, token bucket and sliding window),
then compact16 model-mode streams from the traffic generator.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from flowsentryx_tpu.core import config as jconfig
from flowsentryx_tpu.core import schema as jschema
from flowsentryx_tpu.engine.traffic import Scenario as JScenario
from flowsentryx_tpu.engine.traffic import TrafficGen as JTrafficGen
from flowsentryx_tpu.engine.traffic import TrafficSpec as JTrafficSpec
from flowsentryx_tpu.models import get_model as jget_model
from flowsentryx_tpu.models import logreg as jlogreg
from flowsentryx_tpu.ops import fused as jfused
from flowsentryx_tpu_torch.core import config, schema
from flowsentryx_tpu_torch.models import logreg
from flowsentryx_tpu_torch.models.registry import get_model
from flowsentryx_tpu_torch.ops import fused

ARTIFACT = str(Path(__file__).resolve().parents[1] / "artifacts"
               / "logreg_int8.npz")
ML_HOT = [0.0, 0.0, 5e6, 0.0, 0.0, 0.0, 5e6, 0.0]
ML_COLD = [80.0, 100.0, 10.0, 100.0, 100.0, 1000.0, 500.0, 2000.0]


def _cfgs(limiter=None, model=None, table=None, batch=None):
    limiter, model = dict(limiter or {}), dict(model or {})
    table = dict(dict(capacity=1 << 12, probes=8, stale_s=1e6), **(table or {}))
    batch = dict(batch or {})
    model.setdefault("name", "logreg_int8")
    jl, tl = dict(limiter), dict(limiter)
    if "kind" in limiter:
        jl["kind"] = jconfig.LimiterKind(limiter["kind"])
        tl["kind"] = config.LimiterKind(limiter["kind"])
    return (jconfig.FsxConfig(limiter=jconfig.LimiterConfig(**jl),
                              model=jconfig.ModelConfig(**model),
                              table=jconfig.TableConfig(**table),
                              batch=jconfig.BatchConfig(**batch)),
            config.FsxConfig(limiter=config.LimiterConfig(**tl),
                             model=config.ModelConfig(**model),
                             table=config.TableConfig(**table),
                             batch=config.BatchConfig(**batch)))


def _params(name):
    jp = (jlogreg.golden_params() if name == "golden"
          else jlogreg.load_params(ARTIFACT))
    return jp, logreg.params_from_numpy(
        {k: np.asarray(v) for k, v in jp._asdict().items()})


def _batch(entries, b=256):
    """entries: (key, n_packets, pkt_len, t, feat) -> numpy batch."""
    key, plen, ts, feat = [], [], [], []
    for k, n, ln, t, f in entries:
        for i in range(n):
            key.append(k)
            plen.append(ln)
            ts.append(t + i * 1e-6)
            feat.append(f)
    n = len(key)
    assert n <= b
    pad = b - n
    return dict(
        key=np.array(key + [0] * pad, np.uint32),
        feat=np.array(feat + [[0.0] * 8] * pad, np.float32),
        pkt_len=np.array(plen + [0] * pad, np.float32),
        ts=np.array(ts + [0] * pad, np.float32),
        valid=np.array([True] * n + [False] * pad))


class Pair:
    """Reference and port stepping in lockstep, compared after each
    batch.  ``wire=True`` feeds compact16 wire buffers, else decoded
    batches."""

    def __init__(self, cfgs, params="golden", wire=False, quant=None):
        jcfg, tcfg = cfgs
        self.jp, self.tp = _params(params)
        jcls = jget_model(jcfg.model.name).classify_batch
        tcls = get_model(tcfg.model.name).classify_batch
        if wire:
            self.jstep = jax.jit(jfused.make_compact_step(
                jcfg, jcls, emit_score=True, **quant))
            self.tstep = fused.make_compact_step(tcfg, tcls,
                                                 emit_score=True, **quant)
        else:
            self.jstep = jax.jit(jfused.make_step(jcfg, jcls,
                                                  emit_score=True))
            self.tstep = fused.make_step(tcfg, tcls, emit_score=True)
        self.jt = jschema.make_table(jcfg.table.capacity)
        self.js = jschema.make_stats()
        self.tt = schema.make_table(tcfg.table.capacity)
        self.ts = schema.make_stats()

    def step(self, batch):
        if isinstance(batch, dict):
            jb = jschema.FeatureBatch(**{k: jnp.asarray(v)
                                         for k, v in batch.items()})
            tb = schema.FeatureBatch(
                key=torch.from_numpy(batch["key"].astype(np.int64)),
                feat=torch.from_numpy(batch["feat"]),
                pkt_len=torch.from_numpy(batch["pkt_len"]),
                ts=torch.from_numpy(batch["ts"]),
                valid=torch.from_numpy(batch["valid"]))
        else:
            jb, tb = jnp.asarray(batch), schema.wire_to_tensor(batch)
        self.jt, self.js, jo = self.jstep(self.jt, self.js, self.jp, jb)
        self.tt, self.ts, to = self.tstep(self.tt, self.ts, self.tp, tb)
        self.check(jo, to)
        return jo, to

    def check(self, jo, to):
        np.testing.assert_array_equal(to.verdict.numpy(),
                                      np.asarray(jo.verdict))
        np.testing.assert_array_equal(to.score.numpy(), np.asarray(jo.score))
        np.testing.assert_array_equal(to.block_key.numpy().view(np.uint32),
                                      np.asarray(jo.block_key))
        np.testing.assert_array_equal(to.block_until.numpy().view(np.uint32),
                                      np.asarray(jo.block_until)
                                      .view(np.uint32))
        assert to.now.numpy().view(np.uint32) == \
            np.asarray(jo.now).view(np.uint32)
        if jo.wire is not None:
            np.testing.assert_array_equal(to.wire.numpy().view(np.uint32),
                                          np.asarray(jo.wire))
        key, state = schema.table_to_numpy(self.tt)
        np.testing.assert_array_equal(key, np.asarray(self.jt.key))
        diff = state.view(np.uint32) != np.asarray(self.jt.state).view(
            np.uint32)
        assert not diff.any(), (
            f"state columns differ: {np.nonzero(diff.any(axis=0))[0]}")
        ref = schema.stats_to_numpy(self.ts)
        for f in jschema.GlobalStats._fields:
            np.testing.assert_array_equal(ref[f], np.asarray(getattr(self.js, f)))


def test_benign_passes():
    p = Pair(_cfgs(limiter=dict(pps_threshold=100.0, bps_threshold=1e9)))
    _, to = p.step(_batch([(1001, 5, 100, 0.1, ML_COLD),
                           (1002, 3, 200, 0.1, ML_COLD)]))
    assert (to.verdict.numpy()[:8] == 0).all()


def test_flood_rate_limited_blacklisted_then_expires():
    p = Pair(_cfgs(limiter=dict(pps_threshold=100.0, bps_threshold=1e9,
                                block_s=10.0)))
    _, o1 = p.step(_batch([(2001, 150, 100, 0.1, ML_COLD)]))
    assert (o1.verdict.numpy()[:150] == 2).all()
    _, o2 = p.step(_batch([(2001, 5, 100, 1.2, ML_COLD)]))
    assert (o2.verdict.numpy()[:5] == 1).all()
    _, o3 = p.step(_batch([(2001, 5, 100, 20.0, ML_COLD)]))
    assert (o3.verdict.numpy()[:5] == 0).all()


def test_ml_vote_then_blacklist_and_young_record_gate():
    p = Pair(_cfgs(limiter=dict(pps_threshold=100.0, bps_threshold=1e9)))
    _, o1 = p.step(_batch([(3001, 4, 100, 0.1, ML_HOT),
                           (3002, 4, 100, 0.1, ML_COLD),
                           (3101, 3, 100, 0.1, ML_HOT)]))
    assert (o1.verdict.numpy()[:4] == 3).all()     # per-record gate
    _, o2 = p.step(_batch([(3001, 2, 100, 0.3, ML_HOT)]))
    assert 3001 in o2.block_key.numpy().view(np.uint32)
    _, o3 = p.step(_batch([(3001, 2, 100, 0.5, ML_COLD),
                           (3101, 4, 100, 0.5, ML_COLD)]))
    assert (o3.verdict.numpy()[:2] == 1).all()
    assert (o3.verdict.numpy()[2:6] == 0).all()


def test_ml_dense_burst_blocks_first_batch():
    p = Pair(_cfgs(limiter=dict(pps_threshold=1e6, bps_threshold=1e12)))
    _, o = p.step(_batch([(4001, 12, 100, 0.1, ML_HOT)]))
    assert 4001 in o.block_key.numpy().view(np.uint32)


@pytest.mark.parametrize("gap_s", [0.7, 5.3, 37.0, 300.0])
def test_ml_vote_decay(gap_s):
    """Votes accrue on a mature flow, then decay over an idle gap (the
    exp2 column, ROADMAP queue 3)."""
    p = Pair(_cfgs(limiter=dict(pps_threshold=1e6, bps_threshold=1e12),
                   model=dict(vote_m=50, vote_decay_s=60.0)))
    t = 0.1
    p.step(_batch([(5001, 5, 100, t, ML_COLD)]))
    for i in range(6):                 # 3 hot records per batch: votes
        t += 0.01 * (i + 1)
        p.step(_batch([(5001, 3, 100, t, ML_HOT)]))
    p.step(_batch([(5001, 1, 100, t + gap_s, ML_HOT)]))
    p.step(_batch([(5001, 2, 100, t + 2 * gap_s + 0.123, ML_HOT)]))


def test_full_table_arbitration_and_untracked_flows():
    """More distinct sources than slots: probe exhaustion, arbitration
    losers and untracked flows (burst rule only)."""
    p = Pair(_cfgs(limiter=dict(pps_threshold=20.0, bps_threshold=1e9),
                   table=dict(capacity=64, probes=2)))
    rng = np.random.default_rng(8)
    for step in range(6):
        entries = [(int(k), int(rng.integers(1, 6)), 64, 0.1 + step * 0.3,
                    ML_HOT if k % 3 == 0 else ML_COLD)
                   for k in rng.choice(np.arange(1, 400), 60, replace=False)]
        entries.append((9999, 30, 64, 0.1 + step * 0.3, ML_COLD))
        p.step(_batch(entries, b=512))
    key, _ = schema.table_to_numpy(p.tt)
    assert (key != 0).sum() == 64


def test_spoofed_key_zero_and_invalid_key():
    p = Pair(_cfgs(limiter=dict(pps_threshold=50.0, bps_threshold=1e9)))
    _, o = p.step(_batch([(0, 80, 100, 0.1, ML_COLD),
                          (0xFFFFFFFF, 3, 100, 0.1, ML_COLD),
                          (77, 2, 100, 0.1, ML_COLD)]))
    assert 0xFFFFFFFE in o.block_key.numpy().view(np.uint32)
    p.step(_batch([(0, 3, 100, 0.5, ML_COLD)]))


@pytest.mark.parametrize("kind", ["token_bucket", "sliding_window"])
def test_other_limiters_over_a_stream(kind):
    p = Pair(_cfgs(limiter=dict(kind=kind, pps_threshold=100.0,
                                bps_threshold=1e6, bucket_rate_pps=50.0,
                                bucket_burst=80.0, bucket_rate_bps=2e4,
                                bucket_burst_bytes=5e4)))
    rng = np.random.default_rng(12)
    t = 0.05
    for _ in range(12):
        t += float(rng.uniform(0.05, 1.3))
        entries = [(int(k), int(rng.integers(1, 40)), 120, t, ML_COLD)
                   for k in rng.choice(np.arange(1, 30), 6, replace=False)]
        p.step(_batch(entries))


@pytest.mark.parametrize("window_s", [0.3, 3.0])
def test_sliding_window_stream_non_power_of_two_window(window_s):
    """The sliding-window limiter's ``/ window_s`` is a reciprocal
    multiply in the reference's compiled step; windows that are not a
    power of two, over a stream that rolls them."""
    p = Pair(_cfgs(limiter=dict(kind="sliding_window", pps_threshold=60.0,
                                bps_threshold=1e6, window_s=window_s)))
    rng = np.random.default_rng(int(window_s * 10))
    t = 0.05
    for _ in range(12):
        t += float(rng.uniform(0.1, 1.5) * window_s)
        entries = [(int(k), int(rng.integers(1, 40)), 120, t, ML_COLD)
                   for k in rng.choice(np.arange(1, 30), 6, replace=False)]
        p.step(_batch(entries))


@pytest.mark.parametrize("vote_decay_s", [7.5, 0.3])
def test_ml_vote_decay_other_half_lives(vote_decay_s):
    """Half-lives whose reciprocal is inexact in float32, with gaps that
    decay the votes deep into the flush-to-zero range."""
    p = Pair(_cfgs(limiter=dict(pps_threshold=1e6, bps_threshold=1e12),
                   model=dict(vote_m=50, vote_decay_s=vote_decay_s)))
    t = 0.1
    p.step(_batch([(5001, 5, 100, t, ML_COLD)]))
    for gap in (0.01, 0.02, 0.4, 3.3, 30.0, 0.05):
        t += gap * vote_decay_s
        p.step(_batch([(5001, 3, 100, t, ML_HOT)]))


@pytest.mark.parametrize("params", ["golden", "log1p"])
@pytest.mark.parametrize("scenario,verdict_k", [
    ("syn_benign_mix", 64), ("mixed_l34_1m", 64), ("icmp_flood_single", 4),
    ("udp_flood_multi", 8),
])
def test_compact_wire_streams(params, scenario, verdict_k):
    """compact16 model-mode wire through both steps, several batches,
    ragged tails included.  With the log1p artifact the multi-source
    flood blocks more flows in a batch than its K=8 wire slots, so the
    overflow flag is set (and compared, as part of the wire)."""
    jp, _ = _params(params)
    quant = jschema.model_quant_args(jp)
    b = 512
    cfgs = _cfgs(limiter=dict(pps_threshold=300.0),
                 table=dict(capacity=1 << 12, stale_s=30.0, salt=0x5EED),
                 batch=dict(max_batch=b, verdict_k=verdict_k))
    p = Pair(cfgs, params=params, wire=True, quant=quant)
    gen = JTrafficGen(JTrafficSpec(scenario=JScenario(scenario), seed=3,
                                   n_attack_ips=64, n_benign_ips=512,
                                   rate_pps=4e4))
    t0 = None
    overflowed = 0
    for i in range(10):
        rec = gen.next_records(b - (i % 4) * 97)
        t0 = int(rec["ts_ns"][0]) if t0 is None else t0
        raw = jschema.encode_compact(rec, b, t0, **quant)
        jo, _ = p.step(raw)
        overflowed += int(np.asarray(jo.wire)[2 * verdict_k + 1])
    if scenario == "icmp_flood_single" and params == "log1p":
        assert p.ts.to_dict()["dropped"] > 0
    if (scenario, params) == ("udp_flood_multi", "log1p"):
        assert overflowed > 0


def test_masked_batch_changes_nothing():
    """The warm-up contract: an all-masked wire leaves table and stats
    untouched on both sides."""
    jp, _ = _params("golden")
    quant = jschema.model_quant_args(jp)
    p = Pair(_cfgs(batch=dict(max_batch=256)), wire=True, quant=quant)
    p.step(np.zeros((257, 4), np.uint32))
    assert p.ts.to_dict() == schema.make_stats().to_dict()
    assert not schema.table_to_numpy(p.tt)[0].any()

