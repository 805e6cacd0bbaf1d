"""The port's IP-hash-sharded step (``flowsentryx_tpu_torch/parallel/``)
against the JAX reference's on 8 virtual CPU devices, byte for byte.

The reference runs ``shard_map`` over the 8 virtual devices of
``tests/conftest.py``; the port runs 8 shards of one CPU device as row
ranges of one table (``make_mesh(8, devices=["cpu"] * 8)``).  After every
batch: verdicts, scores, block arrays, clock, ``route_drop``, verdict
wire, the whole table (every f32 column by its bits) and the stats.  The
cases restate ``tests/test_parallel.py`` (single-device equality, state
across batches, distinct shards, one key one shard, cross-slice flows,
the adversarial owner skew and the salt, uniform traffic, the sharded
megastep and ring with its guards, the mesh refusals), the meshed
engine of ``tests/test_engine.py`` and the mesh eviction and checkpoint
reshards of ``tests/test_table.py``, plus the port's own: a scatter
loser in shard 0 must not write shard 1's first row, raw48 byte sums
past 2^24 across slices, the ``mesh.ip_axis`` config, ``serve --mesh``
and ``bench --scaling``.  Capacity 2^12, B = 256 (1,024 where the
reference's case needs 128 records per slice).
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from flowsentryx_tpu import benchmarks as jbenchmarks
from flowsentryx_tpu import cli as jcli
from flowsentryx_tpu.core import config as jconfig
from flowsentryx_tpu.core import schema as jschema
from flowsentryx_tpu.engine import ArraySource as JArraySource
from flowsentryx_tpu.engine import CollectSink as JCollectSink
from flowsentryx_tpu.engine import Engine as JEngine
from flowsentryx_tpu.engine.traffic import Scenario as JScenario
from flowsentryx_tpu.engine.traffic import TrafficGen as JTrafficGen
from flowsentryx_tpu.engine.traffic import TrafficSpec as JTrafficSpec
from flowsentryx_tpu.fused import device_loop as jdl
from flowsentryx_tpu.models import get_model as jget_model
from flowsentryx_tpu.parallel import layout as jlayout
from flowsentryx_tpu.parallel import make_mesh as jmake_mesh
from flowsentryx_tpu.parallel import step as jpstep
from flowsentryx_tpu_torch import benchmarks, cli
from flowsentryx_tpu_torch.core import config, schema
from flowsentryx_tpu_torch.engine import ArraySource, CollectSink, Engine
from flowsentryx_tpu_torch.engine import table as tbl
from flowsentryx_tpu_torch.fused import device_loop as dl
from flowsentryx_tpu_torch.models.registry import get_model
from flowsentryx_tpu_torch.ops import fused
from flowsentryx_tpu_torch.parallel import layout, make_mesh
from flowsentryx_tpu_torch.parallel import mesh as pmesh
from flowsentryx_tpu_torch.parallel import step as pstep
from tests.test_torch_fused import ML_COLD, ML_HOT, _batch, _cfgs, _params
from tests.test_torch_raw48 import family_params, raw_stream

REPO = Path(__file__).resolve().parents[1]
N = 8
LIM = dict(pps_threshold=100.0, bps_threshold=1e9)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The plain CPU steps run ~10x faster on 2 threads than on one per
    core (thread hand-offs dominate at these sizes)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def meshes(n=N):
    return jmake_mesh(n), make_mesh(n, devices=["cpu"] * n)


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype in (np.float32, np.int32) else a


def port_batch(batch: dict) -> schema.FeatureBatch:
    return schema.FeatureBatch(
        key=torch.from_numpy(batch["key"].astype(np.int64)),
        feat=torch.from_numpy(batch["feat"]),
        pkt_len=torch.from_numpy(batch["pkt_len"]),
        ts=torch.from_numpy(batch["ts"]),
        valid=torch.from_numpy(batch["valid"]))


def ref_batch(batch: dict) -> jschema.FeatureBatch:
    return jschema.FeatureBatch(**{k: jnp.asarray(v)
                                   for k, v in batch.items()})


def assert_same_state(tt, ts, jt, js):
    key, state = schema.table_to_numpy(tt)
    np.testing.assert_array_equal(key, np.asarray(jt.key))
    diff = state.view(np.uint32) != _bits(jt.state)
    assert not diff.any(), (
        f"state columns differ: {np.nonzero(diff.any(axis=0))[0]}")
    ref = schema.stats_to_numpy(ts)
    for f in jschema.GlobalStats._fields:
        np.testing.assert_array_equal(ref[f], np.asarray(getattr(js, f)), f)


def assert_same_out(to, jo, score=True):
    np.testing.assert_array_equal(to.verdict.numpy(), np.asarray(jo.verdict))
    if score:
        np.testing.assert_array_equal(_bits(to.score.numpy()),
                                      _bits(jo.score))
    np.testing.assert_array_equal(to.block_key.numpy().view(np.uint32),
                                  np.asarray(jo.block_key))
    np.testing.assert_array_equal(_bits(to.block_until.numpy()),
                                  _bits(jo.block_until))
    np.testing.assert_array_equal(_bits(to.now.numpy()), _bits(jo.now))
    np.testing.assert_array_equal(np.asarray(to.route_drop),
                                  np.asarray(jo.route_drop))
    if jo.wire is not None:
        np.testing.assert_array_equal(to.wire.numpy().view(np.uint32),
                                      np.asarray(jo.wire))


class ShardedPair:
    """The reference's sharded step and the port's, in lockstep over the
    same inputs: decoded batches (``wire=None``), compact16 or raw48 wire
    buffers; compared after each batch."""

    def __init__(self, cfgs, jp, tp, n=N, wire=None, quant=None,
                 emit_score=True):
        jcfg, tcfg = cfgs
        self.jm, self.tm = meshes(n)
        jcls = jget_model(jcfg.model.name).classify_batch
        tcls = get_model(tcfg.model.name).classify_batch
        self.wire = wire
        if wire == "compact16":
            self.jstep = jpstep.make_sharded_compact_step(
                jcfg, jcls, self.jm, donate=False, emit_score=emit_score,
                **quant)
            self.tstep = pstep.make_sharded_compact_step(
                tcfg, tcls, self.tm, emit_score=emit_score, **quant)
        elif wire == "raw48":
            self.jstep = jpstep.make_sharded_raw_step(
                jcfg, jcls, self.jm, donate=False, emit_score=emit_score)
            self.tstep = pstep.make_sharded_raw_step(
                tcfg, tcls, self.tm, emit_score=emit_score)
        else:
            self.jstep = jpstep.make_sharded_step(
                jcfg, jcls, self.jm, donate=False, emit_score=emit_score)
            self.tstep = pstep.make_sharded_step(tcfg, tcls, self.tm,
                                                 emit_score=emit_score)
        self.emit_score = emit_score
        self.jp, self.tp = jp, tp
        self.jt = jpstep.make_sharded_table(jcfg, self.jm)
        self.js = jschema.make_stats()
        self.tt = pstep.make_sharded_table(tcfg, self.tm)
        self.ts = schema.make_stats()

    def step(self, batch):
        if isinstance(batch, dict):
            jb, tb = ref_batch(batch), port_batch(batch)
        else:
            jb, tb = jnp.asarray(batch), schema.wire_to_tensor(batch)
        self.jt, self.js, jo = self.jstep(self.jt, self.js, self.jp, jb)
        self.tt, self.ts, to = self.tstep(self.tt, self.ts, self.tp, tb)
        assert_same_out(to, jo, score=self.emit_score)
        assert_same_state(self.tt, self.ts, self.jt, self.js)
        return jo, to


def golden_pair(limiter=LIM, n=N, **kw):
    jp, tp = _params("golden")
    return ShardedPair(_cfgs(limiter=limiter, **kw), jp, tp, n=n)


def random_batch(b: int, n_ips: int, seed: int, t0: float = 0.0) -> dict:
    rng = np.random.default_rng(seed)
    return dict(
        key=rng.integers(1, n_ips + 1, b).astype(np.uint32),
        feat=rng.uniform(0, 3000, (b, 8)).astype(np.float32),
        pkt_len=rng.integers(64, 1500, b).astype(np.float32),
        ts=(t0 + np.sort(rng.uniform(0, 0.01, b))).astype(np.float32),
        valid=np.ones(b, bool))


def owned_by_zero(n_keys: int, n=N) -> np.ndarray:
    """Distinct keys whose UNSALTED hash puts every one on owner 0."""
    cand = np.arange(1, 400_000, dtype=np.uint32)
    bits = n.bit_length() - 1
    keys = cand[(tbl.hash_u32_np(cand) >> np.uint32(32 - bits)) == 0]
    return keys[:n_keys]


def skew_batch(b=1024) -> dict:
    return dict(key=owned_by_zero(b), feat=np.zeros((b, 8), np.float32),
                pkt_len=np.full(b, 100.0, np.float32),
                ts=np.linspace(0, 0.001, b, dtype=np.float32),
                valid=np.ones(b, bool))


# -- the sharded step -------------------------------------------------------------


def test_matches_single_device_and_reference():
    """A benign mix, a rate flood and an ML hit: the port's sharded step
    equals the reference's byte for byte, and its verdicts and stats
    equal the port's single-shard step."""
    entries = [(1000 + i, 3, 100, 0.1, ML_COLD) for i in range(30)]
    entries += [(7777, 120, 100, 0.1, ML_COLD), (8888, 4, 100, 0.1, ML_HOT)]
    batch = _batch(entries)
    p = golden_pair()
    _, to = p.step(batch)
    jcfg, tcfg = _cfgs(limiter=LIM)
    single = fused.make_step(tcfg, get_model(tcfg.model.name).classify_batch)
    t1, s1, o1 = single(schema.make_table(tcfg.table.capacity),
                        schema.make_stats(), p.tp, port_batch(batch))
    np.testing.assert_array_equal(to.verdict.numpy(), o1.verdict.numpy())
    assert p.ts.to_dict() == s1.to_dict()
    assert (to.verdict.numpy() == 2).sum() == 120


def test_state_persists_and_blacklist_works_sharded():
    p = golden_pair()
    _, o = p.step(_batch([(4242, 150, 100, 0.1, ML_COLD)]))
    assert (o.verdict.numpy()[:150] == 2).all()
    _, o = p.step(_batch([(4242, 5, 100, 1.0, ML_COLD)]))
    assert (o.verdict.numpy()[:5] == 1).all()


def test_flows_land_on_distinct_shards():
    p = golden_pair()
    p.step(_batch([(10_000 + i, 1, 100, 0.1, ML_COLD) for i in range(128)]))
    keys = p.tt.key.numpy()
    local = p.tt.capacity // N
    counts = [int((keys[i * local:(i + 1) * local] != 0).sum())
              for i in range(N)]
    assert sum(counts) >= 120 and sum(c > 0 for c in counts) >= 4
    p.step(_batch([(10_000 + i, 1, 100, 0.3, ML_COLD) for i in range(128)]))
    assert int((p.tt.key.numpy() != 0).sum()) == 128


def test_same_key_same_shard_across_batches():
    p = golden_pair()
    p.step(_batch([(31337, 10, 100, 0.1, ML_COLD)]))
    occ1 = np.flatnonzero(p.tt.key.numpy() == 31337)
    p.step(_batch([(31337, 10, 100, 0.4, ML_COLD)]))
    np.testing.assert_array_equal(occ1,
                                  np.flatnonzero(p.tt.key.numpy() == 31337))
    assert len(occ1) == 1


@pytest.mark.parametrize("seed", [7, 8])
def test_cross_slice_flows(seed):
    """~5 records per flow at scattered lanes: nearly every flow spans
    several slices (the owner-side merge); three batches in lockstep
    with the reference, and the verdicts and stats of the single-shard
    step."""
    p = golden_pair()
    jcfg, tcfg = _cfgs(limiter=LIM)
    single = fused.make_step(tcfg, get_model(tcfg.model.name).classify_batch)
    t1, s1 = schema.make_table(tcfg.table.capacity), schema.make_stats()
    for i in range(3):
        batch = random_batch(1024, 200, seed * 10 + i, t0=0.3 * i)
        _, to = p.step(batch)
        _, _, o1 = single(t1, s1, p.tp, port_batch(batch))
        np.testing.assert_array_equal(to.verdict.numpy(), o1.verdict.numpy())
        assert int(to.route_drop) == 0
    assert p.ts.to_dict() == s1.to_dict()


def test_adversarial_owner_skew_fails_open():
    """1,024 distinct keys all owned by shard 0 (unsalted): each slice
    overflows its C = 64 bucket, the overflowed flows PASS, skip their
    table update and are counted (8 x 64), equal to the reference."""
    p = golden_pair()
    _, to = p.step(skew_batch())
    assert int(to.route_drop) == 8 * 64
    assert (to.verdict.numpy() == 0).all()
    occupied = np.flatnonzero(p.tt.key.numpy() != 0)
    assert 0 < len(occupied) <= 8 * 64
    assert (occupied < p.tt.capacity // N).all()


def test_salt_defeats_precomputed_owner_skew():
    jp, tp = _params("golden")
    p = ShardedPair(_cfgs(limiter=LIM, table=dict(salt=0xA5F00D01)), jp, tp)
    _, to = p.step(skew_batch())
    assert int(to.route_drop) == 0
    local = p.tt.capacity // N
    assert len({int(r) // local
                for r in np.flatnonzero(p.tt.key.numpy() != 0)}) >= 4


def test_route_drop_zero_under_uniform_traffic():
    p = golden_pair()
    _, to = p.step(random_batch(1024, 100_000, 11))
    assert int(to.route_drop) == 0


@pytest.mark.parametrize("n", [2, 4])
def test_smaller_meshes(n):
    """2 and 4 shards: floods, ML hits and cross-slice flows."""
    p = golden_pair(n=n)
    for i in range(3):
        b = random_batch(256, 40, 30 + i, t0=0.2 * i)
        b["feat"][::7] = ML_HOT
        p.step(b)


# -- the single-device scenarios, sharded -----------------------------------------


def test_flood_blacklisted_then_expires_sharded():
    p = golden_pair(limiter=dict(LIM, block_s=10.0))
    _, o1 = p.step(_batch([(2001, 150, 100, 0.1, ML_COLD)]))
    assert (o1.verdict.numpy()[:150] == 2).all()
    _, o2 = p.step(_batch([(2001, 5, 100, 1.2, ML_COLD)]))
    assert (o2.verdict.numpy()[:5] == 1).all()
    _, o3 = p.step(_batch([(2001, 5, 100, 20.0, ML_COLD)]))
    assert (o3.verdict.numpy()[:5] == 0).all()


def test_ml_vote_gate_and_burst_sharded():
    p = golden_pair()
    _, o1 = p.step(_batch([(3001, 4, 100, 0.1, ML_HOT),
                           (3002, 4, 100, 0.1, ML_COLD),
                           (3101, 3, 100, 0.1, ML_HOT),
                           (4001, 12, 100, 0.1, ML_HOT)]))
    assert (o1.verdict.numpy()[:4] == 3).all()     # the per-record gate
    assert 4001 in o1.block_key.numpy().view(np.uint32)   # a dense burst
    _, o2 = p.step(_batch([(3001, 2, 100, 0.3, ML_HOT)]))
    assert 3001 in o2.block_key.numpy().view(np.uint32)


@pytest.mark.parametrize("gap_s", [0.7, 37.0])
def test_ml_vote_decay_sharded(gap_s):
    jp, tp = _params("golden")
    p = ShardedPair(_cfgs(limiter=dict(pps_threshold=1e6,
                                       bps_threshold=1e12),
                          model=dict(vote_m=50, vote_decay_s=60.0)), jp, tp)
    t = 0.1
    p.step(_batch([(5001, 5, 100, t, ML_COLD)]))
    for i in range(4):
        t += 0.01 * (i + 1)
        p.step(_batch([(5001, 3, 100, t, ML_HOT)]))
    p.step(_batch([(5001, 1, 100, t + gap_s, ML_HOT)]))


def test_full_table_arbitration_sharded():
    """More sources than the 8-row shards hold: probe exhaustion,
    arbitration losers and untracked flows."""
    jp, tp = _params("golden")
    p = ShardedPair(_cfgs(limiter=dict(pps_threshold=20.0,
                                       bps_threshold=1e9),
                          table=dict(capacity=64, probes=2)), jp, tp)
    rng = np.random.default_rng(8)
    for step in range(5):
        entries = [(int(k), int(rng.integers(1, 6)), 64, 0.1 + step * 0.3,
                    ML_HOT if k % 3 == 0 else ML_COLD)
                   for k in rng.choice(np.arange(1, 400), 60, replace=False)]
        entries.append((9999, 30, 64, 0.1 + step * 0.3, ML_COLD))
        p.step(_batch(entries, b=512))


def test_spoofed_key_zero_sharded():
    p = golden_pair(limiter=dict(pps_threshold=50.0, bps_threshold=1e9))
    _, o = p.step(_batch([(0, 80, 100, 0.1, ML_COLD),
                          (0xFFFFFFFF, 3, 100, 0.1, ML_COLD),
                          (77, 2, 100, 0.1, ML_COLD)]))
    assert 0xFFFFFFFE in o.block_key.numpy().view(np.uint32)


# -- the park row -----------------------------------------------------------------


def _probe0(key: int, salt: int, local: int) -> int:
    return int(tbl.hash_u32_np(np.uint32(key), salt)) & (local - 1)


def test_scatter_loser_never_writes_the_next_shard():
    """Shard 1's row 0 holds a flow; then two new flows owned by shard 0
    claim the same empty slot, so one loses arbitration.  The loser
    writes the table's one park row, never row ``capacity / n`` (shard
    1's first row, which a per-shard park index would be): shard 1's row
    is unchanged, and the step equals the reference's."""
    p = golden_pair()
    local = p.tt.capacity // N
    cand = np.arange(1, 2_000_000, dtype=np.uint32)
    owner = tbl.hash_u32_np(cand) >> np.uint32(29)
    first = tbl.hash_u32_np(cand) & np.uint32(local - 1)
    resident = int(cand[(owner == 1) & (first == 0)][0])
    fighters = cand[(owner == 0) & (first == 5)][:2]
    p.step(_batch([(resident, 2, 100, 0.1, ML_COLD)]))
    row = local          # shard 1's first row
    assert int(p.tt.key_rows[row]) == resident
    # every row past shard 0, park row excluded
    keys, states = p.tt.key[local:].clone(), p.tt.state[local:].clone()
    p.step(_batch([(int(fighters[0]), 3, 100, 0.2, ML_COLD),
                   (int(fighters[1]), 3, 100, 0.2, ML_COLD)]))
    assert int(p.tt.key_rows[row]) == resident
    assert torch.equal(p.tt.key[local:], keys)
    assert torch.equal(p.tt.state[local:], states)
    tracked = {int(k) for k in p.tt.key.numpy().view(np.uint32) if k}
    assert len(tracked & {int(f) for f in fighters}) == 1   # one lost


def test_shard_view_writes_and_reads_its_own_rows():
    t = schema.make_table(64)
    sh = t.shard(16, 16)
    assert sh.capacity == 16 and sh.park == 64
    assert sh.key.data_ptr() == t.key_rows[16:].data_ptr()
    np.testing.assert_array_equal(sh.at(torch.arange(3)).numpy(), [16, 17, 18])
    np.testing.assert_array_equal(t.at(torch.arange(3)).numpy(), [0, 1, 2])
    assert t.park == 64


# -- the megastep family and the ring ---------------------------------------------


def _compact_raws(quant, n, b=128, seed=9, n_ips=200):
    rng = np.random.default_rng(seed)
    raws = []
    for i in range(n):
        buf = np.zeros(b, dtype=jschema.FLOW_RECORD_DTYPE)
        buf["saddr"] = rng.integers(1, n_ips, b).astype(np.uint32)
        buf["pkt_len"] = rng.integers(64, 1500, b)
        buf["ts_ns"] = (i * b + np.arange(b)) * 50_000
        buf["feat"] = rng.integers(0, 1 << 22, (b, 8))
        raws.append(jschema.encode_compact(buf, b, t0_ns=0, **quant))
    return raws


def _wire_cfgs(b=128, **kw):
    return _cfgs(limiter=dict(pps_threshold=40.0, bps_threshold=1e9),
                 batch=dict(max_batch=b, **kw))


@pytest.mark.parametrize("g", [2, 4])
def test_sharded_megastep_family_matches_sequential_and_reference(g):
    """Each rung against g sequential sharded steps (port) and against
    the reference's rung: table, stats, stacked verdicts, ``route_drop``
    ``[g]`` and the merged wire."""
    jcfg, tcfg = _wire_cfgs(verdict_k=4)
    jp, tp = _params("artifact")
    quant = jschema.wire_quant_for(jp)
    jm, tm = meshes()
    raws = _compact_raws(quant, g)
    jcls = jget_model(jcfg.model.name).classify_batch
    tcls = get_model(tcfg.model.name).classify_batch
    jmega = jpstep.make_sharded_compact_megastep_family(
        jcfg, jcls, jm, (g,), donate=False, **quant)[g]
    fam = pstep.make_sharded_compact_megastep_family(tcfg, tcls, tm, (g,),
                                                     **quant)
    single = pstep.make_sharded_compact_step(tcfg, tcls, tm, **quant)
    t1, s1 = pstep.make_sharded_table(tcfg, tm), schema.make_stats()
    verdicts, wires = [], []
    for r in raws:
        _, _, o = single(t1, s1, tp, schema.wire_to_tensor(r))
        verdicts.append(o.verdict)
        wires.append(o.wire)
    t2, s2 = pstep.make_sharded_table(tcfg, tm), schema.make_stats()
    stacked = np.stack(raws)
    _, _, out = fam[g](t2, s2, tp, schema.wire_to_tensor(stacked))
    jt, js, jo = jmega(jpstep.make_sharded_table(jcfg, jm),
                       jschema.make_stats(), jp, jnp.asarray(stacked))
    assert torch.equal(t1.key_rows, t2.key_rows)
    assert torch.equal(t1.state_rows, t2.state_rows)
    assert s1.to_dict() == s2.to_dict()
    assert torch.equal(out.verdict, torch.stack(verdicts))
    assert tuple(out.route_drop.shape) == (g,)
    assert torch.equal(out.wire, fused.merge_verdict_wires(
        torch.stack(wires)))
    assert_same_out(out, jo, score=False)
    assert_same_state(t2, s2, jt, js)


def test_sharded_ring_matches_sequential_megasteps_and_reference():
    jcfg, tcfg = _wire_cfgs()
    jp, tp = _params("artifact")
    quant = jschema.wire_quant_for(jp)
    jm, tm = meshes()
    ring, chunks = 2, 2
    jcls = jget_model(jcfg.model.name).classify_batch
    tcls = get_model(tcfg.model.name).classify_batch
    mega = pstep.make_sharded_compact_megastep(tcfg, tcls, tm, chunks,
                                               **quant)
    loop = dl.make_sharded_compact_device_loop(tcfg, tcls, tm, ring, chunks,
                                               **quant)
    jloop = jdl.make_sharded_compact_device_loop(jcfg, jcls, jm, ring,
                                                 chunks, donate=False,
                                                 **quant)
    raws = _compact_raws(quant, ring * chunks, seed=17)
    slots = [np.stack(raws[r * chunks:(r + 1) * chunks]) for r in range(ring)]
    t1, s1 = pstep.make_sharded_table(tcfg, tm), schema.make_stats()
    slot_wires = [mega(t1, s1, tp, schema.wire_to_tensor(s))[2].wire
                  for s in slots]
    t2, s2 = pstep.make_sharded_table(tcfg, tm), schema.make_stats()
    _, _, out = loop(t2, s2, tp, *(schema.wire_to_tensor(s) for s in slots))
    jt, js, jo = jloop(jpstep.make_sharded_table(jcfg, jm),
                       jschema.make_stats(), jp,
                       *(jnp.asarray(s) for s in slots))
    assert torch.equal(t1.key_rows, t2.key_rows)
    assert torch.equal(t1.state_rows, t2.state_rows)
    assert s1.to_dict() == s2.to_dict()
    assert tuple(out.wire.shape) == (ring, 2 * tcfg.batch.verdict_k + 4)
    assert torch.equal(out.wire, torch.stack(slot_wires))
    np.testing.assert_array_equal(out.wire.numpy().view(np.uint32),
                                  np.asarray(jo.wire))
    assert tuple(out.block_key.shape[:2]) == (ring, chunks)
    assert_same_state(t2, s2, jt, js)


def test_sharded_ring_guards_slot_shape():
    _, tcfg = _wire_cfgs()
    jp, tp = _params("artifact")
    quant = jschema.wire_quant_for(jp)
    _, tm = meshes()
    loop = dl.make_sharded_compact_device_loop(
        tcfg, get_model(tcfg.model.name).classify_batch, tm, 2, 2, **quant)
    slot = torch.zeros((2, 129, schema.COMPACT_RECORD_WORDS),
                       dtype=torch.int32)
    table, stats = pstep.make_sharded_table(tcfg, tm), schema.make_stats()
    with pytest.raises(ValueError, match="2-slot ring"):
        loop(table, stats, tp, slot)
    with pytest.raises(ValueError, match="chunk"):
        loop(table, stats, tp, slot[:1], slot[:1])
    with pytest.raises(ValueError, match="verdict wire"):
        dl.make_sharded_compact_device_loop(
            dataclasses.replace(tcfg, batch=dataclasses.replace(
                tcfg.batch, verdict_k=0)),
            get_model(tcfg.model.name).classify_batch, tm, 2, 2, **quant)


# -- raw48: lane-order byte sums and the eviction sweep ---------------------------


@pytest.mark.parametrize("scenario", ["mixed_l34_1m", "udp_flood_multi"])
def test_raw48_mlp_with_eviction_sharded(scenario):
    """The mlp artifact on raw48 with the in-step sweep (each shard its
    own window): six batches byte-equal to the reference's sharded raw
    step, rows evicted."""
    from tests.test_torch_raw48 import cfgs as raw_cfgs

    name, jp, tp = family_params("mlp")
    p = ShardedPair(raw_cfgs(name, limiter=dict(pps_threshold=300.0),
                             batch=dict(verdict_k=8),
                             table=dict(stale_s=30.0, evict_ttl_s=0.002,
                                        evict_every=2)),
                    jp, tp, wire="raw48")
    for raw in raw_stream(scenario, 6, seed=5):
        p.step(raw)
    assert p.ts.to_dict()["evicted"] > 0


@pytest.mark.parametrize("n", [2, 8])
def test_raw48_byte_sums_past_2p24_across_slices(n):
    """A source of 675 records of 65,535 B spread over every slice: at
    2 shards each slice's partial passes 2^24, at 8 the owner's merge
    does, where only the reference's lane order gives its bits."""
    name, jp, tp = family_params("mlp")
    from tests.test_torch_raw48 import cfgs as raw_cfgs

    b = 1024
    p = ShardedPair(raw_cfgs(name, limiter=dict(pps_threshold=1e6,
                                                bps_threshold=1e15),
                             batch=dict(max_batch=b)),
                    jp, tp, n=n, wire="raw48")
    rng = np.random.default_rng(n)
    lane = np.arange(b)
    rec = np.zeros(b, jschema.FLOW_RECORD_DTYPE)
    rec["saddr"] = np.where(lane < 900, np.where(lane % 4 != 3, 1, 2),
                            rng.integers(10, 60, b))
    rec["pkt_len"] = np.where(lane < 900, 65_535,
                              rng.integers(64, 65_536, b))
    rec["ts_ns"] = 10_000 + lane * 1000
    rec["feat"] = rng.integers(0, 1 << 20, (b, 8))
    p.step(jschema.encode_raw(rec, b, 0))
    assert p.tt.state[:, schema.TableCol.WIN_BPS].max() > 2 ** 24


def test_sharded_epoch_step_equals_reference_sweep():
    """Mesh eviction, the reference's own pin restated: the sharded step
    with the sweep equals a numpy sweep of the whole row array followed
    by the sweepless sharded step (the sweep is shard-local and
    elementwise), and the evicted count is the sweep's."""
    from tests.test_table import mkbuf

    def cfg(ttl):
        return config.FsxConfig(
            table=config.TableConfig(capacity=1 << 12, stale_s=1e6,
                                     evict_ttl_s=ttl, evict_every=1),
            batch=config.BatchConfig(max_batch=256),
            limiter=config.LimiterConfig(pps_threshold=1e9,
                                         bps_threshold=1e18))

    _, tm = meshes()
    cfg_e, cfg_0 = cfg(2.5), cfg(0.0)
    cls = get_model(cfg_e.model.name).classify_batch
    params = get_model(cfg_e.model.name).init("cpu")
    step_e = pstep.make_sharded_raw_step(cfg_e, cls, tm)
    step_0 = pstep.make_sharded_raw_step(cfg_0, cls, tm)
    t_e, s_e = pstep.make_sharded_table(cfg_e, tm), schema.make_stats()
    t_r, s_r = pstep.make_sharded_table(cfg_0, tm), schema.make_stats()
    total = 0
    for i in range(6):
        keys = 1000 * (i % 3 + 1) + np.arange(64)
        raw = schema.wire_to_tensor(schema.encode_raw(mkbuf(keys, float(i)),
                                                      256, 0))
        _, _, out_e = step_e(t_e, s_e, params, raw)
        now = np.float32(out_e.now.item())
        st = t_r.state.numpy()
        victim = ((t_r.key.numpy() != 0)
                  & (now - st[:, 0] > np.float32(2.5)) & ~(st[:, 11] > now))
        total += int(victim.sum())
        t_r.key[torch.from_numpy(victim)] = 0
        t_r.state[torch.from_numpy(victim)] = 0.0
        _, _, out_r = step_0(t_r, s_r, params, raw)
        assert torch.equal(t_e.key_rows, t_r.key_rows)
        assert torch.equal(t_e.state_rows, t_r.state_rows)
        assert torch.equal(out_e.verdict, out_r.verdict)
    assert total > 0 and int(s_e.evicted) == total


# -- the meshed engine ------------------------------------------------------------


def _engine_cfgs(b=512, **table):
    kw = dict(limiter=dict(pps_threshold=50.0, bps_threshold=1e9),
              table=dict(capacity=1 << 12, **table),
              batch=dict(max_batch=b))
    return (jconfig.FsxConfig(limiter=jconfig.LimiterConfig(**kw["limiter"]),
                              table=jconfig.TableConfig(**kw["table"]),
                              batch=jconfig.BatchConfig(**kw["batch"])),
            config.FsxConfig(limiter=config.LimiterConfig(**kw["limiter"]),
                             table=config.TableConfig(**kw["table"]),
                             batch=config.BatchConfig(**kw["batch"])))


def _flood(n_batches, b=512, seed=13):
    return JTrafficGen(JTrafficSpec(
        scenario=JScenario.UDP_FLOOD_MULTI, rate_pps=1e6, n_attack_ips=32,
        attack_fraction=0.8, seed=seed)).next_records(b * n_batches)


def _run_pair(recs, n=N, jkw=None, tkw=None, cfgs=None, **kw):
    jcfg, tcfg = cfgs or _engine_cfgs()
    js = JCollectSink()
    je = JEngine(jcfg, JArraySource(recs.copy()), js, sink_thread=False,
                 mesh=jmake_mesh(n) if n > 1 else None, **kw, **(jkw or {}))
    jr = je.run()
    ts = CollectSink()
    te = Engine(tcfg, ArraySource(recs.copy()), ts, device="cpu",
                sink_thread=False,
                mesh=make_mesh(n, devices=["cpu"] * n), **kw, **(tkw or {}))
    tr = te.run()
    return (je, js, jr), (te, ts, tr)


def assert_same_engines(j, t):
    (je, js, jr), (te, ts, tr) = j, t
    assert tr.stats == jr.stats
    assert tr.batches == jr.batches and tr.records == jr.records
    assert tr.route_drop == jr.route_drop
    assert tr.blocked_sources == jr.blocked_sources
    assert ts.blocked.keys() == js.blocked.keys()
    for k, v in js.blocked.items():
        assert np.float32(ts.blocked[k]) == np.float32(v)
    assert tr.table == jr.table
    key, state = schema.table_to_numpy(te.table)
    np.testing.assert_array_equal(key, np.asarray(je.table.key))
    np.testing.assert_array_equal(state.view(np.uint32),
                                  _bits(je.table.state))


@pytest.mark.parametrize("mega_n", [0, 4, "auto"])
def test_meshed_engine_matches_reference(mega_n):
    """``Engine(mesh=8 shards)`` against the reference's
    ``Engine(mesh=make_mesh(8))`` on a blocking flood: stats, blacklist
    with its untils, table bytes, summary and route_drop; singles, a
    fixed rung and the adaptive ladder."""
    j, t = _run_pair(_flood(12), mega_n=mega_n, readback_depth=8)
    assert t[0].mesh is not None and t[0].wire == schema.WIRE_COMPACT16
    assert t[2].stats["dropped"] > 0
    assert_same_engines(j, t)
    if mega_n:
        assert any(int(g) > 1 for g in t[2].dispatch["group_hist"])


def test_meshed_engine_matches_single_device():
    recs = _flood(8)
    _, (_, ts_m, tr_m) = _run_pair(recs)
    _, tcfg = _engine_cfgs()
    ts = CollectSink()
    tr = Engine(tcfg, ArraySource(recs.copy()), ts, device="cpu",
                sink_thread=False).run()
    assert tr_m.stats == tr.stats and ts_m.blocked.keys() == ts.blocked.keys()


def test_meshed_engine_ring_matches_reference():
    j, t = _run_pair(_flood(16), mega_n=4, device_loop=2)
    assert t[2].dispatch["device_loop"]["rounds"] >= 1
    assert_same_engines(j, t)


@pytest.mark.parametrize("verdict_k", [0, 64])
def test_meshed_engine_route_drop_matches_reference(verdict_k):
    """The owner skew fed through the engine: route_drop from the wire,
    or (``verdict_k=0``) from the block record's tail, equals the
    reference's."""
    b = 1024
    rec = np.zeros(2 * b, jschema.FLOW_RECORD_DTYPE)
    rec["saddr"] = np.concatenate([owned_by_zero(b)] * 2)
    rec["pkt_len"] = 100
    rec["ts_ns"] = np.arange(2 * b) * 1000
    cfgs = _engine_cfgs(b=b)
    cfgs = tuple(dataclasses.replace(c, batch=dataclasses.replace(
        c.batch, verdict_k=verdict_k)) for c in cfgs)
    j, t = _run_pair(rec, cfgs=cfgs)
    assert t[2].route_drop == 2 * 8 * 64
    assert_same_engines(j, t)


def test_meshed_engine_single_device_mesh_falls_back():
    _, tcfg = _engine_cfgs(b=128)
    eng = Engine(tcfg, ArraySource(_flood(1, 128)), CollectSink(),
                 device="cpu", mesh=make_mesh(1, devices=["cpu"]))
    assert eng.mesh is None
    assert type(eng.table) is schema.IpTableState


def test_meshed_engine_refuses_a_mesh_on_another_device():
    _, tcfg = _engine_cfgs(b=128)
    with pytest.raises(ValueError, match="engine's device"):
        Engine(tcfg, ArraySource(_flood(1, 128)), CollectSink(),
               device="cpu", mesh=make_mesh(2, devices=["meta"] * 2))


def test_meshed_engine_eviction_matches_reference_and_single():
    """Eviction engines under churn: the port's mesh engine equals the
    reference's mesh engine byte for byte; against the single-shard
    engine the verdict counts are equal and ``evicted`` close (it counts
    rows, which the two layouts arbitrate differently)."""
    from tests.test_table import mkbuf

    recs = np.concatenate([mkbuf(10_000 * (i + 1) + np.arange(256),
                                 t_s=float(i)) for i in range(6)])

    def cfgs():
        lim = dict(pps_threshold=1e9, bps_threshold=1e18)
        tb = dict(capacity=1 << 12, stale_s=1e6, evict_ttl_s=2.5,
                  evict_every=2)
        return (jconfig.FsxConfig(limiter=jconfig.LimiterConfig(**lim),
                                  table=jconfig.TableConfig(**tb),
                                  batch=jconfig.BatchConfig(max_batch=256)),
                config.FsxConfig(limiter=config.LimiterConfig(**lim),
                                 table=config.TableConfig(**tb),
                                 batch=config.BatchConfig(max_batch=256)))

    j, t = _run_pair(recs, cfgs=cfgs())
    assert_same_engines(j, t)
    single = Engine(cfgs()[1], ArraySource(recs.copy()), CollectSink(),
                    device="cpu", sink_thread=False).run()
    for f, v in single.stats.items():
        if f == "evicted":
            assert v > 0 and t[2].stats[f] > 0
            assert abs(v - t[2].stats[f]) <= 8
        else:
            assert v == t[2].stats[f], f


# -- checkpoints under a mesh -----------------------------------------------------


def test_mesh4_checkpoint_roundtrip_and_reshards(tmp_path):
    """A mesh-4 engine's checkpoint records 4 shards; it restores
    bit-identically at mesh 4, and reshards to mesh 8 and to one shard
    with every key kept, owner-correct, the info equal to the
    reference's restoring the same file, and the tables equal to the
    reference's."""
    b = 256
    flood = np.zeros(b * 8, jschema.FLOW_RECORD_DTYPE)
    flood["saddr"] = np.repeat(
        np.arange(1, b * 8 // 128 + 1, dtype=np.uint32) * 7919, 128)
    flood["pkt_len"] = 100
    flood["ts_ns"] = np.arange(b * 8) * 1000
    lim = dict(pps_threshold=50.0, bps_threshold=1e18, block_s=3600.0)
    tb = dict(capacity=1 << 12, stale_s=1e6, salt=0xABC)
    jcfg = jconfig.FsxConfig(limiter=jconfig.LimiterConfig(**lim),
                             table=jconfig.TableConfig(**tb),
                             batch=jconfig.BatchConfig(max_batch=b))
    tcfg = config.FsxConfig(limiter=config.LimiterConfig(**lim),
                            table=config.TableConfig(**tb),
                            batch=config.BatchConfig(max_batch=b))

    def port(n):
        return Engine(tcfg, ArraySource(flood.copy()), CollectSink(),
                      device="cpu", sink_thread=False,
                      mesh=make_mesh(n, devices=["cpu"] * n))

    e1 = port(4)
    e1.run()
    assert len(e1._blocked) > 0
    path = e1.checkpoint(tmp_path / "m4.npz")
    from flowsentryx_tpu.engine import checkpoint as jckpt

    assert jckpt.peek_header(path)["n_shards"] == 4
    key1, state1 = schema.table_to_numpy(e1.table)
    occupied = set(key1[key1 != 0].tolist())
    for n in (4, 8, 1):
        e2 = port(n)
        info = e2.restore(path)
        je = JEngine(jcfg, JArraySource(flood.copy()), JCollectSink(),
                     sink_thread=False,
                     mesh=jmake_mesh(n) if n > 1 else None)
        jinfo = je.restore(path)
        for k in ("resharded", "dropped_rows", "from", "to"):
            assert info[k] == jinfo[k], k
        assert info["resharded"] == (n != 4)
        key2, state2 = schema.table_to_numpy(e2.table)
        np.testing.assert_array_equal(key2, np.asarray(je.table.key))
        np.testing.assert_array_equal(state2, np.asarray(je.table.state))
        assert set(key2[key2 != 0].tolist()) == occupied
        if n == 4:
            np.testing.assert_array_equal(key2, key1)
            np.testing.assert_array_equal(state2.view(np.uint32),
                                          state1.view(np.uint32))
            assert e2.stats.to_dict() == e1.stats.to_dict()
        local = (1 << 12) // n
        rows = np.flatnonzero(key2 != 0)
        np.testing.assert_array_equal(
            rows // local, tbl.owner_of(key2[rows], 0xABC, n))


# -- the mesh, the layout and the package -----------------------------------------


def test_make_mesh_refusals_match_reference():
    for n in (3, 6):
        with pytest.raises(ValueError) as jerr:
            jmake_mesh(n)
        with pytest.raises(ValueError) as terr:
            make_mesh(n, devices=["cpu"] * 8)
        assert str(terr.value) == str(jerr.value)
    with pytest.raises(ValueError) as jerr:
        jmake_mesh(512)
    with pytest.raises(ValueError) as terr:
        make_mesh(512, devices=["cpu"] * 8)
    assert str(terr.value) == str(jerr.value) == "requested 512 devices, have 8"
    with pytest.raises(ValueError, match="distinct devices is not ported"):
        make_mesh(2, devices=["cpu", "meta"])
    m = make_mesh(devices=["cpu"] * 4, axis_name="x")
    assert m.size == 4 and m.axis_names == ("x",)
    # init_distributed takes the reference's arguments, and is a no-op
    # for one process with no coordinator, as the reference's is
    import inspect

    from flowsentryx_tpu.parallel import mesh as jmesh

    ref = list(inspect.signature(jmesh.init_distributed).parameters)
    assert list(inspect.signature(pmesh.init_distributed).parameters)[
        :len(ref)] == ref
    pmesh.init_distributed()
    assert not pmesh._WORLD
    # more than one process needs the coordinator's address
    with pytest.raises(ValueError, match="coordinator_address"):
        pmesh.init_distributed(num_processes=2)
    # a world of one at a coordinator (a file store, or the reference's
    # HOST:PORT, port 0 on loopback): the process mesh of one gloo rank
    # (multi-rank worlds: tests/test_torch_mesh_processes.py)
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        for address in (f"file://{d}/store", "localhost:0"):
            pmesh.init_distributed(address, 1, 0, device="cpu")
            try:
                pm = make_mesh()
                assert (pm.size, pm.rank, pm.backend, pm.is_process) == (
                    1, 0, "gloo", True)
                with pytest.raises(RuntimeError, match="already up"):
                    pmesh.init_distributed(f"file://{d}/other", 1, 0,
                                           device="cpu")
            finally:
                pmesh.shutdown_distributed()
            assert not pmesh._WORLD


@pytest.mark.parametrize("name", ["table.key_rows", "table.state_rows",
                                  "stats.allowed", "params", "raw", "wire",
                                  "slot", "params.w"])
def test_partition_rules_match_reference(name):
    ref_name = name.replace("key_rows", "key").replace("state_rows", "state")
    assert tuple(layout.spec_for(name)) == tuple(jlayout.spec_for(ref_name))
    assert tuple(layout.spec_for(name, "x")) == tuple(
        jlayout.spec_for(ref_name, "x"))


def test_layout_specs_and_placement():
    with pytest.raises(KeyError) as terr:
        layout.spec_for("nope")
    with pytest.raises(KeyError) as jerr:
        jlayout.spec_for("nope")
    assert str(terr.value) == str(jerr.value)
    assert all(tuple(s) == ("ip",) for s in layout.table_specs())
    assert all(tuple(s) == () for s in layout.stats_specs())
    _, tm = meshes()
    assert tuple(layout.replicated(tm).spec) == ()
    assert layout.sharding_for(tm, "table.key_rows").device == tm.device
    t = schema.make_table(1 << 12)
    placed = layout.shard_table(t, tm)
    assert placed.key_rows.data_ptr() == t.key_rows.data_ptr()
    assert pstep.shard_table is layout.shard_table
    with pytest.raises(ValueError, match="divide by device count"):
        layout.shard_table(schema.make_table(4), tm)
    with pytest.raises(ValueError, match="divide by device count"):
        pstep.make_sharded_step(
            config.FsxConfig(table=config.TableConfig(capacity=4)),
            get_model("logreg_int8").classify_batch, tm)


def test_batch_must_divide_by_the_mesh():
    p = golden_pair()
    bad = port_batch(_batch([(1, 1, 100, 0.1, ML_COLD)], b=252))
    with pytest.raises(ValueError, match="must divide by the 8-device mesh"):
        p.tstep(p.tt, p.ts, p.tp, bad)


def test_package_exports_match_reference():
    import flowsentryx_tpu.parallel as jpar
    import flowsentryx_tpu_torch.parallel as tpar

    names = [n for n in dir(jpar) if not n.startswith("_")]
    for n in names:
        assert hasattr(tpar, n), n
    assert tpar.make_mesh is make_mesh
    assert tpar.step is pstep and tpar.layout is layout


# -- the config repair, serve --mesh and bench --scaling --------------------------


def test_ip_axis_config_boots_in_both_packages(tmp_path):
    """``{"mesh": {"ip_axis": 4}}``: the reference serves it (it never
    reads the field) and so does the port now, with equal results."""
    text = '{"mesh": {"ip_axis": 4}, "batch": {"max_batch": 256}, ' \
           '"table": {"capacity": 4096}}'
    jcfg, tcfg = jconfig.FsxConfig.from_json(text), \
        config.FsxConfig.from_json(text)
    assert tcfg.mesh.ip_axis == 4
    recs = _flood(3, 256)
    jr = JEngine(jcfg, JArraySource(recs.copy()), JCollectSink(),
                 sink_thread=False).run()
    tr = Engine(tcfg, ArraySource(recs.copy()), CollectSink(), device="cpu",
                sink_thread=False).run()
    assert tr.stats == jr.stats and tr.batches == jr.batches == 3


@pytest.mark.parametrize("argv,expect", [
    (["--table-capacity", "4096", "--mesh", "3"], "not a power of two"),
    (["--table-capacity", "4", "--mesh", "8"], "cannot split over 8"),
])
def test_serve_mesh_capacity_refusals_match_reference(argv, expect, capsys):
    assert jcli.main(["serve", *argv]) == 1
    jerr = capsys.readouterr().err
    assert cli.main(["serve", "--device", "cpu", *argv]) == 1
    terr = capsys.readouterr().err
    jprob = jerr.split("--table-capacity: ", 1)[1].strip()
    tprob = terr.split("--table-capacity: ", 1)[1].strip()
    assert expect in tprob
    assert tprob == "; ".join(jprob.splitlines()).replace(
        "fsx serve: --table-capacity: ", "")


@pytest.mark.parametrize("n", [2, 16])
def test_serve_mesh_needs_the_devices(n, capsys):
    """As the reference on a host without N devices: ``--mesh N`` is
    refused with the reference's message.  On the CPU a process mesh
    has one gloo rank per core at most, so ``n`` times the cores is
    refused (``--mesh 2`` serves: tests/test_torch_mesh_processes.py)."""
    from flowsentryx_tpu_torch.parallel.launch import host_devices

    have = host_devices("cpu")
    assert cli.main(["serve", "--device", "cpu", "--table-capacity",
                     "4096", "--mesh", str(n * have), "--packets",
                     "256"]) == 1
    err = capsys.readouterr().err
    assert f"requested {n * have} devices, have {have}" in err
    with pytest.raises(ValueError, match=f"requested {n * 64} devices, "
                                         "have 8"):
        jmake_mesh(n * 64)


def test_serve_mesh_one_is_the_single_shard_engine(capsys):
    assert cli.main(["serve", "--device", "cpu", "--table-capacity", "4096",
                     "--mesh", "1", "--packets", "4096", "--json"]) == 0
    rep = json.loads(capsys.readouterr().out)
    assert rep["route_drop"] == 0 and rep["records"] == 4096


def test_bench_scaling_keys_match_reference(monkeypatch, capsys):
    """``bench --scaling`` is no longer refused; its JSON carries the
    reference's keys, at every row, at a small size."""
    small = dict(device_counts=(1, 2), capacity=1 << 12, batch=256,
                 iters=1)
    ref = jbenchmarks.run_scaling(**small)
    real = benchmarks.run_scaling
    monkeypatch.setattr(benchmarks, "run_scaling",
                        lambda **kw: real(**small, **kw))
    assert cli.main(["bench", "--scaling", "--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out)
    assert set(ref) <= set(got)
    assert len(got["results"]) == len(ref["results"]) == 2
    for g, r in zip(got["results"], ref["results"]):
        assert set(r) <= set(g) and g["devices"] == r["devices"]
    assert got["backend"] == "cpu" and got["iters"] == ref["iters"]
    assert got["serialization_ratio_8x"] > 0
    skipped = real(device_counts=(1, 16), capacity=1 << 12, batch=256,
                   iters=1, devices=["cpu"] * 8)
    assert skipped["results"][1] == {"devices": 16,
                                     "skipped": "not enough devices"}
