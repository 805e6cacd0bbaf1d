"""The process mesh (``flowsentryx_tpu_torch/parallel/``: ``launch``,
``follower``, ``exchange``, ``make_process_step``): 2 and 4 gloo ranks,
one process per shard, against the JAX reference's ``shard_map`` step on
as many of its 8 virtual CPU devices, and against the port's
one-process mesh, byte for byte.

This test process is rank 0 (it runs the reference too); the followers
are ``python -m flowsentryx_tpu_torch.parallel.follower`` children that
import only the port.  Each case brings up its own group through a
``FileStore`` in a fresh temporary directory and closes it, and every
collective is bounded by a short group timeout, so a hung collective
fails the case within seconds.

* the step: a compact16 stream with cross-slice flows, owner skew that
  drops routes, a blocking flood and ML hits; a raw48 stream with byte
  sums past 2^24 and the eviction sweep.  After every batch each rank's
  verdict slice, block arrays, clock, ``route_drop``, wire and stats,
  and at the end every rank's rows (keys and every f32 column by its
  bits); the exchange census of the process step;
* the engine: a 2-rank process engine against the reference's meshed
  engine and the one-process mesh engine (stats, blacklist with its
  untils, report summary, table digest), and its refusals;
* checkpoints: written at 2 ranks, restored at 4 ranks and at one;
* ``serve --device cpu --mesh 2`` against the reference's ``serve --mesh
  2``;
* a follower killed mid-stream: the leader's next collective raises
  within the group's timeout, and the health ladder reads FAILED; a
  leader that exits takes its followers with it.
"""

import dataclasses
import hashlib
import json
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from flowsentryx_tpu import cli as jcli
from flowsentryx_tpu.audit import runner as jrunner
from flowsentryx_tpu.core import schema as jschema
from flowsentryx_tpu.engine import ArraySource as JArraySource
from flowsentryx_tpu.engine import CollectSink as JCollectSink
from flowsentryx_tpu.engine import Engine as JEngine
from flowsentryx_tpu.models import get_model as jget_model
from flowsentryx_tpu.parallel import make_mesh as jmake_mesh
from flowsentryx_tpu.parallel import step as jpstep
from flowsentryx_tpu_torch import cli
from flowsentryx_tpu_torch.audit import graph
from flowsentryx_tpu_torch.core import schema
from flowsentryx_tpu_torch.engine import ArraySource, CollectSink, Engine
from flowsentryx_tpu_torch.models.registry import get_model
from flowsentryx_tpu_torch.parallel import exchange, follower, launch
from flowsentryx_tpu_torch.parallel import make_mesh
from flowsentryx_tpu_torch.parallel import step as pstep
from tests.test_torch_fused import ML_HOT, _cfgs, _params
from tests.test_torch_parallel import (
    _bits, _engine_cfgs, _flood, assert_same_state, owned_by_zero,
)

REPO = Path(__file__).resolve().parents[1]
#: A short group timeout: a hung collective fails a case in seconds.
TIMEOUT_S = 20.0


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Up to four ranks share the host's cores: one thread each."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def world(n):
    return launch.MeshProcesses(n, device="cpu", timeout_s=TIMEOUT_S,
                                threads=1)


def _ref_stats(js) -> dict:
    return {f: int(np.asarray(getattr(js, f))[0])
            | int(np.asarray(getattr(js, f))[1]) << 32
            for f in jschema.GlobalStats._fields}


def _digest(key, state) -> str:
    return hashlib.sha256(np.ascontiguousarray(key, np.uint32).tobytes()
                          + np.ascontiguousarray(state).view(np.uint32)
                          .tobytes()).hexdigest()


# -- the step -------------------------------------------------------------------


def _records(b, seed, t0_ns, n):
    """One batch of 48-byte records: scattered keys over 200 sources
    (most flows span several slices), a 150-record flood from one
    source, eight ML hits, and a run of distinct keys that all hash to
    owner 0 (unsalted), which overflows each slice's route to it."""
    rng = np.random.default_rng(seed)
    rec = np.zeros(b, jschema.FLOW_RECORD_DTYPE)
    rec["saddr"] = rng.integers(1, 200, b)
    rec["saddr"][rng.permutation(b)[:150]] = 7777
    skew = rng.permutation(b)[:3 * b // 4]
    owned = owned_by_zero(40_000, n)
    rec["saddr"][skew] = rng.permutation(owned[owned > 1000])[:len(skew)]
    rec["pkt_len"] = rng.integers(64, 1500, b)
    rec["ts_ns"] = t0_ns + np.sort(rng.integers(0, 5_000_000, b))
    rec["feat"] = rng.integers(0, 1 << 12, (b, 8))
    rec["feat"][rng.permutation(b)[:8]] = np.asarray(ML_HOT, np.float32)
    return rec


class ProcessTrio:
    """The reference's sharded step, the port's one-process step and the
    process step over a live group, in lockstep over the same wire
    buffers; compared after each batch."""

    def __init__(self, mesh, cfgs, jp, tp, wire, quant):
        jcfg, tcfg = cfgs
        n = mesh.size
        self.mesh, self.n, self.k = mesh, n, tcfg.batch.verdict_k
        self.jm, self.om = jmake_mesh(n), make_mesh(n, devices=["cpu"] * n)
        jcls = jget_model(jcfg.model.name).classify_batch
        tcls = get_model(tcfg.model.name).classify_batch
        if wire == schema.WIRE_COMPACT16:
            self.jstep = jpstep.make_sharded_compact_step(
                jcfg, jcls, self.jm, donate=False, **quant)
            self.ostep = pstep.make_sharded_compact_step(tcfg, tcls, self.om,
                                                         **quant)
        else:
            self.jstep = jpstep.make_sharded_raw_step(jcfg, jcls, self.jm,
                                                      donate=False)
            self.ostep = pstep.make_sharded_raw_step(tcfg, tcls, self.om)
        self.jp, self.tp = jp, tp
        self.jt = jpstep.make_sharded_table(jcfg, self.jm)
        self.js = jschema.make_stats()
        self.ot = pstep.make_sharded_table(tcfg, self.om)
        self.os = schema.make_stats()
        self.lead = follower.Leader(mesh, {
            "cfg": tcfg, "params": tp, "wire": wire, "quant": quant,
            "keep": 2})
        self.shard = follower.Shard(mesh, {
            "cfg": tcfg, "params": tp, "wire": wire, "quant": quant,
            "keep": 2})
        self.b = tcfg.batch.max_batch

    def step(self, raw: np.ndarray):
        self.jt, self.js, jo = self.jstep(self.jt, self.js, self.jp,
                                          jnp.asarray(raw))
        x = schema.wire_to_tensor(raw)
        _, _, oo = self.ostep(self.ot, self.os, self.tp, x)
        sh = self.shard
        self.lead.step(x)
        self.calls = []      # the process step's exchanges, this batch
        with exchange.recording_exchanges(self.calls):
            _, _, out = sh.step(sh.table, sh.stats, sh.params, x)
        rows = out.block_key.shape[0]
        ranks = [follower.split_digest(d, self.b // self.n, rows, self.k)
                 for d in self.lead.check(out, sh.stats)]
        cat = {f: np.concatenate([r[f] for r in ranks])
               for f in ("verdict", "block_key", "block_until")}
        np.testing.assert_array_equal(cat["verdict"], np.asarray(jo.verdict))
        np.testing.assert_array_equal(cat["verdict"], oo.verdict.numpy())
        np.testing.assert_array_equal(cat["block_key"].view(np.uint32),
                                      np.asarray(jo.block_key))
        np.testing.assert_array_equal(cat["block_until"].view(np.uint32),
                                      _bits(jo.block_until))
        np.testing.assert_array_equal(cat["block_key"],
                                      oo.block_key.numpy())
        ref_stats = _ref_stats(self.js)
        for r in ranks:
            assert r["now"].view(np.uint32)[0] == _bits(jo.now)
            assert r["route_drop"][0] == int(np.asarray(jo.route_drop))
            np.testing.assert_array_equal(r["wire"].view(np.uint32),
                                          np.asarray(jo.wire))
            assert r["stats"] == ref_stats
        assert_same_state(self.ot, self.os, self.jt, self.js)
        return jo

    def assert_rows(self):
        """Every rank's rows, gathered in the one table's order, equal
        the reference's table and the one-process step's."""
        key, state = self.lead.rows(self.shard.table)
        np.testing.assert_array_equal(key, np.asarray(self.jt.key))
        np.testing.assert_array_equal(state.view(np.uint32),
                                      _bits(self.jt.state))
        okey, ostate = schema.table_to_numpy(self.ot)
        np.testing.assert_array_equal(key, okey)
        return key

    def close(self):
        self.lead.stop()


@pytest.mark.parametrize("n", [2, 4])
def test_process_step_equals_reference_and_one_process(n):
    """Compact16 batches through n gloo ranks: every rank's pieces of
    every output, its stats and its rows equal the reference's
    ``shard_map`` step on n virtual devices and the one-process step;
    routes dropped by the skew, blocks by the flood, ML hits voted.
    The exchange census of one process step is the reference's."""
    b = 1024
    jp, tp = _params("artifact")
    quant = jschema.wire_quant_for(jp)
    cfgs = _cfgs(limiter=dict(pps_threshold=40.0, bps_threshold=1e9),
                 batch=dict(max_batch=b, verdict_k=8))
    drops = blocked = 0
    with world(n) as w:
        trio = ProcessTrio(w.mesh, cfgs, jp, tp, schema.WIRE_COMPACT16, quant)
        for i in range(3):
            raw = jschema.encode_compact(
                _records(b, 40 + i, i * 400_000_000, n), b, 0, **quant)
            jo = trio.step(raw)
            drops += int(np.asarray(jo.route_drop))
            blocked += int(np.asarray(jo.wire)[2 * 8])
        key = trio.assert_rows()
        trio.close()
        assert w.close() == [0] * (n - 1)
    # C = B/n at 2 ranks: a slice cannot overflow its route to an owner
    assert (drops > 0) == (n > 2) and blocked > 0 and (key != 0).sum() > 200
    # one call per site per step body, as the reference's census counts
    process = {name: 0 for name, _ in trio.calls}
    for name, _ in trio.calls:
        process[name] += 1
    findings, per_body = graph.check_collectives(
        types.SimpleNamespace(exchanges=trio.calls), 8, True, 1)
    assert not findings and per_body == process == {
        "axis_index": 1, "pmax": 1, "all_to_all": 2, "psum": 2,
        "all_gather": 2}


def test_process_census_equals_reference_audit():
    """The reference's audit of its sharded step counts the process
    step's census (above): one call per site per step body."""
    jcfg, _ = _cfgs(batch=dict(max_batch=256, verdict_k=8))
    ref = jrunner.run_audit(jcfg, mesh=jmake_mesh(2))
    sharded = [v for v in ref.variants if v.collectives]
    assert sharded and all(v.collectives == {
        "axis_index": 1, "pmax": 1, "all_to_all": 2, "psum": 2,
        "all_gather": 2} for v in sharded)


def test_process_raw48_eviction_equals_reference():
    """Raw48 over 2 ranks with the eviction sweep: one flow's bytes pass
    2^24 across slices (the lane-order byte sum), old flows are swept;
    equal to the reference and the one-process step throughout."""
    b = 512
    jp, tp = _params("artifact")
    cfgs = _cfgs(limiter=dict(pps_threshold=1e9, bps_threshold=1e18),
                 table=dict(evict_ttl_s=2.5, evict_every=1),
                 batch=dict(max_batch=b, verdict_k=8))
    lane = np.arange(b)
    with world(2) as w:
        trio = ProcessTrio(w.mesh, cfgs, jp, tp, schema.WIRE_RAW48, {})
        for i in range(5):
            rec = np.zeros(b, jschema.FLOW_RECORD_DTYPE)
            rec["saddr"] = np.where(lane < 300, 1, 1000 * (i % 3 + 1) + lane)
            rec["pkt_len"] = np.where(lane < 300, 65_535, 100)
            rec["ts_ns"] = i * 1_000_000_000 + lane * 1000
            rec["feat"] = np.random.default_rng(i).integers(0, 1 << 20,
                                                            (b, 8))
            trio.step(jschema.encode_raw(rec, b, 0))
        trio.assert_rows()
        assert int(trio.shard.stats.evicted) > 0
        assert trio.shard.table.state[:, schema.TableCol.WIN_BPS].max() \
            > 2 ** 24 or trio.ot.state[:, schema.TableCol.WIN_BPS].max() \
            > 2 ** 24
        trio.close()


# -- the engine -------------------------------------------------------------------


def _engines(recs, n=2, cfgs=None, **kw):
    """The reference's meshed engine, the one-process mesh engine and a
    process engine of ``n`` ranks over the same records."""
    jcfg, tcfg = cfgs or _engine_cfgs()
    js = JCollectSink()
    je = JEngine(jcfg, JArraySource(recs.copy()), js, sink_thread=False,
                 mesh=jmake_mesh(n))
    jr = je.run()
    os_ = CollectSink()
    oe = Engine(tcfg, ArraySource(recs.copy()), os_, device="cpu",
                sink_thread=False, mesh=make_mesh(n, devices=["cpu"] * n))
    orep = oe.run()
    return (je, js, jr), (oe, os_, orep), tcfg


def _assert_engine(ref, rep, sink, rows):
    je, js, jr = ref
    assert rep.stats == jr.stats and rep.route_drop == jr.route_drop
    assert rep.batches == jr.batches and rep.records == jr.records
    assert rep.blocked_sources == jr.blocked_sources
    assert rep.table == jr.table
    assert sink.blocked.keys() == js.blocked.keys()
    for k, v in js.blocked.items():
        assert np.float32(sink.blocked[k]) == np.float32(v)
    assert _digest(*rows) == _digest(np.asarray(je.table.key),
                                     np.asarray(je.table.state))


@pytest.mark.parametrize("verdict_k", [64, 0])
def test_process_engine_equals_reference_and_one_process(verdict_k):
    """A 2-rank process engine on a blocking flood: stats, blacklist with
    its untils, report summary and table digest equal the reference's
    ``Engine(mesh=make_mesh(2))`` and the one-process mesh engine's;
    with ``verdict_k=0`` every sink gathers the owners' block arrays.
    The process mesh refuses the ladder, the ring, a sink thread and a
    hot swap by name."""
    jcfg, tcfg = _engine_cfgs()
    cfgs = tuple(dataclasses.replace(c, batch=dataclasses.replace(
        c.batch, verdict_k=verdict_k)) for c in (jcfg, tcfg))
    recs = _flood(12)
    ref, (oe, osink, orep), tcfg = _engines(recs, cfgs=cfgs)
    with world(2) as w:
        for kw, what in ((dict(mega_n=2), "mega grouping"),
                         (dict(sink_thread=True), "sink thread")):
            with pytest.raises(ValueError, match=what):
                Engine(tcfg, ArraySource(recs[:8]), CollectSink(),
                       device="cpu", mesh=w.mesh, **kw)
        sink = CollectSink()
        eng = Engine(tcfg, ArraySource(recs.copy()), sink, device="cpu",
                     mesh=w.mesh)
        eng.warm()
        rep = eng.run()
        rows = eng.table_rows()
        with pytest.raises(ValueError, match="hot_swap on a process mesh"):
            eng.hot_swap(eng.params)
        eng.close()
        assert w.close() == [0]
    assert rep.stats["dropped"] > 0 and rep.readback["fallback_sinks"] == (
        0 if verdict_k else rep.batches)
    _assert_engine(ref, rep, sink, rows)
    _assert_engine(ref, orep, osink, schema.table_to_numpy(oe.table))


def test_checkpoint_at_two_ranks_restores_at_four_and_one(tmp_path):
    """A checkpoint written by a 2-rank process engine records 2 shards
    and the one table's rows; restored by a 4-rank process engine and by
    a single-shard engine it reshards as the reference's restores of the
    same file do, every key kept, the tables equal."""
    b = 256
    flood = np.zeros(b * 8, jschema.FLOW_RECORD_DTYPE)
    flood["saddr"] = np.repeat(
        np.arange(1, b * 8 // 128 + 1, dtype=np.uint32) * 7919, 128)
    flood["pkt_len"] = 100
    flood["ts_ns"] = np.arange(b * 8) * 1000
    jcfg, tcfg = _engine_cfgs(b=b, salt=0xABC, stale_s=1e6)
    with world(2) as w:
        e2 = Engine(tcfg, ArraySource(flood.copy()), CollectSink(),
                    device="cpu", mesh=w.mesh)
        rep = e2.run()
        path = e2.checkpoint(tmp_path / "p2.npz")
        rows2 = e2.table_rows()
        e2.close()
    one = Engine(tcfg, ArraySource(flood.copy()), CollectSink(),
                 device="cpu", sink_thread=False,
                 mesh=make_mesh(2, devices=["cpu"] * 2))
    assert one.run().stats == rep.stats
    assert _digest(*rows2) == _digest(*schema.table_to_numpy(one.table))
    from flowsentryx_tpu.engine import checkpoint as jckpt

    assert jckpt.peek_header(path)["n_shards"] == 2
    occupied = set(rows2[0][rows2[0] != 0].tolist())
    assert len(occupied) > 0

    def ref_restore(n):
        je = JEngine(jcfg, JArraySource(flood[:8].copy()), JCollectSink(),
                     sink_thread=False, mesh=jmake_mesh(n) if n > 1 else None)
        return je, je.restore(path)

    with world(4) as w:
        e4 = Engine(tcfg, ArraySource(flood[:8].copy()), CollectSink(),
                    device="cpu", mesh=w.mesh)
        info4 = e4.restore(path)
        rows4 = e4.table_rows()
        stats4 = e4.stats.to_dict()
        e4.close()
    e1 = Engine(tcfg, ArraySource(flood[:8].copy()), CollectSink(),
                device="cpu", sink_thread=False)
    info1 = e1.restore(path)
    for n, info, rows in ((4, info4, rows4),
                          (1, info1, schema.table_to_numpy(e1.table))):
        je, jinfo = ref_restore(n)
        for k in ("resharded", "dropped_rows", "from", "to"):
            assert info[k] == jinfo[k], (n, k)
        assert info["resharded"]
        np.testing.assert_array_equal(rows[0], np.asarray(je.table.key))
        np.testing.assert_array_equal(rows[1].view(np.uint32),
                                      _bits(je.table.state))
        assert set(rows[0][rows[0] != 0].tolist()) == occupied
    assert stats4 == e1.stats.to_dict() == one.stats.to_dict()


def test_serve_mesh_two_over_gloo_ranks_equals_reference(tmp_path, capsys):
    """``serve --device cpu --mesh 2`` serves over 2 gloo ranks (a
    leader and one spawned follower) and reports what the reference's
    ``serve --mesh 2`` reports on 2 virtual devices for the same records
    and config."""
    recs = _flood(6, b=256)
    rec_path = tmp_path / "flood.bin"
    rec_path.write_bytes(recs.tobytes())
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps({
        "table": {"capacity": 4096, "salt": 0x5EED},
        "batch": {"max_batch": 256},
        "limiter": {"pps_threshold": 50.0, "bps_threshold": 1e9}}))
    argv = ["serve", "--config", str(cfg_path), "--records", str(rec_path),
            "--mesh", "2"]
    assert jcli.main(argv) == 0
    jrep = json.loads(capsys.readouterr().out)
    assert cli.main(argv + ["--device", "cpu", "--json"]) == 0
    rep = json.loads(capsys.readouterr().out)
    for k in ("stats", "records", "batches", "route_drop", "table",
              "blocked_sources"):
        assert rep[k] == jrep[k], k
    assert rep["stats"]["dropped"] > 0


def test_killed_follower_makes_the_leader_raise():
    """A follower killed mid-stream: the leader's next collective raises
    :class:`PeerLost` well within the group's timeout, ``run`` does not
    hang, and the health ladder reads FAILED."""
    _, tcfg = _engine_cfgs()
    recs = _flood(40)
    with world(2) as w:
        eng = Engine(tcfg, ArraySource(recs.copy()), CollectSink(),
                     device="cpu", mesh=w.mesh)
        eng.run(max_batches=2)
        w.procs[0].kill()
        w.procs[0].wait()
        t0 = time.perf_counter()
        with pytest.raises(exchange.PeerLost) as err:
            eng.run()
        assert time.perf_counter() - t0 < TIMEOUT_S
        assert err.value.health["state"] == "failed"
        assert "mesh_peer_lost:1" in err.value.health["reasons"]
        eng.close()       # the lost mesh takes no STOP: a no-op


def _alive(pid: int) -> bool:
    """Whether ``pid`` runs (a zombie, exited but not reaped, does not)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def test_a_leader_that_exits_takes_its_followers():
    """A leader process that exits without closing its mesh: its
    follower is gone within seconds (``PR_SET_PDEATHSIG``), never left
    waiting out the group's timeout."""
    code = ("import os\n"
            "from flowsentryx_tpu_torch.parallel import launch\n"
            "w = launch.MeshProcesses(2, device='cpu', threads=1)\n"
            "print(w.procs[0].pid, flush=True)\n"
            "os._exit(0)\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=60, cwd=REPO)
    assert r.returncode == 0, r.stderr
    pid = int(r.stdout.split()[0])
    deadline = time.monotonic() + 10
    while _alive(pid) and time.monotonic() < deadline:
        time.sleep(0.05)
    assert not _alive(pid)
