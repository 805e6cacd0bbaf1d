"""The port's cluster (``flowsentryx_tpu_torch/cluster/``, ``parallel/
layout.py``, ``ShardedIngest``'s shard span, the engine's gossip hooks,
``cli serve --cluster-rank`` and ``cli cluster``) against the JAX
package's.

* mailbox and status-block files written by one package are read by
  the other (wraparound, the u64 seq split across 2^32, a full mailbox
  that drops, unpublished magic refused), and the same operations leave
  the same bytes;
* a mixed plane — a port rank and a reference rank in one directory —
  converges after one tick with equal digests and no seq gaps;
* ``cluster_rank_of``/``ClusterLayout`` equal the reference's;
* two port rank engines over a prefilled 2-shard fan-out equal the
  port's one engine with two workers and the reference's two rank
  engines (blacklist keys and untils, exactly additive stats, digests);
* the supervisor on the millisecond lifecycle stub (no torch): the
  lifecycle, a crash restored from its checkpoint, the restart budget,
  ``request_stop``, the live-plane refusal, and ``aggregate`` equal to
  the reference's over the same report JSONs;
* every CLI refusal with the reference's exit code and message, and one
  real two-rank ``cli cluster --drain --device cpu`` fleet (the only
  test that spawns real engine processes).
"""

import json
import platform
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from flowsentryx_tpu import cli as jcli
from flowsentryx_tpu.cluster import gossip as jgossip
from flowsentryx_tpu.cluster import mailbox as jmailbox
from flowsentryx_tpu.cluster.runner import stub_engine_main as jstub
from flowsentryx_tpu.cluster.supervisor import (
    ClusterSupervisor as JSupervisor,
)
from flowsentryx_tpu.core import config as jconfig
from flowsentryx_tpu.engine import CollectSink as JCollectSink
from flowsentryx_tpu.engine import Engine as JEngine
from flowsentryx_tpu.engine.metrics import LatencyHist as JLatencyHist
from flowsentryx_tpu.engine.shm import RingNotReady as JRingNotReady
from flowsentryx_tpu.engine.shm import ShmRing as JShmRing
from flowsentryx_tpu.engine.writeback import BlacklistUpdate as JUpdate
from flowsentryx_tpu.ingest import ShardedIngest as JShardedIngest
from flowsentryx_tpu.parallel import layout as jlayout
from flowsentryx_tpu_torch import cli
from flowsentryx_tpu_torch.cluster import gossip, mailbox
from flowsentryx_tpu_torch.cluster.runner import stub_engine_main
from flowsentryx_tpu_torch.cluster.supervisor import ClusterSupervisor
from flowsentryx_tpu_torch.core import config, wire
from flowsentryx_tpu_torch.engine import CollectSink, Engine
from flowsentryx_tpu_torch.engine.metrics import LatencyHist
from flowsentryx_tpu_torch.engine.predict import DispatchGovernor
from flowsentryx_tpu_torch.engine.shm import RingNotReady, ShmRing
from flowsentryx_tpu_torch.engine.traffic import (
    Scenario, TrafficGen, TrafficSpec,
)
from flowsentryx_tpu_torch.engine.writeback import BlacklistUpdate
from flowsentryx_tpu_torch.ingest import ShardedIngest
from flowsentryx_tpu_torch.parallel import layout

REPO = Path(__file__).resolve().parents[1]
B = 256

pytestmark = pytest.mark.skipif(
    platform.machine() not in ("x86_64", "AMD64")
    or platform.system() != "Linux",
    reason="the cluster plane is mmap shm under x86-TSO and process "
           "groups (Linux)")

PKG = {
    "port": (mailbox.VerdictMailbox, mailbox.StatusBlock, RingNotReady),
    "reference": (jmailbox.VerdictMailbox, jmailbox.StatusBlock,
                  JRingNotReady),
}
CROSS = [("port", "reference"), ("reference", "port")]


@pytest.fixture
def two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


# ---------------------------------------------------------------------------
# (a) the shm plane's files, cross-read
# ---------------------------------------------------------------------------


def _wires(n, k, seed=5):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << 32, (n, 2 * k + 4), dtype=np.uint64
                        ).astype(np.uint32)


@pytest.mark.parametrize("writer,reader", CROSS)
def test_mailbox_cross_read_wraps_and_splits_seq(tmp_path, writer, reader):
    """11 wires through 4 slots (wraparound), their u64 seqs crossing
    2^32, written by one package and popped by the other."""
    path = tmp_path / "m.mbx"
    tx = PKG[writer][0].create(path, 4, k_max=3)
    rx = PKG[reader][0](path)
    assert (rx.slots, rx.k_max, rx.wire_words) == (4, 3, 10)
    wires = _wires(11, 3)
    seqs = [(1 << 32) - 3 + i for i in range(11)]
    got, i = [], 0
    while i < len(wires) or rx.readable():
        while i < len(wires) and tx.publish(wires[i], seqs[i], i % 4):
            i += 1
        got += rx.pop_wires(3)
    assert [s for s, _ in got] == seqs
    for (_, w), want in zip(got, wires):
        np.testing.assert_array_equal(w, want)


@pytest.mark.parametrize("writer,reader", CROSS)
def test_full_mailbox_drops_across_packages(tmp_path, writer, reader):
    """A full mailbox refuses the publish (the caller counts the drop)
    and the reader still sees exactly the published wires."""
    path = tmp_path / "m.mbx"
    tx = PKG[writer][0].create(path, 4, k_max=2)
    rx = PKG[reader][0](path)
    wires = _wires(5, 2, seed=9)
    assert [tx.publish(w, j + 1, 2) for j, w in enumerate(wires)] == [
        True] * 4 + [False]
    assert rx.readable() == 4
    got = rx.pop_wires(64)
    assert [s for s, _ in got] == [1, 2, 3, 4]
    np.testing.assert_array_equal(np.stack([w for _, w in got]), wires[:4])
    # the slots are free again for the writer
    assert tx.publish(wires[4], 5, 2)


def test_mailbox_files_byte_equal(tmp_path):
    """The same operations through either package leave the same bytes:
    header, cursors, slot headers and payloads."""
    wires = _wires(7, 4, seed=1)
    files = {}
    for pkg in PKG:
        path = tmp_path / f"{pkg}.mbx"
        m = PKG[pkg][0].create(path, 4, k_max=4)
        for j, w in enumerate(wires[:4]):
            m.publish(w, (1 << 32) + j, j)
        m.pop_wires(3)
        for j, w in enumerate(wires[4:]):
            m.publish(w, 7 + j, 1)
        files[pkg] = path.read_bytes()
    assert files["port"] == files["reference"]


@pytest.mark.parametrize("pkg", list(PKG))
@pytest.mark.parametrize("kind", ["mailbox", "status"])
def test_unpublished_magic_refused(tmp_path, pkg, kind):
    path = tmp_path / "f"
    path.write_bytes(b"\0" * 4096)
    cls = PKG[pkg][0] if kind == "mailbox" else PKG[pkg][1]
    with pytest.raises(PKG[pkg][2], match="magic not published"):
        cls(path)


@pytest.mark.parametrize("pkg", list(PKG))
def test_mailbox_geometry_refusals_match(tmp_path, pkg):
    for slots, k in ((3, 4), (1, 4), (4, 0)):
        with pytest.raises(ValueError) as got:
            PKG[pkg][0].create(tmp_path / "x", slots, k)
        with pytest.raises(ValueError) as want:
            jmailbox.VerdictMailbox.create(tmp_path / "y", slots, k)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("writer,reader", CROSS)
def test_status_block_cross_read(tmp_path, writer, reader):
    """Engine-side fields written by one package, supervisor-side
    fields by the other, each read back across; the files are
    byte-equal to the same stores made by the reference alone."""
    path = tmp_path / "s.blk"
    w = PKG[writer][1].create(path, 3)
    r = PKG[reader][1](path)
    assert r.rank == 3
    vals = {"c_hbeat": (1 << 40) + 7, "c_state": wire.CSTATE_SERVING,
            "c_batches": 123, "c_records": 123 * 2048, "c_pid": 4242}
    sup = {"c_stop": 1, "c_gen": 2, "c_t0": (1 << 50) + 1,
           "c_t0_wall": (1 << 60) + 3}
    for k, v in vals.items():
        w.ctl_set(k, v)
    for k, v in sup.items():
        r.ctl_set(k, v)
    assert {k: r.ctl_get(k) for k in vals} == vals
    assert {k: w.ctl_get(k) for k in sup} == sup
    ref = jmailbox.StatusBlock.create(tmp_path / "ref.blk", 3)
    for k, v in {**vals, **sup}.items():
        ref.ctl_set(k, v)
    assert path.read_bytes() == (tmp_path / "ref.blk").read_bytes()


def test_status_geometry_equals_reference():
    from flowsentryx_tpu.core import schema as jschema

    names = [n for n in dir(wire) if n.startswith(
        ("SHM_STATUS", "STATUS_", "CSTATE_", "SHM_GOSSIP", "GOSSIP_"))]
    assert len(names) >= 19
    for n in names:
        assert getattr(wire, n) == getattr(jschema, n), n


# ---------------------------------------------------------------------------
# (b) a mixed plane: one port rank, one reference rank
# ---------------------------------------------------------------------------


def _blocks(n, seed):
    rng = np.random.default_rng(seed)
    keys = rng.choice(np.arange(1, 1 << 24, dtype=np.uint32), n,
                      replace=False)
    untils = rng.uniform(1.0, 50.0, n).astype(np.float32)
    return keys, untils


@pytest.mark.parametrize("creator", ["port", "reference"])
def test_mixed_plane_converges_in_one_tick(tmp_path, creator):
    d = tmp_path / "plane"
    (gossip if creator == "port" else jgossip).create_plane(
        d, 2, k_max=4, slots=8)
    p = gossip.GossipPlane(d, 0, 2, sink=CollectSink(), merge_interval_s=0)
    j = jgossip.GossipPlane(d, 1, 2, sink=JCollectSink(),
                            merge_interval_s=0)
    pk, pu = _blocks(10, 1)       # 10 > K = 4: three wires
    jk, ju = _blocks(7, 2)
    p.publish(BlacklistUpdate(key=pk, until_s=pu), 1.5)
    j.publish(JUpdate(key=jk, until_s=ju), 2.5)
    assert p.tick(force=True) == len(jk)
    assert j.tick(force=True) == len(pk)
    pr, jr = p.report(), j.report()
    assert set(pr) == set(jr)
    assert pr["merged_digest"] == jr["published_digest"]
    assert jr["merged_digest"] == pr["published_digest"]
    assert pr["rx_seq_gaps"] == jr["rx_seq_gaps"] == 0
    assert (pr["tx_wires"], pr["rx_wires"]) == (jr["rx_wires"],
                                                 jr["tx_wires"]) == (3, 2)
    assert p.sink.blocked == dict(zip(jk.tolist(), ju.tolist()))
    assert j.sink.blocked == dict(zip(pk.tolist(), pu.tolist()))
    # both heartbeat through the tick
    for r in range(2):
        assert mailbox.StatusBlock(
            mailbox.status_path(d, r)).ctl_get("c_hbeat") > 0
    # the same map digests the same in both packages
    from flowsentryx_tpu.cluster.transport import map_digest

    m = dict(zip(pk.tolist(), pu.view(np.uint32).tolist()))
    assert gossip.map_digest(m) == map_digest(m) == pr["published_digest"]


def test_plane_json_and_files_match_reference(tmp_path):
    gossip.create_plane(tmp_path / "p", 3, k_max=8, slots=16)
    jgossip.create_plane(tmp_path / "j", 3, k_max=8, slots=16)
    names = sorted(f.name for f in (tmp_path / "j").iterdir())
    assert sorted(f.name for f in (tmp_path / "p").iterdir()) == names
    for n in names:
        assert (tmp_path / "p" / n).read_bytes() == (
            tmp_path / "j" / n).read_bytes(), n


def test_pressure_defers_ticks_as_reference(tmp_path):
    """The governor's pressure defers a due tick, at most SHED_MAX_DEFER
    in a row; counted like the reference's."""
    got = {}
    for name, mod in (("port", gossip), ("reference", jgossip)):
        d = tmp_path / name
        mod.create_plane(d, 2)
        pl = mod.GossipPlane(d, 0, 2, merge_interval_s=0.0)
        merged = []
        for _ in range(12):
            pl._next_tick = 0.0          # every call is due
            merged.append(pl.tick(pressure=1.0))
        got[name] = (pl.report()["ticks_deferred"], pl._defer_streak)
    assert got["port"] == got["reference"] == (11, 3)


def test_plane_refusals_match_reference(tmp_path):
    d = tmp_path / "plane"
    gossip.create_plane(d, 2)
    for args in ((d, 2, 2), (d, 0, 3)):
        with pytest.raises(ValueError) as got:
            gossip.GossipPlane(*args)
        with pytest.raises(ValueError) as want:
            jgossip.GossipPlane(*args)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match=">= 2 engines"):
        gossip.create_plane(tmp_path / "one", 1)
    # a one-engine plane is legal with the network leg, and attaching it
    # without a NetMailbox is refused in the reference's words
    for name, mod in (("one_p", gossip), ("one_j", jgossip)):
        mod.create_plane(tmp_path / name, 1, net=True)
    with pytest.raises(ValueError, match="network leg") as got:
        gossip.GossipPlane(tmp_path / "one_p", 0, 1)
    with pytest.raises(ValueError) as want:
        jgossip.GossipPlane(tmp_path / "one_j", 0, 1)
    assert str(got.value) == str(want.value)
    assert (tmp_path / "one_p" / "plane.json").read_bytes() == (
        tmp_path / "one_j" / "plane.json").read_bytes()


# ---------------------------------------------------------------------------
# (c) the ownership rule
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,w", [(2, 1), (2, 2), (3, 1), (4, 3)])
def test_cluster_rank_of_and_layout_equal_reference(n, w):
    saddr = np.random.default_rng(n * 10 + w).integers(
        0, 1 << 32, 20_000, dtype=np.uint64).astype(np.uint32)
    got = layout.cluster_rank_of(saddr, n, w)
    np.testing.assert_array_equal(got, jlayout.cluster_rank_of(saddr, n, w))
    assert got.dtype == np.int64 and set(np.unique(got)) == set(range(n))
    for r in range(n):
        lo, jl = layout.ClusterLayout(r, n, w), jlayout.ClusterLayout(r, n, w)
        assert (lo.total_shards, lo.shard_span) == (jl.total_shards,
                                                    jl.shard_span)
        np.testing.assert_array_equal(lo.owns(saddr), jl.owns(saddr))


@pytest.mark.parametrize("args", [(0, 1), (2, 2), (-1, 2), (0, 2, 0)])
def test_layout_refusals_match_reference(args):
    with pytest.raises(ValueError) as got:
        layout.ClusterLayout(*args)
    with pytest.raises(ValueError) as want:
        jlayout.ClusterLayout(*args)
    assert str(got.value) == str(want.value)


def test_sharded_ingest_span_as_reference(tmp_path):
    base = str(tmp_path / "ring")
    for off, total in ((0, 4), (2, 4), (3, 4), (0, 2)):
        kw = dict(shard_offset=off, total_shards=total, precompact=False)
        if off + 2 > total:
            with pytest.raises(ValueError) as got:
                ShardedIngest(base, 2, **kw)
            with pytest.raises(ValueError) as want:
                JShardedIngest(base, 2, **kw)
            assert str(got.value) == str(want.value)
            continue
        assert ShardedIngest(base, 2, **kw).ring_paths == JShardedIngest(
            base, 2, **kw).ring_paths


# ---------------------------------------------------------------------------
# (d) two rank engines == one engine with two workers == the reference
# ---------------------------------------------------------------------------


def _flood(n, seed=13):
    return TrafficGen(TrafficSpec(
        scenario=Scenario.UDP_FLOOD_MULTI, rate_pps=1e7, n_attack_ips=8,
        n_benign_ips=24, attack_fraction=0.8, seed=seed)).next_records(n)


def _fill(ring_cls, base, recs, total):
    sh = wire.shard_of(recs["saddr"], total)
    for k in range(total):
        ring = ring_cls.create(wire.shard_ring_path(base, k, total), 1 << 12,
                               wire.FLOW_RECORD_DTYPE)
        part = recs[sh == k]
        assert ring.produce(part) == len(part)


def _cfg(mod, salt=0x2F1):
    return mod.FsxConfig(
        table=mod.TableConfig(capacity=1 << 14, salt=salt),
        batch=mod.BatchConfig(max_batch=B),
        limiter=mod.LimiterConfig(pps_threshold=200.0, bps_threshold=1e9))


def _drain(pkg, base, workers, offset, total, t0, gossip_plane=None):
    ing, eng, sink = ((ShardedIngest, Engine, CollectSink) if pkg == "port"
                      else (JShardedIngest, JEngine, JCollectSink))
    src = ing(base, workers, shard_offset=offset, total_shards=total,
              queue_slots=16, precompact=False, t0_grace_s=0.2)
    sink = sink()
    kw = {"device": "cpu"} if pkg == "port" else {}
    e = eng(_cfg(config if pkg == "port" else jconfig), src, sink,
            readback_depth=4, t0_ns=t0, sink_thread=False,
            gossip=gossip_plane, **kw)
    try:
        # the epoch before the stop: a worker that sees the stop with no
        # epoch agreed seals nothing (the runner's order too)
        src.set_t0(t0)
        src.request_stop()
        rep = e.run()
    finally:
        src.close()
    return rep, sink


def test_two_rank_engines_equal_one_engine_and_reference(tmp_path,
                                                        two_threads):
    recs = _flood(B * 8)
    t0 = int(recs["ts_ns"].min())
    _fill(ShmRing, str(tmp_path / "single"), recs, 2)
    rep_a, sink_a = _drain("port", str(tmp_path / "single"), 2, 0, 2, t0)
    ranks = {}
    for pkg, ring, mod, sink in (("port", ShmRing, gossip, CollectSink),
                                 ("reference", JShmRing, jgossip,
                                  JCollectSink)):
        base = str(tmp_path / f"cluster_{pkg}")
        _fill(ring, base, recs, 2)
        mod.create_plane(tmp_path / f"plane_{pkg}", 2)
        planes = [mod.GossipPlane(tmp_path / f"plane_{pkg}", r, 2,
                                  sink=sink(), merge_interval_s=0.0)
                  for r in range(2)]
        ranks[pkg] = ([_drain(pkg, base, 1, r, 2, t0, planes[r])
                       for r in range(2)], planes)
    (b0, s0), (b1, s1) = ranks["port"][0]
    planes = ranks["port"][1]
    # lossless, every record on exactly one engine
    assert b0.records + b1.records == rep_a.records == len(recs)
    # the blacklist: keys AND untils equal; the ranks' shards disjoint
    assert s0.blocked and s1.blocked
    assert s0.blocked.keys() & s1.blocked.keys() == set()
    assert {**s0.blocked, **s1.blocked} == sink_a.blocked
    # stats: every counter exactly additive
    for f in rep_a.stats:
        assert b0.stats[f] + b1.stats[f] == rep_a.stats[f], f
    # the reference's two ranks: the same per-rank blacklists and stats
    (j0, js0), (j1, js1) = ranks["reference"][0]
    assert (s0.blocked, s1.blocked) == (js0.blocked, js1.blocked)
    assert (b0.stats, b1.stats) == (j0.stats, j1.stats)
    # the engine's hooks: rank 1 served after rank 0 published, so its
    # merged view already holds rank 0's blacklist, delivered to the
    # plane's own sink; the same digests as the reference's ranks
    assert b1.cluster["merged_digest"] == b0.cluster["published_digest"]
    assert b1.cluster["rx_seq_gaps"] == 0
    assert planes[1].sink.blocked == s0.blocked
    for mine, theirs in ((b0, j0), (b1, j1)):
        for k in ("published_digest", "merged_digest", "tx_wires",
                  "rx_wires", "rx_seq_gaps"):
            assert mine.cluster[k] == theirs.cluster[k], k
    planes[0].tick(force=True)
    assert planes[0].report()["merged_digest"] == b1.cluster[
        "published_digest"]
    assert planes[0].sink.blocked == s1.blocked
    assert rep_a.cluster is None
    assert b0.health == j0.health


# ---------------------------------------------------------------------------
# (e) the supervisor on the lifecycle stub
# ---------------------------------------------------------------------------


def _sup(tmp_path, specs, **kw):
    return ClusterSupervisor(tmp_path / "cl", specs,
                             entry=stub_engine_main, **kw)


def _reports(agg):
    return {(r["rank"], r["gen"]): r for r in agg["reports"]}


def test_supervisor_refuses_single_engine(tmp_path):
    with pytest.raises(ValueError, match="fsx serve"):
        ClusterSupervisor(tmp_path / "cl", [{}])


def test_supervisor_clean_lifecycle(tmp_path):
    sup = _sup(tmp_path, [{"stub_serve_s": 0.2}, {"stub_serve_s": 0.2}])
    sup.boot()
    agg = sup.run()
    assert agg["restarts"] == [0, 0] and agg["failed_ranks"] == []
    assert sorted(_reports(agg)) == [(0, 0), (1, 0)]
    assert agg["t0_ns"] > 0 and agg["t0_wall_ns"] > 0
    for r in range(2):
        st = mailbox.StatusBlock(mailbox.status_path(tmp_path / "cl", r))
        assert st.ctl_get("c_state") == wire.CSTATE_DONE
        assert st.ctl_get("c_t0") == agg["t0_ns"]
        assert st.ctl_get("c_t0_wall") == agg["t0_wall_ns"]
        assert st.ctl_get("c_pid") > 0


@pytest.mark.parametrize("with_ckpt", [True, False])
def test_supervisor_crash_restart_restores_checkpoint(tmp_path, with_ckpt):
    """Rank 1 dies mid-serve (``os._exit``, no DONE): killpg, then gen 1
    with ``restore=`` its checkpoint (the live path even when only
    ``.prev`` exists); rank 0 finishes untouched."""
    ck = tmp_path / "ck_r1.npz"
    if with_ckpt:
        (tmp_path / "ck_r1.npz.prev").write_bytes(b"stub flow memory")
    sup = _sup(tmp_path, [
        {"stub_serve_s": 0.6},
        {"stub_serve_s": 0.6, "stub_crash_after_s": 0.1,
         "checkpoint": str(tmp_path / "ck_r1")}])
    sup.boot()
    agg = sup.run()
    assert agg["restarts"] == [0, 1] and agg["failed_ranks"] == []
    reps = _reports(agg)
    assert sorted(reps) == [(0, 0), (1, 1)]
    assert reps[(1, 1)]["restored"] == (str(ck) if with_ckpt else None)


def test_supervisor_restart_budget_parks_rank(tmp_path, capsys):
    """Every generation crashes: after ``max_restarts`` respawns the rank
    parks as failed (announced with its span); the survivor serves on."""
    sup = _sup(tmp_path, [
        {"stub_serve_s": 3.0},
        {"stub_serve_s": 3.0, "stub_crash_after_s": 0.05,
         "stub_crash_every_gen": True, "workers": 2}],
        max_restarts=1, restart_backoff_s=0.01)
    sup.boot()
    deadline = time.monotonic() + 30.0
    while 1 not in sup._failed and time.monotonic() < deadline:
        sup.poll()
        time.sleep(0.02)
    try:
        assert sup.restarts[1] == 1 and 1 in sup._failed
        assert sup._procs[0].is_alive()
    finally:
        sup.close()
    agg = sup.aggregate()
    assert agg["failed_ranks"] == [1]
    assert agg["health"]["state"] == "failed"
    assert "ring shards [2, 4)" in capsys.readouterr().err


def test_supervisor_kill_then_restart(tmp_path):
    """The chaos hook: SIGKILL of a live rank's group, observed by the
    next poll and restarted at gen 1."""
    sup = _sup(tmp_path, [{"stub_serve_s": 30.0}, {"stub_serve_s": 30.0}])
    sup.boot()
    st1 = mailbox.StatusBlock(mailbox.status_path(tmp_path / "cl", 1))
    try:
        deadline = time.monotonic() + 30.0
        while not st1.ctl_get("c_hbeat") and time.monotonic() < deadline:
            time.sleep(0.02)
        sup.kill(1)
        assert not sup._procs[1].is_alive()
        while st1.ctl_get("c_gen") != 1 or st1.ctl_get("c_state") not in (
                wire.CSTATE_SPAWNING, wire.CSTATE_SERVING) \
                or sup.restarts[1] != 1:
            assert time.monotonic() < deadline
            sup.poll()
            time.sleep(0.02)
        agg = sup.run(max_seconds=0.2)
    finally:
        sup.close()
    assert agg["restarts"] == [0, 1] and agg["failed_ranks"] == []


def test_supervisor_request_stop_and_drain_overrun(tmp_path):
    sup = _sup(tmp_path, [{"stub_serve_s": 30.0},
                          {"stub_serve_s": 30.0, "stub_ignore_stop": True}])
    sup.boot()
    t0 = time.monotonic()
    agg = sup.run(max_seconds=0.3, drain_timeout_s=1.0)
    assert time.monotonic() - t0 < 15.0
    # rank 0 drained on stop; rank 1 ignored it and was force-killed:
    # failed, not a silent success, and not crash-restarted
    assert agg["failed_ranks"] == [1] and agg["restarts"] == [0, 0]


def test_supervisor_refuses_live_plane(tmp_path):
    d = tmp_path / "cl"
    gossip.create_plane(d, 2)
    now_ns = time.clock_gettime_ns(time.CLOCK_MONOTONIC)
    for r, age_s in ((0, 1.0), (1, 3.0)):
        st = mailbox.StatusBlock(mailbox.status_path(d, r))
        st.ctl_set("c_state", wire.CSTATE_SERVING)
        st.ctl_set("c_hbeat", now_ns - int(age_s * 1e9))
    with pytest.raises(RuntimeError) as ei:
        _sup(tmp_path, [{}, {}]).boot()
    msg = str(ei.value)
    assert "rank 0 heartbeated" in msg and "rank 1 heartbeated" in msg
    assert "Remediation" in msg and "fresh directory" in msg
    # a heartbeat from the future (a reboot) is a dead plane: stomped
    mailbox.StatusBlock(mailbox.status_path(d, 0)).ctl_set(
        "c_hbeat", now_ns + int(1e14))
    mailbox.StatusBlock(mailbox.status_path(d, 1)).ctl_set("c_hbeat", 1)
    sup = _sup(tmp_path, [{"stub_serve_s": 0.1}, {"stub_serve_s": 0.1}])
    sup.boot()
    assert sup.run()["failed_ranks"] == []


def test_aggregate_equals_reference(tmp_path):
    """``aggregate`` over the same report JSONs — two generations of one
    rank, latency histograms, health, the governors' blocks, boot
    stories, the adopt, rebalance and elastic blocks and the pre-warm
    count — equals the reference's, the multi-host ``hosts`` block (None
    on a single-host fleet) included."""
    d = tmp_path / "cl"
    d.mkdir()
    hists = []
    for r, base in enumerate((100e-6, 200e-6)):
        h = LatencyHist()
        for i in range(99):
            h.add(base * (1 + i % 7))
        h.add(50e-3 * (r + 1))
        hists.append(h)
    gov = DispatchGovernor(rung_sizes=(8, 4, 2), batch_records=B).report()
    for r, g, n, wall in ((0, 0, 100, 1.0), (0, 1, 40, 0.5),
                          (1, 0, 60, 2.0)):
        h = hists[r]
        rep = {"records": n, "batches": 1, "wall_s": wall,
               "latency": {"seal_to_verdict": h.to_dict(),
                           "hist": h.to_counts()},
               "health": {"state": "degraded" if r else "healthy",
                          "reasons": ["gossip_tx_dropped:3"] if r else []},
               "predict": dict(gov, holds=r + g),
               "boot": {"serving_ready_s": 1.5 + r, "import_s": 0.5,
                        "cache": {"hits": 4 * r, "misses": 4 - 4 * r,
                                  "stores": 4 - 4 * r}}}
        (d / f"report_r{r}_g{g}.json").write_text(json.dumps(
            {"rank": r, "gen": g, "report": rep}))
    (d / "report_r2_g0.json").write_text(json.dumps(
        {"rank": 2, "gen": 0, "report": {"records": 0, "batches": 0,
                                         "wall_s": 0.1}}))
    (d / "report_r3_g0.json").write_text("{torn")
    specs = [{}, {}, {}]
    got = ClusterSupervisor(d, specs, entry=stub_engine_main)
    want = JSupervisor(d, specs, entry=jstub)
    for s in (got, want):
        s._failed.add(2)
        s._stalled.add(1)
        s.restarts[0] = 1
    ref = want.aggregate()
    assert ref["hosts"] is None
    assert ref["boot"]["prewarm_spawned"] == 0   # elastic fleets only
    agg = got.aggregate()
    assert agg == ref
    assert agg["records"] == 40 + 60 + 0 and agg["max_wall_s"] == 2.0
    merged = JLatencyHist()
    for h in hists:
        merged.merge(JLatencyHist.from_counts(h.to_counts()))
    assert agg["latency"]["seal_to_verdict"] == merged.to_dict()
    assert agg["health"]["state"] == "failed"


def test_supervisor_imports_no_torch():
    """The supervisor process stays free of torch and CUDA: the
    supervisor, the runner (the spawn target's module), the plane and
    the CLI's cluster verb up to its boot import none of it."""
    code = (
        "import sys\n"
        "import flowsentryx_tpu_torch.cluster.supervisor\n"
        "import flowsentryx_tpu_torch.cluster.runner\n"
        "import flowsentryx_tpu_torch.cluster\n"
        "import flowsentryx_tpu_torch.parallel.layout\n"
        "from flowsentryx_tpu_torch import cli\n"
        "assert cli.main(['cluster', '--feature-ring', '/nonexistent/f',"
        " '--table-capacity', '4096', '--mega', '2', '--artifact',"
        " 'artifacts/mlp_robust.npz']) == 1\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('torch', 'jax', 'flowsentryx_tpu')]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


# ---------------------------------------------------------------------------
# (f) the CLI
# ---------------------------------------------------------------------------


def _both(argv, capsys):
    """Run ``argv`` through the port's CLI and the reference's; return
    (rc, message body) of each (the verb prefix stripped)."""
    out = []
    for main in (cli.main, jcli.main):
        rc = main(list(argv))
        err = capsys.readouterr().err.strip().splitlines()[-1]
        out.append((rc, err.split(": ", 1)[1]))
    return out


CLUSTER_REFUSALS = [
    ["cluster", "--engines", "1"],
    ["cluster", "--engines", "2", "--shards", "3"],
    ["cluster", "--engines", "2", "--shards", "0"],
    ["cluster", "--engines", "2", "--shards", "-2"],
    ["cluster", "--checkpoint", "/x/same_path.npz"],
    ["cluster", "--checkpoint", "/x/ck_{rank}_{host}.npz"],
    ["cluster", "--checkpoint", "/x/ck_{rank:02d}.npz",
     "--checkpoint-every", "-1"],
    ["cluster", "--checkpoint-every", "5"],
    ["cluster", "--device-loop", "-1"],
    ["cluster", "--device-loop", "2"],
    ["cluster", "--mega", "2", "--device-loop", "2", "--verdict-k", "0"],
    ["cluster", "--verdict-k", "-1"],
    ["cluster", "--tiered-warm"],
    ["cluster", "--slo-us", "-5"],
    ["cluster", "--predict"],
    # the elastic envelope
    ["cluster", "--min-engines", "2"],
    ["cluster", "--max-engines", "3"],
    ["cluster", "--elastic", "--max-engines", "1", "--engines", "2"],
    ["cluster", "--elastic", "--min-engines", "3", "--engines", "2"],
    ["cluster", "--elastic", "--shards", "2"],
    ["cluster", "--elastic", "--max-engines", "3", "--shards", "4"],
    ["cluster", "--elastic", "--engines", "2", "--checkpoint",
     "/x/same_path.npz"],
    ["cluster", "--elastic", "--hosts", "10.0.0.1:9000,10.0.0.2:9000"],
    # the multi-host leg
    ["cluster", "--engines", "0", "--hosts", "10.0.0.1:9000"],
    ["cluster", "--hosts", "10.0.0.1:9000,10.0.0.2"],
    ["cluster", "--hosts", "10.0.0.1:9000,:9000", "--host-id", "0"],
    ["cluster", "--hosts", "10.0.0.1:9000,10.0.0.2:70000",
     "--host-id", "0"],
    ["cluster", "--hosts", "10.0.0.1:65534,10.0.0.2:9000",
     "--host-id", "1"],
    ["cluster", "--hosts", "10.0.0.1:9000,10.0.0.2:9000"],
    ["cluster", "--hosts", "10.0.0.1:9000", "--host-id", "0"],
    ["cluster", "--engines", "1", "--shards", "1", "--hosts",
     "10.0.0.1:9000", "--host-id", "0"],
    ["cluster", "--hosts", "10.0.0.1:9000,10.0.0.2:9000", "--host-id", "2"],
    ["cluster", "--hosts", "10.0.0.1:9000,10.0.0.2:9000", "--host-id",
     "0", "--gossip-listen", "0.0.0.0"],
    ["cluster", "--hosts", "10.0.0.1:9000,10.0.0.2:9000", "--host-id",
     "0", "--gossip-listen", "0.0.0.0:65535"],
]


@pytest.mark.parametrize("argv", CLUSTER_REFUSALS,
                         ids=[" ".join(a[1:]) for a in CLUSTER_REFUSALS])
def test_cluster_refusals_match_reference(argv, capsys):
    port, ref = _both(argv + ["--feature-ring", "/nonexistent/fring"],
                      capsys)
    assert port == ref and port[0] == 1


def test_cluster_needs_a_feature_ring(capsys):
    assert cli.main(["cluster"]) == 1
    assert "--feature-ring BASE is required" in capsys.readouterr().err


@pytest.mark.parametrize("flag", [
    ["--hosts", "10.0.0.1:9000,10.0.0.2:9000"],
    ["--host-id", "0"], ["--gossip-listen", "0.0.0.0:9000"]])
def test_cluster_refuses_unported_flags_by_name(flag, capsys):
    """Each multi-host flag alone is refused before boot, with the
    reference's exit code and message (the flags were refused as not
    ported before the multi-host leg was; now each needs its partners)."""
    port, ref = _both(["cluster", *flag, "--feature-ring",
                       "/nonexistent/fring"], capsys)
    assert port == ref and port[0] == 1


@pytest.mark.parametrize("model,artifact,refused", [
    ("logreg_int8", "mlp_robust.npz", True),
    ("mlp", None, True),
    ("logreg_int8", "logreg_int8.npz", False)])
def test_cluster_mega_needs_an_observer(tmp_path, capsys, model, artifact,
                                        refused):
    """The engines' wire rule, checked without torch before any spawn
    (an accepted fleet is then refused by the next check in line: a
    live plane in its directory)."""
    cfg = tmp_path / "cfg.json"
    cfg.write_text(config.FsxConfig(
        model=config.ModelConfig(name=model)).to_json())
    d = tmp_path / "plane"
    gossip.create_plane(d, 2)
    st = mailbox.StatusBlock(mailbox.status_path(d, 0))
    st.ctl_set("c_state", wire.CSTATE_SERVING)
    st.ctl_set("c_hbeat", time.clock_gettime_ns(time.CLOCK_MONOTONIC))
    argv = ["cluster", "--feature-ring", str(tmp_path / "fring"), "--mega",
            "2", "--config", str(cfg), "--cluster-dir", str(d)]
    if artifact:
        argv += ["--artifact", str(REPO / "artifacts" / artifact)]
    assert cli.main(argv) == 1
    err = capsys.readouterr().err
    assert ("no input observer" in err) == refused
    assert ("live engines" in err) == (not refused)


def test_serve_cluster_rank_refusals_match_reference(tmp_path, capsys):
    base = ["serve", "--scenario", "benign", "--packets", "64"]
    ring = ["--feature-ring", str(tmp_path / "fring"),
            "--ingest-workers", "1"]
    gossip.create_plane(tmp_path / "plane", 2)
    jgossip.create_plane(tmp_path / "plane3", 3)
    cases = [
        base + ["--cluster-rank", "0"],
        base + ["--cluster-rank", "a/b"],
        base + ["--cluster-rank", "0/1"],
        base + ["--cluster-rank", "2/2"],
        base + ["--cluster-rank", "0/2"],
        base + ring + ["--cluster-rank", "0/2"],
        base + ring + ["--cluster-rank", "0/2", "--cluster-dir",
                       str(tmp_path / "nowhere")],
        base + ring + ["--cluster-rank", "0/2", "--cluster-dir",
                       str(tmp_path / "plane3")],
        # an initialized plane whose epoch was never stamped
        base + ring + ["--cluster-rank", "0/2", "--cluster-dir",
                       str(tmp_path / "plane")],
    ]
    for argv in cases:
        port, ref = _both(argv, capsys)
        assert port == ref and port[0] == 1, argv


# ---------------------------------------------------------------------------
# one real fleet: two engine processes through cli cluster
# ---------------------------------------------------------------------------


def test_cli_cluster_drain_real_engines(tmp_path, two_threads):
    """``cli cluster --drain --device cpu``: two spawned engine
    processes over a prefilled 2-shard fan-out, each pinned to one core
    with a one-thread torch pool (``--pin-cores on``: the fleet takes two
    cores of the host, not all of them).  Lossless per rank, the
    gossip converged with no seq gaps, and each rank's stats and
    published blacklist equal the port's one engine with two workers on
    the same records and epoch."""
    recs = _flood(B * 8, seed=21)
    # the fleet's epoch is stamped at boot: records stamped after it
    recs["ts_ns"] += np.uint64(time.clock_gettime_ns(time.CLOCK_MONOTONIC)
                               + 60 * 10**9 - int(recs["ts_ns"][0]))
    base = str(tmp_path / "ring")
    _fill(ShmRing, base, recs, 2)
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(_cfg(config).to_json())
    p = subprocess.run(
        [sys.executable, "-m", "flowsentryx_tpu_torch.cli", "cluster",
         "--device", "cpu", "--drain", "--feature-ring", base,
         "--config", str(cfg_path), "--pin-cores", "on"],
        cwd=REPO, capture_output=True, text=True, timeout=240)
    assert p.returncode == 0, p.stderr[-4000:]
    agg = json.loads(p.stdout)
    assert agg["failed_ranks"] == [] and agg["restarts"] == [0, 0]
    assert agg["health"]["state"] == "healthy"
    sh = wire.shard_of(recs["saddr"], 2)
    reps = {r["rank"]: r for r in agg["reports"]}
    assert sorted(reps) == [0, 1]
    for r in range(2):
        assert reps[r]["report"]["records"] == int((sh == r).sum())
        cl, peer = reps[r]["report"]["cluster"], reps[1 - r]["report"][
            "cluster"]
        assert cl["merged_digest"] == peer["published_digest"]
        assert cl["rx_seq_gaps"] == 0 and cl["published_sources"] > 0
        assert set(reps[r]["launches"]) == {
            "score_int8", "table_summary", "segment_sum_seq", "gemv_seq"}
    # the same records and epoch through one port engine, two workers
    _fill(ShmRing, str(tmp_path / "single"), recs, 2)
    one, sink = _drain("port", str(tmp_path / "single"), 2, 0, 2,
                       agg["t0_ns"])
    for f in one.stats:
        assert sum(reps[r]["report"]["stats"][f] for r in range(2)) \
            == one.stats[f], f
    owner = layout.cluster_rank_of(np.array(list(sink.blocked), np.uint32),
                                   2)
    for r in range(2):
        part = {k: np.float32(u).view(np.uint32).item()
                for (k, u), o in zip(sink.blocked.items(), owner) if o == r}
        assert gossip.map_digest(part) == reps[r]["report"]["cluster"][
            "published_digest"]
    assert agg["records"] == len(recs)


# ---------------------------------------------------------------------------
# (g) the multi-host leg: the federation on stub fleets, two CLI hosts on
#     loopback, and chip_smoke's multi-host drive on the CPU
# ---------------------------------------------------------------------------


def _free_bases(n_hosts, n_engines):
    """Probed free base ports (chip_smoke's: each base and its engine
    ports free, no two hosts' ranges overlapping)."""
    sys.path.insert(0, str(REPO))
    import chip_smoke

    return chip_smoke._free_base_ports(n_hosts, n_engines)


def _netspec(bases, host_id, n_engines=2, **kw):
    return {"hosts": [["127.0.0.1", b] for b in bases], "host_id": host_id,
            "engines_per_host": n_engines, "listen": None, **kw}


def test_federation_stub_fleets_detect_death_and_rejoin(tmp_path, capsys):
    """Two supervisors of two stub ranks each, federated on loopback: each
    sees the other's beacons; when one host's beacon goes silent the other
    announces it dead once (the reference's message), folds its fleet
    FAILED with ``hosts_dead`` and keeps its own ranks; a beacon on the
    same base port re-joins the host.  Both directions."""
    from flowsentryx_tpu_torch.sync import tuning

    b0, b1 = _free_bases(2, 2)
    fast = {"beacon_interval_s": 0.05, "host_timeout_s": 0.4}
    sups = [ClusterSupervisor(tmp_path / f"h{h}",
                              [{"stub_serve_s": 60.0}] * 2,
                              entry=stub_engine_main,
                              net=_netspec([b0, b1], h, **fast))
            for h in range(2)]

    def poll_until(pred, active, timeout_s=10.0):
        deadline = time.monotonic() + timeout_s
        while not pred():
            for s in active:
                s.poll()
            assert time.monotonic() < deadline
            time.sleep(0.01)

    try:
        for s in sups:
            s.boot()
        assert [s.federation.addr[1] for s in sups] == [b0, b1]
        poll_until(lambda: all(s.federation.rx_beacons for s in sups), sups)
        assert all(s.aggregate()["hosts"]["dead"] == [] for s in sups)
        for dead, watcher in ((1, 0), (0, 1)):
            sups[dead].federation.close()     # the host's beacon is gone
            poll_until(lambda: dead in sups[watcher]._dead_hosts_announced,
                       [sups[watcher]])
            agg = sups[watcher].aggregate()
            assert agg["hosts"]["dead"] == [dead]
            assert agg["health"]["state"] == "failed"
            assert f"hosts_dead:{dead}" in agg["health"]["reasons"]
            assert agg["failed_ranks"] == [] and agg["restarts"] == [0, 0]
            assert all(p.is_alive() for p in sups[watcher]._procs)
            sups[dead]._start_federation()     # revival: the host re-joins
            poll_until(lambda: not sups[watcher]._dead_hosts_announced, sups)
            assert sups[watcher].aggregate()["hosts"]["dead"] == []
    finally:
        for s in sups:
            s.close()
    lines = [ln for ln in capsys.readouterr().err.splitlines()
             if "DEAD" in ln]
    assert len(lines) == 2          # once per incident
    # the announcement is the reference's, word for word
    jsup = JSupervisor(tmp_path / "j", [{}, {}], entry=jstub,
                       net=_netspec([b0, b1], 0, **fast))
    jsup.federation = sups[0].federation
    jsup._announce_dead_host(1)
    assert capsys.readouterr().err.strip() == lines[0]
    assert tuning.NET_HOST_TIMEOUT_S == 5.0


def test_cli_cluster_two_hosts_on_loopback(tmp_path):
    """Two ``cli cluster --engines 1 --shards 1 --hosts A,B --host-id H
    --drain --device cpu`` processes (host 1 also ``--gossip-listen``):
    each serves its ring, finds its peer host's engine through the
    handshake, refuses no wire for its epoch, and reports the federation
    block (its own host id, its peer) in the aggregate."""
    b0, b1 = _free_bases(2, 1)
    hosts = f"127.0.0.1:{b0},127.0.0.1:{b1}"
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(_cfg(config).to_json())
    procs, offered = [], []
    for h in range(2):
        recs = _flood(B * 6, seed=31 + h)
        # stamped after the fleets' boots, well inside the epoch bound
        recs["ts_ns"] += np.uint64(time.clock_gettime_ns(
            time.CLOCK_MONOTONIC) + 20 * 10**9 - int(recs["ts_ns"][0]))
        base = str(tmp_path / f"ring{h}")
        _fill(ShmRing, base, recs, 1)
        offered.append(len(recs))
        argv = [sys.executable, "-m", "flowsentryx_tpu_torch.cli", "cluster",
                "--device", "cpu", "--drain", "--feature-ring", base,
                "--config", str(cfg_path), "--pin-cores", "on",
                "--engines", "1", "--shards", "1", "--hosts", hosts,
                "--host-id", str(h)]
        if h == 1:
            argv += ["--gossip-listen", f"127.0.0.1:{b1}"]
        procs.append(subprocess.Popen(argv, cwd=REPO, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
    outs = [p.communicate(timeout=240) for p in procs]
    for h, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, err[-4000:]
        assert f"host {h} of 2 (UDP gossip + federation beacons)" in err
        agg = json.loads(out)
        assert agg["failed_ranks"] == [] and agg["records"] == offered[h]
        assert agg["hosts"]["host_id"] == h
        assert list(agg["hosts"]["peers"]) == [str(1 - h)]
        [rep] = agg["reports"]
        net = rep["report"]["cluster"]["net"]
        assert (net["host"], net["rank"], net["peers"]) == (h, 0, 1)
        assert net["peers_seen"] == 1
        assert net["rx_dup"] == net["epoch_skew_dropped"] == 0


def test_multihost_drive_on_the_cpu(tmp_path, monkeypatch):
    """``chip_smoke.multihost_drive`` on the CPU at 2^12 rows, B=256: two
    loopback hosts of two rank processes each (one torch thread each),
    host 1 booted 2 s later; every gate of the card phase holds —
    records served, cross-host keys with the originator's canonical
    untils, both hosts' union digests equal, no duplicate or lying-epoch
    wire, host 1's death announced within the federation bound with the
    fleet FAILED and host 0's ranks alive."""
    from flowsentryx_tpu_torch.sync import tuning

    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    sys.path.insert(0, str(REPO))
    import chip_smoke

    cfg = config.FsxConfig(table=config.TableConfig(capacity=1 << 12),
                           batch=config.BatchConfig(max_batch=B))
    res = chip_smoke.multihost_drive(
        "cpu", str(tmp_path / "mh"), cfg,
        str(REPO / "artifacts" / "logreg_int8.npz"), batches=64,
        timeout_s=150)
    assert res["ok"], res["checks"]
    assert res["epoch_delta_s"] >= chip_smoke.MH_HOST_GAP_S
    assert res["death_to_announced_s"] <= (tuning.NET_HOST_TIMEOUT_S
                                           + tuning.NET_BEACON_INTERVAL_S)
    assert set(res["records"].values()) == {64 * B}
    assert res["digests"]["union_h0"] == res["digests"]["all_own"]
