"""The port's sharded ingest (spawned drain workers over ring shards,
sealed-batch queues, the engine's sealed loop) against the JAX package's.

Port and reference fleets drain identical shard rings and must seal the
same batches (header fields and payload bytes, per worker, in order);
one worker through the port's engine must be byte-equal to the inline
ring path; two workers through both engines give equal stats, blocked
sources and table rows; the external epoch, slot validation (a bad
magic, a seq gap, a poisoned slot) and a worker crash (strict and
fail-open) are counted or raised as the reference counts or raises
them.  Workers are real ``spawn`` processes; B = 256, capacity 2^14.
"""

import hashlib
import json
import platform
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from flowsentryx_tpu.core import config as jconfig
from flowsentryx_tpu.core import schema as jschema
from flowsentryx_tpu.core.config import BatchConfig as JBatchConfig
from flowsentryx_tpu.engine import ArraySource as JArraySource
from flowsentryx_tpu.engine import CollectSink as JCollectSink
from flowsentryx_tpu.engine import Engine as JEngine
from flowsentryx_tpu.engine import shm as jshm
from flowsentryx_tpu.engine.batcher import MicroBatcher as JMicroBatcher
from flowsentryx_tpu.ingest import ShardedIngest as JShardedIngest
from flowsentryx_tpu.models import logreg as jlogreg
from flowsentryx_tpu_torch import cli
from flowsentryx_tpu_torch.core import config, schema, wire
from flowsentryx_tpu_torch.engine import ArraySource, CollectSink, Engine
from flowsentryx_tpu_torch.engine import shm
from flowsentryx_tpu_torch.engine.batcher import MicroBatcher
from flowsentryx_tpu_torch.ingest import ShardedIngest, WorkerCrash
from flowsentryx_tpu_torch.models import logreg

REPO = Path(__file__).resolve().parents[1]
ARTIFACT = str(REPO / "artifacts" / "logreg_int8.npz")
B, CAP = 256, 1 << 14

pytestmark = pytest.mark.skipif(
    platform.machine() not in ("x86_64", "AMD64")
    or platform.system() != "Linux",
    reason="shm ingest needs x86-TSO and CLOCK_MONOTONIC (Linux)")

PKGS = {
    "port": (shm, ShardedIngest, Engine, CollectSink),
    "reference": (jshm, JShardedIngest, JEngine, JCollectSink),
}


def make_records(n, t0_ns=1_000_000_000, seed=0, n_ips=64):
    rng = np.random.default_rng(seed)
    rec = np.zeros(n, schema.FLOW_RECORD_DTYPE)
    pool = rng.integers(1, 1 << 24, n_ips).astype(np.uint32)
    rec["saddr"] = pool[rng.integers(0, n_ips, n)]
    rec["ts_ns"] = t0_ns + np.arange(n, dtype=np.uint64) * 1000
    rec["pkt_len"] = rng.integers(40, 1500, n)
    rec["ip_proto"] = 17
    rec["flags"] = schema.FLAG_UDP
    rec["feat"] = rng.integers(0, 1 << 20, (n, schema.NUM_FEATURES))
    return rec


def shard_rings(mod, base, rec, n_shards, capacity=1 << 14):
    """Ring shards at ``base`` holding ``rec`` split by ``shard_of``."""
    sh = schema.shard_of(rec["saddr"], n_shards)
    rings = []
    for k in range(n_shards):
        ring = mod.ShmRing.create(schema.shard_ring_path(base, k, n_shards),
                                  capacity, schema.FLOW_RECORD_DTYPE)
        part = rec[sh == k]
        assert ring.produce(part) == len(part)
        rings.append(ring)
    return rings


def handshake(ing, deadline_s=30.0):
    deadline = time.monotonic() + deadline_s
    while ing.t0_ns is None:
        ing.poll_batches(0)
        assert time.monotonic() < deadline, "t0 handshake never resolved"
        time.sleep(0.01)


def drain(ing, deadline_s=30.0):
    out = []
    deadline = time.monotonic() + deadline_s
    while not ing.exhausted():
        got = ing.poll_batches(8)
        out.extend(got)
        if not got:
            assert time.monotonic() < deadline, "fleet never drained"
            time.sleep(0.005)
    return out + ing.poll_batches(64)


def fleet(pkg, base, n, wire_name, quant=None, max_batch=B, **kw):
    ing = PKGS[pkg][1](base, n, queue_slots=16, precompact=False,
                       t0_grace_s=0.2, **kw)
    ing.start(JBatchConfig(max_batch=max_batch, deadline_us=50_000),
              wire_name, quant)
    ing.wait_ready()
    return ing


def _quant():
    return schema.wire_quant_for(logreg.LogRegParams(
        **logreg.params_to_numpy(logreg.load_params(ARTIFACT))))


@pytest.mark.parametrize("n_workers", [1, 2])
@pytest.mark.parametrize("wire_name", [wire.WIRE_RAW48, wire.WIRE_COMPACT16])
def test_fleet_seals_like_reference(tmp_path, n_workers, wire_name):
    """Port and reference fleets over identical shard rings seal the
    same batches: per worker, in seq order, the same header fields
    (seq, records, wire id) and payload bytes, partial tails included."""
    rec = make_records(B * 5 + 77, seed=n_workers)
    quant = _quant() if wire_name == wire.WIRE_COMPACT16 else None
    got = {}
    for pkg in ("port", "reference"):
        base = str(tmp_path / f"{pkg}_ring")
        shard_rings(PKGS[pkg][0], base, rec, n_workers)
        ing = fleet(pkg, base, n_workers, wire_name, quant)
        try:
            handshake(ing)
            ing.request_stop()
            batches = drain(ing)
        finally:
            ing.close()
        per = {k: [(sb.seq, sb.n_records, sb.raw.tobytes())
                   for sb in sorted(batches, key=lambda s: s.seq)
                   if sb.worker == k] for k in range(n_workers)}
        stats = ing.ingest_stats()
        got[pkg] = (ing.t0_ns, per, {
            k: {f: w[f] for f in ("batches", "records", "seq_gaps",
                                  "seq_missing", "bad_wire_slots", "dead")}
            for k, w in stats["workers"].items()})
    assert got["port"] == got["reference"]
    per = got["port"][1]
    assert sum(n for w in per.values() for _, n, _ in w) == len(rec)


def _engine_cfgs(**batch):
    t = dict(capacity=CAP, salt=0x1CE)
    bt = dict(max_batch=B, deadline_us=50_000, readback_depth=4, **batch)
    lim = dict(pps_threshold=200.0, bps_threshold=1e9)
    return (jconfig.FsxConfig(limiter=jconfig.LimiterConfig(**lim),
                              table=jconfig.TableConfig(**t),
                              batch=jconfig.BatchConfig(**bt)),
            config.FsxConfig(limiter=config.LimiterConfig(**lim),
                             table=config.TableConfig(**t),
                             batch=config.BatchConfig(**bt)))


def _flood(n, seed=13):
    from flowsentryx_tpu_torch.engine import Scenario, TrafficGen, TrafficSpec

    return TrafficGen(TrafficSpec(
        scenario=Scenario.UDP_FLOOD_MULTI, rate_pps=1e7, n_attack_ips=8,
        n_benign_ips=24, attack_fraction=0.8, seed=seed)).next_records(n)


def serve_sealed(pkg, base, rec, n_workers, cfg, params, queue_slots=16,
                 wire_name=None, **eng_kw):
    """Serve ``rec`` through ``n_workers`` real workers over ring shards
    at ``base`` with one package's engine (drain-on-stop, until the
    fleet is exhausted); returns the report, the sink and the engine."""
    mod, ing_cls, eng_cls, sink_cls = PKGS[pkg]
    shard_rings(mod, base, rec, n_workers)
    src = ing_cls(base, n_workers, queue_slots=queue_slots,
                  precompact=False, t0_grace_s=0.2, strict=True)
    sink = sink_cls()
    kw = ({"device": "cpu"} if pkg == "port" else {"sink_thread": False})
    if wire_name is not None:
        kw["wire"] = wire_name
    try:
        e = eng_cls(cfg, src, sink, params=params, **kw, **eng_kw)
        e.warm()
        handshake(src)
        src.request_stop()
        rep = e.run()
    finally:
        src.close()
    return rep, sink, e


def _rows(e, port: bool):
    """The table as ``{key: state row bits}`` (position-free)."""
    if port:
        key, state = schema.table_to_numpy(e.table)
    else:
        key, state = np.asarray(e.table.key), np.asarray(e.table.state)
    occ = key != 0
    return dict(zip(key[occ].tolist(),
                    (r.tobytes() for r in state[occ].view(np.uint32))))


def _digest(e):
    k, st = schema.table_to_numpy(e.table)
    return hashlib.sha256(k.tobytes() + st.tobytes()).hexdigest()


@pytest.mark.parametrize("wire_name", [wire.WIRE_COMPACT16, wire.WIRE_RAW48])
def test_one_worker_is_byte_equal_to_inline(tmp_path, wire_name):
    """The acceptance gate of the ingest path: one worker keeps the
    record order and the batch composition, so stats, the blacklist with
    until-times, the table bytes and the batch count equal the inline
    engine's (port and reference) on the same stream."""
    jcfg, tcfg = _engine_cfgs()
    rec = _flood(B * 8)
    rep1, sink1, e1 = serve_sealed(
        "port", str(tmp_path / "r"), rec, 1, tcfg,
        logreg.load_params(ARTIFACT), wire_name=wire_name)
    e0 = Engine(tcfg, ArraySource(rec.copy()), CollectSink(),
                params=logreg.load_params(ARTIFACT), device="cpu",
                wire=wire_name)
    rep0 = e0.run()
    je = JEngine(jcfg, JArraySource(rec.copy()), JCollectSink(),
                 params=jlogreg.load_params(ARTIFACT), sink_thread=False,
                 wire=wire_name)
    jrep = je.run()
    assert rep1.records == rep0.records == jrep.records == len(rec)
    assert rep1.batches == rep0.batches == jrep.batches == 8
    assert rep1.stats == rep0.stats == jrep.stats
    assert sink1.blocked == e0.sink.blocked == je.sink.blocked
    assert sink1.blocked                      # blocks were exercised
    assert _digest(e1) == _digest(e0)
    assert rep1.ingest["n_workers"] == 1
    assert rep1.ingest["workers"]["0"]["seq_gaps"] == 0
    assert rep1.ingest["workers"]["0"]["batches"] == 8
    assert rep1.dispatch["arena"]["group_max"] == 4


def test_two_workers_match_reference_engine(tmp_path):
    """Two workers through each package's engine: the interleaving of
    the two workers' batches is timing-dependent, but no flow spans two
    shards, so stats, the blacklist and each flow's table row agree."""
    jcfg, tcfg = _engine_cfgs()
    rec = _flood(B * 10, seed=3)
    rep, sink, e = serve_sealed("port", str(tmp_path / "t"), rec, 2, tcfg,
                                logreg.load_params(ARTIFACT))
    jrep, jsink, je = serve_sealed("reference", str(tmp_path / "j"), rec, 2,
                                   jcfg, jlogreg.load_params(ARTIFACT))
    assert rep.records == jrep.records == len(rec)
    assert rep.batches == jrep.batches
    assert rep.stats == jrep.stats
    assert set(sink.blocked) == set(jsink.blocked) and sink.blocked
    assert _rows(e, True) == _rows(je, False)
    for k in ("0", "1"):
        w, jw = rep.ingest["workers"][k], jrep.ingest["workers"][k]
        assert (w["batches"], w["records"], w["seq_gaps"]) == (
            jw["batches"], jw["records"], jw["seq_gaps"]) == (
            w["batches"], w["records"], 0)


def test_slot_reuse_under_live_overwrite(tmp_path):
    """A 2-slot queue and 16 batches: every queue slot is reused by the
    live worker many times while earlier batches are still in flight —
    the engine released each slot right after staging it into the
    arena, so the worker's overwrites race real dispatches.  The run
    stays byte-equal to the inline path."""
    _, tcfg = _engine_cfgs()
    rec = _flood(B * 16, seed=8)
    rep1, sink1, e1 = serve_sealed(
        "port", str(tmp_path / "r"), rec, 1, tcfg,
        logreg.load_params(ARTIFACT), queue_slots=2)
    e0 = Engine(tcfg, ArraySource(rec.copy()), CollectSink(),
                params=logreg.load_params(ARTIFACT), device="cpu")
    rep0 = e0.run()
    assert rep1.batches == rep0.batches == 16
    assert rep1.stats == rep0.stats and sink1.blocked == e0.sink.blocked
    assert _digest(e1) == _digest(e0)


def test_mega_auto_over_sealed_batches_equals_singles(tmp_path):
    _, tcfg = _engine_cfgs()
    rec = _flood(B * 12, seed=4)
    repa, sinka, ea = serve_sealed(
        "port", str(tmp_path / "a"), rec, 1, tcfg,
        logreg.load_params(ARTIFACT), mega_n="auto")
    e0 = Engine(tcfg, ArraySource(rec.copy()), CollectSink(),
                params=logreg.load_params(ARTIFACT), device="cpu")
    rep0 = e0.run()
    assert repa.stats == rep0.stats and sinka.blocked == e0.sink.blocked
    assert _digest(ea) == _digest(e0)
    hist = {int(g): n for g, n in repa.dispatch["group_hist"].items()}
    assert sum(g * n for g, n in hist.items()) == 12


def test_engine_t0_reaches_the_fleet_before_the_handshake(tmp_path):
    """An explicit epoch (``Engine(t0_ns=...)``, or a restored
    checkpoint's) is imposed on the fleet by ``set_t0`` before its
    first-timestamp handshake."""
    _, tcfg = _engine_cfgs()
    rec = _flood(B * 3, seed=2)
    epoch = int(rec["ts_ns"].min()) - 12_345
    base = str(tmp_path / "r")
    shard_rings(shm, base, rec, 1)
    src = ShardedIngest(base, 1, precompact=False, t0_grace_s=0.2)
    try:
        e = Engine(tcfg, src, CollectSink(), device="cpu", t0_ns=epoch)
        src.request_stop()
        rep = e.run()
    finally:
        src.close()
    assert src.t0_ns == epoch == e.batcher.t0_ns
    assert rep.records == len(rec)


@pytest.mark.parametrize("pkg", ["port", "reference"])
def test_external_t0_before_and_after_handshake(tmp_path, pkg):
    rec = make_records(512)
    base = str(tmp_path / "r")
    mod = PKGS[pkg][0]
    rings = [mod.ShmRing.create(schema.shard_ring_path(base, k, 2), 1 << 12,
                                schema.FLOW_RECORD_DTYPE) for k in range(2)]
    ing = fleet(pkg, base, 2, wire.WIRE_RAW48)
    try:
        with pytest.raises(ValueError, match="positive"):
            ing.set_t0(0)
        epoch = int(rec["ts_ns"].min()) - 999
        ing.set_t0(epoch)
        sh = schema.shard_of(rec["saddr"], 2)
        for k, ring in enumerate(rings):
            ring.produce(rec[sh == k])
        ing.request_stop()
        batches = drain(ing)
        assert ing.t0_ns == epoch      # not overwritten by the handshake
        assert sum(sb.n_records for sb in batches) == len(rec)
        with pytest.raises(RuntimeError, match="already resolved"):
            ing.set_t0(epoch + 1)
        ing.set_t0(epoch)              # the same epoch: a no-op
    finally:
        ing.close()


def _sealed_fleet(pkg, tmp_path, n_batches=4, **kw):
    base = str(tmp_path / f"{pkg}_r")
    rec = make_records(B * n_batches)
    shard_rings(PKGS[pkg][0], base, rec, 1)
    ing = fleet(pkg, base, 1, wire.WIRE_RAW48, **kw)
    handshake(ing)
    q = ing._queues[0]
    deadline = time.monotonic() + 30
    while q.readable() < n_batches:
        assert time.monotonic() < deadline, "fleet never sealed"
        time.sleep(0.005)
    return ing, q, rec


def _cell(q, back):
    return q._cells[(int(q._tail[0]) + back) & (q.slots - 1)]


def _corrupt_and_drain(pkg, tmp_path, how, **kw):
    ing, q, rec = _sealed_fleet(pkg, tmp_path, **kw)
    try:
        lost = how(q)
        ing.request_stop()
        batches = drain(ing)
    finally:
        ing.close()
    st = ing.ingest_stats()
    w = st["workers"]["0"]
    return (sum(sb.n_records for sb in batches), lost, len(rec),
            st["bad_wire_slots"], st["quarantined_batches"],
            st["quarantined_records"], w["seq_gaps"], w["seq_missing"],
            w["dead"]), st


def _bad_magic(q):
    cell = _cell(q, 0)
    cell[schema.BATCHQ_WIRE_ID_WORD] = 0xDEAD
    return int(cell[schema.BATCHQ_N_RECORDS_WORD])


def _seq_jump(q):
    cell = _cell(q, 2)
    seq = (int(cell[schema.BATCHQ_SEQ_LO_WORD])
           | int(cell[schema.BATCHQ_SEQ_HI_WORD]) << 32) + 5
    cell[schema.BATCHQ_SEQ_LO_WORD] = seq & 0xFFFFFFFF
    cell[schema.BATCHQ_SEQ_HI_WORD] = seq >> 32
    return 0


def _poison(q):
    cell = _cell(q, 1)
    bad = B + 9
    cell[schema.BATCHQ_N_RECORDS_WORD] = bad
    cell[schema.BATCHQ_SLOT_HDR_WORDS + B * schema.RECORD_WORDS] = bad
    return B


@pytest.mark.parametrize("how", [_bad_magic, _seq_jump, _poison],
                         ids=["bad_magic", "seq_gap", "poisoned_meta"])
def test_slot_validation_counts_as_reference(tmp_path, how):
    """The same corruption of a sealed slot in each package's queue: a
    bad wire-id magic is skipped and counted (the next good slot shows
    the seq hole), a seq jump is counted and served, a poisoned metadata
    row is quarantined (and spooled); the counters and the records
    served agree with the reference."""
    got, st = _corrupt_and_drain("port", tmp_path, how,
                                 quarantine_dir=str(tmp_path / "spool"))
    want, _ = _corrupt_and_drain("reference", tmp_path, how,
                                 quarantine_dir=str(tmp_path / "jspool"))
    assert got == want
    served, lost, total = got[:3]
    assert served + lost == total and not got[-1]
    if how is _poison:
        dumps = list((tmp_path / "spool").glob("quarantine_*.npy"))
        assert len(dumps) == 1 == st["quarantine_dumps"]
        np.testing.assert_array_equal(
            np.load(dumps[0]),
            np.load(next((tmp_path / "jspool").glob("quarantine_*.npy"))))
        assert np.load(dumps[0]).shape == (B + 1, schema.RECORD_WORDS)


@pytest.mark.parametrize("strict", [False, True])
def test_worker_crash(tmp_path, strict):
    """Kill worker 0 mid-stream.  Fail-open (the default): the other
    shard keeps serving to its last record and the death is reported.
    Strict: once the dead worker's queue is drained, the next poll
    raises :class:`WorkerCrash` on the dispatch side."""
    base = str(tmp_path / "r")
    rec = make_records(B * 4)
    sh = schema.shard_of(rec["saddr"], 2)
    parts = [rec[sh == k] for k in range(2)]
    rings = [shm.ShmRing.create(schema.shard_ring_path(base, k, 2), 1 << 12,
                                schema.FLOW_RECORD_DTYPE) for k in range(2)]
    for ring, part in zip(rings, parts):
        ring.produce(part[: len(part) // 2])
    ing = fleet("port", base, 2, wire.WIRE_RAW48, strict=strict)
    try:
        handshake(ing)
        ing._procs[0].terminate()
        ing._procs[0].join(timeout=10)
        rings[1].produce(parts[1][len(parts[1]) // 2:])
        ing.request_stop()
        if strict:
            with pytest.raises(WorkerCrash, match="worker 0 crashed"):
                drain(ing)
            assert ing._queues[0].readable() == 0   # drained first
            return
        batches = drain(ing)
    finally:
        ing.close()
    st = ing.ingest_stats()
    assert st["dead_workers"] == [0] and st["crashed"]
    assert not st["workers"]["1"]["dead"]
    assert sum(sb.n_records for sb in batches if sb.worker == 1) == len(
        parts[1])


def test_worker_import_closure_has_no_torch():
    """A spawned worker imports the worker module, the wire layout, the
    config, the batcher and the shm transport: none of them torch, so a
    worker boots fast and cannot initialise CUDA."""
    code = ("import sys\n"
            "import flowsentryx_tpu_torch.ingest.worker as w\n"
            "import flowsentryx_tpu_torch.ingest\n"
            "from flowsentryx_tpu_torch.core import wire, config\n"
            "from flowsentryx_tpu_torch.engine import batcher, shm\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'jax', 'flowsentryx_tpu')]\n"
            "assert not bad, bad\n"
            "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def test_on_seal_keeps_two_buffers_intact():
    """One drain of two batches' worth onto a partly filled batch: with
    ``on_seal`` every sealed buffer is handed over before its buffer is
    refilled.  The reference's worker collects the sealed buffers first,
    and with two buffers the first one's leading rows are overwritten
    before it is enqueued (ROADMAP queue 3, item 14)."""
    rec = make_records(100, n_ips=100)
    rec["saddr"] = np.arange(1, 101)
    bt = dict(max_batch=8, verdict_k=0)
    port = MicroBatcher(config.BatchConfig(**bt), n_buffers=2,
                        wire=wire.WIRE_RAW48)
    ref = JMicroBatcher(JBatchConfig(**bt), n_buffers=2,
                        wire=jschema.WIRE_RAW48)
    got = []
    port.add(rec[:3], on_seal=lambda b: got.append(b[:8, 2].copy()))
    port.add(rec[3:19], on_seal=lambda b: got.append(b[:8, 2].copy()))
    assert [list(g) for g in got] == [list(range(1, 9)), list(range(9, 17))]
    ref.add(rec[:3])
    out = ref.add(rec[3:19])
    assert list(out[0][:8, 2]) == [17, 18, 19, 4, 5, 6, 7, 8]   # torn


def test_cli_serves_feature_ring_through_workers(tmp_path, capsys):
    """``serve --feature-ring F --verdict-ring V --ingest-workers 1
    --strict-ingest`` on the CPU: the report carries the ingest block,
    and the refusals fire before boot."""
    rec = _flood(2048 * 3, seed=6)
    fpath, vpath = str(tmp_path / "f"), str(tmp_path / "v")
    shm.ShmRing.create(fpath, 1 << 13, schema.FLOW_RECORD_DTYPE).produce(rec)
    shm.ShmRing.create(vpath, 1 << 12, schema.VERDICT_RECORD_DTYPE)
    rc = cli.main(["serve", "--device", "cpu", "--table-capacity", "4096",
                   "--feature-ring", fpath, "--verdict-ring", vpath,
                   "--ingest-workers", "1", "--strict-ingest",
                   "--batches", "3", "--json"])
    assert rc == 0
    rep = json.loads(
        capsys.readouterr().out.strip().splitlines()[-1])
    assert rep["batches"] == 3 and rep["records"] == 3 * 2048
    assert rep["ingest"]["n_workers"] == 1 and rep["ingest"]["strict"]
    for argv, msg in (
            (["--ingest-workers", "2"], "requires --feature-ring"),
            (["--strict-ingest"], "requires --ingest-workers"),
            (["--quarantine-dir", "q"], "requires --ingest-workers"),
            (["--ingest-workers", "-1"], "must be >= 0"),
            (["--checkpoint-every", "5"], "requires --checkpoint"),
            (["--verdict-ring", vpath], "requires --feature-ring")):
        assert cli.main(["serve", "--device", "cpu"] + argv) == 1
        assert msg in capsys.readouterr().err


@pytest.mark.parametrize("pkg", ["port", "reference"])
def test_idle_policy_and_timeouts_reach_the_fleet(tmp_path, pkg):
    """``spin_us``, ``idle_us``, ``timeout_s`` and
    ``heartbeat_timeout_s`` are the fleet's parameters: the idle policy
    is in each queue's ctl block before its worker spawns, and both
    packages hold the same values (and refuse a negative one alike)."""
    base = str(tmp_path / "r")
    shard_rings(shm, base, make_records(64), 2)
    ing = fleet(pkg, base, 2, wire.WIRE_RAW48, spin_us=7, idle_us=11,
                timeout_s=3.5, heartbeat_timeout_s=0.25)
    try:
        assert (ing.spin_us, ing.idle_us) == (7, 11)
        assert (ing.timeout_s, ing.heartbeat_timeout_s) == (3.5, 0.25)
        for q in ing._queues:
            assert q.ctl_get("spin_us") == 7 and q.ctl_get("idle_us") == 11
    finally:
        ing.request_stop()
        ing.close()
    cls = PKGS[pkg][1]
    for kw in ({"spin_us": -1}, {"idle_us": -1}):
        with pytest.raises(ValueError, match="spin_us/idle_us must be >= 0"):
            cls(base, 2, precompact=False, **kw)


def test_spin_auto_matches_reference(tmp_path, monkeypatch):
    """``spin_us=None`` is AUTO in both packages: the spin budget only
    where the host has a core for each worker, the engine and a spare."""
    import os

    base = str(tmp_path / "r")
    shard_rings(shm, base, make_records(64), 2)
    for cpus in (2, 3, 4, 16):
        monkeypatch.setattr(os, "sched_getaffinity",
                            lambda _pid, n=cpus: set(range(n)))
        port = ShardedIngest(base, 2, precompact=False)
        ref = JShardedIngest(base, 2, precompact=False)
        assert port.spin_us == ref.spin_us
        assert port.idle_us == ref.idle_us == 200
        assert (port.timeout_s, port.heartbeat_timeout_s) == (
            ref.timeout_s, ref.heartbeat_timeout_s)
    assert port.spin_us > 0
