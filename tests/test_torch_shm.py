"""The port's shared-memory transport against the JAX package's.

The ring and queue layout constants and record dtypes (the contract with
the C++ daemon, ``kern/fsx_schema.h``), rings written by one package and
read by the other across the index wrap, backpressure, the sealed-batch
queue's peek/release views, and the inline ring path of both engines
over the same ring contents: 48-byte records through compact16 with
``artifacts/logreg_int8.npz``, through raw48 with
``artifacts/mlp_robust.npz`` and the eviction sweep, and 16-byte
compact-emit records with ``CLOCK_MONOTONIC`` pinned.  Stats, blocked
sources with their until-times, the table (every column by its bits)
and the verdict-ring records must be equal.  Small shapes (B = 256,
capacity 2^12); all records from a seed.
"""

import platform
import re
import time
from pathlib import Path

import numpy as np
import pytest

from flowsentryx_tpu.core import config as jconfig
from flowsentryx_tpu.core import schema as jschema
from flowsentryx_tpu.engine import Engine as JEngine
from flowsentryx_tpu.engine import shm as jshm
from flowsentryx_tpu.engine.traffic import Scenario as JScenario
from flowsentryx_tpu.engine.traffic import TrafficGen as JTrafficGen
from flowsentryx_tpu.engine.traffic import TrafficSpec as JTrafficSpec
from flowsentryx_tpu.models import logreg as jlogreg
from flowsentryx_tpu.models import mlp as jmlp
from flowsentryx_tpu_torch.core import config, schema, wire
from flowsentryx_tpu_torch.engine import Engine
from flowsentryx_tpu_torch.engine import shm
from flowsentryx_tpu_torch.models import logreg, mlp

REPO = Path(__file__).resolve().parents[1]
ART = REPO / "artifacts"
B, CAP, N_BATCHES = 256, 1 << 12, 6

pytestmark = pytest.mark.skipif(
    platform.machine() not in ("x86_64", "AMD64")
    or platform.system() != "Linux",
    reason="the shm cursor protocol needs x86-TSO on Linux")

CONSTANTS = [
    "SHM_MAGIC", "SHM_HDR_SIZE", "SHM_CAPACITY_OFFSET",
    "SHM_RECORD_SIZE_OFFSET", "SHM_HEAD_OFFSET", "SHM_TAIL_OFFSET",
    "SHM_BATCHQ_MAGIC", "SHM_HBEAT_OFFSET", "SHM_FIRST_TS_OFFSET",
    "SHM_T0_OFFSET", "SHM_STOP_OFFSET", "SHM_WSTATE_OFFSET",
    "SHM_EMIT_DROP_OFFSET", "SHM_SPIN_US_OFFSET", "SHM_IDLE_US_OFFSET",
    "WSTATE_SPAWNING", "WSTATE_RUNNING", "WSTATE_DONE", "WSTATE_FAILED",
    "BATCHQ_SLOT_HDR_WORDS", "BATCHQ_SEQ_LO_WORD", "BATCHQ_SEQ_HI_WORD",
    "BATCHQ_N_RECORDS_WORD", "BATCHQ_WIRE_ID_WORD",
    "BATCHQ_SEAL_NS_LO_WORD", "BATCHQ_SEAL_NS_HI_WORD",
    "BATCHQ_FILL_DUR_US_WORD", "BATCHQ_RESERVED_WORD", "WIRE_ID_RAW48",
    "WIRE_ID_COMPACT16", "COMPACT_RECORD_SIZE", "VERDICT_RECORD_SIZE",
    "FLOW_RECORD_SIZE", "RECORD_WORDS", "COMPACT_RECORD_WORDS",
    "RANGE_DEPLOY_HORIZON_S", "RANGE_DT_US_MAX", "FLAG_IPV6",
    "FLAG_TCP_SYN", "FLAG_TCP", "FLAG_UDP", "FLAG_ICMP",
]


@pytest.mark.parametrize("name", CONSTANTS)
def test_constant_equals_reference(name):
    assert getattr(wire, name) == getattr(jschema, name)
    assert getattr(schema, name) == getattr(jschema, name)  # re-exported


@pytest.mark.parametrize("name", ["FLOW_RECORD_DTYPE", "COMPACT_RECORD_DTYPE",
                                  "VERDICT_RECORD_DTYPE"])
def test_record_dtype_equals_reference(name):
    assert getattr(wire, name) == getattr(jschema, name)
    assert getattr(wire, name).itemsize == getattr(jschema, name).itemsize


def test_c_header_agrees():
    """``kern/fsx_schema.h`` (what the daemon compiles against): the
    ring magic, and the header's u64 words put head at 64, tail at 128
    and the records at 192."""
    h = (REPO / "kern" / "fsx_schema.h").read_text()
    assert int(re.search(r"#define FSX_SHM_MAGIC (0x[0-9A-F]+)ULL",
                         h).group(1), 16) == wire.SHM_MAGIC
    body = re.search(r"struct fsx_shm_ring_hdr \{(.*?)\}", h, re.S).group(1)
    offs, at = {}, 0
    for name, n in re.findall(r"__u64 (\w+)(?:\[(\d+)\])?;", body):
        offs[name] = at
        at += 8 * int(n or 1)
    assert (offs["head"], offs["tail"], at) == (
        wire.SHM_HEAD_OFFSET, wire.SHM_TAIL_OFFSET, wire.SHM_HDR_SIZE)
    assert offs["capacity"] == wire.SHM_CAPACITY_OFFSET
    assert offs["record_size"] == wire.SHM_RECORD_SIZE_OFFSET


def test_host_helpers_equal_reference():
    rng = np.random.default_rng(3)
    saddr = rng.integers(0, 1 << 32, 4096, dtype=np.uint64).astype(np.uint32)
    for n in (1, 2, 3, 8, 64):
        np.testing.assert_array_equal(wire.shard_of(saddr, n),
                                      jschema.shard_of(saddr, n))
        for k in range(min(n, 3)):
            assert (wire.shard_ring_path("/r", k, n)
                    == jschema.shard_ring_path("/r", k, n))
    w3 = rng.integers(0, 1 << 32, 4096, dtype=np.uint64).astype(np.uint32)
    for now in (0, 65_535_999, 10 ** 12 + 12_345, 2 ** 62 + 7):
        np.testing.assert_array_equal(wire.unwrap_kernel_ts16(w3, now),
                                      jschema.unwrap_kernel_ts16(w3, now))
    for w in (wire.WIRE_RAW48, wire.WIRE_COMPACT16):
        assert wire.wire_id_of(w) == jschema.wire_id_of(w)


def _records(n, seed=0):
    return JTrafficGen(JTrafficSpec(scenario=JScenario.MIXED_L34_1M,
                                    rate_pps=1e6, seed=seed)).next_records(n)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_ring_cross_package_across_wraparound(tmp_path, writer):
    """One package produces, the other consumes, through a 64-slot ring
    over 1,000 records (15 wraps), in uneven chunks."""
    prod_mod, cons_mod = (jshm, shm) if writer == "reference" else (shm, jshm)
    path = tmp_path / "ring"
    prod = prod_mod.ShmRing.create(path, 64, jschema.FLOW_RECORD_DTYPE)
    cons = cons_mod.ShmRing(path, jschema.FLOW_RECORD_DTYPE)
    rec = _records(1000)
    got, sent, rng = [], 0, np.random.default_rng(1)
    while sent < len(rec) or cons.readable():
        sent += prod.produce(rec[sent:sent + int(rng.integers(1, 50))])
        c = cons.consume(int(rng.integers(1, 40)))
        if len(c):
            got.append(c)
    np.testing.assert_array_equal(np.concatenate(got), rec)
    assert int(cons._tail[0]) == int(prod._head[0]) == len(rec)


def test_ring_backpressure_and_peek(tmp_path):
    path = tmp_path / "ring"
    ring = shm.ShmRing.create(path, 16, wire.FLOW_RECORD_DTYPE)
    rec = _records(40)
    assert ring.produce(rec) == 16          # full: the rest is refused
    assert ring.produce(rec[16:]) == 0
    views, n = ring.peek(10)
    assert n == 10 and sum(len(v) for v in views) == 10
    ring.advance(6)
    assert ring.readable() == 10
    assert ring.produce(rec[16:]) == 6      # 6 slots freed, 6 written
    np.testing.assert_array_equal(ring.consume(100),
                                  np.concatenate([rec[6:16], rec[16:22]]))
    with pytest.raises(ValueError, match="record size"):
        shm.ShmRing(path, wire.VERDICT_RECORD_DTYPE)
    with pytest.raises(ValueError, match="power of two"):
        shm.ShmRing.create(tmp_path / "bad", 12, wire.FLOW_RECORD_DTYPE)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_sealed_queue_cross_package_peek_release(tmp_path, writer):
    """Sealed batches through a 4-slot queue, 11 of them: headers and
    payloads read back equal through the other package's peek views
    (staged before release) and copying consume."""
    prod_mod, cons_mod = (jshm, shm) if writer == "reference" else (shm, jshm)
    words = 3 * 4
    q = prod_mod.SealedBatchQueue.create(tmp_path / "q", 4, words)
    cons = cons_mod.SealedBatchQueue(tmp_path / "q", words)
    sent, seen = 0, 0
    while sent < 11 or cons.readable():
        if sent < 11 and q.produce_batch(
                np.arange(words, dtype=np.uint32) + 1000 * sent,
                seq=sent + 1, n_records=sent, wire_id=1,
                seal_ns=10 ** 9 + sent, fill_dur_us=7 * sent):
            sent += 1
        for hdr, view in cons.peek_batches(2):
            staged = view.copy()
            hdr_c, payload = cons.consume_batch()
            np.testing.assert_array_equal(hdr, hdr_c)
            np.testing.assert_array_equal(staged, payload)
            assert int(hdr[wire.BATCHQ_SEQ_LO_WORD]) == seen + 1
            assert int(hdr[wire.BATCHQ_FILL_DUR_US_WORD]) == 7 * seen
            assert int(payload[0]) == 1000 * seen
            seen += 1
    assert seen == 11
    with pytest.raises(ValueError, match="payload"):
        cons_mod.SealedBatchQueue(tmp_path / "q", words + 1)


def test_sealed_queue_mutate_after_release(tmp_path):
    """Stage BEFORE release: a producer overwrite of a released slot
    never reaches the staged copy, while the released view (dead) shows
    the new bytes."""
    q = shm.SealedBatchQueue.create(tmp_path / "q", 2, 8)
    cons = shm.SealedBatchQueue(tmp_path / "q", 8)

    def push(tag, seq):
        return q.produce_batch(np.full(8, tag, np.uint32), seq=seq,
                               n_records=1, wire_id=0, seal_ns=1,
                               fill_dur_us=0)

    assert push(0xAAAA, 1) and push(0xBBBB, 2)
    assert not push(0xCCCC, 3)              # full: backpressure
    view_a = cons.peek_batches(2)[0][1]
    staged = np.empty_like(view_a)
    staged[:] = view_a                      # the one staging copy
    cons.release(1)
    assert push(0xCCCC, 3)                  # overwrites slot A
    np.testing.assert_array_equal(staged, np.full(8, 0xAAAA, np.uint32))
    (_, view_b), (_, view_c) = cons.peek_batches(2)
    assert int(view_b[0]) == 0xBBBB and int(view_c[0]) == 0xCCCC
    assert int(view_a[0]) == 0xCCCC
    q.ctl_set("t0", 123)
    assert cons.ctl_get("t0") == 123 and cons.ctl_get("stop") == 0


def test_non_tso_host_raises(tmp_path, monkeypatch):
    """The plain-store cursor protocol is only correct on x86-TSO:
    elsewhere the ring refuses to open instead of corrupting quietly."""
    monkeypatch.setattr(shm.platform, "machine", lambda: "aarch64")
    with pytest.raises(RuntimeError, match="x86-TSO"):
        shm.ShmRing.create(tmp_path / "r", 16, wire.FLOW_RECORD_DTYPE)
    with pytest.raises(RuntimeError, match="x86-TSO"):
        shm.SealedBatchQueue.create(tmp_path / "q", 2, 8)


# -- the inline ring path of both engines -----------------------------------


def _cfgs(model="logreg_int8", table=None, limiter=None):
    t = dict(capacity=CAP, salt=0x5EED, **(table or {}))
    bt = dict(max_batch=B, deadline_us=50_000)
    lim = dict(pps_threshold=200.0, bps_threshold=1e9, **(limiter or {}))
    return (jconfig.FsxConfig(limiter=jconfig.LimiterConfig(**lim),
                              model=jconfig.ModelConfig(name=model),
                              table=jconfig.TableConfig(**t),
                              batch=jconfig.BatchConfig(**bt)),
            config.FsxConfig(limiter=config.LimiterConfig(**lim),
                             model=config.ModelConfig(name=model),
                             table=config.TableConfig(**t),
                             batch=config.BatchConfig(**bt)))


def _flood(n, seed=13):
    return JTrafficGen(JTrafficSpec(
        scenario=JScenario.UDP_FLOOD_MULTI, rate_pps=1e7, n_attack_ips=16,
        n_benign_ips=48, attack_fraction=0.8, seed=seed)).next_records(n)


def _kernel_compact(rec, now_ns):
    """48-byte records as the compact-emit kernel writes them: minifloat
    features, length in 8-byte units, flags, and the low 16 bits of the
    µs clock, the last record stamped ``now_ns``."""
    out = np.zeros(len(rec), wire.COMPACT_RECORD_DTYPE)
    q = wire.quantize_feat_minifloat(rec["feat"])
    out["w0"] = rec["saddr"]
    out["w1"] = q[:, 0] | q[:, 1] << 8 | q[:, 2] << 16 | q[:, 3] << 24
    out["w2"] = q[:, 4] | q[:, 5] << 8 | q[:, 6] << 16 | q[:, 7] << 24
    len8 = np.minimum((rec["pkt_len"].astype(np.uint32) + 4) >> 3, 2047)
    ts = (np.uint64(now_ns) - (rec["ts_ns"][-1] - rec["ts_ns"])) // 1000
    out["w3"] = (len8 | (rec["flags"].astype(np.uint32) & 0x1F) << 11
                 | (ts & np.uint64(0xFFFF)).astype(np.uint32) << 16)
    return out


def _serve_ring(pkg, cfg, params, rec, tmp_path, label):
    """Serve ``rec`` written into a fresh feature ring through one
    package's engine, blocks into a fresh verdict ring; returns the
    report, the table (host) and the verdict-ring records."""
    mod, eng_cls = (jshm, JEngine) if pkg == "reference" else (shm, Engine)
    fpath, vpath = tmp_path / f"{label}.f", tmp_path / f"{label}.v"
    ring = mod.ShmRing.create(fpath, 1 << 13, rec.dtype)
    assert ring.produce(rec) == len(rec)
    vring = mod.ShmRing.create(vpath, 1 << 12, jschema.VERDICT_RECORD_DTYPE)
    src, sink = mod.ShmRingSource(fpath), mod.ShmVerdictSink(vpath)
    kw = ({"sink_thread": False} if pkg == "reference"
          else {"device": "cpu"})
    e = eng_cls(cfg, src, sink, params=params, **kw)
    rep = e.run(max_batches=N_BATCHES)
    if pkg == "reference":
        key, state = np.asarray(e.table.key), np.asarray(e.table.state)
    else:
        key, state = schema.table_to_numpy(e.table)
    assert sink.dropped == 0
    return rep, key, state.view(np.uint32), vring.consume(1 << 12), e


def _assert_same(ref, port):
    jr, jk, js, jv, _ = ref
    tr, tk, ts, tv, _ = port
    assert tr.batches == jr.batches == N_BATCHES
    assert tr.records == jr.records == N_BATCHES * B
    assert tr.stats == jr.stats
    assert tr.blocked_sources == jr.blocked_sources
    assert tr.table == jr.table
    np.testing.assert_array_equal(tk, jk)
    np.testing.assert_array_equal(ts, js)
    assert len(tv) > 0                       # the blacklist was exercised
    assert tv.tobytes() == jv.tobytes()      # saddr and until_ns, in order


def test_ring_compact16_logreg_matches_reference(tmp_path):
    jcfg, tcfg = _cfgs()
    rec = _flood(N_BATCHES * B)
    path = str(ART / "logreg_int8.npz")
    ref = _serve_ring("reference", jcfg, jlogreg.load_params(path), rec,
                      tmp_path, "j")
    port = _serve_ring("port", tcfg, logreg.load_params(path), rec,
                       tmp_path, "t")
    assert port[4].wire == schema.WIRE_COMPACT16 and not port[4].precompact
    _assert_same(ref, port)


def test_ring_raw48_mlp_eviction_matches_reference(tmp_path):
    jcfg, tcfg = _cfgs("mlp", table=dict(evict_ttl_s=2e-5, evict_every=4))
    rec = _flood(N_BATCHES * B, seed=21)
    path = str(ART / "mlp_robust.npz")
    ref = _serve_ring("reference", jcfg, jmlp.load_params(path), rec,
                      tmp_path, "j")
    port = _serve_ring("port", tcfg, mlp.load_params(path), rec, tmp_path,
                       "t")
    assert port[4].wire == schema.WIRE_RAW48
    assert port[0].stats["evicted"] > 0
    _assert_same(ref, port)


def test_ring_compact_emit_matches_reference(tmp_path, monkeypatch):
    """16-byte kernel-quantized records: both engines unwrap the 16-bit
    µs stamps against ``CLOCK_MONOTONIC``, pinned here to one value, and
    serve compact16/minifloat whatever the params (the precompact rule,
    with its notice)."""
    now = 5_000_000_123_456
    real = time.clock_gettime_ns
    monkeypatch.setattr(time, "clock_gettime_ns",
                        lambda clk: now if clk == time.CLOCK_MONOTONIC
                        else real(clk))
    jcfg, tcfg = _cfgs()
    rec = _kernel_compact(_flood(N_BATCHES * B, seed=5), now - 3000)
    path = str(ART / "logreg_int8.npz")
    ref = _serve_ring("reference", jcfg, jlogreg.load_params(path), rec,
                      tmp_path, "j")
    port = _serve_ring("port", tcfg, logreg.load_params(path), rec,
                       tmp_path, "t")
    eng = port[4]
    assert eng.precompact and eng.wire == schema.WIRE_COMPACT16
    assert eng.quant == {"feat_mode": "minifloat"}
    assert eng.batcher.t0_ns == ref[4].batcher.t0_ns
    _assert_same(ref, port)


def test_explicit_t0_reaches_the_sink_at_construction(tmp_path):
    _, tcfg = _cfgs()
    vpath = tmp_path / "v"
    shm.ShmRing.create(vpath, 64, wire.VERDICT_RECORD_DTYPE)
    sink = shm.ShmVerdictSink(vpath)
    src = shm.ShmRing.create(tmp_path / "f", 64, wire.FLOW_RECORD_DTYPE)
    del src
    e = Engine(tcfg, shm.ShmRingSource(tmp_path / "f"), sink, device="cpu",
               t0_ns=77_000_000_000)
    assert sink.t0_ns == 77_000_000_000 == e.batcher.t0_ns
    # the verdict sink's translation: engine seconds -> absolute ns
    from flowsentryx_tpu_torch.engine.writeback import BlacklistUpdate

    sink.apply(BlacklistUpdate(key=np.array([9], np.uint32),
                               until_s=np.array([1.5], np.float32)))
    v = shm.ShmRing(vpath, wire.VERDICT_RECORD_DTYPE).consume(8)
    assert int(v["saddr"][0]) == 9
    assert int(v["until_ns"][0]) == 77_000_000_000 + 1_500_000_000


def test_port_batcher_precompact_equals_reference(monkeypatch):
    """``add_precompact`` and ``note_poll``: the same wire rows, batch
    bases and wrap-risk count as the reference's batcher, clock pinned."""
    from flowsentryx_tpu.core.config import BatchConfig as JBatchConfig
    from flowsentryx_tpu.engine.batcher import MicroBatcher as JMicroBatcher
    from flowsentryx_tpu_torch.engine.batcher import MicroBatcher

    now = 9_000_000_000_000
    monkeypatch.setattr(time, "clock_gettime_ns", lambda clk: now)
    rec = _kernel_compact(_flood(3 * 64 + 17), now - 500)
    kw = dict(max_batch=64, deadline_us=10_000, verdict_k=8)
    quant = {"feat_mode": "minifloat"}
    jb = JMicroBatcher(JBatchConfig(**kw), t0_ns=now - 10 ** 7,
                       wire=jschema.WIRE_COMPACT16, quant=quant)
    tb = MicroBatcher(config.BatchConfig(**kw), t0_ns=now - 10 ** 7,
                      wire=wire.WIRE_COMPACT16, quant=quant)
    for lo, hi in ((0, 50), (50, 51), (51, 200), (200, len(rec))):
        a, b = jb.add_precompact(rec[lo:hi]), tb.add_precompact(rec[lo:hi])
        assert len(a) == len(b)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(jb.take(), tb.take())
    jb._last_poll_t = tb._last_poll_t = time.perf_counter() - 0.2
    jb.add_precompact(rec[:3])
    tb.add_precompact(rec[:3])
    assert tb.ts_wrap_risk_polls == jb.ts_wrap_risk_polls == 1
    with pytest.raises(ValueError, match="compact16"):
        MicroBatcher(config.BatchConfig(**kw),
                     wire=wire.WIRE_RAW48).add_precompact(rec)
