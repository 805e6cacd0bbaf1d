"""Checkpoint and restore of the port against the JAX package's.

The file format is shared: a reference engine's checkpoint restores in
the port, which then serves on equal to the reference uninterrupted; a
port checkpoint loads with the reference's ``load_checkpoint``, with the
same entries and CRC as the reference's checkpoint of the same stream
(stats as ``(lo, hi)`` pairs).  The restore is in place (the table and
stats tensors keep their storage), a capacity change reshards as the
reference's ``reshard_rows`` does, a salt mismatch is refused, a corrupt
file falls back to ``.prev`` and without one raises.  B = 256,
capacity 2^12.
"""

import json
from pathlib import Path

import numpy as np
import pytest

from flowsentryx_tpu.core import config as jconfig
from flowsentryx_tpu.engine import ArraySource as JArraySource
from flowsentryx_tpu.engine import CollectSink as JCollectSink
from flowsentryx_tpu.engine import Engine as JEngine
from flowsentryx_tpu.engine import checkpoint as jckpt
from flowsentryx_tpu.engine import table as jtable
from flowsentryx_tpu.models import logreg as jlogreg
from flowsentryx_tpu_torch import cli
from flowsentryx_tpu_torch.core import config, schema
from flowsentryx_tpu_torch.engine import ArraySource, CollectSink, Engine
from flowsentryx_tpu_torch.engine import checkpoint as ckpt
from flowsentryx_tpu_torch.engine import table
from flowsentryx_tpu_torch.engine.traffic import (
    Scenario, TrafficGen, TrafficSpec,
)
from flowsentryx_tpu_torch.models import logreg

ARTIFACT = str(Path(__file__).resolve().parents[1] / "artifacts"
               / "logreg_int8.npz")
B, CAP, HALF = 256, 1 << 12, 6


def _cfgs(capacity=CAP, salt=0xC0FFEE):
    t = dict(capacity=capacity, salt=salt)
    bt = dict(max_batch=B, readback_depth=4)
    lim = dict(pps_threshold=200.0, bps_threshold=1e9)
    return (jconfig.FsxConfig(limiter=jconfig.LimiterConfig(**lim),
                              table=jconfig.TableConfig(**t),
                              batch=jconfig.BatchConfig(**bt)),
            config.FsxConfig(limiter=config.LimiterConfig(**lim),
                             table=config.TableConfig(**t),
                             batch=config.BatchConfig(**bt)))


def _stream(seed=17):
    return TrafficGen(TrafficSpec(
        scenario=Scenario.UDP_FLOOD_MULTI, rate_pps=1e6, n_attack_ips=16,
        n_benign_ips=400, attack_fraction=0.7, seed=seed)).next_records(
            2 * HALF * B)


def _port(cfg, rec, **kw):
    return Engine(cfg, ArraySource(rec.copy()), CollectSink(),
                  params=logreg.load_params(ARTIFACT), device="cpu", **kw)


def _ref(cfg, rec):
    return JEngine(cfg, JArraySource(rec.copy()), JCollectSink(),
                   params=jlogreg.load_params(ARTIFACT), sink_thread=False)


def _tables(e, port=True):
    if port:
        return schema.table_to_numpy(e.table)
    return np.asarray(e.table.key), np.asarray(e.table.state)


@pytest.fixture(scope="module")
def reference_runs(tmp_path_factory):
    """The reference engine over the stream: uninterrupted, and its
    checkpoint after the first half."""
    d = tmp_path_factory.mktemp("ref")
    jcfg, _ = _cfgs()
    rec = _stream()
    full = _ref(jcfg, rec)
    rep = full.run()
    half = _ref(jcfg, rec[:HALF * B])
    half.run()
    path = half.checkpoint(str(d / "ref_half"))
    return {"rec": rec, "rep": rep, "blocked": dict(full.sink.blocked),
            "table": _tables(full, port=False), "half_path": path,
            "half_blocked": dict(half.sink.blocked)}


def test_reference_checkpoint_restores_in_port(reference_runs):
    """Restore the reference's half-way checkpoint into a port engine and
    serve the second half: stats, blacklist and table equal the
    reference uninterrupted."""
    _, tcfg = _cfgs()
    rec = reference_runs["rec"]
    e = _port(tcfg, rec[HALF * B:])
    key_ptr, state_ptr = (e.table.key_rows.data_ptr(),
                          e.table.state_rows.data_ptr())
    info = e.restore(reference_runs["half_path"])
    assert info["crc_checked"] and not info["resharded"]
    assert (e.table.key_rows.data_ptr(), e.table.state_rows.data_ptr()) == (
        key_ptr, state_ptr)                     # copied in place
    assert e.stats.to_dict()["batches"] == HALF
    rep = e.run()
    want = reference_runs["rep"]
    assert rep.stats == want.stats
    blocked = {**reference_runs["half_blocked"], **e.sink.blocked}
    assert blocked == reference_runs["blocked"] and blocked
    k, st = _tables(e)
    jk, jst = reference_runs["table"]
    np.testing.assert_array_equal(k, jk)
    np.testing.assert_array_equal(st.view(np.uint32), jst.view(np.uint32))


def _npz_entries(path):
    with np.load(path) as z:
        return {n: np.asarray(z[n]) for n in z.files}


def test_port_checkpoint_loads_in_reference(reference_runs, tmp_path):
    """The port's checkpoint after the same first half: the reference's
    ``load_checkpoint`` verifies and loads it, and every entry — stats as
    ``[2]`` uint32 ``(lo, hi)`` pairs, t0, the geometry header — and the
    CRC equal the reference's own checkpoint of that state."""
    _, tcfg = _cfgs()
    e = _port(tcfg, reference_runs["rec"][:HALF * B])
    e.run()
    path = e.checkpoint(str(tmp_path / "port_half"))
    assert path.endswith(".npz")
    mine = _npz_entries(path)
    ref = _npz_entries(reference_runs["half_path"])
    assert mine.keys() == ref.keys()
    for name in ref:
        assert mine[name].dtype == ref[name].dtype, name
        np.testing.assert_array_equal(mine[name], ref[name], err_msg=name)
    assert mine["stats_batches"].tolist() == [HALF, 0]
    ck = jckpt.load_checkpoint(path)
    assert ck.crc_checked and ck.capacity == CAP
    ours = ckpt.load_checkpoint(reference_runs["half_path"])
    assert ours.stats["batches"].dtype == np.uint32
    assert {k: v.tolist() for k, v in ours.stats.items()} == {
        k: np.asarray(v).tolist() for k, v in ck.stats._asdict().items()}
    assert ckpt.peek_header(path) == jckpt.peek_header(path)


def test_stats_past_32_bits_round_trip(tmp_path):
    """A counter past 2^32 is written as its ``(lo, hi)`` pair and reads
    back whole (``batches``' low 32 bits place the eviction window)."""
    _, tcfg = _cfgs()
    e = _port(tcfg, _stream()[:0])
    e.stats.batches.fill_((5 << 32) + 7)
    e.stats.allowed.fill_(3)
    path = e.checkpoint(str(tmp_path / "big"))
    assert _npz_entries(path)["stats_batches"].tolist() == [7, 5]
    assert jckpt.load_checkpoint(path).stats.batches.tolist() == [7, 5]
    e2 = _port(tcfg, _stream()[:0])
    e2.restore(path)
    assert e2.stats.to_dict()["batches"] == (5 << 32) + 7


@pytest.mark.parametrize("new_cap", [1 << 13, 1 << 11])
def test_reshard_equals_reference(reference_runs, new_cap):
    """A checkpoint restored into another capacity: the port's
    ``reshard_rows`` equals the reference's on the loaded rows, and the
    engine's restore places exactly those rows."""
    ck = ckpt.load_checkpoint(reference_runs["half_path"])
    _, tcfg = _cfgs(capacity=new_cap)
    plan = table.TablePlan(capacity=new_cap, salt=ck.hash_salt, probes=8)
    jplan = jtable.TablePlan(capacity=new_cap, salt=ck.hash_salt, probes=8)
    k, st, dropped = table.reshard_rows(ck.key, ck.state, plan)
    jk, jst, jdropped = jtable.reshard_rows(ck.key, ck.state, jplan)
    np.testing.assert_array_equal(k, jk)
    np.testing.assert_array_equal(st, jst)
    assert dropped == jdropped
    e = _port(tcfg, reference_runs["rec"][:0])
    info = e.restore(reference_runs["half_path"])
    assert info["resharded"] and info["dropped_rows"] == dropped
    assert info["to"]["capacity"] == new_cap
    ek, est = _tables(e)
    np.testing.assert_array_equal(ek, k)
    np.testing.assert_array_equal(est, st)


def test_table_helpers_equal_reference():
    rng = np.random.default_rng(2)
    keys = rng.integers(1, 1 << 32, 5000, dtype=np.uint64).astype(np.uint32)
    for salt in (0, 0xC0FFEE):
        np.testing.assert_array_equal(table.hash_u32_np(keys, salt),
                                      jtable.hash_u32_np(keys, salt))
        for n in (1, 2, 8):
            np.testing.assert_array_equal(table.owner_of(keys, salt, n),
                                          jtable.owner_of(keys, salt, n))
    for args in ((1 << 12,), (3000,), (1 << 30,), (1 << 10, 2048),
                 (1 << 12, 0, 3), (4, 0, 8)):
        assert table.validate_capacity(*args) == jtable.validate_capacity(
            *args)
    plan = table.TablePlan(capacity=1 << 10, salt=5)
    jplan = jtable.TablePlan(capacity=1 << 10, salt=5)
    base_k = np.zeros(1 << 10, np.uint32)
    base_k[rng.integers(0, 1 << 10, 300)] = rng.integers(1, 1 << 31, 300)
    base_s = rng.random((1 << 10, schema.NUM_TABLE_COLS)).astype(np.float32)
    add_k = np.concatenate([keys[:200], base_k[base_k != 0][:5]])
    add_s = rng.random((len(add_k), schema.NUM_TABLE_COLS)).astype(
        np.float32)
    got = table.insert_rows(base_k, base_s, add_k, add_s, plan)
    want = jtable.insert_rows(base_k, base_s, add_k, add_s, jplan)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="power of two"):
        table.TablePlan(capacity=3000)


def test_salt_mismatch_refused(reference_runs):
    _, tcfg = _cfgs(salt=0xBAD)
    e = _port(tcfg, reference_runs["rec"][:0])
    with pytest.raises(ValueError, match="hash salt"):
        e.restore(reference_runs["half_path"])


def test_corrupt_checkpoint_falls_back_to_prev(tmp_path, capsys):
    """Two saves rotate the first to ``.prev``; a flipped byte in the
    live file fails its CRC, and restore loads ``.prev`` (announced,
    counted); a truncated ``.prev`` as well raises.  The reference
    reads the same files the same way."""
    _, tcfg = _cfgs()
    rec = _stream()
    e = _port(tcfg, rec[:HALF * B])
    e.run()
    path = e.checkpoint(str(tmp_path / "snap.npz"))
    first = Path(path).read_bytes()
    e.stats.allowed.fill_(1)
    e.checkpoint(path)
    assert ckpt.prev_path(path).read_bytes() == first
    assert ckpt.prev_path(path) == jckpt.prev_path(path)
    raw = bytearray(Path(path).read_bytes())
    raw[len(raw) // 2] ^= 0x5A
    Path(path).write_bytes(bytes(raw))
    with pytest.raises(ckpt.CheckpointCorrupt):
        ckpt.load_checkpoint(path)
    with pytest.raises(jckpt.CheckpointCorrupt):
        jckpt.load_checkpoint(path)
    e2 = _port(tcfg, rec[:0])
    info = e2.restore(path)
    assert info["fallback_from"] == path and e2._restore_fallbacks == 1
    assert "REFUSED" in capsys.readouterr().err
    assert e2.stats.to_dict() == _port(tcfg, rec[:HALF * B]).run().stats
    ckpt.prev_path(path).write_bytes(first[:100])
    with pytest.raises(ckpt.CheckpointCorrupt):
        _port(tcfg, rec[:0]).restore(path)
    # no .prev at all: the corrupt live file raises
    ckpt.prev_path(path).unlink()
    with pytest.raises(ckpt.CheckpointCorrupt):
        _port(tcfg, rec[:0]).restore(path)
    empty = tmp_path / "empty.npz"
    empty.write_bytes(b"")
    with pytest.raises(ckpt.CheckpointCorrupt, match="empty"):
        ckpt.peek_header(empty)


def test_byte_flips_are_refused_or_harmless(tmp_path):
    """One flipped byte every 40 bytes of a checkpoint: the port either
    refuses the file as :class:`CheckpointCorrupt` (so a restore falls
    back to ``.prev``) or loads exactly the state that was written (a
    flip in a zip timestamp).  The reference lets a few flips escape as
    other exceptions — a damaged ``.npy`` header member or compression
    method — which skip its fallback (ROADMAP queue 3)."""
    _, tcfg = _cfgs()
    e = _port(tcfg, _stream()[:4 * B])
    e.run()
    path = e.checkpoint(str(tmp_path / "f.npz"))
    good = Path(path).read_bytes()
    want = ckpt.load_checkpoint(path)
    escaped = 0
    for i in range(0, len(good), 40):
        raw = bytearray(good)
        raw[i] ^= 0x5A
        Path(path).write_bytes(bytes(raw))
        try:
            got = ckpt.load_checkpoint(path)
        except ckpt.CheckpointCorrupt:
            pass
        else:
            np.testing.assert_array_equal(got.key, want.key)
            np.testing.assert_array_equal(got.state, want.state)
            assert got.t0_ns == want.t0_ns
        try:
            jckpt.load_checkpoint(path)
        except jckpt.CheckpointCorrupt:
            pass
        except Exception:   # noqa: BLE001 - the reference's escapes
            escaped += 1
    assert escaped > 0


def test_restore_refused_with_batches_in_flight(tmp_path):
    _, tcfg = _cfgs()
    e = _port(tcfg, _stream()[:B])
    path = e.checkpoint(str(tmp_path / "c"))
    e._pending.append(np.zeros((B + 1, 4), np.uint32))
    with pytest.raises(RuntimeError, match="in flight"):
        e.restore(path)
    with pytest.raises(RuntimeError, match="in flight"):
        e.checkpoint(path)


def test_cli_checkpoint_then_restore(tmp_path, capsys):
    """``serve --checkpoint`` then ``serve --restore``: the restored run
    adopts the checkpoint's salt and capacity and resumes its counters;
    a config salt that disagrees is refused before boot."""
    path = str(tmp_path / "cli.npz")
    rec = _stream()
    rfile = tmp_path / "records.bin"
    rfile.write_bytes(rec.tobytes())
    base = ["serve", "--device", "cpu", "--json", "--records", str(rfile)]
    assert cli.main(base + ["--table-capacity", "8192", "--packets",
                            str(4 * B), "--checkpoint", path,
                            "--checkpoint-every", "30"]) == 0
    first = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    hdr = ckpt.peek_header(path)
    assert hdr["capacity"] == 8192 and hdr["hash_salt"] != 0
    assert cli.main(base + ["--restore", path, "--batches", "1"]) == 0
    second = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert second["stats"]["batches"] == first["stats"]["batches"] + 1
    assert second["table"]["tracked"] > 0
    conf = tmp_path / "c.json"
    conf.write_text(json.dumps({"table": {"salt": 1}}))
    assert cli.main(base + ["--restore", path, "--config", str(conf)]) == 1
    assert "refusing to restore" in capsys.readouterr().err
