"""The port's elastic fleet (``cluster/rebalance.py``, ``cluster/elastic.py``,
the supervisor's handoff, adopt and elastic halves, the engine's three
quiescent table methods) against the JAX package's, on the CPU.

* the wire constants, the status block's fields, the tuning constants and
  ``parallel/layout.py``'s assignment routing equal the reference's;
* the counterpart of every test of ``tests/test_rebalance.py``, each
  output held to the reference's: the shard assignment and the bytes of
  ``layout.json``; ``pack_rows`` bytes, ``rows_digest`` and every verdict
  and detail of ``rows_conserved``; the mailbox file's bytes after
  ``ship_rows``; the receiver's refusals; ``load_ckpt_rows``;
  ``insert_rows``; the rebalancer's retry after an abort; the ack word;
  ``ElasticPolicy`` over the reference's cases and a seeded run of 200
  signal vectors; ``NetHandoff`` on loopback;
* streams and spools cross the packages: a port ``ship_rows`` stream
  verifies in the reference's ``HandoffReceiver`` and the reverse, a
  corrupted word is refused by both, each ``load_spool`` reads the
  other's spool;
* the port's CPU ``Engine`` and the reference's serve the same records,
  then ``extract_span_rows``, ``drop_span_rows`` and ``adopt_rows`` give
  equal arrays, counts and table bytes, and each package's
  ``load_ckpt_rows`` reads each package's checkpoint alike; with batches
  in flight each of the three raises;
* the supervisor on stub fleets, beside the reference's: a handoff's
  commit and lift with scripted acks, an abort when a party dies, the
  stale-handoff cleanup, ``adopt_dead_span`` from a checkpoint, the
  ``boot(adopt=True)`` census and ``elastic_tick`` with injected signals
  leave ``layout.json``, ``handoff.json``, the counters and
  ``aggregate()`` equal;
* one real CPU fleet (2 live ranks of 3, 2^12 rows) moves shard 2
  mid-serve with exact conservation and drains every record;
  ``cli cluster --elastic`` and ``--adopt`` run with ``--device cpu``;
* the supervisor's side imports no torch.

Every compared field is exact: no tolerance.
"""

import contextlib
import io
import json
import platform
import subprocess
import sys
import threading
import time
import zipfile
import zlib
from pathlib import Path

import numpy as np
import pytest

from flowsentryx_tpu.cluster import elastic as jelastic
from flowsentryx_tpu.cluster import mailbox as jmailbox
from flowsentryx_tpu.cluster import rebalance as jrb
from flowsentryx_tpu.cluster.runner import stub_engine_main as jstub
from flowsentryx_tpu.cluster.supervisor import (
    ClusterSupervisor as JSupervisor,
)
from flowsentryx_tpu.core import config as jconfig
from flowsentryx_tpu.core import schema as jschema
from flowsentryx_tpu.engine import ArraySource as JArraySource
from flowsentryx_tpu.engine import CollectSink as JCollectSink
from flowsentryx_tpu.engine import Engine as JEngine
from flowsentryx_tpu.engine import table as jtable
from flowsentryx_tpu.parallel import layout as jlayout
from flowsentryx_tpu.sync import tuning as jtuning
from flowsentryx_tpu_torch.cluster import elastic, mailbox
from flowsentryx_tpu_torch.cluster import rebalance as rb
from flowsentryx_tpu_torch.cluster.runner import (
    prewarm_main, stub_engine_main,
)
from flowsentryx_tpu_torch.cluster.supervisor import ClusterSupervisor
from flowsentryx_tpu_torch.core import config, schema, wire
from flowsentryx_tpu_torch.engine import ArraySource, CollectSink, Engine
from flowsentryx_tpu_torch.engine import table as tbl
from flowsentryx_tpu_torch.engine.traffic import (
    Scenario, TrafficGen, TrafficSpec,
)
from flowsentryx_tpu_torch.parallel import layout
from flowsentryx_tpu_torch.sync import tuning

REPO = Path(__file__).resolve().parents[1]
B, CAP = 256, 1 << 12
#: a pinned fleet epoch, so stub fleets' aggregates compare
T0_NS, T0_WALL_NS = 1_000_000_000, 1_700_000_000_000_000_000

pytestmark = pytest.mark.skipif(
    platform.machine() not in ("x86_64", "AMD64")
    or platform.system() != "Linux",
    reason="the cluster plane is mmap shm under x86-TSO and process "
           "groups (Linux)")

PKG = {"port": rb, "reference": jrb}
CROSS = [("port", "reference"), ("reference", "port")]


def _rows(rng, n):
    keys = rng.choice(np.arange(1, 1 << 20, dtype=np.uint32), n,
                      replace=False).astype(np.uint32)
    states = rng.random((n, wire.NUM_TABLE_COLS)).astype(np.float32)
    return keys, states


@pytest.fixture
def rng():
    return np.random.default_rng(16)


# ---------------------------------------------------------------------------
# constants
# ---------------------------------------------------------------------------

def test_wire_and_tuning_constants_equal_reference():
    for name in ("SHM_HANDOFF_MAGIC", "HANDOFF_SLOT_HDR_WORDS",
                 "HANDOFF_KIND_ROWS", "HANDOFF_KIND_SEAL", "HP_SHIPPED",
                 "HP_STAGED", "HP_DROPPED", "HP_INSERTED",
                 "STATUS_HANDOFF_OFFSET", "STATUS_LAYOUT_ACK_OFFSET",
                 "STATUS_LAYOUT_GEN_OFFSET", "STATUS_FENCE_OFFSET",
                 "NUM_TABLE_COLS", "TABLE_COLUMN_NAMES"):
        assert getattr(wire, name) == getattr(jschema, name), name
    assert wire.NUM_TABLE_COLS == schema.NUM_TABLE_COLS
    assert rb.ROW_WORDS == jrb.ROW_WORDS
    assert mailbox.StatusBlock._CTL == jmailbox.StatusBlock._CTL
    for name in ("ELASTIC_TICK_S", "ELASTIC_HYSTERESIS_TICKS",
                 "ELASTIC_COOLDOWN_S", "ELASTIC_GROW_BACKLOG",
                 "ELASTIC_SHRINK_BACKLOG", "ELASTIC_SKEW_RATIO",
                 "HANDOFF_SHIP_TIMEOUT_S", "HANDOFF_TIMEOUT_S",
                 "NET_HANDOFF_TIMEOUT_S"):
        assert getattr(tuning, name) == getattr(jtuning, name), name


# ---------------------------------------------------------------------------
# shard assignment
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("total,w,n_live", [
    (8, 2, 4), (8, 2, 2), (3, 1, 2), (6, 2, 3), (12, 4, 1)])
def test_initial_assignment_equals_reference(total, w, n_live):
    got = rb.ShardAssignment.initial(total, w, n_live)
    want = jrb.ShardAssignment.initial(total, w, n_live)
    assert (got.generation, got.owners) == (want.generation, want.owners)
    for r in range(total // w):
        assert got.spans_of(r) == want.spans_of(r)


@pytest.mark.parametrize("args", [(7, 2, 2), (4, 2, 3), (4, 2, 0)])
def test_initial_validates_geometry_as_reference(args):
    msgs = []
    for mod in (rb, jrb):
        with pytest.raises(ValueError) as ei:
            mod.ShardAssignment.initial(*args)
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]


def test_reassign_bumps_generation_immutably_as_reference():
    for mod in (rb, jrb):
        asg = mod.ShardAssignment.initial(4, 1, 4)
        moved = asg.reassign([3], 0)
        assert (moved.generation, moved.owners) == (1, (0, 1, 2, 0))
        assert asg.owners == (0, 1, 2, 3)
        with pytest.raises(ValueError):
            asg.reassign([4], 0)
        with pytest.raises(ValueError):
            mod.ShardAssignment(-1, (0,))
        with pytest.raises(ValueError):
            mod.ShardAssignment(0, ())


@pytest.mark.parametrize("writer,reader", CROSS)
def test_layout_json_bytes_equal_and_cross_load(tmp_path, writer, reader):
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    assert PKG[reader].ShardAssignment.load(tmp_path / "a") is None
    for mod, d in ((PKG[writer], "a"), (PKG[reader], "b")):
        mod.ShardAssignment.initial(6, 2, 3).reassign([0, 1], 2).save(
            tmp_path / d)
    a, b = (tmp_path / d / "layout.json" for d in "ab")
    assert a.read_bytes() == b.read_bytes()
    back = PKG[reader].ShardAssignment.load(tmp_path / "a")
    assert (back.generation, back.owners) == (1, (2, 2, 1, 1, 2, 2))
    assert list(tmp_path.glob("*/.layout.json.tmp.*")) == []


def test_assigned_ring_and_owner_rank_equal_reference(rng):
    owners = (0, 0, 1, 0)
    for s in range(4):
        assert rb.assigned_ring_of(s, owners, 2) == jrb.assigned_ring_of(
            s, owners, 2)
    assert rb.assigned_ring_of(3, owners, 2) == 1
    keys, _ = _rows(rng, 512)
    for own in ((0, 1, 1, 0), (2, 0, 1)):
        got = rb.owner_rank_of_keys(keys, own)
        assert np.array_equal(got, jrb.owner_rank_of_keys(keys, own))
        assert np.array_equal(got, np.asarray(own)[wire.shard_of(
            keys, len(own))])
    saddr = rng.integers(0, 1 << 32, 4096, dtype=np.uint32)
    for own, w in (((0, 1, 1, 0), 1), ((0, 0, 1, 0, 2, 2), 2)):
        assert np.array_equal(layout.assigned_ring_of(saddr, own, w),
                              jlayout.assigned_ring_of(saddr, own, w))
        assert np.array_equal(layout.assigned_rank_of(saddr, own, w),
                              jlayout.assigned_rank_of(saddr, own, w))


def test_gen0_assignment_reproduces_boot_frozen_rule(rng):
    saddr = rng.integers(0, 1 << 32, 4096, dtype=np.uint32)
    for n, w in ((2, 1), (3, 2), (4, 4)):
        asg = rb.ShardAssignment.initial(n * w, w, n)
        assert np.array_equal(
            layout.assigned_rank_of(saddr, asg.owners, w),
            layout.cluster_rank_of(saddr, n, w)), (n, w)


# ---------------------------------------------------------------------------
# row packing and the conservation judge
# ---------------------------------------------------------------------------

def test_pack_rows_bytes_and_digest_equal_reference(rng):
    keys, states = _rows(rng, 257)
    packed = rb.pack_rows(keys, states)
    assert packed.tobytes() == jrb.pack_rows(keys, states).tobytes()
    assert rb.rows_digest(keys, states) == jrb.rows_digest(keys, states)
    k2, s2 = rb.unpack_rows(packed)
    assert np.array_equal(k2, keys) and s2.tobytes() == states.tobytes()


def _conservation_cases(rng):
    keys, states = _rows(rng, 300)
    tampered = states.copy()
    tampered[10, 3] += 1.0
    owners = (0, 1)
    return {
        "exact_split": ((keys, states), [(keys[:100], states[:100]),
                                         (keys[100:], states[100:])], {}),
        "lost_row": ((keys, states), [(keys[:-1], states[:-1])], {}),
        "double_owner": ((keys, states),
                         [(keys, states), (keys[:1], states[:1])], {}),
        "bit_flip": ((keys, states), [(keys, tampered)], {}),
        "foreign": ((keys, states), [(keys, states)],
                    {"owners": owners, "part_ranks": [0]}),
        "empty": ((keys[:0], states[:0]), [], {}),
    }


@pytest.mark.parametrize("case", ["exact_split", "lost_row", "double_owner",
                                  "bit_flip", "foreign", "empty"])
def test_rows_conserved_equals_reference(rng, case):
    pre, parts, kw = _conservation_cases(rng)[case]
    if case == "empty":
        # no rows at all: both packages' numpy reshape refuses alike
        for mod in (rb, jrb):
            with pytest.raises(ValueError, match="reshape"):
                mod.rows_conserved(pre, parts, **kw)
        return
    got = rb.rows_conserved(pre, parts, **kw)
    assert got == jrb.rows_conserved(pre, parts, **kw)
    assert got["ok"] == (case == "exact_split")


# ---------------------------------------------------------------------------
# the handoff mailbox
# ---------------------------------------------------------------------------

def test_ship_rows_mailbox_bytes_equal_reference(tmp_path, rng):
    keys, states = _rows(rng, 1000)
    files, out = [], []
    for mod, name in ((rb, "p.mbx"), (jrb, "r.mbx")):
        mbx = mod.HandoffMailbox.create(tmp_path / name, slots=32,
                                        rows_per_slot=64)
        out.append(mod.ship_rows(mbx, keys, states))
        files.append((tmp_path / name).read_bytes())
    assert out[0] == out[1] == (1000, rb.rows_digest(keys, states))
    assert files[0] == files[1]


@pytest.mark.parametrize("writer,reader", CROSS)
def test_stream_crosses_packages(tmp_path, rng, writer, reader):
    keys, states = _rows(rng, 1000)
    mbx = PKG[writer].HandoffMailbox.create(tmp_path / "h.mbx", slots=32,
                                            rows_per_slot=64)
    PKG[writer].ship_rows(mbx, keys, states)
    rx_mbx = PKG[reader].HandoffMailbox(tmp_path / "h.mbx")
    assert (rx_mbx.row_words, rx_mbx.rows_per_slot) == (rb.ROW_WORDS, 64)
    recv = PKG[reader].HandoffReceiver()
    while not recv.done:
        recv.drain(rx_mbx)
    assert recv.ok, recv.detail
    assert rb.rows_conserved((keys, states), [recv.rows()])["ok"]


@pytest.mark.parametrize("how", ["payload_word", "sequence_gap"])
def test_corrupt_stream_refused_by_both(tmp_path, rng, how):
    keys, states = _rows(rng, 128)
    mbx = rb.HandoffMailbox.create(tmp_path / "h.mbx", slots=8,
                                   rows_per_slot=64)
    if how == "payload_word":
        rb.ship_rows(mbx, keys, states)
        mbx._cells[1][wire.HANDOFF_SLOT_HDR_WORDS + 7] ^= 1
    else:
        packed = rb.pack_rows(keys, states)
        mbx.publish_rows(packed[:64], 1)
        mbx.publish_rows(packed[64:], 3)  # slot 2 lost
        mbx.publish_seal(4, 128, zlib.crc32(packed.tobytes()) & 0xFFFFFFFF)
    # each package drains its own copy of the same file
    (tmp_path / "j.mbx").write_bytes((tmp_path / "h.mbx").read_bytes())
    got = []
    for mod, name in ((rb, "h.mbx"), (jrb, "j.mbx")):
        recv = mod.HandoffReceiver()
        m = mod.HandoffMailbox(tmp_path / name)
        while not recv.done:
            recv.drain(m)
        got.append((recv.ok, recv.detail, recv.seq_gaps))
    assert got[0] == got[1]
    assert not got[0][0]
    assert ("CRC" if how == "payload_word" else "sequence gap") in got[0][1]


def test_unsealed_stream_never_verifies(tmp_path, rng):
    keys, states = _rows(rng, 128)
    mbx = rb.HandoffMailbox.create(tmp_path / "h.mbx", slots=8,
                                   rows_per_slot=64)
    packed = rb.pack_rows(keys, states)
    mbx.publish_rows(packed[:64], 1)
    mbx.publish_rows(packed[64:], 2)  # ... and the donor dies here
    recv = rb.HandoffReceiver()
    for _ in range(5):
        recv.drain(mbx)
    assert not recv.done and not recv.ok
    assert len(recv.rows()[0]) == 128


def test_full_mailbox_backpressures_not_drops(tmp_path, rng):
    keys, states = _rows(rng, 128)
    mbx = rb.HandoffMailbox.create(tmp_path / "h.mbx", slots=2,
                                   rows_per_slot=64)
    packed = rb.pack_rows(keys, states)
    assert mbx.publish_rows(packed[:64], 1)
    assert mbx.publish_rows(packed[64:], 2)
    assert not mbx.publish_rows(packed[:64], 3)  # full: refused
    assert mbx.readable() == 2
    with pytest.raises(TimeoutError):
        rb.ship_rows(mbx, keys, states, timeout_s=0.05)
    with pytest.raises(ValueError):
        mbx.publish_rows(rb.pack_rows(*_rows(rng, 65)), 4)


def test_mailbox_geometry_validated_and_in_the_header(tmp_path):
    for mod in (rb, jrb):
        with pytest.raises(ValueError):
            mod.HandoffMailbox.create(tmp_path / "x.mbx", slots=3)
        with pytest.raises(ValueError):
            mod.HandoffMailbox.create(tmp_path / "x.mbx", rows_per_slot=0)
    rb.HandoffMailbox.create(tmp_path / "h.mbx")
    again = jrb.HandoffMailbox(tmp_path / "h.mbx")
    assert (again.row_words, again.rows_per_slot, again.slots) == (
        rb.ROW_WORDS, 512, 64)
    (tmp_path / "raw.mbx").write_bytes(bytes(4096))
    with pytest.raises(Exception, match="magic"):
        rb.HandoffMailbox(tmp_path / "raw.mbx")


# ---------------------------------------------------------------------------
# the staged spool
# ---------------------------------------------------------------------------

def _members(path: Path) -> dict:
    with zipfile.ZipFile(path) as z:
        return {i.filename: z.read(i) for i in z.infolist()}


@pytest.mark.parametrize("writer,reader", CROSS)
def test_spool_crosses_packages(tmp_path, rng, writer, reader):
    keys, states = _rows(rng, 300)
    paths = {}
    for name, mod in PKG.items():
        paths[name] = tmp_path / f"{name}.npz"
        mod.save_spool(paths[name], keys, states, handoff_id=7, to_gen=3)
    # the same members, byte for byte (the zip headers' timestamps aside)
    assert _members(paths["port"]) == _members(paths["reference"])
    got = PKG[reader].load_spool(paths[writer])
    assert got["handoff_id"] == 7 and got["to_gen"] == 3
    assert np.array_equal(got["keys"], keys)
    assert got["states"].tobytes() == states.tobytes()
    assert PKG[reader].load_spool(tmp_path / "absent.npz") is None
    torn = tmp_path / "torn.npz"
    torn.write_bytes(paths[writer].read_bytes()[:100])
    with pytest.raises(ValueError, match="torn or corrupt"):
        rb.load_spool(torn)


def test_discard_uncommitted_spool_equals_reference(tmp_path, rng):
    keys, states = _rows(rng, 16)
    for name, mod in PKG.items():
        d = tmp_path / name
        d.mkdir()
        mod.ShardAssignment(1, (0, 1)).save(d)
        out = []
        for to_gen in (1, 2):   # committed: kept; uncommitted: removed
            mod.save_spool(mod.staged_path(d, 0), keys, states,
                           handoff_id=1, to_gen=to_gen)
            out.append(mod.discard_uncommitted_spool(d, 0))
        mod.staged_path(d, 1).write_bytes(b"torn")
        out.append(mod.discard_uncommitted_spool(d, 1))
        out.append(mod.discard_uncommitted_spool(d, 1))
        if name == "port":
            got = out
        else:
            assert got == out == [False, True, True, False]


# ---------------------------------------------------------------------------
# the UDP leg on loopback
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tx_pkg,rx_pkg", [("port", "port"), *CROSS])
def test_net_handoff_loopback(tmp_path, rng, tx_pkg, rx_pkg):
    keys, states = _rows(rng, 400)
    src = rb.HandoffMailbox.create(tmp_path / "src.mbx", slots=16,
                                   rows_per_slot=64)
    rb.ship_rows(src, keys, states)
    slots = []
    for seq, kind, count, payload in src.pop_slots(64):
        hdr = np.array([seq & 0xFFFFFFFF, seq >> 32, count, kind], np.uint32)
        slots.append(np.concatenate([hdr, payload]))
    tx, rx = PKG[tx_pkg].NetHandoff(), PKG[rx_pkg].NetHandoff()
    got = []
    try:
        t = threading.Thread(target=lambda: got.extend(rx.recv_stream(
            len(slots), src.slot_words, timeout_s=10)))
        t.start()
        tx.send_stream(rx.addr, slots, timeout_s=10)
        t.join(timeout=15)
        assert not t.is_alive()
    finally:
        tx.close()
        rx.close()
    assert [g.tobytes() for g in got] == [s.tobytes() for s in slots]
    dst = rb.HandoffMailbox.create(tmp_path / "dst.mbx", slots=16,
                                   rows_per_slot=64)
    for img in got:
        dst._publish(int(img[0]) | (int(img[1]) << 32), int(img[3]),
                     int(img[2]), img[4:])
    recv = rb.HandoffReceiver()
    while not recv.done:
        recv.drain(dst)
    assert recv.ok, recv.detail
    assert rb.rows_conserved((keys, states), [recv.rows()])["ok"]


# ---------------------------------------------------------------------------
# the checkpoint row reader and the probe-insert
# ---------------------------------------------------------------------------

def _write_ckpt(path, keys, states, *, tamper=False):
    entries = {"table_key": np.asarray(keys, np.uint32)}
    for i, name in enumerate(wire.TABLE_COLUMN_NAMES):
        entries[f"table_{name}"] = np.asarray(states)[:, i].astype(
            np.float32)
    crc = 0
    for name in sorted(entries):
        crc = zlib.crc32(name.encode(), crc)
        crc = zlib.crc32(np.ascontiguousarray(entries[name]).tobytes(), crc)
    if tamper:
        entries["table_key"] = entries["table_key"].copy()
        entries["table_key"][0] ^= 1
    np.savez(path, integrity_crc32=np.uint32(crc & 0xFFFFFFFF), **entries)


def test_load_ckpt_rows_equals_reference(tmp_path, rng):
    keys, states = _rows(rng, 32)
    full_k = np.concatenate([keys, np.zeros(16, np.uint32)])
    full_s = np.concatenate(
        [states, np.zeros((16, wire.NUM_TABLE_COLS), np.float32)])
    _write_ckpt(tmp_path / "ck.npz", full_k, full_s)
    k2, s2 = rb.load_ckpt_rows(tmp_path / "ck.npz")
    jk, js = jrb.load_ckpt_rows(tmp_path / "ck.npz")
    assert np.array_equal(k2, jk) and s2.tobytes() == js.tobytes()
    assert rb.rows_conserved((keys, states), [(k2, s2)])["ok"]
    _write_ckpt(tmp_path / "bad.npz", keys[:8], states[:8], tamper=True)
    for mod in (rb, jrb):
        with pytest.raises(ValueError, match="integrity"):
            mod.load_ckpt_rows(tmp_path / "bad.npz")


def test_insert_rows_equals_reference(rng):
    keys, states = _rows(rng, 400)
    plan, jplan = tbl.TablePlan(capacity=1024), jtable.TablePlan(
        capacity=1024)
    key, state, _ = tbl.reshard_rows(keys[:200], states[:200], plan)
    got = tbl.insert_rows(key, state, keys[200:], states[200:], plan)
    want = jtable.insert_rows(key, state, keys[200:], states[200:], jplan)
    assert got[2] == want[2] == 0
    assert np.array_equal(got[0], want[0])
    assert got[1].tobytes() == want[1].tobytes()
    occ = got[0] != 0
    assert rb.rows_conserved((keys, states), [(got[0][occ],
                                               got[1][occ])])["ok"]
    # an adopted key already live is dropped, never overwrites
    dup = tbl.insert_rows(got[0], got[1], keys[:4], states[:4] + 9.0, plan)
    assert dup[2] == 4 and np.array_equal(dup[1], got[1])


# ---------------------------------------------------------------------------
# the engine-side state machine, on a scripted status block
# ---------------------------------------------------------------------------

class _FakeStatus:
    def __init__(self):
        self._ctl = {}

    def ctl_get(self, name):
        return self._ctl.get(name, 0)

    def ctl_set(self, name, value):
        self._ctl[name] = int(value)


class _FakeEng:
    def __init__(self):
        self.counters = {}
        self.adopted = []

    def count_rebalance(self, key, n=1):
        self.counters[key] = self.counters.get(key, 0) + int(n)

    def drop_span_rows(self, shards, total_shards):
        return 0

    def adopt_rows(self, keys, states):
        self.adopted.append((keys, states))
        return len(keys), 0


def _write_handoff_json(mod, cluster_dir, hid, *, to_gen):
    mod._write_atomic(mod.handoff_json_path(cluster_dir), json.dumps({
        "id": hid, "shards": [1], "donor": 1, "recipient": 0,
        "to_gen": to_gen, "total_shards": 2, "source": "engine"}) + "\n")


def _retry_after_abort(mod, d, keys, states):
    """The reference's retry-after-abort sequence on ``mod``'s
    rebalancer; returns the status words, counters and adopted rows."""
    mod.ShardAssignment.initial(2, 1, 2).save(d)
    status, eng = _FakeStatus(), _FakeEng()
    rbal = mod.EngineRebalancer(d, 0, status)
    mbx1 = mod.HandoffMailbox.create(mod.handoff_mailbox_path(d, 1),
                                     slots=8, rows_per_slot=64)
    mbx1.publish_rows(mod.pack_rows(keys, states)[:64], 1)
    _write_handoff_json(mod, d, 1, to_gen=1)
    status.ctl_set("c_fence", 1)
    for _ in range(4):
        rbal.step(eng)
    staged_mid = mod._phase_of(status.ctl_get("c_handoff"), 1)
    status.ctl_set("c_fence", 0)   # ABORT
    mod.handoff_json_path(d).unlink()
    Path(mod.handoff_mailbox_path(d, 1)).unlink()
    dropped_partial = rbal.step(eng)
    mbx2 = mod.HandoffMailbox.create(mod.handoff_mailbox_path(d, 2),
                                     slots=8, rows_per_slot=64)
    mod.ship_rows(mbx2, keys, states)
    _write_handoff_json(mod, d, 2, to_gen=1)
    status.ctl_set("c_fence", 2)
    for _ in range(16):
        if mod._phase_of(status.ctl_get("c_handoff"), 2) == wire.HP_STAGED:
            break
        rbal.step(eng)
    spool = (d / "handoff_staged_r0.npz").exists()
    mod.ShardAssignment.load(d).reassign([1], 0).save(d)
    status.ctl_set("c_layout_gen", 1)
    status.ctl_set("c_fence", 0)
    for _ in range(4):
        rbal.step(eng)
    return {"ctl": dict(status._ctl), "counters": eng.counters,
            "staged_mid": staged_mid, "dropped_partial": dropped_partial,
            "spool": spool, "released": rbal.note_checkpointed(),
            "adopted": [(k.tobytes(), s.tobytes()) for k, s in eng.adopted]}


def test_rebalancer_retry_after_abort_equals_reference(tmp_path, rng):
    keys, states = _rows(rng, 200)
    (tmp_path / "p").mkdir()
    (tmp_path / "r").mkdir()
    got = _retry_after_abort(rb, tmp_path / "p", keys, states)
    want = _retry_after_abort(jrb, tmp_path / "r", keys, states)
    assert got == want
    assert got["ctl"]["c_layout_ack"] == 1 and got["staged_mid"] == 0
    assert got["counters"]["rows_adopted"] == 200 and got["spool"]
    assert got["ctl"]["c_handoff"] == 2 * 8 + wire.HP_INSERTED
    assert len(got["adopted"]) == 1 and got["released"]


def test_phase_of_equals_reference():
    for ack in (0, 7 * 8 + wire.HP_STAGED, 8 * 8 + wire.HP_INSERTED, 3):
        for hid in (0, 7, 8):
            assert rb._phase_of(ack, hid) == jrb._phase_of(ack, hid)
    assert rb._phase_of(7 * 8 + wire.HP_STAGED, 7) == wire.HP_STAGED
    assert rb._phase_of(7 * 8 + wire.HP_STAGED, 8) == 0


# ---------------------------------------------------------------------------
# ElasticPolicy
# ---------------------------------------------------------------------------

def _policies(**kw):
    kw = {"min_engines": 1, "max_engines": 4, "hysteresis_ticks": 3,
          "cooldown_s": 10.0, **kw}
    return elastic.ElasticPolicy(**kw), jelastic.ElasticPolicy(**kw)


HOT = {"backlog_per_engine": 1e6}
QUIET = {"backlog_per_engine": 500.0, "backlog_max": 500.0}
POLICY_CASES = {
    # one spike never moves the fleet; the streak resets
    "hysteresis": ({}, [(HOT, 2), (HOT, 2), (QUIET, 2), (HOT, 2), (HOT, 2),
                        (HOT, 2)], None),
    # the cooldown suppresses and counts, then the same evidence grows
    "cooldown": ({}, [(HOT, 2)] * 3 + [(HOT, 3)] * 4, 3.0),
    "grow_clamped": ({"max_engines": 2}, [(HOT, 2)], None),
    "shrink_clamped": ({"min_engines": 2},
                       [({"backlog_per_engine": 1.0, "backlog_max": 1.0},
                         2)], None),
    "skew": ({}, [({"backlog_per_engine": 1000.0, "backlog_max": 9000.0,
                    "rate_skew": 5.0}, 2)] * 3, None),
    "quiet_shrinks": ({}, [({"backlog_per_engine": 2.0,
                             "backlog_max": 4.0}, 3)] * 3, None),
    "degraded_holds": ({}, [({"backlog_per_engine": 2.0, "backlog_max": 4.0,
                              "degraded": True}, 3)] * 6, None),
    "slo_and_drops": ({}, [({"p99_us": 900.0, "slo_us": 500.0,
                             "tx_dropped": 2, "watchdog_trips": 1},
                            2)] * 3, None),
}


@pytest.mark.parametrize("case", sorted(POLICY_CASES))
def test_elastic_policy_equals_reference(case):
    kw, ticks, executed_at = POLICY_CASES[case]
    got_pol, want_pol = _policies(**kw)
    for pol in (got_pol, want_pol):
        for t, (sig, n_live) in enumerate(ticks):
            plan = pol.decide(sig, n_live, float(t))
            if executed_at is not None and plan["action"] != "hold" \
                    and t < executed_at:
                pol.executed(executed_at)
    assert got_pol.decisions == want_pol.decisions
    assert got_pol.suppressed == want_pol.suppressed
    last = got_pol.decisions[-1]
    assert last["action"] == {
        "hysteresis": "grow", "cooldown": "hold", "grow_clamped": "hold",
        "shrink_clamped": "hold", "skew": "rebalance",
        "quiet_shrinks": "shrink", "degraded_holds": "hold",
        "slo_and_drops": "grow"}[case]


def test_elastic_policy_validates_clamps():
    for mod in (elastic, jelastic):
        for lo, hi in ((3, 2), (0, 2)):
            with pytest.raises(ValueError):
                mod.ElasticPolicy(min_engines=lo, max_engines=hi)


def test_elastic_policy_seeded_200_ticks_equal_reference():
    """200 seeded signal vectors (backlogs across the grow and shrink
    bars, skews, p99 against a budget, drops, trips, degraded), with the
    live count following the executed plans and each executed plan
    starting the cooldown: every plan, streak and suppression equal."""
    got_pol, want_pol = _policies(min_engines=1, max_engines=4,
                                  hysteresis_ticks=2, cooldown_s=5.0)
    for pol in (got_pol, want_pol):
        n_live, now = 2, 0.0
        rr = np.random.default_rng(13)
        for _ in range(200):
            now += 2.0
            sig = {}
            if rr.random() < 0.8:
                b = float(rr.choice([10.0, 500.0, 9000.0, 50000.0]))
                sig["backlog_per_engine"] = b
                sig["backlog_max"] = b * float(rr.choice([1.0, 3.0]))
            if rr.random() < 0.3:
                sig["rate_skew"] = float(rr.choice([1.1, 2.5, 4.0]))
            if rr.random() < 0.2:
                sig["p99_us"], sig["slo_us"] = float(rr.integers(100, 2000)), 800.0
            if rr.random() < 0.1:
                sig["tx_dropped"] = int(rr.integers(0, 3))
            if rr.random() < 0.05:
                sig["watchdog_trips"] = 1
            if rr.random() < 0.1:
                sig["degraded"] = True
            plan = pol.decide(sig, n_live, now)
            if plan["action"] != "hold":
                pol.executed(now)
                n_live += {"grow": 1, "shrink": -1}.get(plan["action"], 0)
    assert got_pol.decisions == want_pol.decisions
    assert got_pol.suppressed == want_pol.suppressed
    assert {d["action"] for d in got_pol.decisions} >= {"hold", "grow"}


# ---------------------------------------------------------------------------
# the engine's three quiescent methods, against the reference engine
# ---------------------------------------------------------------------------

def _cfgs():
    t = dict(capacity=CAP, salt=0x5EED)
    bt = dict(max_batch=B, readback_depth=4)
    lim = dict(pps_threshold=200.0, bps_threshold=1e9)
    return (config.FsxConfig(limiter=config.LimiterConfig(**lim),
                             table=config.TableConfig(**t),
                             batch=config.BatchConfig(**bt)),
            jconfig.FsxConfig(limiter=jconfig.LimiterConfig(**lim),
                              table=jconfig.TableConfig(**t),
                              batch=jconfig.BatchConfig(**bt)))


def _stream(seed, n):
    return TrafficGen(TrafficSpec(
        scenario=Scenario.UDP_FLOOD_MULTI, rate_pps=1e6, n_attack_ips=16,
        n_benign_ips=900, attack_fraction=0.6, seed=seed)).next_records(n)


def _host(e, port):
    if port:
        return schema.table_to_numpy(e.table)
    return np.asarray(e.table.key), np.asarray(e.table.state)


@pytest.fixture(scope="module")
def engine_handoffs(tmp_path_factory):
    """A donor and a recipient of each package serve their own seeded
    records, checkpoint, then shard 2 of 3 moves: extract, adopt, drop."""
    import torch

    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    tmp = tmp_path_factory.mktemp("eng")
    pcfg, jcfg = _cfgs()
    recs = {"donor": _stream(21, 12 * B), "recip": _stream(22, 8 * B)}
    out = {}
    try:
        for pkg in ("port", "reference"):
            port = pkg == "port"
            engs = {}
            for role, rec in recs.items():
                if port:
                    e = Engine(pcfg, ArraySource(rec.copy()), CollectSink(),
                               device="cpu", sink_thread=False)
                else:
                    e = JEngine(jcfg, JArraySource(rec.copy()),
                                JCollectSink(), sink_thread=False)
                e.run()
                e.checkpoint(tmp / f"{pkg}_{role}.npz")
                engs[role] = e
            d, r = engs["donor"], engs["recip"]
            res = {"before": [_host(e, port) for e in (d, r)]}
            res["extract"] = d.extract_span_rows([2], 3)
            res["adopt"] = r.adopt_rows(*res["extract"])
            res["drop"] = d.drop_span_rows([2], 3)
            res["drop_again"] = d.drop_span_rows([2], 3)
            res["adopt_again"] = r.adopt_rows(*res["extract"])
            res["adopt_none"] = r.adopt_rows(np.empty(0, np.uint32),
                                             np.empty((0, 12), np.float32))
            res["after"] = [_host(e, port) for e in (d, r)]
            res["engines"] = engs
            out[pkg] = res
    finally:
        torch.set_num_threads(prev)
    return out, tmp


def _same_table(a, b):
    assert np.array_equal(a[0], b[0])
    assert a[1].tobytes() == b[1].tobytes()


def test_engine_handoff_equals_reference(engine_handoffs):
    out, _ = engine_handoffs
    got, want = out["port"], out["reference"]
    for a, b in zip(got["before"], want["before"]):
        _same_table(a, b)
    _same_table(got["extract"], want["extract"])
    assert len(got["extract"][0]) > 0
    assert np.all(wire.shard_of(got["extract"][0], 3) == 2)
    for k in ("adopt", "drop", "drop_again", "adopt_again", "adopt_none"):
        assert got[k] == want[k], k
    assert got["adopt"] == (len(got["extract"][0]), 0)
    assert got["drop"] == len(got["extract"][0]) and got["drop_again"] == 0
    assert got["adopt_again"] == (0, len(got["extract"][0]))
    for a, b in zip(got["after"], want["after"]):
        _same_table(a, b)
    # conserved: the donor lost the span, the recipient holds it
    (dk, ds), (rk, rs) = got["after"]
    (dk0, ds0), (rk0, rs0) = got["before"]
    assert rb.rows_conserved(
        (np.concatenate([dk0[dk0 != 0], rk0[rk0 != 0]]),
         np.concatenate([ds0[dk0 != 0], rs0[rk0 != 0]])),
        [(dk[dk != 0], ds[dk != 0]), (rk[rk != 0], rs[rk != 0])])["ok"]


def test_engine_table_written_in_place(engine_handoffs):
    out, _ = engine_handoffs
    d = out["port"]["engines"]["donor"]
    ptrs = (d.table.key_rows.data_ptr(), d.table.state_rows.data_ptr())
    park = (d.table.key_rows[-1].clone(), d.table.state_rows[-1].clone())
    d.drop_span_rows([0], 3)
    d.adopt_rows(*out["port"]["extract"])
    assert (d.table.key_rows.data_ptr(),
            d.table.state_rows.data_ptr()) == ptrs
    # the park row is neither shipped nor written
    assert bool((d.table.key_rows[-1] == park[0]).all())
    assert bool((d.table.state_rows[-1] == park[1]).all())


@pytest.mark.parametrize("call", ["extract_span_rows", "drop_span_rows",
                                  "adopt_rows"])
def test_engine_methods_raise_with_batches_in_flight(engine_handoffs, call):
    out, _ = engine_handoffs
    e = out["port"]["engines"]["recip"]
    args = {"adopt_rows": out["port"]["extract"]}.get(call, ([2], 3))
    e._inflight.append(None)
    try:
        with pytest.raises(RuntimeError, match="in flight"):
            getattr(e, call)(*args)
    finally:
        e._inflight.clear()


def test_engine_report_carries_the_counters(engine_handoffs):
    out, _ = engine_handoffs
    e = out["port"]["engines"]["recip"]
    e.count_rebalance("rows_adopted", 5)
    e.count_rebalance("adopt_dropped", 2)
    e.reset_stream(ArraySource(_stream(23, B)))
    rep = e.run()
    assert rep.rebalance["rows_adopted"] == 5
    assert "rebalance_adopt_dropped:2" in rep.health["reasons"]


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_load_ckpt_rows_on_each_packages_checkpoint(engine_handoffs,
                                                    writer):
    _, tmp = engine_handoffs
    path = tmp / f"{writer}_donor.npz"
    k, s = rb.load_ckpt_rows(path)
    jk, js = jrb.load_ckpt_rows(path)
    assert len(k) > 0 and np.array_equal(k, jk)
    assert s.tobytes() == js.tobytes()
    other = tmp / f"{'reference' if writer == 'port' else 'port'}_donor.npz"
    ok, os_ = rb.load_ckpt_rows(other)
    assert np.array_equal(np.sort(ok), np.sort(k))


# ---------------------------------------------------------------------------
# the supervisor on stub fleets, beside the reference's
# ---------------------------------------------------------------------------

SUPS = {"port": (ClusterSupervisor, stub_engine_main, rb, elastic),
        "reference": (JSupervisor, jstub, jrb, jelastic)}


def _stub_specs(n, **extra):
    return [{"stub_serve_s": 60.0, "workers": 1, **extra} for _ in range(n)]


def _boot_both(tmp_path, specs_of, wait=(), **kw):
    """A stub fleet of each package under ``tmp_path/<pkg>/cl``; waits
    until the ranks in ``wait`` heartbeat as SERVING."""
    sups = {}
    for pkg, (Sup, stub, _, _) in SUPS.items():
        root = tmp_path / pkg
        root.mkdir()
        sup = Sup(root / "cl", specs_of(root), entry=stub, t0_ns=T0_NS,
                  t0_wall_ns=T0_WALL_NS, heartbeat_timeout_s=60.0, **kw)
        sup.boot()
        sups[pkg] = sup
    deadline = time.monotonic() + 60
    for sup in sups.values():
        st = [mailbox.StatusBlock(mailbox.status_path(sup.cluster_dir, r))
              for r in wait]
        while not all(s.ctl_get("c_state") == wire.CSTATE_SERVING
                      and s.ctl_get("c_hbeat") for s in st):
            assert time.monotonic() < deadline, "stub fleet never served"
            time.sleep(0.01)
    return sups


def _files(sup) -> dict:
    d = sup.cluster_dir
    return {n: (d / n).read_text() if (d / n).exists() else None
            for n in ("layout.json", "handoff.json")}


def _norm(sups, obj_of) -> list:
    """``obj_of(pkg, sup)`` of each package, its directory replaced."""
    out = []
    for pkg, sup in sups.items():
        text = json.dumps(obj_of(pkg, sup), sort_keys=True, default=str)
        out.append(json.loads(text.replace(str(sup.cluster_dir.parent),
                                           "<dir>")))
    return out


def _handoff_state(sup):
    h = dict(sup._handoff or {})
    h.pop("deadline", None)
    return {"handoff": h, "counters": sup.rebalance_counters,
            "seq": sup._handoff_seq, "files": _files(sup),
            "ctl": [[sup._status[r].ctl_get(k) for k in (
                "c_fence", "c_layout_gen")] for r in range(sup.n)]}


def _aggregate(pkg, sup):
    """``aggregate()``; its multi-host ``hosts`` block is None on one
    host, in both packages."""
    agg = sup.aggregate()
    assert agg["hosts"] is None, pkg
    return agg


def _close_and_aggregate(sups):
    for sup in sups.values():
        sup.close()
    return _norm(sups, _aggregate)


def test_supervisor_handoff_commit_and_lift_equal_reference(tmp_path):
    sups = _boot_both(tmp_path, lambda root: _stub_specs(3), wait=(0, 1, 2))
    try:
        steps = {}
        for pkg, sup in sups.items():
            st = sup._status
            hid = sup.start_handoff([2], donor=2, recipient=0)
            with pytest.raises(RuntimeError, match="already in flight"):
                sup.start_handoff([1], donor=1, recipient=0)
            seen = [_handoff_state(sup)]
            st[2].ctl_set("c_handoff", hid * 8 + wire.HP_SHIPPED)
            sup.poll()
            seen.append(_handoff_state(sup))   # the donor alone: no commit
            # the recipient stages (its spool is the shipped-row census)
            SUPS[pkg][2].save_spool(SUPS[pkg][2].staged_path(
                sup.cluster_dir, 0), *_rows(np.random.default_rng(3), 40),
                handoff_id=hid, to_gen=1)
            st[0].ctl_set("c_handoff", hid * 8 + wire.HP_STAGED)
            sup.poll()
            seen.append(_handoff_state(sup))   # committed
            for r in (0, 2):
                st[r].ctl_set("c_layout_ack", 1)
            sup.poll()
            seen.append(_handoff_state(sup))   # rank 1's ack missing
            st[1].ctl_set("c_layout_ack", 1)
            sup.poll()
            seen.append(_handoff_state(sup))   # lifted
            steps[pkg] = seen
        a, b = _norm(sups, lambda pkg, _: steps[pkg])
        assert a == b
        port = a
        assert port[1]["handoff"]["phase"] == "shipping"
        assert port[2]["handoff"]["phase"] == "committing"
        assert port[3]["handoff"]["phase"] == "committing"
        assert port[4]["handoff"] == {} and port[4]["counters"]["flips"] == 1
        assert port[4]["counters"]["rows_shipped"] == 40
        assert json.loads(port[4]["files"]["layout.json"]) == {
            "generation": 1, "owners": [0, 1, 0]}
    finally:
        got, want = _close_and_aggregate(sups)
    assert got == want


def test_supervisor_aborts_when_a_party_dies(tmp_path):
    sups = _boot_both(tmp_path, lambda root: _stub_specs(3), wait=(0, 1, 2))
    try:
        seen = {}
        stderr = {}
        for pkg, sup in sups.items():
            mod = SUPS[pkg][2]
            # a spool of an earlier committed flip survives the abort
            mod.save_spool(mod.staged_path(sup.cluster_dir, 0),
                           *_rows(np.random.default_rng(4), 8),
                           handoff_id=1, to_gen=0)
            hid = sup.start_handoff([2], donor=2, recipient=0)
            sup.kill(0)
            buf = io.StringIO()
            with contextlib.redirect_stderr(buf):
                sup.poll()
            stderr[pkg] = buf.getvalue()
            seen[pkg] = {**_handoff_state(sup),
                         "mailbox": Path(mod.handoff_mailbox_path(
                             sup.cluster_dir, hid)).exists(),
                         "spool": mod.staged_path(sup.cluster_dir,
                                                  0).exists()}
        assert seen["port"] == seen["reference"]
        assert seen["port"]["counters"]["aborts"] == 1
        assert seen["port"]["handoff"] == {} and seen["port"]["spool"]
        assert not seen["port"]["mailbox"]
        assert stderr["port"] == stderr["reference"]
        assert "ABORTED: party died" in stderr["port"]
    finally:
        got, want = _close_and_aggregate(sups)
    assert got == want
    assert "rebalance_aborts:1" in got["health"]["reasons"]


@pytest.mark.parametrize("committed", [True, False])
def test_neutralize_stale_handoff_equals_reference(tmp_path, committed):
    sups = _boot_both(tmp_path, lambda root: _stub_specs(3), wait=(0, 1, 2))
    try:
        for pkg, sup in sups.items():
            mod = SUPS[pkg][2]
            d = sup.cluster_dir
            if committed:
                mod.ShardAssignment(1, (0, 1, 0)).save(d)
            mod._write_atomic(mod.handoff_json_path(d), json.dumps({
                "id": 5, "shards": [2], "donor": 2, "recipient": 0,
                "to_gen": 1, "total_shards": 3, "source": "engine"}) + "\n")
            mod.HandoffMailbox.create(mod.handoff_mailbox_path(d, 5))
            mod.save_spool(mod.staged_path(d, 0), *_rows(
                np.random.default_rng(5), 8), handoff_id=5, to_gen=1)
            for st in sup._status:
                st.ctl_set("c_fence", 5)
            sup._neutralize_stale_handoff()
        a, b = _norm(sups, lambda _, s: {
            **_handoff_state(s),
            "mbx": Path(SUPS["port"][2].handoff_mailbox_path(
                s.cluster_dir, 5)).exists(),
            "spool": (s.cluster_dir / "handoff_staged_r0.npz").exists()})
        assert a == b
        assert a["seq"] == 5 and all(c[0] == 0 for c in a["ctl"])
        if committed:
            assert a["handoff"]["phase"] == "committing"
            assert all(c[1] == 1 for c in a["ctl"]) and a["spool"]
        else:
            assert a["handoff"] == {} and not a["mbx"] and not a["spool"]
    finally:
        got, want = _close_and_aggregate(sups)
    assert got == want


def test_adopt_dead_span_from_checkpoint_equals_reference(tmp_path):
    keys, states = _rows(np.random.default_rng(6), 3000)
    k, s = keys, states

    def specs(root):
        _write_ckpt(root / "ck_r1.npz", k, s)
        return [{"stub_serve_s": 60.0, "workers": 1},
                {"stub_serve_s": 60.0, "workers": 1,
                 "checkpoint": str(root / "ck_r1.npz")}]

    sups = _boot_both(tmp_path, specs, wait=(0, 1))
    try:
        entries, mbx = [], []
        for pkg, sup in sups.items():
            entries.append(sup.adopt_dead_span(1, 0))
            mbx.append(Path(SUPS[pkg][2].handoff_mailbox_path(
                sup.cluster_dir, entries[-1]["handoff_id"])).read_bytes())
        a, b = _norm(sups, lambda _, s: _handoff_state(s))
        assert a == b and entries[0] == entries[1] and mbx[0] == mbx[1]
        span = wire.shard_of(keys, 2) == 1
        assert entries[0]["rows"] == int(span.sum()) > 0
        assert a["counters"]["adoptions"] == 1
        assert [c[0] for c in a["ctl"]] == [1, 0]   # the recipient alone
        # the mailbox holds the whole sealed stream of the span's rows
        recv = rb.HandoffReceiver()
        recv.drain(rb.HandoffMailbox(rb.handoff_mailbox_path(
            sups["port"].cluster_dir, 1)), max_slots=1 << 10)
        assert recv.done and recv.ok
        assert rb.rows_conserved((keys[span], states[span]),
                                 [recv.rows()])["ok"]
    finally:
        got, want = _close_and_aggregate(sups)
    assert got == want
    assert got["rebalance"]["adopted_spans"] == [entries[0]]


def test_boot_adopt_census_equals_reference(tmp_path):
    """Supervisor A's rank 1 is SIGKILLed and A stops supervising; B boots
    with ``adopt=True`` (the census), then stop-drains the fleet."""
    from flowsentryx_tpu_torch.chaos import faults

    def specs(root):
        (root / "ck_r1.npz").write_bytes(b"stub flow memory")
        return [{"stub_serve_s": 60.0, "workers": 1},
                {"stub_serve_s": 60.0, "workers": 1,
                 "checkpoint": str(root / "ck_r1.npz")}]

    sups_a = _boot_both(tmp_path, specs, wait=(0, 1))
    sups_b = {}
    try:
        for pkg, sup in sups_a.items():
            faults.kill_process_group(sup._procs[1].pid)
            sup._procs[1].join(timeout=10.0)
            sups_b[pkg] = SUPS[pkg][0](sup.cluster_dir, sup.specs,
                                       entry=SUPS[pkg][1],
                                       heartbeat_timeout_s=60.0)
            sups_b[pkg].boot(adopt=True)
        a, b = _norm(sups_b, lambda _, s: {
            "adopted": sorted(s._adopted), "restarts": s.restarts,
            "gen": s._gen, "t0": [s.t0_ns, s.t0_wall_ns],
            "active": sorted(s._active)})
        assert a == b
        assert a["adopted"] == [0] and a["restarts"] == [0, 1]
        assert a["gen"] == [0, 1] and a["t0"] == [T0_NS, T0_WALL_NS]
        for sup in sups_b.values():
            sup.run(max_seconds=0.5)
        for pkg, sup in sups_a.items():
            with pytest.raises(RuntimeError, match="nothing to adopt"):
                SUPS[pkg][0](tmp_path / pkg / "none", sup.specs,
                             entry=SUPS[pkg][1]).boot(adopt=True)
    finally:
        for sup in sups_a.values():
            sup.close()
    got, want = _norm(sups_b, _aggregate)
    assert got == want
    assert got["adopted_ranks"] == [] and got["failed_ranks"] == []
    assert sorted((r["rank"], r["gen"]) for r in got["reports"]) == [
        (0, 0), (1, 1)]


def test_elastic_tick_with_injected_signals_equals_reference(tmp_path):
    """An elastic stub fleet (2 live of 3): injected backlog signals
    decide GROW (rank 2 spawns), then the grow's span move, then clamped
    and suppressed ticks; every plan, file and counter equals the
    reference's."""
    signals = [{"backlog_per_engine": 9e4, "backlog_max": 1e5}] * 6
    sups = {}
    for pkg, (Sup, stub, _, el) in SUPS.items():
        (tmp_path / pkg).mkdir()
        sups[pkg] = Sup(tmp_path / pkg / "cl", _stub_specs(3), entry=stub,
                        t0_ns=T0_NS, t0_wall_ns=T0_WALL_NS, n_live=2,
                        heartbeat_timeout_s=60.0,
                        elastic=el.ElasticPolicy(
                            min_engines=2, max_engines=3,
                            hysteresis_ticks=2, cooldown_s=3.0))
        sups[pkg].boot()
    try:
        plans = {}
        for pkg, sup in sups.items():
            it = iter(signals)
            sup._sample_signals = lambda now, it=it: dict(next(it))
            out = []
            for i in range(6):
                if i == 2:
                    # the grown rank serves before the span move
                    st = sup._status[2]
                    deadline = time.monotonic() + 60
                    while st.ctl_get("c_state") != wire.CSTATE_SERVING:
                        assert time.monotonic() < deadline
                        time.sleep(0.01)
                out.append(sup.elastic_tick(now=100.0 + 2.0 * i))
                out.append(_handoff_state(sup))
            plans[pkg] = out
        a, b = _norm(sups, lambda pkg, _: plans[pkg])
        assert a == b
        actions = [p["action"] for p in a[0::2]]
        assert actions[:2] == ["hold", "grow"]
        assert a[5]["handoff"]["recipient"] == 2
        assert a[5]["handoff"]["shards"] == [2]
        assert sups["port"].elastic_executed == 1
    finally:
        got, want = _close_and_aggregate(sups)
    assert got == want
    assert got["elastic"]["executed"] == 1
    assert got["boot"] is None and got["active_ranks"] == [0, 1, 2]


def test_prewarm_main_warms_a_cache_on_the_cpu(tmp_path):
    cfg = _cfgs()[0]
    assert prewarm_main({"cfg_json": cfg.to_json(), "device": "cpu",
                         "mega": 2, "compile_cache": str(tmp_path / "c")}
                        ) == 0


# ---------------------------------------------------------------------------
# real engines: one CPU fleet, and the CLI
# ---------------------------------------------------------------------------

def test_real_cpu_fleet_moves_shard_2_mid_serve(tmp_path, monkeypatch):
    """``chip_smoke.rebalance_live_drive`` on the CPU at 2^12 rows: two
    live rank processes of three provisioned (one torch thread each, so
    the fleet takes two cores of the host); shard 2 moves from rank 0
    to rank 1 while both keep serving; exact row conservation, one flip,
    no abort, and every produced record served at the drain."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    sys.path.insert(0, str(REPO))
    import chip_smoke

    cfg = config.FsxConfig(table=config.TableConfig(capacity=CAP),
                           batch=config.BatchConfig(max_batch=B))
    recs = _stream(31, 24 * B)
    res = chip_smoke.rebalance_live_drive("cpu", str(tmp_path / "live"), cfg,
                                          recs, pre=16 * B, timeout_s=120)
    assert res["ok"], res["checks"]
    c = res["conservation"]
    assert c["rows_shipped"] == c["rows_adopted"] > 0
    assert c["rows_dropped_post_flip"] == c["rows_shipped"]
    assert res["records"]["served"] == res["records"]["produced"] == len(recs)


def test_cli_cluster_elastic_then_adopt_on_the_cpu(tmp_path):
    """``cli cluster --elastic --device cpu``: 2 live engines of 3
    provisioned (each pinned to one core with a one-thread torch pool)
    serve a ring fan-out, then stop-drain; ``--adopt`` then re-attaches
    to the plane they left (every rank DONE) and exits 0."""
    from flowsentryx_tpu_torch.engine.shm import ShmRing

    base = str(tmp_path / "ring")
    recs = _stream(41, 8 * B)
    recs["ts_ns"] += np.uint64(time.clock_gettime_ns(time.CLOCK_MONOTONIC)
                               + 60 * 10**9 - int(recs["ts_ns"][0]))
    sh = wire.shard_of(recs["saddr"], 3)
    owners = rb.ShardAssignment.initial(3, 1, 2).owners
    rings = [ShmRing.create(wire.shard_ring_path(base, k, 3), 1 << 12,
                            wire.FLOW_RECORD_DTYPE) for k in range(3)]
    for s in range(3):
        rings[rb.assigned_ring_of(s, owners, 1)].produce(recs[sh == s])
    argv = [sys.executable, "-m", "flowsentryx_tpu_torch.cli", "cluster",
            "--device", "cpu", "--feature-ring", base, "--engines", "2",
            "--shards", "3", "--table-capacity", str(CAP), "--pin-cores",
            "on"]
    p = subprocess.run(argv + ["--elastic", "--max-engines", "3",
                               "--seconds", "4"],
                       cwd=REPO, capture_output=True, text=True, timeout=240)
    assert p.returncode == 0, p.stderr[-4000:]
    agg = json.loads(p.stdout)
    assert agg["engines"] == 3 and agg["active_ranks"] == [0, 1]
    assert agg["elastic"]["min_engines"] == 1
    assert agg["elastic"]["max_engines"] == 3
    assert agg["records"] == len(recs) and agg["failed_ranks"] == []
    assert json.loads((Path(f"{base}.cluster") / "layout.json").read_text()
                      ) == {"generation": 0, "owners": list(owners)}
    assert "elastic [1, 3]" in p.stderr
    p = subprocess.run(argv + ["--elastic", "--max-engines", "3", "--adopt"],
                       cwd=REPO, capture_output=True, text=True, timeout=240)
    assert p.returncode == 0, p.stderr[-4000:]
    agg2 = json.loads(p.stdout)
    assert agg2["adopted_ranks"] == [] and agg2["active_ranks"] == []
    assert agg2["restarts"] == [0, 0, 0]
    assert agg2["t0_ns"] == agg["t0_ns"]


# ---------------------------------------------------------------------------
# imports
# ---------------------------------------------------------------------------

def test_supervisor_side_imports_no_torch():
    """The supervisor, the rebalance and elastic modules, and the handoff
    child's ``ship_rows`` path import neither torch nor jax nor the
    reference package."""
    code = (
        "import sys\n"
        "import flowsentryx_tpu_torch.cluster.rebalance as rb\n"
        "import flowsentryx_tpu_torch.cluster.elastic\n"
        "import flowsentryx_tpu_torch.cluster.supervisor\n"
        "import numpy as np, tempfile, os\n"
        "d = tempfile.mkdtemp()\n"
        "m = rb.HandoffMailbox.create(os.path.join(d, 'm.mbx'), slots=4,"
        " rows_per_slot=4)\n"
        "rb.ship_rows(m, np.arange(1, 9, dtype=np.uint32),"
        " np.zeros((8, 12), np.float32))\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('torch', 'jax', 'flowsentryx_tpu')]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"
