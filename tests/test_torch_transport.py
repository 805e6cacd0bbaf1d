"""The port's multi-host gossip leg (``flowsentryx_tpu_torch/cluster/
transport.py``, the gossip plane's ``net=`` leg, the health ladder's net
reasons) against the JAX package's, on the CPU and on real loopback
sockets.

* every case of the reference's ``tests/test_transport.py`` (datagram
  framing, the canonical form, the mailbox's sequence discipline, epoch
  rebase and skew bound, backpressure, handshake, federation beacons,
  the plane's net leg, the health reasons), run on both packages: the
  port's results must be the reference's;
* the four sections of the reference's ``scripts/net_smoke.py`` with the
  port's planes (the campaign's ``_net_pair``): a lossless exchange both
  ways with the absolute expiry kept through the rebase, a healed
  partition converging within ``HEAL_TICK_BOUND`` ticks, federation
  death detection, and the u64 sequence crossing 2^32 on the datagram
  and the shm transports;
* the packages mixed: ``pack_packet`` gives the same bytes for
  hypothesis-drawn headers and wires, each ``unpack_packet`` reads the
  other's bytes and both reject the same malformed ones, the canonical
  form and the digest agree, and a port mailbox and a reference mailbox
  250 s of epoch apart exchange wires both ways on loopback UDP with
  rebased untils bit-equal to a reference pair's and one ``net_digest``;
* the supervisor's side (transport, gossip, supervisor, runner) imports
  no torch.

Every socket binds port 0 or a probed free port.  Every compared field
is exact: no tolerance beyond the reference's own.
"""

import platform
import socket
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from flowsentryx_tpu.cluster import gossip as jgossip
from flowsentryx_tpu.cluster import mailbox as jmailbox
from flowsentryx_tpu.cluster import transport as jtransport
from flowsentryx_tpu.core import schema as jschema
from flowsentryx_tpu.engine import health as jhealth
from flowsentryx_tpu.engine.writeback import (
    BlacklistUpdate as JUpdate, CollectSink as JSink,
)
from flowsentryx_tpu.sync import tuning as jtuning
from flowsentryx_tpu_torch.chaos import campaign
from flowsentryx_tpu_torch.cluster import gossip, mailbox, transport
from flowsentryx_tpu_torch.core import wire
from flowsentryx_tpu_torch.engine import health
from flowsentryx_tpu_torch.engine.writeback import BlacklistUpdate, CollectSink
from flowsentryx_tpu_torch.sync import tuning

pytestmark = pytest.mark.skipif(
    platform.system() != "Linux",
    reason="loopback UDP + CLOCK_MONOTONIC semantics (Linux)")

REPO = Path(__file__).resolve().parents[1]
EPOCH_DELTA_S = 250.0
#: the reference net smoke's bound on ticks to converge after a heal
HEAL_TICK_BOUND = 60

PKG = {
    "port": types.SimpleNamespace(
        t=transport, W=wire, gossip=gossip, health=health, tuning=tuning,
        mailbox=mailbox, Update=BlacklistUpdate, Sink=CollectSink),
    "reference": types.SimpleNamespace(
        t=jtransport, W=jschema, gossip=jgossip, health=jhealth,
        tuning=jtuning, mailbox=jmailbox, Update=JUpdate, Sink=JSink),
}
BOTH = pytest.mark.parametrize("pkg", ["port", "reference"])
CROSS = [("port", "reference"), ("reference", "port")]


def _clocks(delta_s: float = 0.0):
    mono = time.clock_gettime_ns(time.CLOCK_MONOTONIC)
    wall = time.time_ns()
    d = int(delta_s * 1e9)
    return mono - d, wall - d


def _mk_wire(keys, untils, k=4, now=0.0):
    w = np.zeros(2 * k + 4, np.uint32)
    keys = np.asarray(keys, np.uint32)
    w[:len(keys)] = keys
    w[k:k + len(keys)] = np.asarray(untils, np.float32).view(np.uint32)
    w[2 * k] = len(keys)
    w[2 * k + 3] = np.float32(now).view(np.uint32)
    return w


def _pair(ma, mb, clocks_a=None, clocks_b=None, **kw):
    """A (fresh epoch, package ``ma``) and B (epoch 250 s older, ``mb``)
    on loopback, each the other's peer."""
    mono_a, wall_a = clocks_a or _clocks()
    mono_b, wall_b = clocks_b or _clocks(EPOCH_DELTA_S)
    a = ma.t.NetMailbox(0, 0, mono_a, wall_a, k_max=4, **kw)
    b = mb.t.NetMailbox(1, 0, mono_b, wall_b, k_max=4, **kw)
    a.add_peer((1, 0), b.addr)
    b.add_peer((0, 0), a.addr)
    return a, b


@pytest.fixture()
def pair(pkg):
    a, b = _pair(PKG[pkg], PKG[pkg])
    yield a, b
    a.close()
    b.close()


def _bnow(b):
    return (time.clock_gettime_ns(time.CLOCK_MONOTONIC) - b.t0_ns) * 1e-9


def _pump_until(mbx, pred, timeout_s=2.0):
    deadline = time.monotonic() + timeout_s
    while not pred():
        mbx.pump()
        if time.monotonic() > deadline:
            return False
        time.sleep(0.005)
    return True


def _send(pkts, addr):
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        for p in pkts:
            sock.sendto(p, addr)
            time.sleep(0.002)
    finally:
        sock.close()


def _free_bases(n_hosts, n_engines):
    """Probed free base ports (chip_smoke's: each base and its engine
    ports free, no two hosts' ranges overlapping)."""
    sys.path.insert(0, str(REPO))
    import chip_smoke

    return chip_smoke._free_base_ports(n_hosts, n_engines)


# ---------------------------------------------------------------------------
# the constants
# ---------------------------------------------------------------------------

def test_net_constants_equal_reference():
    names = [n for n in dir(jschema) if n.startswith("NET_")]
    assert len(names) >= 15
    for n in names + ["RANGE_EPOCH_SKEW_S"]:
        assert getattr(wire, n) == getattr(jschema, n), n
    for n in [n for n in dir(jtuning) if n.startswith("NET_")]:
        assert getattr(tuning, n) == getattr(jtuning, n), n


# ---------------------------------------------------------------------------
# datagram framing and the canonical form, both packages
# ---------------------------------------------------------------------------

class TestPacket:
    @BOTH
    @pytest.mark.parametrize("seq", [
        1, (1 << 32) - 1, 1 << 32, (1 << 32) + 1, (1 << 63) + 5])
    def test_u64_seq_split_roundtrip(self, pkg, seq):
        m = PKG[pkg]
        wall = time.time_ns()
        pkt = m.t.unpack_packet(m.t.pack_packet(
            m.W.NET_KIND_WIRE, 3, 1, seq, 2, wall, _mk_wire([7], [1.0])))
        assert pkt["seq"] == seq
        assert pkt["t0_wall_ns"] == wall
        assert pkt["host"] == 3 and pkt["rank"] == 1
        assert pkt["count"] == 2
        assert len(pkt["wire"]) == 2 * 4 + 4

    @BOTH
    def test_ctl_packet_has_no_wire(self, pkg):
        m = PKG[pkg]
        pkt = m.t.unpack_packet(m.t.pack_packet(
            m.W.NET_KIND_HELLO, 0, 0, 0, 0, 123))
        assert pkt["kind"] == m.W.NET_KIND_HELLO
        assert pkt["wire"] is None

    @BOTH
    def test_malformed_rejected(self, pkg):
        m = PKG[pkg]
        assert m.t.unpack_packet(b"short") is None
        assert m.t.unpack_packet(b"\0" * 64) is None  # bad magic
        good = m.t.pack_packet(m.W.NET_KIND_WIRE, 0, 0, 1, 1, 123,
                               _mk_wire([1], [1.0]))
        assert m.t.unpack_packet(good[:-2]) is None   # torn word
        bad = m.t.pack_packet(m.W.NET_KIND_WIRE, 0, 0, 1, 1, 123,
                              np.zeros(5, np.uint32))
        assert m.t.unpack_packet(bad) is None


class TestCanonicalForm:
    @BOTH
    def test_until_wall_us_exact_integer_arithmetic(self, pkg):
        m = PKG[pkg]
        bits = np.array([np.float32(12.25).view(np.uint32)], np.uint32)
        wall = 1_700_000_000_123_456_789
        [us] = m.t.until_wall_us(bits, wall).tolist()
        assert us == wall // 1000 + 12_250_000

    @BOTH
    def test_map_digest_order_insensitive(self, pkg):
        m = PKG[pkg]
        assert m.t.map_digest({1: 10, 2: 20}) == m.t.map_digest(
            {2: 20, 1: 10})
        assert m.t.map_digest({1: 10}) != m.t.map_digest({1: 11})


# ---------------------------------------------------------------------------
# the mailbox: loopback delivery, rebase, sequence discipline
# ---------------------------------------------------------------------------

class TestNetMailbox:
    @BOTH
    def test_requires_stamped_epoch(self, pkg):
        with pytest.raises(ValueError, match="t0_wall_ns") as got:
            PKG[pkg].t.NetMailbox(0, 0, 123, 0)
        with pytest.raises(ValueError) as want:
            jtransport.NetMailbox(0, 0, 123, 0)
        assert str(got.value) == str(want.value)

    @BOTH
    def test_roundtrip_rebases_into_rx_epoch(self, pkg, pair):
        a, b = pair
        ln = _bnow(b)
        b.queue_tx(_mk_wire([101, 202], [ln + 10.0, ln + 12.5], now=ln), 2)
        b.pump()
        assert _pump_until(a, lambda: a.rx_wires == 1)
        [(src, seq, w, keys, untils)] = a.pop_wires(4)
        assert src == (1, 0) and seq == 1
        assert keys.tolist() == [101, 202]
        abs_err = abs((float(untils[0]) + a.t0_wall_ns * 1e-9)
                      - (ln + 10.0 + b.t0_wall_ns * 1e-9))
        assert abs_err < 0.005
        assert PKG[pkg].t.map_digest(a.net_map) == PKG[pkg].t.map_digest(
            b.net_map)

    @BOTH
    def test_duplicate_datagram_suppressed_and_counted(self, pkg, pair):
        a, b = pair
        m = PKG[pkg]
        ln = _bnow(b)
        pkt = m.t.pack_packet(m.W.NET_KIND_WIRE, 1, 0, 1, 1, b.t0_wall_ns,
                              _mk_wire([7], [ln + 9], now=ln))
        _send([pkt, pkt], a.addr)
        assert _pump_until(a, lambda: a.rx_pkts >= 2)
        assert a.rx_wires == 1 and a.rx_dup == 1

    @BOTH
    def test_reorder_restored_within_window(self, pkg, pair):
        a, b = pair
        m = PKG[pkg]
        ln = _bnow(b)
        _send([m.t.pack_packet(m.W.NET_KIND_WIRE, 1, 0, seq, 1,
                               b.t0_wall_ns, _mk_wire([seq], [ln + 9],
                                                      now=ln))
               for seq in (3, 1, 2)], a.addr)
        assert _pump_until(a, lambda: a.rx_wires == 3)
        assert [s for _, s, *_ in a.pop_wires(8)] == [1, 2, 3]
        assert a.rx_dup == 0 and a.rx_gap == 0

    @BOTH
    def test_window_overflow_evicts_and_counts_never_grows(self, pkg):
        m = PKG[pkg]
        mono, wall = _clocks()
        a = m.t.NetMailbox(0, 0, mono, wall, k_max=4, reorder_window=3)
        try:
            a.add_peer((1, 0), ("127.0.0.1", 1))
            sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            try:
                for seq in (20, 19, 18, 25, 30):
                    sock.sendto(m.t.pack_packet(
                        m.W.NET_KIND_WIRE, 1, 0, seq, 1, wall,
                        _mk_wire([seq], [9.0])), a.addr)
                    time.sleep(0.002)
                    a.pump()
                    assert len(a._rx_state[(1, 0)]["buf"]) <= 3
            finally:
                sock.close()
            assert a.reorder_evict >= 1
            assert a.rx_gap >= 1
        finally:
            a.close()

    @BOTH
    def test_hole_conceded_at_timeout(self, pkg):
        m = PKG[pkg]
        mono, wall = _clocks()
        a = m.t.NetMailbox(0, 0, mono, wall, k_max=4, reorder_timeout_s=0.05)
        try:
            a.add_peer((1, 0), ("127.0.0.1", 1))
            _send([m.t.pack_packet(m.W.NET_KIND_WIRE, 1, 0, seq, 1, wall,
                                   _mk_wire([seq], [9.0]))
                   for seq in (1, 3)], a.addr)       # 2 is lost for good
            assert _pump_until(a, lambda: a.rx_wires == 1)
            assert a.rx_gap == 0
            time.sleep(0.07)
            a.pump()
            assert a.rx_wires == 2 and a.rx_gap == 1
            assert a.gap_timeouts == 1
        finally:
            a.close()

    @BOTH
    def test_queue_tx_backpressure_drops_and_counts(self, pkg):
        mono, wall = _clocks()
        a = PKG[pkg].t.NetMailbox(0, 0, mono, wall, k_max=4, outq_max=2)
        try:
            w = _mk_wire([1], [9.0])
            t0 = time.monotonic()
            assert a.queue_tx(w, 1) and a.queue_tx(w, 1)
            assert not a.queue_tx(w, 1)
            assert time.monotonic() - t0 < 0.1
            assert a.txq_dropped == 1
            assert a.report()["tx_drop"] == 1
        finally:
            a.close()

    @BOTH
    def test_sendto_failure_drops_and_counts_never_raises(self, pkg):
        mono, wall = _clocks()
        a = PKG[pkg].t.NetMailbox(0, 0, mono, wall, k_max=4)
        try:
            a.add_peer((1, 0), ("255.255.255.255", 1))
            a.queue_tx(_mk_wire([1], [9.0]), 1)
            a.pump()
            assert a.tx_sock_drops >= 1
            assert a.report()["tx_drop"] >= 1
        finally:
            a.close()

    @BOTH
    def test_stale_epoch_refused_and_gauged(self, pkg, pair):
        a, b = pair
        m = PKG[pkg]
        bogus_wall = b.t0_wall_ns - int(3600 * 1e9)
        _send([m.t.pack_packet(m.W.NET_KIND_WIRE, 1, 0, 1, 1, bogus_wall,
                               _mk_wire([7], [10.0], now=0.0))], a.addr)
        assert _pump_until(a, lambda: a.rx_pkts >= 1)
        assert a.epoch_skew_dropped == 1
        assert a.rx_wires == 0 and not a.net_map
        assert a.epoch_skew_max > m.W.RANGE_EPOCH_SKEW_S

    @BOTH
    def test_hello_resets_peer_and_queues_resync(self, pkg, pair):
        a, b = pair
        m = PKG[pkg]
        ln = _bnow(b)
        b.queue_tx(_mk_wire([42], [ln + 9], now=ln), 1)
        b.pump()
        assert _pump_until(a, lambda: a.rx_wires == 1)
        _send([m.t.pack_packet(m.W.NET_KIND_HELLO, 1, 0, 0, 0,
                               b.t0_wall_ns)], a.addr)
        assert _pump_until(a, lambda: a.hellos_rx == 1)
        assert (1, 0) not in a._rx_state
        # the resync the HELLO queued went out on that pump: the own map
        # is empty here, so it sent nothing, and the peer got a WELCOME
        assert _pump_until(b, lambda: (0, 0) in b._peers_seen)

    @BOTH
    def test_handshake_discovers_peers_with_backoff(self, pkg, pair):
        a, b = pair
        deadline = time.monotonic() + 5.0
        done_a = False
        while not done_a and time.monotonic() < deadline:
            try:
                a.handshake(timeout_s=0.05)
                done_a = True
            except PKG[pkg].t.NetHandshakeTimeout:
                b.pump()
        assert done_a
        b.pump()
        assert (0, 0) in b._peers_seen

    @BOTH
    def test_spoofed_source_address_rejected(self, pkg):
        m = PKG[pkg]
        mono, wall = _clocks()
        a = m.t.NetMailbox(0, 0, mono, wall, k_max=4)
        try:
            a.add_peer((1, 0), ("10.9.9.9", 9))
            _send([m.t.pack_packet(kind, 1, 0, 1, 1, wall,
                                   _mk_wire([7], [9.0]))
                   for kind in (m.W.NET_KIND_WIRE, m.W.NET_KIND_HELLO)],
                  a.addr)
            assert _pump_until(a, lambda: a.rx_alien == 2)
            assert a.rx_wires == 0 and a.hellos_rx == 0
            assert not a.net_map
        finally:
            a.close()

    @BOTH
    def test_resync_prunes_long_expired_verdicts(self, pkg):
        m = PKG[pkg]
        mono, wall = _clocks()
        a = m.t.NetMailbox(0, 0, mono, wall, k_max=4, resync_interval_s=0.0)
        try:
            dead_until = -m.W.RANGE_EPOCH_SKEW_S - 5.0
            a.queue_tx(_mk_wire([1, 2], [dead_until, 10.0], now=0.0), 2)
            a.pump()
            assert 1 not in a._own_map and 2 in a._own_map
            assert 1 not in a.net_map and 2 in a.net_map
            assert a.pruned == 1
        finally:
            a.close()

    @BOTH
    def test_rx_staging_bounded_drops_and_counts(self, pkg, pair):
        a, b = pair
        m = PKG[pkg]
        ln = _bnow(b)
        sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:
            seq = 0
            deadline = time.monotonic() + 5.0
            while a.rx_overflow == 0:
                for _ in range(160):
                    seq += 1
                    sock.sendto(m.t.pack_packet(
                        m.W.NET_KIND_WIRE, 1, 0, seq, 1, b.t0_wall_ns,
                        _mk_wire([seq], [ln + 9], now=ln)), a.addr)
                a.pump()
                assert time.monotonic() < deadline, a.rx_pkts
                time.sleep(0.002)
            assert len(a._ready) <= m.tuning.NET_OUTQ_MAX
            assert len(a.net_map) == a.rx_wires
        finally:
            sock.close()

    @BOTH
    def test_hello_resync_neither_shadows_nor_postpones_periodic(self, pkg):
        mono, wall = _clocks()
        a = PKG[pkg].t.NetMailbox(0, 0, mono, wall, k_max=4,
                                  resync_interval_s=1000.0)
        try:
            a.add_peer((1, 0), ("127.0.0.1", 1))
            a.add_peer((2, 0), ("127.0.0.1", 2))
            a.queue_tx(_mk_wire([5], [10.0], now=0.0), 1)
            a.pump()
            assert a._tx_seq == {(1, 0): 1, (2, 0): 1}
            deadline_before = a._next_resync
            a._resync_peers.add((1, 0))
            a.pump()
            assert a._tx_seq == {(1, 0): 2, (2, 0): 1}
            assert a._next_resync == deadline_before
            a._resync_peers.add((1, 0))
            a._next_resync = 0.0
            a.pump()
            assert a._tx_seq == {(1, 0): 3, (2, 0): 2}
        finally:
            a.close()

    @BOTH
    def test_handshake_timeout_names_silent_peer(self, pkg):
        mono, wall = _clocks()
        a = PKG[pkg].t.NetMailbox(0, 0, mono, wall, k_max=4)
        try:
            a.add_peer((2, 1), ("127.0.0.1", 1))
            with pytest.raises(PKG[pkg].t.NetHandshakeTimeout,
                               match=r"h2r1.*\(backoff ladder exhausted"):
                a.handshake(timeout_s=0.15)
        finally:
            a.close()

    @BOTH
    def test_pressure_defers_periodic_resync_bounded(self, pkg):
        """The governor's pressure defers a due periodic resync, at most
        ``SHED_MAX_DEFER`` times in a row, counted."""
        mono, wall = _clocks()
        a = PKG[pkg].t.NetMailbox(0, 0, mono, wall, k_max=4,
                                  resync_interval_s=1000.0)
        try:
            a.add_peer((1, 0), ("127.0.0.1", 1))
            a.queue_tx(_mk_wire([5], [10.0], now=0.0), 1)
            a.pump()
            for _ in range(12):
                a._next_resync = 0.0
                a.pump(pressure=1.0)
            got = (a.resync_deferred, a.resyncs, a._resync_defer_streak)
        finally:
            a.close()
        assert got == (PKG[pkg].tuning.SHED_MAX_DEFER + 3, 1, 3)


def test_mailbox_reports_equal_reference():
    """The same traffic through a port pair and a reference pair (same
    epochs): every report key, and every counter but the clock-read
    gauge, are the reference's."""
    ca, cb = _clocks(), _clocks(EPOCH_DELTA_S)
    ln = (time.clock_gettime_ns(time.CLOCK_MONOTONIC) - cb[0]) * 1e-9
    reps = {}
    for name in ("port", "reference"):
        a, b = _pair(PKG[name], PKG[name], ca, cb, resync_interval_s=1000.0)
        try:
            for j in range(3):
                b.queue_tx(_mk_wire([10 + j, 20 + j], [ln + 9, ln + 9.5],
                                    now=ln), 2)
            b.pump()
            assert _pump_until(a, lambda: a.rx_wires == 3)
            ra, rb = a.report(), b.report()
        finally:
            a.close()
            b.close()
        for r in (ra, rb):
            r.pop("epoch_skew_max")
        reps[name] = (ra, rb)
    assert reps["port"] == reps["reference"]


# ---------------------------------------------------------------------------
# federation beacons
# ---------------------------------------------------------------------------

class TestHostBeacon:
    @BOTH
    def test_liveness_then_death_detected(self, pkg):
        t = PKG[pkg].t
        wall = time.time_ns()
        h0 = t.HostBeacon(0, wall, interval_s=0.03, timeout_s=0.3)
        h1 = t.HostBeacon(1, wall, interval_s=0.03, timeout_s=0.3)
        try:
            h0.add_peer(1, h1.addr)
            h1.add_peer(0, h0.addr)
            deadline = time.monotonic() + 3.0
            while (h0.report()["peers"]["1"]["age_s"] is None
                   or h1.report()["peers"]["0"]["age_s"] is None):
                h0.tick()
                h1.tick()
                assert time.monotonic() < deadline
                time.sleep(0.01)
            assert not h0.dead_hosts() and not h1.dead_hosts()
            h1.close()
            t0 = time.monotonic()
            while 1 not in h0.dead_hosts():
                h0.tick()
                assert time.monotonic() - t0 < 2.0
                time.sleep(0.01)
        finally:
            h0.close()
            h1.close()

    @BOTH
    def test_never_heard_peer_is_dead_after_grace(self, pkg):
        h = PKG[pkg].t.HostBeacon(0, time.time_ns(), timeout_s=0.05)
        try:
            h.add_peer(1, ("127.0.0.1", 1))
            time.sleep(0.07)
            assert h.dead_hosts() == [1]
            assert h.report()["dead"] == [1]
        finally:
            h.close()

    @pytest.mark.parametrize("a_pkg,b_pkg", CROSS)
    def test_beacons_cross_packages(self, a_pkg, b_pkg):
        """A port beacon and a reference beacon see each other alive."""
        wall = time.time_ns()
        h0 = PKG[a_pkg].t.HostBeacon(0, wall, interval_s=0.03, timeout_s=0.3)
        h1 = PKG[b_pkg].t.HostBeacon(1, wall, interval_s=0.03, timeout_s=0.3)
        try:
            h0.add_peer(1, h1.addr)
            h1.add_peer(0, h0.addr)
            deadline = time.monotonic() + 3.0
            while not (h0.rx_beacons and h1.rx_beacons):
                h0.tick()
                h1.tick()
                assert time.monotonic() < deadline
                time.sleep(0.01)
            assert not h0.dead_hosts() and not h1.dead_hosts()
        finally:
            h0.close()
            h1.close()


# ---------------------------------------------------------------------------
# the gossip plane's net leg, the spec derivation, the health ladder
# ---------------------------------------------------------------------------

class TestGossipPlaneNet:
    @staticmethod
    def _planes(tmp_path, m, ca=None, cb=None):
        na, nb = _pair(m, m, ca, cb)
        planes = []
        for h, net in ((0, na), (1, nb)):
            m.gossip.create_plane(tmp_path / f"h{h}", 1, k_max=4, net=True)
            planes.append(m.gossip.GossipPlane(
                tmp_path / f"h{h}", 0, 1, sink=m.Sink(),
                merge_interval_s=0.0, net=net))
        return planes

    @BOTH
    def test_cross_host_block_reaches_peer_sink_rebased(self, tmp_path, pkg):
        m = PKG[pkg]
        a, b = self._planes(tmp_path, m)
        try:
            ln = _bnow(b.net)
            b.publish(m.Update(key=np.array([101], np.uint32),
                               until_s=np.array([ln + 10.0], np.float32)),
                      now=ln)
            b.tick(force=True)
            deadline = time.monotonic() + 2.0
            while not a.sink.blocked:
                a.tick(force=True)
                assert time.monotonic() < deadline
                time.sleep(0.005)
            until_a = a.sink.blocked[101]
            assert 5.0 < until_a < 15.0     # ~10 s out on A's clock
            ra, rb = a.report(), b.report()
            assert ra["net"]["net_digest"] == rb["net"]["net_digest"]
            # the shm digests are untouched by the net leg
            assert ra["merged_digest"] == m.t.map_digest({})
        finally:
            a.net.close()
            b.net.close()

    @BOTH
    def test_single_host_report_has_no_net_key(self, tmp_path, pkg):
        m = PKG[pkg]
        m.gossip.create_plane(tmp_path, 2)
        assert "net" not in m.gossip.GossipPlane(tmp_path, 0, 2).report()

    def test_single_engine_plane_requires_net(self, tmp_path):
        msgs = []
        for name, m in PKG.items():
            d = tmp_path / name
            with pytest.raises(ValueError, match=">= 2 engines") as e1:
                m.gossip.create_plane(d / "x", 1)
            m.gossip.create_plane(d / "y", 1, net=True)
            with pytest.raises(ValueError, match="network leg") as e2:
                m.gossip.GossipPlane(d / "y", 0, 1)
            msgs.append((str(e1.value), str(e2.value),
                         (d / "y" / "plane.json").read_bytes()))
        assert msgs[0] == msgs[1]

    @BOTH
    def test_engine_net_mailbox_port_and_peer_derivation(self, pkg):
        p0, p1 = _free_bases(2, 2)
        spec = {"hosts": [["127.0.0.1", p0], ["127.0.0.1", p1]],
                "host_id": 0, "engines_per_host": 2, "listen": None}
        mono, wall = _clocks()
        t = PKG[pkg].t
        m = t.engine_net_mailbox(spec, rank=1, t0_ns=mono, t0_wall_ns=wall)
        try:
            assert m.addr[1] == p0 + 1 + 1
            assert m.peers == {(1, 0): ("127.0.0.1", p1 + 1),
                               (1, 1): ("127.0.0.1", p1 + 2)}
        finally:
            m.close()
        hb = t.host_beacon(dict(spec, host_id=1), wall)
        try:
            assert hb.addr[1] == p1 and hb.peers == {0: ("127.0.0.1", p0)}
        finally:
            hb.close()

    def test_plane_reports_equal_reference(self, tmp_path):
        """The same publishes through a port pair of planes and a
        reference pair: the plane reports (the net block included, bar
        the clock-read gauge) and the sinks' blacklists are equal."""
        out = {}
        ca, cb = _clocks(), _clocks(EPOCH_DELTA_S)
        ln = (time.clock_gettime_ns(time.CLOCK_MONOTONIC) - cb[0]) * 1e-9
        for name, m in PKG.items():
            a, b = self._planes(tmp_path / name, m, ca, cb)
            try:
                b.publish(m.Update(key=np.arange(30, 36, dtype=np.uint32),
                                   until_s=np.full(6, ln + 10.0,
                                                   np.float32)), now=ln)
                b.tick(force=True)
                deadline = time.monotonic() + 2.0
                while len(a.sink.blocked) < 6:
                    a.tick(force=True)
                    assert time.monotonic() < deadline
                    time.sleep(0.005)
                reps = [a.report(), b.report()]
            finally:
                a.net.close()
                b.net.close()
            for r in reps:
                r["net"].pop("epoch_skew_max")
            out[name] = (reps, sorted(a.sink.blocked))
        assert out["port"] == out["reference"]


class TestHealthNet:
    def test_net_counters_are_degraded_reasons(self):
        g = {"tx_dropped": 0, "rx_seq_gaps": 0,
             "net": {"tx_drop": 3, "rx_gap": 2, "rx_dup": 1,
                     "reorder_evict": 4, "epoch_skew_dropped": 2,
                     "epoch_skew_max": 301.25}}
        h = health.engine_health(gossip=g)
        assert h == jhealth.engine_health(gossip=g)
        assert h["state"] == health.DEGRADED
        assert set(h["reasons"]) == {
            "net_tx_drop:3", "net_rx_gap:2", "net_rx_dup:1",
            "net_reorder_evict:4", "net_epoch_skew_dropped:2",
            "net_epoch_skew_max:301.25"}

    def test_clean_net_block_stays_healthy(self):
        g = {"tx_dropped": 0,
             "net": {"tx_drop": 0, "rx_gap": 0, "rx_dup": 0,
                     "reorder_evict": 0, "epoch_skew_dropped": 0,
                     "epoch_skew_max": 0.004}}
        assert health.engine_health(gossip=g) == jhealth.engine_health(
            gossip=g)
        assert health.engine_health(gossip=g)["state"] == health.HEALTHY

    def test_dead_host_folds_cluster_failed(self):
        args = ({0: {"state": "healthy", "reasons": []}}, [], [])
        agg = health.cluster_health(*args, dead_hosts=[1])
        assert agg == jhealth.cluster_health(*args, dead_hosts=[1])
        assert agg["state"] == health.FAILED
        assert "hosts_dead:1" in agg["reasons"]


# ---------------------------------------------------------------------------
# the reference net smoke's four sections, with the port's planes
# ---------------------------------------------------------------------------

def _digest(plane) -> str:
    return transport.map_digest(plane.net.net_map)


def _converge(a, b, want_sources, bound=HEAL_TICK_BOUND):
    for i in range(bound):
        a.tick(force=True)
        b.tick(force=True)
        if _digest(a) == _digest(b) and len(a.net.net_map) == want_sources:
            return i + 1
        time.sleep(0.01)
    return None


def test_net_smoke_lossless(tmp_path):
    a, b = campaign._net_pair(tmp_path, "lossless", resync_s=1000.0)
    try:
        # both directions, multi-wire streams (40 keys = 5 wires at K=8),
        # each published in its publisher's own epoch
        a.publish(campaign._nupd(a, 1000, 40), now=campaign._local_now(a))
        b.publish(campaign._nupd(b, 5000, 24), now=campaign._local_now(b))
        assert _converge(a, b, 64) is not None
        ra, rb = a.net.report(), b.net.report()
        for r in (ra, rb):
            assert r["tx_drop"] == r["rx_gap"] == r["rx_dup"] == 0, r
        assert ra["net_digest"] == rb["net_digest"]
        assert (ra["tx_wires"], rb["tx_wires"]) == (5, 3)
        assert (ra["rx_wires"], rb["rx_wires"]) == (3, 5)
        # B's key 5000: its absolute expiry on A is B's, within f32
        until_b = float(np.uint32(b.net._own_map[5000]).view(np.float32))
        abs_err = abs((a.sink.blocked[5000] + a.net.t0_wall_ns * 1e-9)
                      - (until_b + b.net.t0_wall_ns * 1e-9))
        assert abs_err <= 0.005
    finally:
        campaign._close_pair(a, b)


def test_net_smoke_partition_heal(tmp_path):
    from flowsentryx_tpu_torch.chaos.faults import NetChaos

    a, b = campaign._net_pair(tmp_path, "heal", resync_s=0.05)
    try:
        chaos = NetChaos(a.net)
        chaos.partition()
        a.publish(campaign._nupd(a, 2000, 12), now=campaign._local_now(a))
        for _ in range(3):
            a.tick(force=True)
            b.tick(force=True)
        assert chaos.dropped and not b.net.net_map
        chaos.heal()
        ticks = _converge(a, b, 12)
        chaos.uninstall()
        assert ticks is not None and ticks <= HEAL_TICK_BOUND
        assert a.net.report()["resyncs"] >= 1
    finally:
        campaign._close_pair(a, b)


def test_net_smoke_federation():
    wall = time.time_ns()
    h0 = transport.HostBeacon(0, wall, interval_s=0.05, timeout_s=0.4)
    h1 = transport.HostBeacon(1, wall, interval_s=0.05, timeout_s=0.4)
    try:
        h0.add_peer(1, h1.addr)
        h1.add_peer(0, h0.addr)
        deadline = time.monotonic() + 3.0
        while (h0.report()["peers"]["1"]["age_s"] is None
               or h1.report()["peers"]["0"]["age_s"] is None):
            h0.tick()
            h1.tick()
            assert time.monotonic() < deadline
            time.sleep(0.02)
        assert not h0.dead_hosts() and not h1.dead_hosts()
        h1.close()
        t0 = time.monotonic()
        while 1 not in h0.dead_hosts():
            h0.tick()
            assert time.monotonic() - t0 < 2.0
            time.sleep(0.02)
    finally:
        h0.close()
        h1.close()


@pytest.mark.parametrize("tx_pkg,rx_pkg", [("port", "port"), *CROSS])
def test_net_smoke_seq_boundary(tmp_path, tx_pkg, rx_pkg):
    """The u64 wire sequence crosses 2^32 intact on the datagram
    transport (``reorder_window=0``: the receiver anchors at the first
    seq) and on the shm ``VerdictMailbox``."""
    mono, wall = _clocks()
    na = PKG[tx_pkg].t.NetMailbox(0, 0, mono, wall, k_max=4,
                                  reorder_window=0)
    nb = PKG[rx_pkg].t.NetMailbox(1, 0, mono, wall, k_max=4,
                                  reorder_window=0)
    try:
        na.add_peer((1, 0), nb.addr)
        nb.add_peer((0, 0), na.addr)
        base = (1 << 32) - 2
        na._tx_seq[(1, 0)] = base
        now = (time.clock_gettime_ns(time.CLOCK_MONOTONIC) - mono) * 1e-9
        for j in range(3):
            na.queue_tx(_mk_wire([100 + j], [now + 10], now=now), 1)
            na.pump()
        assert _pump_until(nb, lambda: nb.rx_wires == 3)
        assert [s for _s, s, *_ in nb.pop_wires(8)] == [
            base + 1, base + 2, base + 3]
        assert nb.rx_gap == nb.rx_dup == 0
    finally:
        na.close()
        nb.close()
    tx_mbx = PKG[tx_pkg].mailbox.VerdictMailbox.create(
        tmp_path / "bnd.mbx", slots=4, k_max=2)
    rx_mbx = PKG[rx_pkg].mailbox.VerdictMailbox(tmp_path / "bnd.mbx")
    seqs = [(1 << 32) - 1, 1 << 32, (1 << 32) + 1]
    got = []
    for j, seq in enumerate(seqs):
        assert tx_mbx.publish(np.full(2 * 2 + 4, j, np.uint32), seq, 1)
        [(s, _w)] = rx_mbx.pop_wires(1)
        got.append(s)
    assert got == seqs


# ---------------------------------------------------------------------------
# the packages mixed
# ---------------------------------------------------------------------------

_U32 = st.integers(0, (1 << 32) - 1)
_U64 = st.integers(0, (1 << 64) - 1)


@settings(max_examples=300, deadline=None, database=None)
@given(kind=st.sampled_from([1, 2, 3, 4, 0, 7, (1 << 32) - 1]),
       host=_U32, rank=_U32, seq=_U64, count=_U32, t0_wall=_U64,
       k=st.integers(0, 9), data=st.data())
def test_pack_packet_bytes_equal_reference(kind, host, rank, seq, count,
                                           t0_wall, k, data):
    w = None
    if k:
        w = np.array(data.draw(st.lists(_U32, min_size=2 * k + 4,
                                        max_size=2 * k + 4)), np.uint32)
    got = transport.pack_packet(kind, host, rank, seq, count, t0_wall, w)
    want = jtransport.pack_packet(kind, host, rank, seq, count, t0_wall, w)
    assert got == want
    for reader in (transport.unpack_packet, jtransport.unpack_packet):
        for pkt in (got, want):
            p = reader(pkt)
            assert (p["kind"], p["host"], p["rank"], p["seq"], p["count"],
                    p["t0_wall_ns"]) == (kind, host, rank, seq, count,
                                         t0_wall)
            assert (p["wire"] is None if w is None
                    else p["wire"].tobytes() == w.tobytes())


@settings(max_examples=300, deadline=None, database=None)
@given(data=st.binary(min_size=0, max_size=120),
       magic=st.booleans())
def test_unpack_rejects_as_reference(data, magic):
    """Arbitrary bytes (with the magic word forced in half the cases):
    both parsers accept and reject the same inputs, and agree on what
    they read."""
    if magic and len(data) >= 4:
        data = (np.uint32(wire.NET_PKT_MAGIC).tobytes() + data[4:])
    got, want = transport.unpack_packet(data), jtransport.unpack_packet(data)
    assert (got is None) == (want is None)
    if got is not None:
        gw, ww = got.pop("wire"), want.pop("wire")
        assert got == want
        assert (gw is None) == (ww is None)
        assert gw is None or gw.tobytes() == ww.tobytes()


def test_canonical_form_and_digest_equal_reference(rng):
    bits = rng.integers(0, 1 << 32, 4096, dtype=np.uint64).astype(np.uint32)
    f = bits.view(np.float32)
    bits = bits[np.isfinite(f) & (np.abs(f) < 1e9)]
    for wall in (1, 1_700_000_000_123_456_789, (1 << 63) - 10 ** 12):
        got = transport.until_wall_us(bits, wall)
        want = jtransport.until_wall_us(bits, wall)
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype == np.int64
        m = dict(zip(rng.permutation(len(bits)).tolist(), got.tolist()))
        assert transport.map_digest(m) == jtransport.map_digest(m)
    assert transport.map_digest({}) == jtransport.map_digest({})


def _exchange(ma, mb, ca, cb, wires_a, wires_b):
    """A (package ``ma``) and B (``mb``) on loopback: each publishes its
    wires, each pumps until it took the other's; returns what each
    popped (rebased untils' bits) and both reports."""
    a, b = _pair(ma, mb, ca, cb, resync_interval_s=1000.0)
    try:
        for w in wires_a:
            a.queue_tx(w, int(w[8]))
        for w in wires_b:
            b.queue_tx(w, int(w[8]))
        a.pump()
        b.pump()
        assert _pump_until(a, lambda: a.rx_wires == len(wires_b))
        assert _pump_until(b, lambda: b.rx_wires == len(wires_a))
        got = [[(s, q, rw.tobytes(), k.tolist(), u.view(np.uint32).tolist())
                for s, q, rw, k, u in m.pop_wires(64)] for m in (a, b)]
        return got, a.report(), b.report()
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize("a_pkg,b_pkg", CROSS)
def test_mixed_mailboxes_converge_bit_equal_to_reference_pair(a_pkg, b_pkg,
                                                              rng):
    """A port mailbox and a reference mailbox 250 s of epoch apart trade
    wires both ways: the rebased untils are bit-equal to what a
    reference pair with the same epochs pops, and both ends reach one
    ``net_digest``."""
    ca, cb = _clocks(), _clocks(EPOCH_DELTA_S)
    now_a = (time.clock_gettime_ns(time.CLOCK_MONOTONIC) - ca[0]) * 1e-9
    now_b = now_a + EPOCH_DELTA_S

    def wires(now, base, n):
        return [_mk_wire(base + 4 * j + np.arange(4),
                         now + rng.uniform(1.0, 30.0, 4), now=now)
                for j in range(n)]

    wa, wb = wires(now_a, 1000, 5), wires(now_b, 9000, 7)
    got, ra, rb = _exchange(PKG[a_pkg], PKG[b_pkg], ca, cb, wa, wb)
    want, ja, jb = _exchange(PKG["reference"], PKG["reference"], ca, cb,
                             wa, wb)
    assert got == want
    assert ra["net_digest"] == rb["net_digest"] == ja["net_digest"]
    assert ra["net_sources"] == 5 * 4 + 7 * 4
    for r in (ra, rb):
        assert r["rx_dup"] == r["rx_gap"] == r["epoch_skew_dropped"] == 0


def test_supervisor_side_imports_no_torch():
    """The transport, the gossip plane, the supervisor and the runner —
    with a mailbox and a federation beacon built and ticked — import
    neither torch nor anything of the JAX package."""
    code = (
        "import sys, time\n"
        "from flowsentryx_tpu_torch.cluster import transport, gossip\n"
        "import flowsentryx_tpu_torch.cluster.supervisor\n"
        "import flowsentryx_tpu_torch.cluster.runner\n"
        "import flowsentryx_tpu_torch.chaos.faults\n"
        "m = transport.NetMailbox(0, 0, 1, time.time_ns())\n"
        "m.pump(); m.report(); m.close()\n"
        "h = transport.HostBeacon(0, time.time_ns())\n"
        "h.tick(); h.report(); h.close()\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in "
        "('torch', 'jax', 'flowsentryx_tpu')]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"
