"""The gossip plane's network leg: loss-tolerant UDP verdict transport.

Counterpart of ``flowsentryx_tpu/cluster/transport.py``.  The shm plane
(:mod:`.mailbox`) is exact on one host: one CLOCK_MONOTONIC ``t0`` makes
every gossiped ``until`` the same bits fleet-wide, and the cursor
protocol delivers exactly once, in order.  Between hosts this module
carries the same ``[2K+4]`` compact verdict wire and u64 sequence over
UDP datagrams (the byte layout is ``core/wire.py``'s ``NET_*``), with
every failure of a network made explicit and counted:

* **loss**: sequence holes are counted (``rx_gap``), never waited on; a
  verdict stream is last-wins and bounded by its expiries, so the
  periodic anti-entropy resync (each endpoint re-publishes its own map,
  ``NET_RESYNC_INTERVAL_S``) repairs loss while the verdicts matter;
* **duplication**: per-peer suppression on the u64 seq (``rx_dup``);
* **reorder**: a bounded per-peer buffer restores sequence order up to
  ``NET_REORDER_WINDOW`` wires; past it the oldest is delivered out of
  order and counted (``reorder_evict``), memory bounded, never a stall;
* **backpressure**: the publish side never blocks: the handoff queue
  drops and counts past ``NET_OUTQ_MAX`` (``txq_dropped``) and a failed
  ``sendto`` drops and counts (``tx_sock_drops``);
* **epochs**: monotonic clocks are per host.  Each supervisor stamps a
  CLOCK_REALTIME ``t0_wall_ns`` at the instant of its monotonic ``t0``;
  every datagram carries the sender's stamp, and a received wire is
  rebased tx-epoch -> rx-epoch (``until += tx_t0_wall - rx_t0_wall``)
  before any sink sees it.  A rebased wire whose ``now`` word lands more
  than ``RANGE_EPOCH_SKEW_S`` from the receiver's clock carries a lying
  epoch: dropped and counted (``epoch_skew_dropped``), the worst skew
  kept (``epoch_skew_max``).

The f32 rebase rounds differently for each epoch delta, so hosts compare
the canonical form, absolute wall microseconds::

    until_wall_us = tx_t0_wall_ns // 1000 + round(until_f32 * 1e6)

computed from the originator's stamp and f32 bits, both carried verbatim,
so every host derives the same integers and ``net_digest`` converges
exactly.  The resync re-publishes only the wires an endpoint originated,
with their original bits; engines own disjoint IP-hash spans, so each
key has one originator and last-wins convergence is deterministic.

Threading: :meth:`NetMailbox.queue_tx` is the only publish-section
method (``GossipPlane.publish``, the engine's sink section); the socket,
the counters, the reorder state and the canonical map belong to the
merge section (``GossipPlane.tick``, the dispatch thread).  They meet
only at ``_outq``, a deque with one appender and one popper.

numpy and ``socket`` only: the supervisor's federation beacon and the
chaos harness import it without torch.
"""

from __future__ import annotations

import collections
import socket
import time
import zlib

import numpy as np

from flowsentryx_tpu_torch.core import wire as W
from flowsentryx_tpu_torch.sync import tuning


class NetHandshakeTimeout(RuntimeError):
    """Peer discovery ran out of its backoff budget; the message names
    every peer that never answered."""


def pack_packet(kind: int, host: int, rank: int, seq: int,
                count: int, t0_wall_ns: int,
                wire: np.ndarray | None = None) -> bytes:
    """One gossip datagram (``wire.NET_*`` layout): the u64 ``seq`` and
    ``t0_wall_ns`` split across two u32 words each."""
    hdr = np.zeros(W.NET_PKT_HDR_WORDS, np.uint32)
    hdr[W.NET_MAGIC_WORD] = W.NET_PKT_MAGIC
    hdr[W.NET_KIND_WORD] = kind
    hdr[W.NET_HOST_WORD] = host
    hdr[W.NET_RANK_WORD] = rank
    hdr[W.NET_SEQ_LO_WORD] = seq & 0xFFFFFFFF
    hdr[W.NET_SEQ_HI_WORD] = (seq >> 32) & 0xFFFFFFFF
    hdr[W.NET_COUNT_WORD] = count
    hdr[W.NET_T0_WALL_LO_WORD] = t0_wall_ns & 0xFFFFFFFF
    hdr[W.NET_T0_WALL_HI_WORD] = (t0_wall_ns >> 32) & 0xFFFFFFFF
    if wire is None:
        return hdr.tobytes()
    return hdr.tobytes() + np.ascontiguousarray(wire, np.uint32).tobytes()


def unpack_packet(data: bytes) -> dict | None:
    """Parse one datagram; None for anything malformed (an open UDP port
    receives whatever the network sends)."""
    if len(data) < W.NET_PKT_HDR_WORDS * 4 or len(data) % 4:
        return None
    words = np.frombuffer(data, np.uint32)
    if int(words[W.NET_MAGIC_WORD]) != W.NET_PKT_MAGIC:
        return None
    wire = words[W.NET_PKT_HDR_WORDS:].copy()
    if len(wire) and (len(wire) < 6 or len(wire) % 2):
        return None  # a wire payload is [2K+4] words, K >= 1
    return {
        "kind": int(words[W.NET_KIND_WORD]),
        "host": int(words[W.NET_HOST_WORD]),
        "rank": int(words[W.NET_RANK_WORD]),
        "seq": (int(words[W.NET_SEQ_LO_WORD])
                | (int(words[W.NET_SEQ_HI_WORD]) << 32)),
        "count": int(words[W.NET_COUNT_WORD]),
        "t0_wall_ns": (int(words[W.NET_T0_WALL_LO_WORD])
                       | (int(words[W.NET_T0_WALL_HI_WORD]) << 32)),
        "wire": wire if len(wire) else None,
    }


def _wire_entries(wire: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """``(keys u32, until bits u32)`` of one ``[2K+4]`` wire."""
    k = (wire.shape[0] - 4) // 2
    n = min(int(wire[2 * k]), k)
    return wire[:n], wire[k:k + n]


def until_wall_us(until_bits: np.ndarray, t0_wall_ns: int) -> np.ndarray:
    """The canonical rebased form (module docstring): absolute wall
    microseconds as i64, from the originator's epoch stamp and f32 bits,
    the same integers on every host."""
    until = np.asarray(until_bits, np.uint32).view(np.float32)
    return (np.rint(until.astype(np.float64) * 1e6).astype(np.int64)
            + np.int64(t0_wall_ns // 1000))


def map_digest(d: dict) -> str:
    """Order-insensitive digest of a ``key -> int`` map (until bits or
    ``until_wall_us``): crc32 of the sorted pairs as i64, then the
    count.  The one digest of the port's gossip reports."""
    items = np.array(sorted(d.items()), np.int64)
    return f"{zlib.crc32(items.tobytes()):08x}.{len(d)}"


class NetMailbox:
    """One engine's datagram gossip endpoint (module docstring).

    ``peers`` maps an endpoint key ``(host_id, rank)`` to its UDP
    address.  One socket serves both directions; bind to port 0 and read
    :attr:`addr` for an assigned port.
    """

    def __init__(self, host_id: int, rank: int, t0_ns: int,
                 t0_wall_ns: int, *,
                 listen: tuple[str, int] = ("127.0.0.1", 0),
                 peers: dict | None = None,
                 k_max: int = 64,
                 reorder_window: int = tuning.NET_REORDER_WINDOW,
                 reorder_timeout_s: float = tuning.NET_REORDER_TIMEOUT_S,
                 outq_max: int = tuning.NET_OUTQ_MAX,
                 resync_interval_s: float = tuning.NET_RESYNC_INTERVAL_S):
        if t0_wall_ns <= 0:
            raise ValueError(
                "NetMailbox needs the host's stamped t0_wall_ns epoch "
                "(schema.STATUS_T0_WALL_OFFSET): without it received "
                "wires cannot be rebased into this host's clock")
        self.host_id = host_id
        self.rank = rank
        self.t0_ns = t0_ns
        self.t0_wall_ns = t0_wall_ns
        self.k_max = k_max
        self.reorder_window = reorder_window
        self.reorder_timeout_s = reorder_timeout_s
        #: bounds both handoff queues, the publish deque and the receive
        #: staging deque; each drops and counts
        self.outq_max = outq_max
        self.resync_interval_s = resync_interval_s
        self.peers: dict[tuple[int, int], tuple[str, int]] = dict(
            peers or {})
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._sock.setblocking(False)
        self._sock.bind(tuple(listen))
        #: the bound address (port 0 resolves here)
        self.addr = self._sock.getsockname()
        # -- publish side (engine sink section) ---------------------------
        self._outq: collections.deque = collections.deque()
        self.txq_dropped = 0
        # -- merge side (dispatch thread) ---------------------------------
        self._tx_seq: dict[tuple[int, int], int] = {}
        #: wires this endpoint ORIGINATED: key -> until f32 bits, what the
        #: resync re-publishes verbatim
        self._own_map: dict[int, int] = {}
        #: the canonical map, key -> until_wall_us: own publishes and
        #: accepted peer wires alike
        self.net_map: dict[int, int] = {}
        self._rx_state: dict[tuple[int, int], dict] = {}
        self._ready: collections.deque = collections.deque()
        self._peers_seen: set[tuple[int, int]] = set()
        self._resync_peers: set[tuple[int, int]] = set()
        self._next_resync = time.monotonic() + resync_interval_s
        self.tx_wires = 0
        self.tx_pkts = 0
        self.tx_sock_drops = 0
        self.rx_pkts = 0
        self.rx_wires = 0
        self.rx_dup = 0
        self.rx_gap = 0
        self.reorder_evict = 0
        self.gap_timeouts = 0
        self.rx_alien = 0
        self.peer_restarts = 0
        self.epoch_skew_dropped = 0
        self.epoch_skew_max = 0.0
        self.resyncs = 0
        self.hellos_rx = 0
        self.rx_overflow = 0
        self.pruned = 0
        # the governor's budget pressure defers PERIODIC resyncs (counted),
        # at most SHED_MAX_DEFER in a row; HELLO-triggered ones never wait
        self.resync_deferred = 0
        self._resync_defer_streak = 0

    # -- lifecycle (no serving thread alive) ----------------------------------

    def add_peer(self, key: tuple[int, int],
                 addr: tuple[str, int]) -> None:
        """Register one remote endpoint (the CLI derives the whole table
        up front; harnesses with assigned ports add them here)."""
        self.peers[key] = tuple(addr)

    def close(self) -> None:
        self._sock.close()

    # -- publish side (engine sink section) -----------------------------------

    def queue_tx(self, wire: np.ndarray, count: int) -> bool:
        """Hand one outgoing verdict wire to the merge-side pump; False
        (counted) past the queue bound: the publisher never blocks on a
        slow or partitioned network."""
        if len(self._outq) >= self.outq_max:
            self.txq_dropped += 1
            return False
        self._outq.append((np.array(wire, np.uint32), int(count)))
        return True

    # -- merge side (dispatch thread) -----------------------------------------

    def _sendto(self, payload: bytes, addr: tuple[str, int]) -> bool:
        """The one raw send (the chaos injector wraps exactly this).
        False is a counted drop, never a raise: EAGAIN/ENOBUFS is
        backpressure, ECONNREFUSED a dead peer, both fail open."""
        try:
            self._sock.sendto(payload, addr)
            return True
        except OSError:
            self.tx_sock_drops += 1
            return False

    def _send_wire(self, peer: tuple[int, int], wire: np.ndarray,
                   count: int) -> None:
        seq = self._tx_seq.get(peer, 0) + 1
        self._tx_seq[peer] = seq
        pkt = pack_packet(W.NET_KIND_WIRE, self.host_id, self.rank,
                          seq, count, self.t0_wall_ns, wire)
        self.tx_pkts += 1
        self._sendto(pkt, self.peers[peer])

    def _send_ctl(self, kind: int, peer: tuple[int, int]) -> None:
        self.tx_pkts += 1
        self._sendto(pack_packet(kind, self.host_id, self.rank, 0, 0,
                                 self.t0_wall_ns), self.peers[peer])

    def pump(self, pressure: float = 0.0) -> None:
        """One merge-section pass: send the publish queue, run the
        anti-entropy resync when due, take in every pending datagram, and
        concede sequence holes older than the reorder timeout.

        ``pressure > 0`` (the governor's budget-pressure signal, through
        ``GossipPlane.tick``) defers a due periodic resync by
        ``SHED_TICK_STRETCH`` intervals, at most ``SHED_MAX_DEFER`` times
        in a row (``resync_deferred``).  Verdict wires and HELLO-triggered
        resyncs are never deferred."""
        while True:
            try:
                wire, count = self._outq.popleft()
            except IndexError:
                break
            keys, bits = _wire_entries(wire)
            self._own_map.update(zip(keys.tolist(), bits.tolist()))
            self.net_map.update(zip(
                keys.tolist(),
                until_wall_us(bits, self.t0_wall_ns).tolist()))
            self.tx_wires += 1
            for peer in self.peers:
                self._send_wire(peer, wire, count)
        now = time.monotonic()
        if (pressure > 0.0 and not self._resync_peers
                and now >= self._next_resync
                and self._resync_defer_streak < tuning.SHED_MAX_DEFER):
            self._resync_defer_streak += 1
            self.resync_deferred += 1
            self._next_resync = (
                now + self.resync_interval_s * tuning.SHED_TICK_STRETCH)
        if self._resync_peers or now >= self._next_resync:
            # a HELLO-triggered resync serves only the (re)appeared peers
            # and leaves the periodic deadline alone: a handshake with one
            # peer must not postpone the other peers' loss repair
            targets = set(self._resync_peers)
            self._resync_peers.clear()
            if now >= self._next_resync:
                self._next_resync = now + self.resync_interval_s
                self._resync_defer_streak = 0
                targets |= set(self.peers)
            self._prune_expired()
            self._resync(targets)
        self._recv_all()
        # a hole older than the reorder timeout is loss, not reorder:
        # concede it (rx_gap) so the wires parked behind it deliver
        now_m = time.monotonic()
        for src, st in self._rx_state.items():
            while (st["buf"]
                   and now_m - min(v[0] for v in st["buf"].values())
                   > self.reorder_timeout_s):
                self.gap_timeouts += 1
                self._concede_hole(src, st)

    def _prune_expired(self) -> None:
        """Drop long-expired verdicts from both maps (at the resync's
        cadence): the maps hold the live blacklist, and the resync
        re-publishes ``_own_map`` whole.  The grace is
        ``RANGE_EPOCH_SKEW_S``, the receive side's own bound, so every
        host prunes the same keys by the same absolute-time rule."""
        grace = W.RANGE_EPOCH_SKEW_S
        local_now = ((time.clock_gettime_ns(time.CLOCK_MONOTONIC)
                      - self.t0_ns) * 1e-9)
        if self._own_map:
            floor = local_now - grace
            dead = [k for k, bits in self._own_map.items()
                    if float(np.uint32(bits).view(np.float32)) < floor]
            for k in dead:
                del self._own_map[k]
            self.pruned += len(dead)
        if self.net_map:
            floor_us = int((time.time_ns() // 1000) - grace * 1e6)
            dead = [k for k, us in self.net_map.items() if us < floor_us]
            for k in dead:
                del self.net_map[k]

    def _resync(self, targets: set) -> None:
        """Anti-entropy: re-publish this endpoint's OWN map, original f32
        bits, to ``targets``.  Repairs loss and a healed partition within
        one interval."""
        if not self._own_map or not targets:
            return
        self.resyncs += 1
        items = sorted(self._own_map.items())
        k = self.k_max
        local_now = np.float32(
            (time.clock_gettime_ns(time.CLOCK_MONOTONIC) - self.t0_ns)
            * 1e-9)
        for lo in range(0, len(items), k):
            chunk = items[lo:lo + k]
            wire = np.zeros(2 * k + 4, np.uint32)
            wire[:len(chunk)] = np.array([c[0] for c in chunk], np.uint32)
            wire[k:k + len(chunk)] = np.array([c[1] for c in chunk],
                                              np.uint32)
            wire[2 * k] = len(chunk)
            wire[2 * k + 3] = local_now.view(np.uint32)
            for peer in targets:
                if peer in self.peers:
                    self._send_wire(peer, wire, len(chunk))

    def _recv_all(self, budget: int = 256) -> None:
        for _ in range(budget):
            try:
                data, from_addr = self._sock.recvfrom(65536)
            except (BlockingIOError, InterruptedError):
                return
            except OSError:
                continue  # an ICMP refusal reflected from a dead peer
            pkt = unpack_packet(data)
            if pkt is None:
                self.rx_alien += 1
                continue
            self.rx_pkts += 1
            src = (pkt["host"], pkt["rank"])
            if (src not in self.peers
                    or from_addr[0] != self.peers[src][0]):
                # the claimed endpoint must arrive from its registered
                # host address (an IP-level check: it stops a
                # misconfigured process from impersonating a peer and
                # resetting its duplicate suppression; the trust
                # boundary is the network, as for the shm plane)
                self.rx_alien += 1
                continue
            self._peers_seen.add(src)
            kind = pkt["kind"]
            if kind == W.NET_KIND_HELLO:
                # a (re)booting peer: welcome it, reset its sequence
                # space (its seqs restart at 1) and queue a full-map
                # resync so it converges without the periodic sweep
                self.hellos_rx += 1
                self._rx_state.pop(src, None)
                self._resync_peers.add(src)
                self._send_ctl(W.NET_KIND_WELCOME, src)
            elif kind == W.NET_KIND_WIRE and pkt["wire"] is not None:
                self._rx_wire(src, pkt["seq"], pkt["count"],
                              pkt["t0_wall_ns"], pkt["wire"])
            # WELCOME and BEACON: being seen is the payload

    def _rx_wire(self, src: tuple, seq: int, count: int,
                 t0_wall_ns: int, wire: np.ndarray) -> None:
        """Per-peer sequence discipline: duplicate suppression, the
        bounded reorder buffer, gap accounting, restart detection."""
        st = self._rx_state.get(src)
        if st is None:
            # the first packet from this peer: expect from one window
            # behind it (the first to arrive may be a reordered later
            # one; anchoring at `seq` would count its in-flight
            # predecessors as duplicates)
            st = self._rx_state[src] = {
                "next": max(1, seq - self.reorder_window), "buf": {}}
        if seq < st["next"] - tuning.NET_RESTART_JUMP:
            # a far-backward jump: the peer restarted and its sequence
            # began again; resetting is the only honest reading
            self.peer_restarts += 1
            st["buf"].clear()
            st["next"] = seq
        if seq < st["next"] or seq in st["buf"]:
            self.rx_dup += 1
            return
        st["buf"][seq] = (time.monotonic(), count, t0_wall_ns, wire)
        self._drain_in_order(src, st)
        while len(st["buf"]) > self.reorder_window:
            # bounded memory: concede the hole instead of growing
            self.reorder_evict += 1
            self._concede_hole(src, st)

    def _drain_in_order(self, src: tuple, st: dict) -> None:
        while st["next"] in st["buf"]:
            self._accept(src, st["next"], *st["buf"].pop(st["next"])[1:])
            st["next"] += 1

    def _concede_hole(self, src: tuple, st: dict) -> None:
        """Count the wires below ``min(buf)`` as lost and resume in-order
        delivery from there."""
        s = min(st["buf"])
        self.rx_gap += s - st["next"]
        st["next"] = s
        self._drain_in_order(src, st)

    def _accept(self, src: tuple, seq: int, count: int,
                t0_wall_ns: int, wire: np.ndarray) -> None:
        """Rebase one in-sequence wire tx -> rx epoch and stage it for
        :meth:`pop_wires`, under the ``RANGE_EPOCH_SKEW_S`` bound.  The
        delta is a Python float of the stamps' difference; the untils
        widen to float64, take the delta and round to f32 once."""
        k = (wire.shape[0] - 4) // 2
        n = min(count, k)
        delta_s = (t0_wall_ns - self.t0_wall_ns) * 1e-9
        local_now = ((time.clock_gettime_ns(time.CLOCK_MONOTONIC)
                      - self.t0_ns) * 1e-9)
        wire_now = float(wire[2 * k + 3:2 * k + 4].view(np.float32)[0])
        skew = abs((wire_now + delta_s) - local_now)
        self.epoch_skew_max = max(self.epoch_skew_max, skew)
        if skew > W.RANGE_EPOCH_SKEW_S:
            self.epoch_skew_dropped += 1
            return
        rebased = wire.copy()
        untils = wire[k:k + n].view(np.float32).astype(np.float64)
        rebased[k:k + n] = ((untils + delta_s).astype(np.float32)
                            .view(np.uint32))
        rebased[2 * k + 3] = np.float32(wire_now + delta_s).view(np.uint32)
        keys = wire[:n].copy()
        wall_us = until_wall_us(wire[k:k + n], t0_wall_ns)
        self.net_map.update(zip(keys.tolist(), wall_us.tolist()))
        self.rx_wires += 1
        if len(self._ready) >= self.outq_max:
            # the staging queue is bounded like the publish queue: a
            # consumer slower than the inflow drops and counts (the
            # canonical map above took the entries; the next resync
            # delivers them again)
            self.rx_overflow += 1
            return
        self._ready.append((src, seq, rebased, keys,
                            rebased[k:k + n].view(np.float32)))

    def pop_wires(self, max_wires: int) -> list:
        """Up to ``max_wires`` accepted wires in per-peer sequence order,
        each rebased into this host's epoch:
        ``(src_endpoint, seq, rebased_wire, keys u32, untils f32)``."""
        out = []
        while len(out) < max_wires:
            try:
                out.append(self._ready.popleft())
            except IndexError:
                break
        return out

    def handshake(self, timeout_s: float = tuning.NET_HANDSHAKE_TIMEOUT_S,
                  ) -> None:
        """Peer discovery: HELLO every silent peer with exponential
        backoff until each has answered anything, or raise
        :class:`NetHandshakeTimeout` naming the silent ones.  The engine
        runner serves anyway (fail-open): a late peer's first HELLO
        triggers the full-map resync."""
        deadline = time.monotonic() + timeout_s
        backoff = tuning.NET_HANDSHAKE_BACKOFF_BASE_S
        while True:
            pending = set(self.peers) - self._peers_seen
            if not pending:
                return
            for peer in pending:
                self._send_ctl(W.NET_KIND_HELLO, peer)
            slice_end = min(time.monotonic() + backoff, deadline)
            while time.monotonic() < slice_end:
                self._recv_all()
                if not set(self.peers) - self._peers_seen:
                    return
                time.sleep(0.002)
            if time.monotonic() >= deadline:
                still = sorted(set(self.peers) - self._peers_seen)
                raise NetHandshakeTimeout(
                    f"gossip peer discovery timed out after "
                    f"{timeout_s:.1f}s: no answer from "
                    f"{[f'h{h}r{r}@{self.peers[(h, r)]}' for h, r in still]} "
                    "(backoff ladder exhausted; the caller may serve "
                    "fail-open — a late peer's HELLO triggers a full "
                    "resync)")
            backoff = min(backoff * 2, tuning.NET_HANDSHAKE_BACKOFF_MAX_S)

    # -- reporting (merge section, or no serving thread alive) ----------------

    def report(self) -> dict:
        return {
            "host": self.host_id,
            "rank": self.rank,
            "peers": len(self.peers),
            "peers_seen": len(self._peers_seen),
            "tx_wires": self.tx_wires,
            "tx_pkts": self.tx_pkts,
            # every drop on the send side, summed
            "tx_drop": self.txq_dropped + self.tx_sock_drops,
            "txq_dropped": self.txq_dropped,
            "tx_sock_drops": self.tx_sock_drops,
            "rx_pkts": self.rx_pkts,
            "rx_wires": self.rx_wires,
            "rx_dup": self.rx_dup,
            "rx_gap": self.rx_gap,
            "reorder_evict": self.reorder_evict,
            "gap_timeouts": self.gap_timeouts,
            "rx_alien": self.rx_alien,
            "peer_restarts": self.peer_restarts,
            "epoch_skew_dropped": self.epoch_skew_dropped,
            "epoch_skew_max": round(self.epoch_skew_max, 6),
            "resyncs": self.resyncs,
            "resync_deferred": self.resync_deferred,
            "hellos_rx": self.hellos_rx,
            "rx_overflow": self.rx_overflow,
            "pruned": self.pruned,
            "net_sources": len(self.net_map),
            "net_digest": map_digest(self.net_map),
        }


class HostBeacon:
    """The supervisors' federation heartbeat: one liveness beacon per host.

    Each host's supervisor beacons every ``NET_BEACON_INTERVAL_S`` and
    listens for its peers'; a peer silent past ``NET_HOST_TIMEOUT_S``
    (from its last beacon, or from this beacon's boot if it never spoke)
    is DEAD: :meth:`dead_hosts` feeds ``ClusterSupervisor.aggregate``
    (the dead host is announced and fleet health folds FAILED).  Control
    plane only: no verdict rides a beacon, and a dead federation changes
    nothing for serving engines.
    """

    def __init__(self, host_id: int, t0_wall_ns: int, *,
                 listen: tuple[str, int] = ("127.0.0.1", 0),
                 peers: dict | None = None,
                 interval_s: float = tuning.NET_BEACON_INTERVAL_S,
                 timeout_s: float = tuning.NET_HOST_TIMEOUT_S):
        self.host_id = host_id
        self.t0_wall_ns = t0_wall_ns
        self.interval_s = interval_s
        self.timeout_s = timeout_s
        self.peers: dict[int, tuple[str, int]] = dict(peers or {})
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._sock.setblocking(False)
        self._sock.bind(tuple(listen))
        self.addr = self._sock.getsockname()
        self._boot = time.monotonic()
        self._next_tx = 0.0
        self._seq = 0
        self._last_seen: dict[int, float] = {}
        self.tx_beacons = 0
        self.rx_beacons = 0

    def add_peer(self, host_id: int, addr: tuple[str, int]) -> None:
        self.peers[host_id] = tuple(addr)

    def close(self) -> None:
        self._sock.close()

    def tick(self) -> None:
        """Send when due, take in everything pending (driven by the
        supervisor's poll; no thread of its own)."""
        now = time.monotonic()
        if now >= self._next_tx:
            self._next_tx = now + self.interval_s
            self._seq += 1
            pkt = pack_packet(W.NET_KIND_BEACON, self.host_id,
                              W.NET_RANK_BEACON, self._seq, 0,
                              self.t0_wall_ns)
            for addr in self.peers.values():
                try:
                    self._sock.sendto(pkt, addr)
                    self.tx_beacons += 1
                except OSError:
                    pass  # fail open: liveness, not delivery
        for _ in range(64):
            try:
                data, from_addr = self._sock.recvfrom(4096)
            except (BlockingIOError, InterruptedError):
                break
            except OSError:
                continue
            pkt = unpack_packet(data)
            if (pkt is None or pkt["kind"] != W.NET_KIND_BEACON
                    or pkt["host"] not in self.peers
                    or from_addr[0] != self.peers[pkt["host"]][0]):
                # the mailbox's source check: a stray process must not
                # keep a dead host looking alive
                continue
            self.rx_beacons += 1
            self._last_seen[pkt["host"]] = time.monotonic()

    def dead_hosts(self) -> list[int]:
        """Peer hosts silent past the timeout (a peer never heard counts
        from this beacon's boot: a host that never joined is as dead as
        one that stopped)."""
        now = time.monotonic()
        dead = []
        for h in self.peers:
            last = self._last_seen.get(h, self._boot)
            if now - last > self.timeout_s:
                dead.append(h)
        return sorted(dead)

    def report(self) -> dict:
        now = time.monotonic()
        return {
            "host_id": self.host_id,
            "tx_beacons": self.tx_beacons,
            "rx_beacons": self.rx_beacons,
            "peers": {
                str(h): {
                    "age_s": (round(now - self._last_seen[h], 3)
                              if h in self._last_seen else None),
                }
                for h in sorted(self.peers)
            },
            "dead": self.dead_hosts(),
        }


def engine_net_mailbox(netspec: dict, rank: int, t0_ns: int,
                       t0_wall_ns: int, k_max: int = 64) -> NetMailbox:
    """One cluster engine's :class:`NetMailbox` from the CLI's net spec
    (``cluster --hosts``): host h's supervisor beacon binds its base
    port, engine r binds ``base + 1 + r``, and the peers are every engine
    of every OTHER host at the same offsets (the port arithmetic assumes
    the same ``--engines`` on every host)."""
    hosts = [tuple(h) for h in netspec["hosts"]]
    hid = int(netspec["host_id"])
    n_eng = int(netspec["engines_per_host"])
    ip, base = netspec.get("listen") or hosts[hid]
    peers = {
        (h, r): (hip, int(hport) + 1 + r)
        for h, (hip, hport) in enumerate(hosts) if h != hid
        for r in range(n_eng)
    }
    return NetMailbox(hid, rank, t0_ns, t0_wall_ns,
                      listen=(ip, int(base) + 1 + rank), peers=peers,
                      k_max=k_max)


def host_beacon(netspec: dict, t0_wall_ns: int, **kw) -> HostBeacon:
    """The supervisor's twin of :func:`engine_net_mailbox`: the
    federation beacon on host ``host_id``'s base port."""
    hosts = [tuple(h) for h in netspec["hosts"]]
    hid = int(netspec["host_id"])
    ip, base = netspec.get("listen") or hosts[hid]
    peers = {h: (hip, int(hport))
             for h, (hip, hport) in enumerate(hosts) if h != hid}
    return HostBeacon(hid, t0_wall_ns, listen=(ip, int(base)),
                      peers=peers, **kw)
