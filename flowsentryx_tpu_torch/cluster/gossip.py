"""Engine-side verdict gossip: publish local blocks, merge the peers'.

Counterpart of ``flowsentryx_tpu/cluster/gossip.py``.  Each engine
owns one :class:`GossipPlane`: the engine's half of every pair mailbox
(:mod:`.mailbox`) — N-1 TX queues it publishes to, N-1 RX queues it
merges from — its status block and, in a multi-host fleet (``cluster
--hosts``), a :class:`~.transport.NetMailbox` as its ``net`` leg.

Threading contract, as in the reference:

* :meth:`GossipPlane.publish` runs in the engine's sink section (right
  after the local ``sink.apply``), so every TX head cursor has one
  writing thread, whichever thread owns the sink;
* :meth:`GossipPlane.tick` runs on the dispatch thread (every loop
  iteration, idle ones included), so every RX tail cursor has one
  writing thread;
* merged verdicts go to the plane's OWN sink, never the engine's (whose
  producer is the sink section).

Merged verdicts apply last-wins by key.  The supervisor gives every
engine of a host one t0 epoch, so the ``until`` an engine publishes is
the same bits every peer on the host enforces.  The net leg's wires
arrive rebased into this host's epoch (:mod:`.transport` owns the
network's discipline: duplicates, reorder, gaps, epoch skew).  With
``net=None`` the plane is the single-host plane, byte for byte.  numpy
only.
"""

from __future__ import annotations

import json
import time
from pathlib import Path

import numpy as np

from flowsentryx_tpu_torch.cluster.mailbox import (
    StatusBlock, VerdictMailbox, mailbox_path, status_path,
)
# the one digest of the gossip reports (re-exported for its callers)
from flowsentryx_tpu_torch.cluster.transport import map_digest  # noqa: F401
from flowsentryx_tpu_torch.core import durable
from flowsentryx_tpu_torch.engine.writeback import (
    BlacklistUpdate, decode_verdict_wire,
)
from flowsentryx_tpu_torch.sync import tuning


def create_plane(cluster_dir, n_engines: int, k_max: int = 64,
                 slots: int = 256, net: bool = False) -> None:
    """Create every pair mailbox and status block (the supervisor, or a
    test standing in for it, once, before any engine attaches), then
    the geometry stamp ``plane.json`` last: its presence implies the
    files exist.  ``net`` marks a multi-host fleet, where a one-engine
    local plane is legal: its peers are across the network leg."""
    if n_engines < 2 and not net:
        raise ValueError(
            f"a gossip plane needs >= 2 engines, got {n_engines}")
    if n_engines < 1:
        raise ValueError(f"n_engines must be >= 1, got {n_engines}")
    Path(cluster_dir).mkdir(parents=True, exist_ok=True)
    for src in range(n_engines):
        StatusBlock.create(status_path(cluster_dir, src), src)
        for dst in range(n_engines):
            if dst != src:
                VerdictMailbox.create(
                    mailbox_path(cluster_dir, src, dst), slots, k_max)
    durable.atomic_write(Path(cluster_dir) / "plane.json", json.dumps(
        {"n_engines": n_engines, "k_max": k_max, "slots": slots,
         "net": bool(net)}).encode())


class GossipPlane:
    """One engine's verdict-gossip endpoint (module docstring)."""

    def __init__(self, cluster_dir, rank: int, n_engines: int,
                 sink=None,
                 merge_interval_s: float = tuning.GOSSIP_MERGE_INTERVAL_S,
                 net=None):
        if not 0 <= rank < n_engines:
            raise ValueError(f"rank {rank} not in [0, {n_engines})")
        meta_path = Path(cluster_dir) / "plane.json"
        if meta_path.exists():
            stamped = json.loads(meta_path.read_text()).get("n_engines")
            if stamped != n_engines:
                raise ValueError(
                    f"gossip plane at {cluster_dir} was created for "
                    f"{stamped} engines, attaching with {n_engines}: "
                    "a mismatched fleet size would silently exclude "
                    "peers from gossip")
        self.rank = rank
        self.n_engines = n_engines
        #: Where merged peer verdicts go (the engine's second path to its
        #: kernel tier; a CollectSink in tests); None tracks only.
        #: Dispatch-thread owned.
        self.sink = sink
        self.merge_interval_s = merge_interval_s
        #: The multi-host leg (:class:`~.transport.NetMailbox`), or None:
        #: publish queues each wire to it from the sink section, tick
        #: pumps and merges it on the dispatch thread.
        self.net = net
        self.status = StatusBlock(status_path(cluster_dir, rank))
        self._tx = {
            peer: VerdictMailbox(mailbox_path(cluster_dir, rank, peer))
            for peer in range(n_engines) if peer != rank
        }
        self._rx = {
            peer: VerdictMailbox(mailbox_path(cluster_dir, peer, rank))
            for peer in range(n_engines) if peer != rank
        }
        if self._tx:
            self.k_max = next(iter(self._tx.values())).k_max
        elif net is not None:
            self.k_max = net.k_max
        else:
            raise ValueError(
                "a single-engine local plane only makes sense with a "
                "network leg (fsx cluster --hosts): there is no shm "
                "peer to gossip with and no NetMailbox was given")
        # -- publish side (engine sink section) ---------------------------
        self._pub_seq = 0
        self._published: dict[int, int] = {}   # key -> until f32 bits
        self._tx_dropped = 0
        self._tx_wires = 0
        # -- merge side (dispatch thread) ---------------------------------
        self._merged: dict[int, int] = {}      # key -> until f32 bits
        self._rx_wires = 0
        self._rx_seq_gaps = 0
        self._rx_next_seq = {peer: 1 for peer in self._rx}
        self._merge_ticks = 0
        self._next_tick = 0.0
        # budget-pressure shedding (the governor's pressure signal)
        self._ticks_deferred = 0
        self._defer_streak = 0

    # -- publish side (engine sink section) ---------------------------------

    def publish(self, upd: BlacklistUpdate, now: float) -> None:
        """Republish one sink group's blacklist updates to every peer,
        in ``[2K+4]`` compact verdict wires (a group larger than K ships
        more wires; the overflow flag is never set)."""
        n = len(upd.key)
        if not n:
            return
        k = self.k_max
        keys = np.asarray(upd.key, np.uint32)
        untils = np.asarray(upd.until_s, np.float32)
        self._published.update(
            zip(keys.tolist(), untils.view(np.uint32).tolist()))
        for lo in range(0, n, k):
            ck = keys[lo:lo + k]
            cu = untils[lo:lo + k]
            w = np.zeros(2 * k + 4, np.uint32)
            w[:len(ck)] = ck
            w[k:k + len(cu)] = cu.view(np.uint32)
            w[2 * k] = len(ck)
            w[2 * k + 3] = np.float32(now).view(np.uint32)
            self._pub_seq += 1
            for mbx in self._tx.values():
                if mbx.publish(w, self._pub_seq, len(ck)):
                    self._tx_wires += 1
                else:
                    self._tx_dropped += 1
            if self.net is not None:
                # the same wire to the network leg's handoff queue (full:
                # dropped and counted, the publisher never blocks)
                self.net.queue_tx(w, len(ck))

    # -- merge side (dispatch thread) ---------------------------------------

    def tick(self, force: bool = False, pressure: float = 0.0) -> int:
        """Heartbeat, then merge every peer's pending wires into the
        local view (and the plane's sink); throttled to the merge
        interval.  Returns the verdicts merged by this call.

        ``pressure > 0`` (the governor's budget-pressure signal) defers
        a due tick by ``SHED_TICK_STRETCH`` intervals, at most
        ``SHED_MAX_DEFER`` times in a row; deferrals are counted.  A tick
        that runs passes the pressure on to the net leg's pump, which
        defers only its periodic resync."""
        t = time.monotonic()
        if not force and t < self._next_tick:
            return 0
        if (pressure > 0.0 and not force
                and self._defer_streak < tuning.SHED_MAX_DEFER):
            self._defer_streak += 1
            self._ticks_deferred += 1
            self._next_tick = (
                t + self.merge_interval_s * tuning.SHED_TICK_STRETCH)
            return 0
        self._defer_streak = 0
        self._next_tick = t + self.merge_interval_s
        self.status.ctl_set(
            "c_hbeat", time.clock_gettime_ns(time.CLOCK_MONOTONIC))
        merged_k: list[np.ndarray] = []
        merged_u: list[np.ndarray] = []
        for peer, mbx in self._rx.items():
            while True:
                got = mbx.pop_wires(64)
                if not got:
                    break
                for seq, w in got:
                    if seq != self._rx_next_seq[peer]:
                        # a drop at a full mailbox or a torn restart
                        # re-publishing old numbers: counted
                        self._rx_seq_gaps += 1
                    self._rx_next_seq[peer] = seq + 1
                    vw = decode_verdict_wire(w)
                    merged_k.append(vw.key)
                    merged_u.append(vw.until_s)
                    self._rx_wires += 1
        # the network leg: pump it and take its delivered wires, already
        # in this host's epoch.  They go to the sink (the kernel tier
        # enforces remote verdicts) but not into ``_merged``, whose
        # digest is the shm plane's; cross-host convergence is judged on
        # the canonical form (``net_digest``)
        net_k: list[np.ndarray] = []
        net_u: list[np.ndarray] = []
        if self.net is not None:
            self.net.pump(pressure=pressure)
            # deeper than one pump's receive budget, so a sustained
            # inflow converges instead of backing up into the bounded
            # staging queue
            for _src, _seq, _w, keys, untils in self.net.pop_wires(256):
                if len(keys):
                    net_k.append(keys)
                    net_u.append(untils)
        if not merged_k and not net_k:
            return 0
        self._merge_ticks += 1
        total = 0
        if merged_k:
            keys = np.concatenate(merged_k)
            untils = np.concatenate(merged_u)
            # last-wins by key in arrival order: the kernel map's
            # overwrite-on-update semantics
            self._merged.update(
                zip(keys.tolist(),
                    untils.astype(np.float32).view(np.uint32).tolist()))
            if self.sink is not None:
                self.sink.apply(BlacklistUpdate(key=keys, until_s=untils))
            total += int(len(keys))
        if net_k:
            keys = np.concatenate(net_k)
            untils = np.concatenate(net_u)
            if self.sink is not None:
                self.sink.apply(BlacklistUpdate(key=keys, until_s=untils))
            total += int(len(keys))
        return total

    def quiesce(self, timeout_s: float, peers_quiet=None) -> None:
        """Converge on shutdown: force-tick until the RX mailboxes run
        dry (3 idle ticks in a row) and, with ``peers_quiet``, until it
        says every peer stopped publishing — bounded by ``timeout_s``
        (a peer that serves on is a live cluster, not a drain)."""
        for _ in self._quiesce_steps(timeout_s, peers_quiet):
            time.sleep(self.merge_interval_s)

    def _quiesce_steps(self, timeout_s: float, peers_quiet=None,
                       clock=time.monotonic):
        """The loop of :meth:`quiesce`, one yield per iteration that has
        not converged: it returns on convergence or at the deadline.
        ``fsx live`` (``quiesce_terminates``) drives this generator under
        a model clock; :meth:`quiesce` is it plus a real sleep."""
        idle = 0
        deadline = clock() + timeout_s
        while clock() < deadline:
            idle = idle + 1 if self.tick(force=True) == 0 else 0
            if idle >= 3 and (peers_quiet is None or peers_quiet()):
                return
            yield

    def stop_requested(self) -> bool:
        return self.status.ctl_get("c_stop") != 0

    # -- lifecycle (engine runner, between runs) -----------------------------

    def set_state(self, state: int) -> None:
        self.status.ctl_set("c_state", state)

    def note_progress(self, batches: int, records: int) -> None:
        self.status.ctl_set("c_batches", batches)
        self.status.ctl_set("c_records", records)

    def report(self) -> dict:
        rep = {
            "rank": self.rank,
            "n_engines": self.n_engines,
            "k_max": self.k_max,
            "merge_interval_s": self.merge_interval_s,
            "published_sources": len(self._published),
            "published_digest": map_digest(self._published),
            "tx_wires": self._tx_wires,
            "tx_dropped": self._tx_dropped,
            "merged_sources": len(self._merged),
            "merged_digest": map_digest(self._merged),
            "rx_wires": self._rx_wires,
            "rx_seq_gaps": self._rx_seq_gaps,
            "merge_ticks": self._merge_ticks,
            "ticks_deferred": self._ticks_deferred,
        }
        if self.net is not None:
            # the network leg's counters: they ride EngineReport.cluster,
            # feed the health ladder's net_* reasons and `status` /
            # `monitor`; a single-host report has no "net" key at all
            rep["net"] = self.net.report()
        return rep
