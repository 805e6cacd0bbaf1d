"""Cluster supervisor: spawn, watch, restart — never on the data path.

Counterpart of ``flowsentryx_tpu/cluster/supervisor.py``.  The
supervisor is control plane only: it creates the shm plane, stamps the
shared t0 epoch (and its wall twin), spawns one engine process per rank
(``spawn``: this process imports neither torch nor CUDA, only the
engines own a context on the card), watches liveness and restarts the
dead from their last checkpoint.  Its own death changes nothing for the
engines serving: a new supervisor re-attaches (``boot(adopt=True)``).

A multi-host fleet (``net=``, the CLI's ``--hosts`` spec) also runs the
federation: a :class:`~.transport.HostBeacon` ticked from :meth:`poll`
beacons this host's liveness to its peer hosts' supervisors and
announces a peer host silent past ``NET_HOST_TIMEOUT_S`` (once per
incident); ``aggregate()["hosts"]`` carries the view, and a dead host
folds fleet health FAILED.

The elastic fleet: shard spans move between live ranks through the
handoff protocol (:mod:`.rebalance`, one handoff at a time, driven from
:meth:`ClusterSupervisor.poll`), a dead rank's span can be adopted by a
survivor from its checkpoint, and an :class:`~.elastic.ElasticPolicy`
grows, shrinks or rebalances the live set inside a plane provisioned at
``len(specs)`` ranks.

Crash-fail-open: when an engine dies, the blocks it published are
already in the kernel map (its own verdict ring) and in every peer's
merged view (the gossip plane); the supervisor ``killpg``\\s the corpse's
process group (an orphaned drain worker would be a second consumer on
an SPSC ring), then respawns the rank with ``gen+1`` and ``restore=``
its checkpoint.  Surviving engines never notice: their mailboxes to the
dead rank fill and drop, counted.
"""

from __future__ import annotations

import json
import multiprocessing as mp
import os
import signal
import sys
import time
from pathlib import Path

from flowsentryx_tpu_torch.cluster import gossip as gplane
from flowsentryx_tpu_torch.cluster.mailbox import StatusBlock, status_path
from flowsentryx_tpu_torch.core import durable, wire
# numpy-only engine leaves (engine/__init__ resolves lazily): the HDR
# histogram the per-rank reports carry, the health ladder, the
# governor's report merge
from flowsentryx_tpu_torch.engine import health as health_mod
from flowsentryx_tpu_torch.sync import tuning

_LIVE = (wire.CSTATE_SPAWNING, wire.CSTATE_SERVING, wire.CSTATE_DRAINING)


def _pid_alive(pid: int) -> bool:
    """Liveness of a process this supervisor never spawned (an adopted
    rank): signal 0 probes it without touching it."""
    if pid <= 0:
        return False
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True  # exists, another uid
    return True


def _heartbeat_age_ns(st: StatusBlock) -> tuple[int, int]:
    """A rank's heartbeat and its age.  The clock is read after the
    heartbeat: read before it, a rank that ticks in between shows a
    negative age and passes for a heartbeat from the future (a
    reboot's), i.e. for a dead rank."""
    hb = st.ctl_get("c_hbeat")
    return hb, time.clock_gettime_ns(time.CLOCK_MONOTONIC) - hb


class ClusterSupervisor:
    """Supervise ``len(specs)`` engine processes (module docstring).

    ``specs[r]`` is rank r's spec for
    :func:`~flowsentryx_tpu_torch.cluster.runner.engine_main` (or for
    ``entry``, the lifecycle stub in tests).  The supervisor fills in the
    lifecycle fields: ``rank``, ``n_engines``, ``cluster_dir``, ``gen``,
    ``t0_ns``, ``report_path`` and, on a restart whose checkpoint
    exists, ``restore``."""

    def __init__(
        self,
        cluster_dir: str | Path,
        specs: list[dict],
        *,
        entry=None,
        max_restarts: int = 2,
        heartbeat_timeout_s: float = tuning.SUPERVISOR_HEARTBEAT_TIMEOUT_S,
        restart_backoff_s: float = tuning.RESPAWN_BACKOFF_BASE_S,
        restart_backoff_max_s: float = tuning.RESPAWN_BACKOFF_MAX_S,
        restart_window_s: float = tuning.RESTART_WINDOW_S,
        k_max: int = 64,
        mailbox_slots: int = 256,
        t0_ns: int | None = None,
        t0_wall_ns: int | None = None,
        net: dict | None = None,
        elastic=None,
        n_live: int | None = None,
    ):
        if len(specs) < 2 and net is None:
            raise ValueError(
                f"a cluster needs >= 2 engines, got {len(specs)} "
                "(one engine is fsx serve)")
        if len(specs) < 1:
            raise ValueError("a cluster needs >= 1 engine")
        self.cluster_dir = Path(cluster_dir)
        self.n = len(specs)
        self.specs = specs
        #: real engines, not lifecycle stubs: only they pre-warm a cache
        self._entry_is_real = entry is None
        if entry is None:
            from flowsentryx_tpu_torch.cluster.runner import engine_main

            entry = engine_main
        self._entry = entry
        self.max_restarts = max_restarts
        self.heartbeat_timeout_s = heartbeat_timeout_s
        # crash-loop discipline: respawns back off exponentially, and
        # only deaths inside the sliding window count against the budget
        self.restart_backoff_s = restart_backoff_s
        self.restart_backoff_max_s = restart_backoff_max_s
        self.restart_window_s = restart_window_s
        self.k_max = k_max
        self.mailbox_slots = mailbox_slots
        self.t0_ns = t0_ns
        self.t0_wall_ns = t0_wall_ns
        #: the multi-host net spec (hosts, host_id, engines_per_host,
        #: listen): each child's ``engine_net_mailbox`` and the
        #: federation beacon read it; None on a single-host fleet
        self.net = net
        self.federation = None
        self._dead_hosts_announced: set[int] = set()
        self._ctx = mp.get_context("spawn")
        self._procs: list[mp.process.BaseProcess | None] = [None] * self.n
        self._status: list[StatusBlock] = []
        self._gen = [0] * self.n
        self.restarts = [0] * self.n
        #: monotonic stamps of each rank's deaths inside the window
        self._death_times: list[list[float]] = [[] for _ in range(self.n)]
        #: rank -> monotonic due time of a backoff-delayed respawn
        self._respawn_at: dict[int, float] = {}
        self._failed: set[int] = set()
        self._done: set[int] = set()
        self._stalled: set[int] = set()
        self._booted = False
        self._stop_sent = False
        # -- the elastic fleet (cluster/rebalance.py, cluster/elastic.py)
        #: the autoscaling policy, or None for a fixed fleet.  The plane
        #: is provisioned at ``len(specs)`` ranks (= max_engines), so a
        #: grow is a spawn: mailboxes to unspawned ranks fill and drop
        self._elastic = elastic
        #: the ranks this supervisor runs; run() and poll() judge
        #: completion against it (a parked, shrunk rank leaves it
        #: without counting as failed)
        self._active: set[int] = set(range(
            self.n if n_live is None else max(1, min(n_live, self.n))))
        #: ranks adopted live from a previous supervisor: no process
        #: handle, judged by pid and heartbeat
        self._adopted: set[int] = set()
        #: the one handoff in flight (fleet-wide: a fence lifts once
        #: every rank converged on one generation)
        self._handoff: dict | None = None
        self._handoff_seq = 0
        self.rebalance_counters = {
            "rows_shipped": 0, "flips": 0, "fences": 0, "aborts": 0,
            "adoptions": 0}
        self.adopted_spans: list[dict] = []
        self.elastic_executed = 0
        self._elastic_next = 0.0
        self._pending_grow: dict | None = None
        self._pending_shrink: dict | None = None
        #: the one-shot compile-cache pre-warm child (:meth:`_maybe_prewarm`)
        self._prewarm_proc: mp.process.BaseProcess | None = None
        self.prewarm_spawned = 0
        self._shrunk: set[int] = set()
        self._last_records: dict[int, tuple[float, int]] = {}
        self._rates: dict[int, float] = {}

    # -- lifecycle ----------------------------------------------------------

    def boot(self, adopt: bool = False) -> None:
        """Create the shm plane, stamp the epoch, spawn every active rank.

        ``adopt=True`` re-attaches to an existing plane instead
        (:meth:`_adopt_plane`): the live-plane scan that makes a cold
        boot refuse becomes the rank census — live ranks keep serving
        untouched, dead ranks respawn ``gen+1`` from their checkpoints."""
        if self._booted:
            raise RuntimeError("ClusterSupervisor already booted")
        self._booted = True
        self.cluster_dir.mkdir(parents=True, exist_ok=True)
        if adopt:
            self._adopt_plane()
            return
        self._refuse_live_plane()
        gplane.create_plane(self.cluster_dir, self.n, k_max=self.k_max,
                            slots=self.mailbox_slots,
                            net=self.net is not None)
        self._write_initial_layout()
        if self.t0_ns is None:
            # the shared epoch: every engine's clock and every gossiped
            # `until` is relative to it, so untils compare across engines;
            # its wall twin, stamped at the same instant, lets a peer
            # host rebase this host's wires into its own epoch
            self.t0_ns = time.clock_gettime_ns(time.CLOCK_MONOTONIC)
            if self.t0_wall_ns is None:
                self.t0_wall_ns = time.time_ns()
        if self.t0_wall_ns is None:
            # an external monotonic epoch: its wall twin names the same
            # instant
            self.t0_wall_ns = time.time_ns() - (
                time.clock_gettime_ns(time.CLOCK_MONOTONIC) - self.t0_ns)
        for r in range(self.n):
            st = StatusBlock(status_path(self.cluster_dir, r))
            st.ctl_set("c_t0", self.t0_ns)
            st.ctl_set("c_t0_wall", self.t0_wall_ns)
            st.ctl_set("c_gen", 0)
            self._status.append(st)
        self._start_federation()
        for r in range(self.n):
            if r in self._active:
                self._spawn(r)
        self._maybe_prewarm()

    def _start_federation(self) -> None:
        """The multi-host fleet's federation beacon on this host's base
        port (``net`` spec); nothing on a single-host fleet."""
        if self.net is None:
            return
        from flowsentryx_tpu_torch.cluster import transport

        self.federation = transport.host_beacon(
            self.net, self.t0_wall_ns,
            interval_s=self.net.get(
                "beacon_interval_s", tuning.NET_BEACON_INTERVAL_S),
            timeout_s=self.net.get(
                "host_timeout_s", tuning.NET_HOST_TIMEOUT_S))

    def _maybe_prewarm(self) -> None:
        """An elastic fleet whose specs carry a compile cache spawns ONE
        short-lived child (:func:`~.runner.prewarm_main`) that builds the
        fleet's kernels into the cache at boot, so a GROW spare (same
        spec) loads them instead of building them.  Best effort and
        non-blocking; stub fleets skip it."""
        if self._elastic is None or not self._entry_is_real:
            return
        spec = next(
            (s for s in self.specs if s.get("compile_cache")), None)
        if spec is None:
            return
        from flowsentryx_tpu_torch.cluster.runner import prewarm_main

        p = self._ctx.Process(target=prewarm_main, args=(dict(spec),),
                              name="fsx-cluster-prewarm", daemon=True)
        p.start()
        self._prewarm_proc = p
        self.prewarm_spawned += 1

    def _uniform_workers(self) -> int:
        """The per-rank ring width when every spec agrees on one (the
        shard assignment's precondition); 0 when the specs carry none
        (the lifecycle stubs: no rings, no layout)."""
        ws = {s.get("workers") for s in self.specs}
        return int(next(iter(ws))) if len(ws) == 1 and None not in ws \
            else 0

    def _write_initial_layout(self) -> None:
        """Publish generation 0 of the shard assignment (``layout.json``):
        ``total_shards = n * w`` for the fleet's lifetime, the spans of
        unspawned ranks folded onto the live ones."""
        from flowsentryx_tpu_torch.cluster import rebalance as rb

        w = self._uniform_workers()
        if not w:
            return
        rb.ShardAssignment.initial(
            self.n * w, w, len(self._active)).save(self.cluster_dir)

    def _adopt_plane(self) -> None:
        """``boot(adopt=True)``: attach to a plane a previous supervisor
        left, of this fleet's shape.  Live ranks (pid alive and a fresh
        heartbeat) are adopted as they are; dead ranks respawn ``gen+1``
        from their checkpoints through the crash path."""
        plane_file = self.cluster_dir / "plane.json"
        if not plane_file.exists():
            raise RuntimeError(
                f"adopt=True but {plane_file} does not exist — nothing "
                "to adopt; boot without adopt to create the plane")
        meta = json.loads(plane_file.read_text())
        if int(meta.get("n_engines", -1)) != self.n:
            raise RuntimeError(
                f"adopt=True: plane has {meta.get('n_engines')} "
                f"engines, this supervisor supervises {self.n} — an "
                "adopted fleet must match the plane's shape")
        dead: list[int] = []
        for r in range(self.n):
            st = StatusBlock(status_path(self.cluster_dir, r))
            self._status.append(st)
            # the shared epoch is the plane's: every gossiped `until` in
            # flight is relative to it
            if self.t0_ns is None and st.ctl_get("c_t0"):
                self.t0_ns = st.ctl_get("c_t0")
                self.t0_wall_ns = st.ctl_get("c_t0_wall") or None
            self._gen[r] = st.ctl_get("c_gen")
            state = st.ctl_get("c_state")
            hb, age_ns = _heartbeat_age_ns(st)
            pid = st.ctl_get("c_pid")
            fresh = (hb and 0 <= age_ns
                     < 2 * self.heartbeat_timeout_s * 1e9)
            if state in _LIVE and fresh and pid and _pid_alive(pid):
                # serving: adopted untouched, judged by its pid from now
                self._adopted.add(r)
                self._active.add(r)
            elif state == wire.CSTATE_DONE:
                self._done.add(r)
                self._active.discard(r)
            elif r in self._active:
                dead.append(r)
        if self.t0_ns is None:
            raise RuntimeError(
                "adopt=True: no rank ever stamped the shared epoch — "
                "this plane never served; boot without adopt")
        self._neutralize_stale_handoff()
        self._start_federation()
        for r in dead:
            # died under the previous supervisor: the crash path
            self.restarts[r] += 1
            self._gen[r] += 1
            self._spawn(r)

    def _refuse_live_plane(self) -> None:
        """Booting over a LIVE plane refuses: ``create_plane`` truncates
        every mailbox and status file under the serving engines' mmaps
        (SIGBUS on their next publish) and would attach this fleet as a
        second consumer of their ring shards.  A dead fleet's plane is
        fine to stomp; a live one is adopted (:meth:`_adopt_plane`).  A
        heartbeat from the future (the monotonic clock restarted at a
        reboot) is stale."""
        live = []
        for r in range(self.n):
            p = Path(status_path(self.cluster_dir, r))
            if not p.exists():
                continue
            try:
                st = StatusBlock(p)
                state = st.ctl_get("c_state")
                hb, age_ns = _heartbeat_age_ns(st)
            except Exception:
                continue  # a partial or corrupt leftover: not a fleet
            if (state in _LIVE and hb
                    and 0 <= age_ns
                    < 2 * self.heartbeat_timeout_s * 1e9):
                live.append((r, age_ns * 1e-9))
        if live:
            detail = ", ".join(
                f"rank {r} heartbeated {age:.1f}s ago" for r, age in live)
            raise RuntimeError(
                f"cluster dir {self.cluster_dir} has live engines "
                f"({detail}; liveness bound "
                f"{2 * self.heartbeat_timeout_s:.0f}s): re-creating "
                "the plane would truncate their mmap'd mailboxes "
                "mid-serve (SIGBUS on their next publish) and attach "
                "this fleet as a second consumer on their SPSC ring "
                "shards. Remediation: adopt the live fleet instead "
                "(boot(adopt=True) / fsx cluster --adopt), stop the "
                "old fleet (its own supervisor's stop-drain, or kill "
                "the listed ranks and wait for their heartbeats to go "
                "stale), or point --cluster-dir at a fresh directory")

    def _spawn(self, rank: int) -> None:
        spec = dict(self.specs[rank])
        gen = self._gen[rank]
        spec["rank"] = rank
        spec["n_engines"] = self.n
        spec["cluster_dir"] = str(self.cluster_dir)
        spec["gen"] = gen
        spec["t0_ns"] = self.t0_ns
        spec["t0_wall_ns"] = self.t0_wall_ns
        if self.net is not None:
            spec["net"] = self.net
        # per-generation default; a caller's report_path serves every
        # generation (aggregate() keeps each rank's latest)
        spec.setdefault(
            "report_path",
            str(self.cluster_dir / f"report_r{rank}_g{gen}.json"))
        if gen > 0 and spec.get("checkpoint"):
            ck_file = Path(self._ckpt_file(spec["checkpoint"]))
            # `<name>.npz.prev` is the checkpoint's retained generation
            # (engine/checkpoint.py's prev_path, inlined: that module
            # imports torch through core/schema.py).  Hand
            # over the LIVE path even when only `.prev` exists:
            # Engine.restore falls back to `.prev` itself, announced and
            # counted in the health ladder — choosing `.prev` here would
            # launder a stale-generation resume into a clean restore
            prev = ck_file.with_name(ck_file.name + ".prev")
            if ck_file.exists() or prev.exists():
                spec["restore"] = str(ck_file)
        p = self._ctx.Process(target=self._entry, args=(spec,),
                              name=f"fsx-cluster-r{rank}")
        p.start()
        self._procs[rank] = p
        self._adopted.discard(rank)  # ours now: judged by its handle
        self._status[rank].ctl_set("c_gen", gen)

    @staticmethod
    def _ckpt_file(path: str) -> str:
        """``save_state`` appends ``.npz`` to a suffix-less path: mirror
        that when probing for a restorable file."""
        p = Path(path)
        return str(p if p.suffix == ".npz"
                   else p.with_suffix(p.suffix + ".npz"))

    def _killpg(self, proc: mp.process.BaseProcess) -> None:
        """Kill a dead engine's whole process group (its drain workers
        must not outlive it)."""
        if proc.pid is None:
            return
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except (ProcessLookupError, PermissionError, OSError):
            pass

    def kill(self, rank: int) -> None:
        """Chaos hook: SIGKILL one rank's whole process group, the death
        crash-fail-open must absorb; the next :meth:`poll` restarts it."""
        p = self._procs[rank]
        if p is not None and p.is_alive():
            self._killpg(p)
            # a child killed before its setpgid has no group yet: kill
            # the process itself too, so the rank is dead on return
            p.kill()
            p.join(timeout=2.0)

    def _announce_park(self, rank: int, recent: int) -> None:
        """A rank spent its restart budget: parked as failed, with its
        shard span named (its flows fall to the kernel tier alone)."""
        w = self.specs[rank].get("workers")
        span = (f"ring shards [{rank * w}, {(rank + 1) * w})"
                if w else f"rank {rank}'s shard span")
        print(
            f"fsx cluster: rank {rank} PARKED as failed — {recent} "
            f"death(s) within the {self.restart_window_s:.0f}s restart "
            f"window (budget {self.max_restarts}); {span} fails open "
            "to the kernel tier. Fix the crash cause and restart the "
            "fleet to re-serve it.", file=sys.stderr)

    def _announce_dead_host(self, host: int) -> None:
        """A peer HOST went silent past the federation timeout: every
        span its engines owned is now mitigated by its kernel tier
        alone.  Announced with the span and the remedy, as a park."""
        n_eng = int(self.net.get("engines_per_host", 0) or 0)
        hosts = self.net.get("hosts") or []
        addr = (f"{hosts[host][0]}:{hosts[host][1]}"
                if host < len(hosts) else "?")
        span = (f"its {n_eng} engine span(s)" if n_eng
                else "its engine spans")
        print(
            f"fsx cluster: peer host {host} ({addr}) DEAD — no "
            f"federation beacon for "
            f"{self.federation.timeout_s:.0f}s; {span} fail open to "
            "that host's kernel tier. Fleet health folds FAILED until "
            "the host returns (its first beacon/HELLO re-joins it and "
            "triggers a gossip resync).", file=sys.stderr)

    def poll(self) -> None:
        """One supervision pass: the federation beacon (multi-host),
        liveness, heartbeat staleness, and the restart-or-park decision
        for each dead rank."""
        now_ns = time.clock_gettime_ns(time.CLOCK_MONOTONIC)
        now = time.monotonic()
        if self.federation is not None:
            # beacon our liveness, take the peers', and announce a peer
            # host's death once per incident
            self.federation.tick()
            dead = set(self.federation.dead_hosts())
            for h in sorted(dead - self._dead_hosts_announced):
                self._announce_dead_host(h)
            # a revived host leaves the set, so a relapse re-announces
            self._dead_hosts_announced = dead
        for r in range(self.n):
            if (r not in self._active or r in self._failed
                    or r in self._done):
                continue
            # a backoff-delayed respawn whose delay elapsed fires now
            if r in self._respawn_at:
                if now >= self._respawn_at[r]:
                    del self._respawn_at[r]
                    self.restarts[r] += 1
                    self._gen[r] += 1
                    self._spawn(r)
                continue
            p = self._procs[r]
            st = self._status[r]
            state = st.ctl_get("c_state")
            if p is None and r in self._adopted:
                # an adopted rank: its pid and heartbeat are the
                # evidence.  DONE is judged first: the exited child is a
                # zombie only its dead supervisor could reap
                if state == wire.CSTATE_DONE:
                    self._adopted.discard(r)
                    self._done.add(r)
                    continue
                pid = st.ctl_get("c_pid")
                if not _pid_alive(pid):
                    self._adopted.discard(r)
                    if pid:
                        try:  # orphaned drain workers, as killpg
                            os.killpg(pid, signal.SIGKILL)
                        except (ProcessLookupError, PermissionError,
                                OSError):
                            pass
                    self._decide_respawn(r, now)
                    continue
            elif p is not None and not p.is_alive():
                if state == wire.CSTATE_DONE:
                    self._done.add(r)
                    continue
                # died without DONE: clean up the whole tree, then
                # restart or park against the sliding window
                self._killpg(p)
                p.join(timeout=1.0)
                self._procs[r] = None
                self._decide_respawn(r, now)
                continue
            hb = st.ctl_get("c_hbeat")
            if (hb and state == wire.CSTATE_SERVING
                    and now_ns - hb > self.heartbeat_timeout_s * 1e9):
                self._stalled.add(r)
            else:
                self._stalled.discard(r)
        self._handoff_tick(now)

    def _decide_respawn(self, r: int, now: float) -> None:
        """Restart or park: deaths older than the window are forgotten;
        the k-th recent one waits ``backoff * 2**k`` (capped)."""
        self._death_times[r] = [
            t for t in self._death_times[r]
            if now - t < self.restart_window_s]
        recent = len(self._death_times[r])
        self._death_times[r].append(now)
        if recent < self.max_restarts:
            self._respawn_at[r] = now + min(
                self.restart_backoff_s * (2 ** recent),
                self.restart_backoff_max_s)
        else:
            self._failed.add(r)
            self._announce_park(r, recent + 1)

    # -- live shard handoff coordination (cluster/rebalance.py) -------------

    def live_ranks(self) -> list[int]:
        """Active ranks able to serve (spawned or adopted; not failed,
        done or parked)."""
        return [r for r in sorted(self._active)
                if r not in self._failed and r not in self._done
                and r not in self._shrunk
                and (self._procs[r] is not None or r in self._adopted)]

    def start_handoff(self, shards, donor: int, recipient: int, *,
                      rows=None) -> int:
        """Open one handoff (the state machine is in :mod:`.rebalance`'s
        docstring): write the descriptor, create the mailbox, stamp the
        fence; the engines do the rest between run chunks and
        :meth:`poll` drives the supervisor's half.  ``rows`` adopts from
        a checkpoint instead: the supervisor is the donor (``donor=-1``)
        and publishes the rows itself."""
        from flowsentryx_tpu_torch.cluster import rebalance as rb

        if self._handoff is not None:
            raise RuntimeError(
                "a handoff is already in flight (one shard span moves "
                "at a time, fleet-wide)")
        asg = rb.ShardAssignment.load(self.cluster_dir)
        if asg is None:
            raise RuntimeError("no layout.json: this fleet has no "
                               "shard assignment to rebalance")
        shards = sorted(int(s) for s in shards)
        self._handoff_seq += 1
        hid = self._handoff_seq
        mbx_path = rb.handoff_mailbox_path(self.cluster_dir, hid)
        n_rows = None
        if rows is not None:
            keys, states = rows
            n_rows = len(keys)
            # room for the whole stream: the supervisor's control loop
            # must not block on the recipient's drain
            per = 512
            need = max(2, (n_rows + per - 1) // per + 2)
            slots = 1
            while slots < need:
                slots *= 2
            mbx = rb.mailbox_cls().create(mbx_path, slots=slots,
                                          rows_per_slot=per)
            rb.ship_rows(mbx, keys, states)
        else:
            rb.mailbox_cls().create(mbx_path)
        rb._write_atomic(rb.handoff_json_path(self.cluster_dir),
                         json.dumps({
                             "id": hid, "shards": shards,
                             "donor": donor, "recipient": recipient,
                             "to_gen": asg.generation + 1,
                             "total_shards": asg.total_shards,
                             "source": "ckpt" if rows is not None
                             else "engine",
                         }) + "\n")
        for r in ([recipient] if donor < 0 else [donor, recipient]):
            self._status[r].ctl_set("c_fence", hid)
        self.rebalance_counters["fences"] += 1
        self._handoff = {
            "id": hid, "shards": shards, "donor": donor,
            "recipient": recipient, "to_gen": asg.generation + 1,
            "phase": "shipping", "n_rows": n_rows,
            "deadline": time.monotonic() + tuning.HANDOFF_TIMEOUT_S,
        }
        return hid

    def _handoff_phase_of(self, rank: int, hid: int) -> int:
        from flowsentryx_tpu_torch.cluster import rebalance as rb

        return rb._phase_of(self._status[rank].ctl_get("c_handoff"), hid)

    def _redeliver_stamps(self, h: dict | None) -> None:
        """Re-assert the supervisor's two idempotent cross-party stamps
        every tick, guarded by a read (the steady state writes nothing):
        with no handoff in flight every ``c_fence`` reads 0, and while
        committing every rank reads the new ``c_layout_gen``.  A lost
        stamp would otherwise leave a rank waiting for good."""
        if h is None:
            for st in self._status:
                if st.ctl_get("c_fence"):
                    st.ctl_set("c_fence", 0)
            return
        if h["phase"] == "committing":
            for r in range(self.n):
                st = self._status[r]
                if st.ctl_get("c_layout_gen") != h["to_gen"]:
                    st.ctl_set("c_layout_gen", h["to_gen"])

    def _handoff_tick(self, now: float) -> None:
        from flowsentryx_tpu_torch.cluster import rebalance as rb

        h = self._handoff
        if h is None:
            self._redeliver_stamps(None)
            return
        if h["phase"] == "shipping":
            # before the commit an abort is always safe: the donor owns
            # the span until layout.json says otherwise
            live = self.live_ranks()
            party_dead = (h["recipient"] not in live
                          or (h["donor"] >= 0 and h["donor"] not in live))
            if party_dead or now > h["deadline"]:
                self._abort_handoff(
                    "party died" if party_dead else "timed out")
                return
            donor_ok = (h["donor"] < 0
                        or self._handoff_phase_of(h["donor"], h["id"])
                        >= wire.HP_SHIPPED)
            recip_ok = (self._handoff_phase_of(h["recipient"], h["id"])
                        >= wire.HP_STAGED)
            if donor_ok and recip_ok:
                # COMMIT, the atomic flip: layout.json first (the truth
                # a crashed rank reconciles against), then the stamp
                asg = rb.ShardAssignment.load(self.cluster_dir)
                asg = asg.reassign(h["shards"], h["recipient"])
                asg.save(self.cluster_dir)
                for r in range(self.n):
                    self._status[r].ctl_set("c_layout_gen",
                                            asg.generation)
                self.rebalance_counters["flips"] += 1
                if h["n_rows"] is None:
                    try:  # the staged spool is the shipped-row census
                        sp = rb.load_spool(rb.staged_path(
                            self.cluster_dir, h["recipient"]))
                        h["n_rows"] = (int(len(sp["keys"]))
                                       if sp is not None else 0)
                    except (OSError, ValueError, KeyError):
                        h["n_rows"] = 0
                h["phase"] = "committing"
            return
        # committing: the flip is durable and never aborted.  The fence
        # lifts once every live active rank echoed the new generation (a
        # respawned rank acks through its boot-time reconcile)
        self._redeliver_stamps(h)
        waiting = [r for r in sorted(self._active)
                   if r not in self._failed and r not in self._done
                   and self._status[r].ctl_get("c_layout_ack")
                   < h["to_gen"]]
        if not waiting:
            self._finish_handoff()

    def _clear_fences(self) -> None:
        for st in self._status:
            st.ctl_set("c_fence", 0)

    def _unlink_handoff_files(self, hid: int) -> None:
        from flowsentryx_tpu_torch.cluster import rebalance as rb

        for p in (rb.handoff_json_path(self.cluster_dir),
                  Path(rb.handoff_mailbox_path(self.cluster_dir, hid))):
            try:
                durable.get_fs().unlink(p)
            except OSError:
                pass

    def _finish_handoff(self) -> None:
        h = self._handoff
        self._clear_fences()
        self.rebalance_counters["rows_shipped"] += int(h["n_rows"] or 0)
        # the recipient's staged spool stays: until its next checkpoint
        # it is the adopted rows' only durable copy (the recipient
        # releases it, EngineRebalancer.note_checkpointed)
        self._unlink_handoff_files(h["id"])
        self._handoff = None

    def _abort_handoff(self, why: str) -> None:
        """The unwind before a commit: clear the fence, delete the
        descriptor and the mailbox (and a spool staged for this attempt).
        The recipient discards its staged rows when it sees the fence
        cleared; the donor never stopped owning the span."""
        from flowsentryx_tpu_torch.cluster import rebalance as rb

        h = self._handoff
        self._clear_fences()
        self._unlink_handoff_files(h["id"])
        # a spool kept from an earlier committed flip is still the
        # recipient's durable copy and stays
        rb.discard_uncommitted_spool(self.cluster_dir, h["recipient"])
        self.rebalance_counters["aborts"] += 1
        print(f"fsx cluster: handoff {h['id']} (shards {h['shards']} "
              f"rank {h['donor']} -> {h['recipient']}) ABORTED: {why}; "
              "donor keeps the span, nothing moved", file=sys.stderr)
        self._handoff = None

    def _neutralize_stale_handoff(self) -> None:
        """On adopt: a supervisor that died mid-handoff left the fence
        stamped and its files behind, and a successor's ids restart at 1
        (its first handoff would read the stale acks and spool as its
        own).  Clear every fence, seed the id counter past the stale id,
        then RESUME the handoff if its flip committed (the layout is the
        truth; the fleet has to finish observing it) or delete the dead
        attempt's files if not (nothing moved)."""
        from flowsentryx_tpu_torch.cluster import rebalance as rb

        self._clear_fences()
        p = rb.handoff_json_path(self.cluster_dir)
        fs = durable.get_fs()
        if not fs.exists(p):
            return
        try:
            stale = json.loads(fs.read_text(p))
        except (OSError, ValueError):
            stale = {}
        hid = int(stale.get("id", 0) or 0)
        self._handoff_seq = max(self._handoff_seq, hid)
        asg = rb.ShardAssignment.load(self.cluster_dir)
        committed = (asg is not None and "to_gen" in stale
                     and asg.generation >= int(stale["to_gen"]))
        if committed and "recipient" in stale and "shards" in stale:
            # the dead supervisor may have published layout.json and died
            # before the stamp: re-stamp (idempotent), and the normal
            # committing -> finish path converges
            for st in self._status:
                st.ctl_set("c_layout_gen", asg.generation)
            self._handoff = {
                "id": hid,
                "shards": [int(s) for s in stale["shards"]],
                "donor": int(stale.get("donor", -1)),
                "recipient": int(stale["recipient"]),
                "to_gen": int(stale["to_gen"]),
                "phase": "committing",
                "n_rows": None,
                "deadline": time.monotonic() + tuning.HANDOFF_TIMEOUT_S,
            }
            return
        self._unlink_handoff_files(hid)
        if "recipient" in stale:
            # guarded: a spool of an earlier committed flip survives
            rb.discard_uncommitted_spool(self.cluster_dir,
                                         int(stale["recipient"]))

    def adopt_dead_span(self, dead_rank: int, recipient: int) -> dict:
        """Dead-span adoption: ship a confirmed-dead rank's span to a
        survivor from its last checkpoint (the supervisor is the donor,
        through the numpy-only :func:`~.rebalance.load_ckpt_rows`).  Rows
        newer than the checkpoint died with the rank, the loss window of
        every restart; what the checkpoint holds is conserved exactly.
        Announced in :meth:`aggregate` as ``adopted_spans``."""
        import numpy as np

        from flowsentryx_tpu_torch.cluster import rebalance as rb

        asg = rb.ShardAssignment.load(self.cluster_dir)
        if asg is None:
            raise RuntimeError("no layout.json: nothing to adopt")
        span = asg.spans_of(dead_rank)
        if not span:
            raise RuntimeError(f"rank {dead_rank} owns no shards")
        ckpt = self.specs[dead_rank].get("checkpoint")
        keys = states = None
        if ckpt:
            ck_file = Path(self._ckpt_file(ckpt))
            prev = ck_file.with_name(ck_file.name + ".prev")
            for cand in (ck_file, prev):
                if durable.get_fs().exists(cand):
                    try:
                        keys, states = rb.load_ckpt_rows(cand)
                        break
                    except (OSError, ValueError, KeyError):
                        continue
        if keys is None:
            keys = np.empty(0, np.uint32)
            states = np.empty((0, wire.NUM_TABLE_COLS), np.float32)
        # only the dead rank's span ships (a snapshot from before a flip
        # may hold other rows)
        sel = np.isin(wire.shard_of(keys, asg.total_shards),
                      np.asarray(span, np.uint32))
        hid = self.start_handoff(span, -1, recipient,
                                 rows=(keys[sel], states[sel]))
        entry = {"dead_rank": dead_rank, "recipient": recipient,
                 "shards": list(span), "rows": int(np.sum(sel)),
                 "handoff_id": hid}
        self.adopted_spans.append(entry)
        self.rebalance_counters["adoptions"] += 1
        return entry

    # -- autoscaling (cluster/elastic.py) ------------------------------------

    def _ring_backlog(self) -> dict[int, int]:
        """Unread records per live rank off the shm ring cursors (head
        minus tail): the real ingest queue depth, read without attaching
        as a consumer."""
        out: dict[int, int] = {}
        w = self._uniform_workers()
        if not w:
            return out
        for r in self.live_ranks():
            base = self.specs[r].get("ring_base")
            total = self.specs[r].get("total_shards", self.n * w)
            if not base:
                continue
            depth = 0
            for s in range(r * w, (r + 1) * w):
                p = wire.shard_ring_path(base, s, total)
                try:
                    with open(p, "rb") as f:
                        f.seek(wire.SHM_HEAD_OFFSET)
                        head = int.from_bytes(f.read(8), "little")
                        f.seek(wire.SHM_TAIL_OFFSET)
                        tail = int.from_bytes(f.read(8), "little")
                    depth += max(0, head - tail)
                except OSError:
                    continue
            out[r] = depth
        return out

    def _sample_signals(self, now: float) -> dict:
        """The elastic signal vector: the ring backlog and the per-rank
        record-rate skew from the ``c_records`` counters."""
        backlog = self._ring_backlog()
        live = self.live_ranks()
        rates = []
        for r in live:
            rec = self._status[r].ctl_get("c_records")
            prev = self._last_records.get(r)
            self._last_records[r] = (now, rec)
            if prev and now > prev[0]:
                rate = max(0.0, (rec - prev[1]) / (now - prev[0]))
                self._rates[r] = rate
                rates.append(rate)
        signals: dict = {}
        if backlog:
            vals = [backlog.get(r, 0) for r in live]
            signals["backlog_per_engine"] = (
                sum(vals) / max(1, len(vals)))
            signals["backlog_max"] = max(vals) if vals else 0
            signals["backlog"] = {str(r): backlog.get(r, 0)
                                  for r in live}
        if rates and max(rates) > 0:
            mean = sum(rates) / len(rates)
            signals["rate_skew"] = (max(rates) / mean) if mean else 1.0
        return signals

    def elastic_tick(self, now: float | None = None) -> dict | None:
        """One autoscaler tick (``run`` calls it every poll when a policy
        is installed): sample, decide, execute.  Every executed plan is
        printed with its signal vector."""
        if self._elastic is None:
            return None
        now = time.monotonic() if now is None else now
        if now < self._elastic_next:
            return None
        self._elastic_next = now + tuning.ELASTIC_TICK_S
        self._finish_pending_grow()
        self._finish_pending_shrink()
        signals = self._sample_signals(now)
        plan = self._elastic.decide(signals, len(self.live_ranks()), now)
        if plan["action"] != "hold":
            self._execute_plan(plan, now)
        return plan

    def _log_plan(self, plan: dict, what: str) -> None:
        print(f"fsx cluster elastic: {plan['action'].upper()} {what} "
              f"— {plan['reason']} | signals={json.dumps(plan['signals'])}",
              file=sys.stderr)

    def _finish_pending_grow(self) -> None:
        """The second half of a grow: once the new rank serves and the
        handoff lane is free, hand it half the hottest live span."""
        g = self._pending_grow
        if g is None or self._handoff is not None:
            return
        r = g["rank"]
        if r in self._failed:
            self._pending_grow = None
            return
        if self._status[r].ctl_get("c_state") != wire.CSTATE_SERVING:
            return
        from flowsentryx_tpu_torch.cluster import rebalance as rb

        asg = rb.ShardAssignment.load(self.cluster_dir)
        donors = [d for d in self.live_ranks() if d != r
                  and len(asg.spans_of(d)) >= 2]
        if not donors:
            self._pending_grow = None
            return
        donor = max(donors, key=lambda d: (
            self._rates.get(d, 0.0), len(asg.spans_of(d))))
        span = asg.spans_of(donor)
        self.start_handoff(span[len(span) // 2:], donor, r)
        self._pending_grow = None

    def _execute_plan(self, plan: dict, now: float) -> None:
        if self._handoff is not None or self._pending_grow is not None:
            return  # the lane is busy: the plan comes again next tick
        from flowsentryx_tpu_torch.cluster import rebalance as rb

        action = plan["action"]
        if action == "grow":
            spare = [r for r in range(self.n)
                     if r not in self._active and r not in self._shrunk]
            if not spare:
                return
            r = spare[0]
            self._active.add(r)
            self._gen[r] = 0
            self._spawn(r)
            self._pending_grow = {"rank": r}
            self.elastic_executed += 1
            self._elastic.executed(now)
            self._log_plan(plan, f"-> spawn rank {r} gen-0")
            return
        asg = rb.ShardAssignment.load(self.cluster_dir)
        if asg is None:
            return
        live = self.live_ranks()
        if action == "shrink" and len(live) >= 2:
            victim = max(live)
            span = asg.spans_of(victim)
            survivors = [r for r in live if r != victim]
            coldest = min(survivors,
                          key=lambda r: self._rates.get(r, 0.0))
            if span:
                self.start_handoff(span, victim, coldest)
            self._pending_shrink = {"rank": victim}
            self.elastic_executed += 1
            self._elastic.executed(now)
            self._log_plan(plan, f"-> drain rank {victim} span to "
                                 f"rank {coldest}, then park")
        elif action == "rebalance" and len(live) >= 2:
            hottest = max(live, key=lambda r: self._rates.get(r, 0.0))
            coldest = min(live, key=lambda r: self._rates.get(r, 0.0))
            span = asg.spans_of(hottest)
            if hottest == coldest or len(span) < 2:
                return
            self.start_handoff(span[len(span) // 2:], hottest, coldest)
            self.elastic_executed += 1
            self._elastic.executed(now)
            self._log_plan(plan, f"-> move {len(span) // 2} shard(s) "
                                 f"rank {hottest} -> {coldest}")

    def _finish_pending_shrink(self) -> None:
        """After a shrink's handoff committed the victim owns nothing:
        stop-drain it alone and park it as SHRUNK (not failed)."""
        s = self._pending_shrink
        if s is None or self._handoff is not None:
            return
        victim = s["rank"]
        self._status[victim].ctl_set("c_stop", 1)
        self._shrunk.add(victim)
        self._pending_shrink = None

    def request_stop(self) -> None:
        """Ask every engine to drain its shard and exit."""
        self._stop_sent = True
        for st in self._status:
            st.ctl_set("c_stop", 1)

    def run(self, max_seconds: float | None = None,
            poll_s: float = tuning.SUPERVISOR_POLL_S,
            drain_timeout_s: float = tuning.SUPERVISOR_DRAIN_TIMEOUT_S
            ) -> dict:
        """Supervise until every rank is DONE or failed.  ``max_seconds``
        bounds the serving phase: then a stop-drain, itself bounded by
        ``drain_timeout_s``."""
        t0 = time.monotonic()
        deadline = None if max_seconds is None else t0 + max_seconds
        while len(self._done) + len(self._failed) < len(self._active):
            self.poll()
            self.elastic_tick()
            if (deadline is not None and not self._stop_sent
                    and time.monotonic() >= deadline):
                self.request_stop()
                deadline = time.monotonic() + drain_timeout_s
            elif (self._stop_sent and deadline is not None
                    and time.monotonic() >= deadline):
                break  # the drain overran its bound: terminate below
            time.sleep(poll_s)
        self.close()
        return self.aggregate()

    def close(self,
              timeout_s: float = tuning.SUPERVISOR_CLOSE_TIMEOUT_S) -> None:
        if not self._stop_sent:
            self.request_stop()
        deadline = time.monotonic() + timeout_s
        for r, p in enumerate(self._procs):
            if p is None:
                if r in self._respawn_at and r not in self._done:
                    # awaiting a backoff respawn when the terminal stop
                    # landed: no restart is coming, the rank failed
                    self._respawn_at.pop(r, None)
                    self._failed.add(r)
                continue
            p.join(timeout=max(0.0, deadline - time.monotonic()))
            if p.is_alive():
                # force-killed mid-drain: its shard was not fully served,
                # so it is failed (and flips the CLI's exit code)
                self._killpg(p)
                p.terminate()
                p.join(timeout=1.0)
                self._failed.add(r)
            elif self._status[r].ctl_get("c_state") == wire.CSTATE_DONE:
                self._done.add(r)
            elif r not in self._done:
                self._failed.add(r)
        p = self._prewarm_proc
        if p is not None:
            p.join(timeout=max(0.0, deadline - time.monotonic()))
            if p.is_alive():
                self._killpg(p)
                p.terminate()
                p.join(timeout=1.0)
        if self.federation is not None:
            self.federation.close()

    # -- reporting ----------------------------------------------------------

    def aggregate(self) -> dict:
        """Every generation's report JSON folded into one cluster view:
        per-rank reports, totals from each rank's latest generation, the
        aggregate rate (total records over the SLOWEST rank's wall: a sum
        of rates would hide a straggler), the latency histograms merged
        exactly, health worst-of (with the supervisor's handoff and
        autoscaler reasons), the governors' counters merged, the boot
        stories, and the rebalance and elastic blocks."""
        reports = []
        for f in sorted(self.cluster_dir.glob("report_r*_g*.json")):
            try:
                reports.append(json.loads(f.read_text()))
            except (OSError, ValueError):
                continue
        latest: dict[int, dict] = {}
        for rep in reports:
            r = rep.get("rank", -1)
            if r not in latest or rep.get("gen", 0) >= latest[r].get(
                    "gen", 0):
                latest[r] = rep
        # totals and walls both from each rank's latest generation, so a
        # restarted rank's records are not counted twice
        total_records = sum(r["report"].get("records", 0)
                            for r in latest.values() if "report" in r)
        total_batches = sum(r["report"].get("batches", 0)
                            for r in latest.values() if "report" in r)
        walls = [r["report"].get("wall_s", 0.0)
                 for r in latest.values() if "report" in r]
        max_wall = max(walls) if walls else 0.0
        # the latency, governor and boot folds are the ones ``fsx status
        # --engine-report`` applies (one implementation), over each rank's
        # latest generation keyed by rank: the HDR bucket counts merge
        # into exact cluster percentiles (never an average of per-rank
        # p99s), the governors' counters sum (each rank forecasts its own
        # shard), the boot caches sum and the slowest serving-ready wins
        from flowsentryx_tpu_torch import cli

        ranked = [(str(r), rep, None) for r, rep in sorted(latest.items())]
        lat = cli._merged_latency(ranked)
        latency = None
        if lat["seal_to_verdict_us"].get("n"):
            latency = {"unit": "us",
                       "seal_to_verdict": lat["seal_to_verdict_us"],
                       "per_rank_p99": {
                           r: e["p99_us"] for r, e in
                           lat["per_report"].items() if "error" not in e}}
        per_rank_health = {
            r: rep["report"]["health"] for r, rep in latest.items()
            if isinstance(rep.get("report"), dict)
            and rep["report"].get("health")}
        # the federation's view (multi-host): per-peer-host beacon ages
        # and the dead list; a dead peer host folds the fleet FAILED
        hosts_block = None
        dead_hosts: list[int] = []
        if self.federation is not None:
            hosts_block = self.federation.report()
            dead_hosts = self.federation.dead_hosts()
        health = health_mod.cluster_health(
            per_rank_health, sorted(self._failed), sorted(self._stalled),
            dead_hosts=dead_hosts)
        # the supervisor's own reasons (a suppressed plan, an aborted
        # handoff), folded so `monitor --alert-degraded` sees them
        sup_reasons = []
        if self._elastic is not None and self._elastic.suppressed:
            sup_reasons.append(
                f"elastic_plans_suppressed:{self._elastic.suppressed}")
        if self.rebalance_counters["aborts"]:
            sup_reasons.append(
                f"rebalance_aborts:{self.rebalance_counters['aborts']}")
        if sup_reasons:
            health["reasons"] = list(health["reasons"]) + sup_reasons
            health["state"] = health_mod.worst(health["state"],
                                               health_mod.DEGRADED)
        predict_block = cli._merged_predict(ranked)
        boot_block = cli._merged_boot(ranked)
        if boot_block is not None:
            boot_block = {"per_rank": boot_block.pop("per_report"),
                          **boot_block,
                          "prewarm_spawned": self.prewarm_spawned}
        elastic_block = None
        if self._elastic is not None:
            elastic_block = {
                "min_engines": self._elastic.min_engines,
                "max_engines": self._elastic.max_engines,
                "executed": self.elastic_executed,
                "suppressed": self._elastic.suppressed,
                "shrunk_ranks": sorted(self._shrunk),
                # every decision with the signal vector behind it
                "decisions": self._elastic.decisions[-200:],
            }
        return {
            "engines": self.n,
            "active_ranks": sorted(self._active),
            "adopted_ranks": sorted(self._adopted),
            "rebalance": dict(self.rebalance_counters,
                              adopted_spans=list(self.adopted_spans)),
            "elastic": elastic_block,
            "t0_ns": self.t0_ns,
            "t0_wall_ns": self.t0_wall_ns,
            "restarts": list(self.restarts),
            "failed_ranks": sorted(self._failed),
            "stalled_ranks": sorted(self._stalled),
            "hosts": hosts_block,
            "health": health,
            "records": total_records,
            "batches": total_batches,
            "max_wall_s": round(max_wall, 4),
            "aggregate_records_per_s": round(
                total_records / max(max_wall, 1e-9), 1),
            "latency": latency,
            "predict": predict_block,
            "boot": boot_block,
            "reports": reports,
        }
