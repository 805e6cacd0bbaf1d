"""Cluster supervisor: spawn, watch, restart — never on the data path.

Counterpart of ``flowsentryx_tpu/cluster/supervisor.py`` for a fixed
single-host fleet (the reference's shard handoff, adopt, elastic and
federation paths are not ported: ROADMAP queue 1).  The supervisor is
control plane only: it creates the shm plane, stamps the shared t0
epoch, spawns one engine process per rank (``spawn``: this process
imports neither torch nor CUDA, only the engines own a context on the
card), watches liveness and restarts the dead from their last
checkpoint.

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
from flowsentryx_tpu_torch.core import wire
# numpy-only engine leaves (engine/__init__ resolves lazily): the HDR
# histogram the per-rank reports carry, the health ladder, the
# governor's report merge
from flowsentryx_tpu_torch.engine import health as health_mod
from flowsentryx_tpu_torch.sync import tuning

_LIVE = (wire.CSTATE_SPAWNING, wire.CSTATE_SERVING, wire.CSTATE_DRAINING)


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
    ):
        if len(specs) < 2:
            raise ValueError(
                f"a cluster needs >= 2 engines, got {len(specs)} "
                "(one engine is fsx serve)")
        self.cluster_dir = Path(cluster_dir)
        self.n = len(specs)
        self.specs = specs
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

    # -- lifecycle ----------------------------------------------------------

    def boot(self) -> None:
        """Create the shm plane, stamp the epoch, spawn every rank."""
        if self._booted:
            raise RuntimeError("ClusterSupervisor already booted")
        self._booted = True
        self.cluster_dir.mkdir(parents=True, exist_ok=True)
        self._refuse_live_plane()
        gplane.create_plane(self.cluster_dir, self.n, k_max=self.k_max,
                            slots=self.mailbox_slots)
        if self.t0_ns is None:
            # the shared epoch: every engine's clock and every gossiped
            # `until` is relative to it, so untils compare across engines
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
        for r in range(self.n):
            self._spawn(r)

    def _refuse_live_plane(self) -> None:
        """Booting over a LIVE plane refuses: ``create_plane`` truncates
        every mailbox and status file under the serving engines' mmaps
        (SIGBUS on their next publish) and would attach this fleet as a
        second consumer of their ring shards.  A dead fleet's plane is
        fine to stomp.  A heartbeat from the future (the monotonic clock
        restarted at a reboot) is stale."""
        now_ns = time.clock_gettime_ns(time.CLOCK_MONOTONIC)
        live = []
        for r in range(self.n):
            p = Path(status_path(self.cluster_dir, r))
            if not p.exists():
                continue
            try:
                st = StatusBlock(p)
                state, hb = st.ctl_get("c_state"), st.ctl_get("c_hbeat")
            except Exception:
                continue  # a partial or corrupt leftover: not a fleet
            if (state in _LIVE and hb
                    and 0 <= now_ns - hb
                    < 2 * self.heartbeat_timeout_s * 1e9):
                live.append((r, (now_ns - hb) * 1e-9))
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
                "shards. Remediation: stop the old fleet (its own "
                "supervisor's stop-drain, or kill the listed ranks and "
                "wait for their heartbeats to go stale), or point "
                "--cluster-dir at a fresh directory")

    def _spawn(self, rank: int) -> None:
        spec = dict(self.specs[rank])
        gen = self._gen[rank]
        spec["rank"] = rank
        spec["n_engines"] = self.n
        spec["cluster_dir"] = str(self.cluster_dir)
        spec["gen"] = gen
        spec["t0_ns"] = self.t0_ns
        spec["t0_wall_ns"] = self.t0_wall_ns
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

    def poll(self) -> None:
        """One supervision pass: liveness, heartbeat staleness, and the
        restart-or-park decision for each dead rank."""
        now_ns = time.clock_gettime_ns(time.CLOCK_MONOTONIC)
        now = time.monotonic()
        for r in range(self.n):
            if r in self._failed or r in self._done:
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
            if p is not None and not p.is_alive():
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
        while len(self._done) + len(self._failed) < self.n:
            self.poll()
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

    # -- reporting ----------------------------------------------------------

    def aggregate(self) -> dict:
        """Every generation's report JSON folded into one cluster view:
        per-rank reports, totals from each rank's latest generation, the
        aggregate rate (total records over the SLOWEST rank's wall: a sum
        of rates would hide a straggler), the latency histograms merged
        exactly, health worst-of, the governors' counters merged and the
        boot stories."""
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
        health = health_mod.cluster_health(
            per_rank_health, sorted(self._failed), sorted(self._stalled))
        predict_block = cli._merged_predict(ranked)
        boot_block = cli._merged_boot(ranked)
        if boot_block is not None:
            boot_block = {"per_rank": boot_block.pop("per_report"),
                          **boot_block}
        return {
            "engines": self.n,
            "active_ranks": list(range(self.n)),
            "t0_ns": self.t0_ns,
            "t0_wall_ns": self.t0_wall_ns,
            "restarts": list(self.restarts),
            "failed_ranks": sorted(self._failed),
            "stalled_ranks": sorted(self._stalled),
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
