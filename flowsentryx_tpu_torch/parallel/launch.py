"""Spawn a process mesh: this process is rank 0 (the leader), and N-1
follower processes (:mod:`.follower`) each hold one shard.

``MeshProcesses(n, device)`` starts the followers as ``python -m
flowsentryx_tpu_torch.parallel.follower SPEC`` (they import only this
package), brings up the group through a ``FileStore`` in a fresh
temporary directory (no port to collide on), and holds the process mesh
(``.mesh``).  On the card each rank gets a card of its own (``cuda:r``)
under NCCL; on the CPU the ranks are gloo processes, one per core at
most.  More ranks than there are devices is refused in the reference's
words (``requested N devices, have M``).  ``devices=`` places the ranks
by hand (the card's 2-rank leg puts both on one card, under gloo).

A leader that exits takes its followers with it: each follower is
killed when its parent process dies (``PR_SET_PDEATHSIG``), and every
collective is bounded by the group's timeout.  :meth:`MeshProcesses.close`
(after the engine sent its ``STOP``) waits for the followers, kills any
that still run, and tears the group down.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

from flowsentryx_tpu_torch.core.device import resolve_device
from flowsentryx_tpu_torch.parallel import mesh as pmesh
from flowsentryx_tpu_torch.sync import tuning

#: The package's parent directory: the followers import the port from it.
_ROOT = str(Path(__file__).resolve().parents[2])


def host_devices(device) -> int:
    """How many ranks a process mesh of ``device``'s kind may have: the
    visible cards, or on the CPU the cores this process may run on."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return torch.cuda.device_count()
    return len(os.sched_getaffinity(0))


class MeshProcesses:
    """A process mesh of ``n`` ranks (module docstring)."""

    def __init__(self, n: int, device=None, backend: str | None = None,
                 devices: list | None = None,
                 timeout_s: float | None = None,
                 threads: int | None = None):
        dev = resolve_device(device)
        if devices is None:
            have = host_devices(dev)
            if n > have:
                raise ValueError(f"requested {n} devices, have {have}")
            devices = ([f"cuda:{r}" for r in range(n)] if dev.type == "cuda"
                       else ["cpu"] * n)
        elif len(devices) != n:
            raise ValueError(f"{len(devices)} devices for {n} ranks")
        if n & (n - 1):
            raise ValueError(f"device count must be a power of two, got {n}")
        self.timeout_s = (tuning.MESH_TIMEOUT_S if timeout_s is None
                          else float(timeout_s))
        self._dir = tempfile.mkdtemp(prefix="fsx-mesh-")
        address = f"file://{self._dir}/store"
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [_ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
        self.procs: list[subprocess.Popen] = []
        try:
            for r in range(1, n):
                spec = {"address": address, "world": n, "rank": r,
                        "device": str(devices[r]), "backend": backend,
                        "timeout_s": self.timeout_s,
                        "threads": threads or torch.get_num_threads()}
                # a follower prints nothing the leader's stdout carries
                self.procs.append(subprocess.Popen(
                    [sys.executable, "-m",
                     "flowsentryx_tpu_torch.parallel.follower",
                     json.dumps(spec)], env=env, stdout=2))
            pmesh.init_distributed(address, n, 0, backend=backend,
                                   device=devices[0],
                                   timeout_s=self.timeout_s)
        except BaseException:
            self._kill()
            raise
        self.mesh = pmesh.make_mesh()

    def _kill(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        shutil.rmtree(self._dir, ignore_errors=True)

    def close(self, wait_s: float = 10.0) -> list[int]:
        """Wait for the followers (``wait_s`` each: a follower that got
        its ``STOP`` exits at once), kill any left, tear the group down;
        the followers' exit codes."""
        try:
            for p in self.procs:
                try:
                    p.wait(wait_s)
                except subprocess.TimeoutExpired:
                    p.kill()
        finally:
            self._kill()
            pmesh.shutdown_distributed()
        return [p.returncode for p in self.procs]

    def __enter__(self) -> "MeshProcesses":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
