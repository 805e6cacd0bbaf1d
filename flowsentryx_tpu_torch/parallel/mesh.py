"""The device mesh of the IP-hash-sharded step, and the multi-process
runtime behind a mesh over several cards.

Counterpart of ``flowsentryx_tpu/parallel/mesh.py``.  The reference's
mesh is a ``jax.sharding.Mesh`` over n devices, driven from one
controller by ``shard_map``; its tests lay it over 8 virtual CPU
devices.  Here a mesh is a plain value naming n devices, in one of two
forms:

* **One process** (``make_mesh(n, devices=[dev] * n)``): the step
  (:mod:`.step`) runs its n shards from this process as row ranges of
  one table on ``dev``, and the collectives are tensor ops.  Every
  device of such a mesh is the same device (the counterpart of the
  virtual devices; the tests and ``chip_smoke.py`` build their meshes
  so), and one process over several distinct devices is refused.
* **One process per shard** (:func:`init_distributed`, then
  ``make_mesh()``): each rank holds its own shard on its own device and
  the five exchanges are ``torch.distributed`` collectives
  (:mod:`.exchange`); on the card the backend is NCCL, one card per
  process, and on the CPU it is gloo (the counterpart of the reference's
  ``--mesh N`` over N virtual CPU devices).  :mod:`.launch` spawns the
  followers, and :mod:`.follower` is their side of the engine.
"""

from __future__ import annotations

import dataclasses
import datetime

import torch
import torch.distributed as dist

from flowsentryx_tpu_torch.sync import tuning


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: ``devices`` along ``axis_names[0]``.  A process mesh
    also names its process ``group`` (None: one process), this
    process's ``rank`` in it and the group's ``backend``."""

    devices: tuple[torch.device, ...]
    axis_names: tuple[str, ...] = ("ip",)
    group: object = None
    rank: int = 0
    backend: str | None = None

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def device(self) -> torch.device:
        """This process's device: the one device every shard of a
        one-process mesh lives on, or this rank's on a process mesh."""
        return self.devices[self.rank]

    @property
    def is_process(self) -> bool:
        """One process per shard (the collectives cross processes)."""
        return self.group is not None


#: This process's place in the multi-process runtime, set by
#: :func:`init_distributed`: backend, device, rank, size and every
#: rank's device.  Empty while no group is up.
_WORLD: dict = {}


def _refuse_count(n: int, have: int) -> None:
    """The reference's two refusals, in its words."""
    if n > have:
        raise ValueError(f"requested {n} devices, have {have}")
    if n & (n - 1):
        raise ValueError(f"device count must be a power of two, got {n}")


def make_mesh(n_devices: int | None = None, axis_name: str = "ip",
              devices=None) -> Mesh:
    """1-D mesh over the first ``n_devices`` of ``devices``, refused as
    the reference refuses it: more devices than there are, or a count
    that is not a power of two (slot ownership is read from hash bits).

    With ``devices`` given, a one-process mesh over them (all one
    device).  Without, under :func:`init_distributed`'s group, the
    process mesh of every rank (one device per rank); else the visible
    cards, where one process over several distinct cards is refused by
    name: the multi-card mesh is one process per card."""
    if devices is None and _WORLD:
        n = n_devices if n_devices is not None else _WORLD["size"]
        _refuse_count(n, _WORLD["size"])
        if n != _WORLD["size"]:
            raise ValueError(
                f"a process mesh spans every rank of its group: requested "
                f"{n} of {_WORLD['size']}")
        return Mesh(tuple(torch.device(d) for d in _WORLD["devices"]),
                    (axis_name,), group=_WORLD["group"],
                    rank=_WORLD["rank"], backend=_WORLD["backend"])
    if devices is None:
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    else:
        devs = [torch.device(d) for d in devices]
    n = n_devices if n_devices is not None else len(devs)
    _refuse_count(n, len(devs))
    devs = tuple(devs[:n])
    if len(set(devs)) > 1:
        raise ValueError(
            f"a mesh over {len(set(devs))} distinct devices is not ported "
            "in one process: one process drives the shards of one device "
            "(pass devices=[dev] * n), and a mesh over several cards is "
            "one process per card (init_distributed, serve --mesh N)")
    return Mesh(devs, (axis_name,))


def _store(address: str, n: int, rank: int, timeout: datetime.timedelta):
    """The rendezvous store at ``address``: ``file://PATH`` (a
    ``FileStore``, no port to collide on) or ``[tcp://]HOST:PORT`` (a
    ``TCPStore`` served by rank 0)."""
    if address.startswith("file://"):
        return dist.FileStore(address[len("file://"):], n)
    host, _, port = address.removeprefix("tcp://").rpartition(":")
    return dist.TCPStore(host or "localhost", int(port), n, rank == 0,
                         timeout)


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None, *,
                     backend: str | None = None, device=None,
                     timeout_s: float | None = None) -> None:
    """Bring up the multi-process runtime, as the reference's signature
    asks: a no-op for one process with no coordinator, else a
    ``torch.distributed`` group of ``num_processes`` ranks over the store
    at ``coordinator_address`` (``file://PATH`` or ``HOST:PORT``), this
    process being rank ``process_id``.  After it, :func:`make_mesh`
    builds the process mesh.

    ``device``: this rank's device (None: card ``process_id``, one card
    per process; there is no fallback to the CPU).  ``backend`` follows
    the device, NCCL for a card and gloo for the CPU; ``backend="gloo"``
    on a card is allowed (gloo copies card tensors through host memory
    itself), NCCL on the CPU is refused.  ``timeout_s`` (default
    ``tuning.MESH_TIMEOUT_S``) bounds every collective: a dead peer
    raises, never hangs."""
    if not (num_processes is not None and num_processes > 1
            or coordinator_address):
        return
    if _WORLD:
        raise RuntimeError("init_distributed: a process group is already "
                           "up in this process")
    n = 1 if num_processes is None else int(num_processes)
    rank = 0 if process_id is None else int(process_id)
    if not 0 <= rank < n:
        raise ValueError(f"process_id {rank} not in [0, {n})")
    if not coordinator_address:
        raise ValueError("init_distributed: a multi-process group needs a "
                         "coordinator_address (file://PATH or HOST:PORT)")
    if device is None:
        _refuse_count(rank + 1, torch.cuda.device_count())
        device = torch.device("cuda", rank)
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown backend {backend!r} (nccl or gloo)")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"the nccl backend needs a card, got {dev}")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    timeout = datetime.timedelta(
        seconds=tuning.MESH_TIMEOUT_S if timeout_s is None else timeout_s)
    dist.init_process_group(
        backend, store=_store(coordinator_address, n, rank, timeout),
        rank=rank, world_size=n, timeout=timeout)
    devices: list = [None] * n
    try:
        # the group's first collective: a backend that refuses the
        # placement (NCCL: two ranks on one card) raises here
        dist.all_gather_object(devices, str(dev))
    except BaseException:
        dist.destroy_process_group()
        raise
    _WORLD.update(backend=backend, device=str(dev), rank=rank, size=n,
                  devices=tuple(devices), group=dist.group.WORLD)


def shutdown_distributed() -> None:
    """Tear down :func:`init_distributed`'s group (a no-op without
    one)."""
    if not _WORLD:
        return
    _WORLD.clear()
    if dist.is_initialized():
        dist.destroy_process_group()
