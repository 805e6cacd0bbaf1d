"""The device mesh of the IP-hash-sharded step.

Counterpart of ``flowsentryx_tpu/parallel/mesh.py``.  The reference's
mesh is a ``jax.sharding.Mesh`` over n devices, driven from one
controller by ``shard_map``; its tests lay it over 8 virtual CPU
devices.  Here a mesh is a plain value naming n devices, and the step
(:mod:`.step`) runs its n shards from one process as row ranges of one
table, so every device of a mesh must be the same device:
``make_mesh(n, devices=[dev] * n)`` lays n shards on ``dev`` (the
counterpart of the virtual devices; the tests and ``chip_smoke.py``
build their meshes so).  A mesh over several cards, and the multi-
process runtime of :func:`init_distributed`, are not ported.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: ``devices`` (all one device) along ``axis_names[0]``."""

    devices: tuple[torch.device, ...]
    axis_names: tuple[str, ...] = ("ip",)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def device(self) -> torch.device:
        """The one device every shard lives on."""
        return self.devices[0]


def make_mesh(n_devices: int | None = None, axis_name: str = "ip",
              devices=None) -> Mesh:
    """1-D mesh over the first ``n_devices`` of ``devices`` (default:
    the visible CUDA devices), refused as the reference refuses it: more
    devices than there are, or a count that is not a power of two (slot
    ownership is read from hash bits).  A mesh spanning more than one
    device is refused by name."""
    if devices is None:
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    else:
        devs = [torch.device(d) for d in devices]
    n = n_devices if n_devices is not None else len(devs)
    if n > len(devs):
        raise ValueError(f"requested {n} devices, have {len(devs)}")
    if n & (n - 1):
        raise ValueError(f"device count must be a power of two, got {n}")
    devs = tuple(devs[:n])
    if len(set(devs)) > 1:
        raise ValueError(
            f"a mesh over {len(set(devs))} distinct devices is not ported: "
            "the sharded step runs its shards on one device (pass "
            "devices=[dev] * n)")
    return Mesh(devs, (axis_name,))


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> None:
    """A no-op for one process, as in the reference; a multi-process
    runtime is refused by name."""
    del process_id
    if num_processes is not None and num_processes > 1 or coordinator_address:
        raise ValueError(
            "init_distributed: a multi-process mesh is not ported (one "
            "process drives every shard of a mesh on one device)")
