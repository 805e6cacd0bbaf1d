"""IP-hash sharding (counterpart of ``flowsentryx_tpu/parallel/``): the
mesh (:mod:`.mesh`), the partition rules and the cluster tier
(:mod:`.layout`), and the sharded serving step (:mod:`.step`), with the
reference's exports; and the process mesh, one process per shard: its
collectives (:mod:`.exchange`), its leader and followers
(:mod:`.follower`) and the launcher (:mod:`.launch`).

Names resolve lazily (PEP 562): :mod:`.layout` imports no torch, and the
cluster supervisor imports it without importing the step.
"""

import importlib

_EXPORTS = {
    "init_distributed": "mesh",
    "make_mesh": "mesh",
    "make_process_compact_step": "step",
    "make_process_raw_step": "step",
    "make_process_step": "step",
    "make_process_table": "step",
    "make_sharded_compact_megastep": "step",
    "make_sharded_compact_megastep_family": "step",
    "make_sharded_compact_step": "step",
    "make_sharded_raw_step": "step",
    "make_sharded_step": "step",
    "make_sharded_table": "step",
    "shard_table": "step",
}

_MODULES = ("exchange", "follower", "launch", "layout", "mesh", "step")

__all__ = sorted(_EXPORTS) + list(_MODULES)


def __getattr__(name: str):
    if name in _MODULES:
        return importlib.import_module(f"{__name__}.{name}")
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{mod}"), name)
