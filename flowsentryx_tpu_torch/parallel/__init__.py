"""IP-hash sharding (counterpart of ``flowsentryx_tpu/parallel/``): the
mesh (:mod:`.mesh`), the partition rules and the cluster tier
(:mod:`.layout`), and the sharded serving step (:mod:`.step`), with the
reference's exports.

Names resolve lazily (PEP 562): :mod:`.layout` imports no torch, and the
cluster supervisor imports it without importing the step.
"""

import importlib

_EXPORTS = {
    "make_mesh": "mesh",
    "make_sharded_compact_megastep": "step",
    "make_sharded_compact_megastep_family": "step",
    "make_sharded_compact_step": "step",
    "make_sharded_raw_step": "step",
    "make_sharded_step": "step",
    "make_sharded_table": "step",
    "shard_table": "step",
}

__all__ = sorted(_EXPORTS) + ["layout", "mesh", "step"]


def __getattr__(name: str):
    if name in ("layout", "mesh", "step"):
        return importlib.import_module(f"{__name__}.{name}")
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{mod}"), name)
