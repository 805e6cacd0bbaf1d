"""The serving engine, its sources and sinks.

Names resolve lazily (PEP 562): importing a numpy-only submodule such as
:mod:`.batcher` or :mod:`.shm` — what a spawned ingest worker does —
does not import the engine, and with it torch.
"""

import importlib

_EXPORTS = {
    "MEGA_AUTO_MAX": "engine", "Engine": "engine", "EngineReport": "engine",
    "ArraySource": "sources", "PacedSource": "sources",
    "RecordSource": "sources", "TrafficSource": "sources",
    "Scenario": "traffic", "TrafficGen": "traffic", "TrafficSpec": "traffic",
    "CollectSink": "writeback", "NullSink": "writeback",
    "ShmRing": "shm", "ShmRingSource": "shm", "ShmVerdictSink": "shm",
    "SealedBatchQueue": "shm",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{mod}"), name)
