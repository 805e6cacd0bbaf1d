from flowsentryx_tpu_torch.engine.engine import (
    MEGA_AUTO_MAX, Engine, EngineReport,
)
from flowsentryx_tpu_torch.engine.sources import ArraySource, TrafficSource
from flowsentryx_tpu_torch.engine.traffic import Scenario, TrafficGen, TrafficSpec
from flowsentryx_tpu_torch.engine.writeback import CollectSink, NullSink

__all__ = [
    "ArraySource", "CollectSink", "Engine", "EngineReport", "MEGA_AUTO_MAX",
    "NullSink", "Scenario", "TrafficGen", "TrafficSource", "TrafficSpec",
]
