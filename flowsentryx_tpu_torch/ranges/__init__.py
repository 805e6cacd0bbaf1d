"""``fsx ranges``: the integer value-range prover over the staged step
graphs.

Counterpart of ``flowsentryx_tpu/ranges/``: an abstract interpreter
over the aten graph of each step variant (the one ``fsx audit`` records)
that propagates per-value integer intervals and proves, without a live
batch, that no int64 partial product overflows and that every int32 or
narrower result comes from an explicit fold -- modulo the audited
``WRAP_OK`` registry, itself checked for staleness every run -- and
the BPF containment bridge (:mod:`.bridge`): the eBPF verifier's ranges
at the distilled scorer's accumulator contain the served int8 lane's.
"""

from flowsentryx_tpu_torch.ranges.interval import IVal  # noqa: F401
from flowsentryx_tpu_torch.ranges.prover import Analysis, analyze  # noqa: F401
from flowsentryx_tpu_torch.ranges.registry import (  # noqa: F401
    WRAP_OK, WrapOk, audit_registry,
)
from flowsentryx_tpu_torch.ranges.runner import (  # noqa: F401
    RangesReport, run_ranges, write_artifact,
)
