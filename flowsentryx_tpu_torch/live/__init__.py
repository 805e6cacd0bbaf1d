"""``fsx live`` — the liveness & progress leg of the port's static suite.

Counterpart of ``flowsentryx_tpu/live/``.  The registry scan is pure
``ast`` (no torch); the checker drives this package's real protocol
objects through :func:`flowsentryx_tpu_torch.sync.interleave
.explore_live`.
"""

from flowsentryx_tpu_torch.live.registry import (  # noqa: F401
    PROGRESS, ProgressEntry, registered_sites, scan_blocking_sites,
    validate,
)
