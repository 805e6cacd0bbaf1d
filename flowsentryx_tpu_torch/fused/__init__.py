"""Device-resident serving graphs beyond one group per dispatch.

Counterpart of ``flowsentryx_tpu/fused/``: :mod:`.device_loop`, the
drain ring that consumes a whole staging ring of arena slices per
dispatch.  ``ops/fused.py`` owns the step and the megastep.
"""

from flowsentryx_tpu_torch.fused.device_loop import (  # noqa: F401
    RingOutput,
    choose_ring_depth,
    make_compact_device_loop,
    ring_round_batches,
    wrap_device_loop,
)
