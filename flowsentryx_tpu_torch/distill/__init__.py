"""The distilled kernel tier's host side: the plan loader and the
simulated tier.

Counterpart of ``flowsentryx_tpu/distill/`` — the loader half of
``plan.py`` (:class:`~.plan.DistillPlan`, :func:`~.plan.load_plan`,
:func:`~.plan.save_plan`, :func:`~.plan.pack_blob`,
:func:`~.plan.unpack_blob`) and ``sim.py``
(:class:`~.sim.SimKernelTier`, behind ``serve --sim-kernel-tier``).
numpy only.  The plan compiler, which bisects the serving chain, is not
ported yet: a plan comes from the reference's ``fsx distill``
(``artifacts/logreg_int8_plan.npz`` is one).
"""

from flowsentryx_tpu_torch.distill.plan import (  # noqa: F401
    DistillError, DistillPlan, load_plan, pack_blob, save_plan, unpack_blob,
)
from flowsentryx_tpu_torch.distill.sim import SimKernelTier  # noqa: F401
