"""The distilled kernel tier's host side: the plan compiler and loader,
the served-lane parity check and the simulated tier.

Counterpart of ``flowsentryx_tpu/distill/`` (less ``emulate.py``, the
eBPF emulator, which needs ``bpf/``): ``plan.py``
(:func:`~.plan.compile_plan`, behind ``fsx distill``;
:class:`~.plan.DistillPlan`, :func:`~.plan.load_plan`,
:func:`~.plan.save_plan`, :func:`~.plan.pack_blob`,
:func:`~.plan.unpack_blob`), ``parity.py`` (the served int8 lane's bands
against a plan's over the reference's ``--emulate`` corpus) and
``sim.py`` (:class:`~.sim.SimKernelTier`, behind ``serve
--sim-kernel-tier``).  The loader and the simulated tier are numpy only;
the compiler and the check import torch when called.
"""

from flowsentryx_tpu_torch.distill.plan import (  # noqa: F401
    DistillError, DistillPlan, compile_plan, load_plan, pack_blob,
    save_plan, unpack_blob,
)
from flowsentryx_tpu_torch.distill.sim import SimKernelTier  # noqa: F401
