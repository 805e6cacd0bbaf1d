"""The distilled kernel tier's host side: the plan compiler and loader,
the scorer bytecode's emulator, the three-way parity check and the
simulated tier.

Counterpart of ``flowsentryx_tpu/distill/``: ``plan.py``
(:func:`~.plan.compile_plan`, behind ``fsx distill``;
:class:`~.plan.DistillPlan`, :func:`~.plan.load_plan`,
:func:`~.plan.save_plan`, :func:`~.plan.pack_blob`,
:func:`~.plan.unpack_blob`), ``emulate.py``
(:func:`~.emulate.emulate_scorer`, the emitted eBPF scorer run lane-SIMD
over numpy), ``parity.py`` (the bytecode, the plan's twin and the served
int8 lane over the reference's ``--emulate`` corpus) and ``sim.py``
(:class:`~.sim.SimKernelTier`, behind ``serve --sim-kernel-tier``). The
loader, the emulator and the simulated tier are numpy only; the compiler
and the served lane import torch when called.
"""

from flowsentryx_tpu_torch.distill.plan import (  # noqa: F401
    DistillError, DistillPlan, compile_plan, load_plan, pack_blob,
    save_plan, unpack_blob,
)
from flowsentryx_tpu_torch.distill.sim import SimKernelTier  # noqa: F401
