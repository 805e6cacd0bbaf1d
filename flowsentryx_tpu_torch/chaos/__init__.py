"""``fsx chaos`` — deterministic fault-injection campaigns over the
port's real stack.

Counterpart of ``flowsentryx_tpu/chaos/``:

* :mod:`~flowsentryx_tpu_torch.chaos.faults` — the fault-injector
  registry (all of the reference's entries) and the injectors of the
  single-host faults: process kills and crash loops, checkpoint byte
  corruption and truncation, shm sealed-slot header corruption (bad
  magic, seq gaps, poisoned metadata), monotonic-clock jumps, a wedged
  sink (the watchdog's prey).
* :mod:`~flowsentryx_tpu_torch.chaos.invariants` — the named invariant
  catalog each fault is judged against.
* :mod:`~flowsentryx_tpu_torch.chaos.campaign` — the seed-driven
  campaign runner over the port's engine (on the card unless
  ``device="cpu"``), ``ShardedIngest`` fleet, ``ClusterSupervisor`` and
  ``GossipPlane`` pairs, plus the planted regressions that prove the
  invariants have teeth.

One ``--seed`` fixes the traffic, the corruption offsets and the kill
schedule, and they equal the reference campaign's at the same seed.

Import cost: this ``__init__`` imports numpy only; the scenario
functions import the engine (and torch) when they run, so ``fsx chaos
--list`` never pays a torch import.
"""

from flowsentryx_tpu_torch.chaos.campaign import run_campaign  # noqa: F401
from flowsentryx_tpu_torch.chaos.invariants import InvariantResult  # noqa: F401
