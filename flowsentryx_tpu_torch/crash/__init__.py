"""``fsx crash`` — crash-consistency model checking over the port's
durable protocols (see ``checker.py``).

Counterpart of ``flowsentryx_tpu/crash/``.  Host Python: the checker
runs this package's real rebalance, supervisor and checkpoint code over
the simulated filesystem and mailbox of ``simfs.py``/``world.py``.
"""

from .checker import (CrashSchedule, INVARIANTS, Violation,  # noqa: F401
                      explore_scenario, run_crash)
from .simfs import CrashNow, SimFS, Tracer, eligible_points  # noqa: F401
from .world import World  # noqa: F401
