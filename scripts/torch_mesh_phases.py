"""The sharded step's card phases of ``chip_smoke.py`` alone: build the
kernels, then ``chip_smoke.mesh_phases`` (``sharded_step_parity``,
``serve_mesh``, ``mesh_checkpoint_reshard``, ``scaling``), printing
each phase's JSON line, then a line with the phases' seconds and their
launch windows.

    python3 scripts/torch_mesh_phases.py     # repository root, one card

Exits non-zero when a phase failed.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    import torch

    from flowsentryx_tpu_torch.ops import kernels

    if not torch.cuda.is_available():
        print("torch_mesh_phases: no CUDA device", file=sys.stderr)
        return 2
    card = cs.smi_line()
    cs.emit({"phase": "card", "nvidia_smi": card,
             "torch": torch.__version__})
    t = time.perf_counter()
    kernels.build_all()
    cs.emit({"phase": "build", "s": time.perf_counter() - t})
    served: dict = {}
    t = time.perf_counter()
    cs.mesh_phases(card, served)
    cs.emit({"phase": "total", "s": time.perf_counter() - t,
             "failed": cs.FAILED,
             "windows": {k: served.get(k) for k in (
                 "launches_sharded_step", "launches_serve_mesh")}})
    return 1 if cs.FAILED else 0


if __name__ == "__main__":
    sys.exit(main())
