"""The process-mesh card phase of ``chip_smoke.py`` alone: build the
kernels, then ``chip_smoke.mesh_processes_phase`` (the NCCL world of one
rank per card driving the process step eagerly and captured, whether
NCCL takes two ranks on one card, and two gloo ranks as engines on the
one card, each against the one-process mesh), printing its JSON line,
then a line with its seconds and launch windows.

    python3 scripts/torch_mesh_processes_phase.py   # repository root, one card

Exits non-zero when the phase failed.
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
        print("torch_mesh_processes_phase: no CUDA device", file=sys.stderr)
        return 2
    card = cs.smi_line()
    cs.emit({"phase": "card", "nvidia_smi": card,
             "torch": torch.__version__, "cuda": torch.version.cuda})
    t = time.perf_counter()
    kernels.build_all()
    cs.emit({"phase": "build", "s": time.perf_counter() - t})
    served: dict = {}
    t = time.perf_counter()
    cs.mesh_processes_phase(card, served)
    cs.emit({"phase": "total", "s": time.perf_counter() - t,
             "failed": cs.FAILED,
             "windows": {k: v for k, v in served.items()
                         if k.startswith("launches_mesh_processes")}})
    return 1 if cs.FAILED else 0


if __name__ == "__main__":
    sys.exit(main())
