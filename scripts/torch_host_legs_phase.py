"""The host plane's model checkers' card phase of ``chip_smoke.py``
alone: build the kernels, then ``chip_smoke.host_legs_phase`` (``fsx
sync``, ``fsx crash`` and ``fsx live`` in full mode as subprocesses, where
``chip_smoke.py`` runs ``fsx live --quick``; then
the arena check: ``mixed_l34_1m`` through the drain ring with the arena
one slot below the bound and the copy stream held, the port's claim
against a claim without its event wait), printing its JSON line, then a
line with its seconds and the arms' launch windows.

    python3 scripts/torch_host_legs_phase.py     # repository root, one card

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
        print("torch_host_legs_phase: no CUDA device", file=sys.stderr)
        return 2
    card = cs.smi_line()
    cs.emit({"phase": "card", "nvidia_smi": card,
             "torch": torch.__version__})
    t = time.perf_counter()
    kernels.build_all()
    cs.emit({"phase": "build", "s": time.perf_counter() - t})
    served: dict = {}
    t = time.perf_counter()
    cs.host_legs_phase(card, served, live_quick=False)
    cs.emit({"phase": "total", "s": time.perf_counter() - t,
             "failed": cs.FAILED,
             "windows": {k: served.get(f"launches_host_legs_{k}")
                         for k in ("guarded", "planted")}})
    return 1 if cs.FAILED else 0


if __name__ == "__main__":
    sys.exit(main())
