"""The training phases of ``chip_smoke.py`` at their full recipes, alone:
``chip_smoke.stress_phases(full=True)`` on the card, ``stress``'s robust
MLP (the v2 fixture's 300,000 rows plus two shift-augmented copies, 80
epochs) and expert heads (60 epochs) held to ``MODEL_METRICS_r05.json``
(clean F1 within 0.01; binary F1 and per-class recall within 0.02), each
with its ms per step and total seconds, the card running nothing else.
``chip_smoke.py`` runs the cut recipes, held to the CPU.

    python3 scripts/torch_train_stress_phase.py     # repository root, one card

Exits non-zero when a phase failed.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_train_stress_phase: no CUDA device", file=sys.stderr)
        return 2
    card = cs.smi_line()
    cs.emit({"phase": "card", "nvidia_smi": card,
             "torch": torch.__version__})
    t = time.perf_counter()
    cs.stress_phases(card, full=True)
    cs.emit({"phase": "total", "s": time.perf_counter() - t,
             "failed": cs.FAILED})
    return 1 if cs.FAILED else 0


if __name__ == "__main__":
    sys.exit(main())
