"""The headline benchmark's and the data-parallel trainer's card phases
of ``chip_smoke.py`` alone: build the kernels, build the deployed
recipe's training split (``train_qat_deployed``'s 2,016,639 rows), then
``chip_smoke.headline_phases`` (``headline_bench``, ``train_qat_dp``),
printing each phase's JSON line, then a line with the phases' seconds
and their launch windows.

    python3 scripts/torch_headline_phases.py     # repository root, one card

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
    from flowsentryx_tpu_torch.train import data, fixture

    if not torch.cuda.is_available():
        print("torch_headline_phases: no CUDA device", file=sys.stderr)
        return 2
    card = cs.smi_line()
    cs.emit({"phase": "card", "nvidia_smi": card,
             "torch": torch.__version__})
    t = time.perf_counter()
    kernels.build_all()
    cs.emit({"phase": "build", "s": time.perf_counter() - t})
    X, y = fixture.cicids_fixture(fixture.N_CLEANED, seed=0)
    Xtr, _, ytr, _ = data.train_test_split(X, y)
    served: dict = {"qat_split": (Xtr, ytr)}
    t = time.perf_counter()
    cs.headline_phases(card, served)
    cs.emit({"phase": "total", "s": time.perf_counter() - t,
             "failed": cs.FAILED,
             "windows": {k: served.get(k) for k in (
                 "launches_headline", "launches_train_qat_dp",
                 "gemv_dp_shard")}})
    return 1 if cs.FAILED else 0


if __name__ == "__main__":
    sys.exit(main())
