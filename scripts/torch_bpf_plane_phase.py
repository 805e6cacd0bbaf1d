"""The eBPF plane's card phase of ``chip_smoke.py`` alone: build the
kernels, train a small log1p QAT artifact on the card (the full phase
uses ``train_qat_deployed``'s), then ``chip_smoke.bpf_plane_phase``
(``fsx distill --check --emulate`` on the card for both artifacts at
10,000 and 65,536 vectors, ``fsx ranges --artifact``, the XDP legs where
``bpf(2)`` is permitted, the host leg in a child process), printing its
JSON line, then a line with its seconds and launch windows.

    python3 scripts/torch_bpf_plane_phase.py     # repository root, one card

Exits non-zero when the phase failed.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    import torch

    from flowsentryx_tpu_torch.models import logreg
    from flowsentryx_tpu_torch.ops import kernels
    from flowsentryx_tpu_torch.train import fixture, qat

    if not torch.cuda.is_available():
        print("torch_bpf_plane_phase: no CUDA device", file=sys.stderr)
        return 2
    card = cs.smi_line()
    cs.emit({"phase": "card", "nvidia_smi": card,
             "torch": torch.__version__})
    t = time.perf_counter()
    kernels.build_all()
    cs.emit({"phase": "build", "s": time.perf_counter() - t})
    t = time.perf_counter()
    X, y = fixture.cicids_fixture(n=200_000, seed=4)
    res = qat.train_logreg_qat(X, y, epochs=60, device="cuda")
    chip_dir = os.path.join(cs.REPO, "build", "chip")
    os.makedirs(chip_dir, exist_ok=True)
    trained = logreg.save_params(res.params, os.path.join(
        chip_dir, "bpf_phase_trained.npz"))
    cs.emit({"phase": "train_small", "s": time.perf_counter() - t,
             "rows": len(y), "epochs": 60})
    served: dict = {}
    t = time.perf_counter()
    cs.bpf_plane_phase(card, served, trained)
    cs.emit({"phase": "total", "s": time.perf_counter() - t,
             "failed": cs.FAILED,
             "windows": served.get("launches_bpf_plane"),
             "shapes": served.get("bpf_plane_shapes")})
    return 1 if cs.FAILED else 0


if __name__ == "__main__":
    sys.exit(main())
