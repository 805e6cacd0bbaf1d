"""The static legs' card phase of ``chip_smoke.py`` alone: build the
kernels, then ``chip_smoke.static_audit_phase`` (``fsx audit`` and ``fsx
ranges`` at ``--mega auto --device-loop 2 --mesh 4``, an audited engine
against a plain one, the cached re-audit, ``serve --audit``, the planted
violation), printing its JSON line, then a line with its seconds and
launch window.

    python3 scripts/torch_static_audit_phase.py     # repository root, one card

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
        print("torch_static_audit_phase: no CUDA device", file=sys.stderr)
        return 2
    card = cs.smi_line()
    cs.emit({"phase": "card", "nvidia_smi": card,
             "torch": torch.__version__})
    t = time.perf_counter()
    kernels.build_all()
    cs.emit({"phase": "build", "s": time.perf_counter() - t})
    served: dict = {}
    t = time.perf_counter()
    cs.static_audit_phase(card, served)
    cs.emit({"phase": "total", "s": time.perf_counter() - t,
             "failed": cs.FAILED,
             "window": served.get("launches_static_audit")})
    return 1 if cs.FAILED else 0


if __name__ == "__main__":
    sys.exit(main())
