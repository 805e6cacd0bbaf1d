"""The full paced scale-out comparison on the card, with the link probes
before it: what ``chip_smoke.py``'s ``link_probe`` and ``cluster_bench``
phases run cut, at full size and alone.

1. Build the kernels (``build/kernels/``).
2. ``--probes N`` runs of ``scripts/torch_link_probe.py --force-e2e`` on
   the card, one after another (the fed loop runs whatever the step and
   H2D say: these runs derive the thresholds of
   ``flowsentryx_tpu_torch/core/linkhealth.py``), one JSON line each.
3. ``scripts/torch_cluster_bench.py`` at its full size (6 trials, no
   cut) against the tree of the pre-cluster commit ``c8043dd``
   (``chip_smoke.pr9_tree``: ``build/fsx_port_pr9_tree``, made with ``git
   archive`` where the checkout has the history), writing
   ``build/CLUSTER_torch.json``; its headline line.
4. A summary line: the probes' ranges, each shape's headline, the
   failures, the card's ``nvidia-smi`` name and power limit.

    python3 scripts/torch_cluster_bench_phase.py [--probes 5]
                                    # repository root, one card

A shorter comparison is ``scripts/torch_cluster_bench.py --trials T --cut
K`` itself.

Exits 1 when a probe is wedged, the comparison reports a failure or the
baseline is not the pre-cluster tree; a missed 1.6x target is a finding,
not a failure.
"""

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--probes", type=int, default=5)
    args = ap.parse_args()
    import torch

    from flowsentryx_tpu_torch.ops import kernels

    if not torch.cuda.is_available():
        print("torch_cluster_bench_phase: no CUDA device", file=sys.stderr)
        return 2
    card = cs.smi_line()
    cs.emit({"phase": "card", "nvidia_smi": card, "torch": torch.__version__,
             "cuda": torch.version.cuda})
    t = time.perf_counter()
    kernels.build_all()
    cs.emit({"phase": "build", "s": time.perf_counter() - t})
    ok = True
    probes = []
    for i in range(args.probes):
        line, err = cs.run_link_probe("cuda", ["--force-e2e"])
        probes.append(line)
        cs.emit({"phase": "link_probe", "run": i, **line})
        if line.get("state") in (None, "wedged"):
            ok = False
            print(err[-3000:], file=sys.stderr)
    baseline, why = cs.pr9_tree()
    if why is not None:
        cs.emit({"phase": "cluster_bench", "ok": False, "error": why})
        return 1
    t = time.perf_counter()
    r = subprocess.run(
        [sys.executable, cs.CLUSTER_BENCH, "--baseline-repo", baseline],
        cwd=cs.REPO, capture_output=True, text=True, timeout=3000)
    wall = time.perf_counter() - t
    lines = [ln for ln in r.stdout.splitlines() if ln.strip()]
    try:
        head = json.loads(lines[-1]) if lines else {}
    except ValueError:
        head = {}
    cs.emit({"phase": "cluster_bench", "rc": r.returncode, "wall_s": wall,
             **head})
    if not head.get("ok"):
        ok = False
        print(r.stderr[-6000:], file=sys.stderr)

    def span(key):
        vals = [p[key] for p in probes if key in p]
        return [min(vals), max(vals)] if vals else None

    cs.emit({"summary": True, "card": card, "probes": len(probes),
             "states": [p.get("state") for p in probes],
             **{k: span(k) for k in ("dispatch_ms", "step_ms", "step_mpps",
                                     "h2d_mbps", "e2e_mpps")},
             "cluster_ok": head.get("ok"),
             "shapes": head.get("shapes"),
             "meets_target": head.get("meets_target"),
             "failures": head.get("failures")})
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
