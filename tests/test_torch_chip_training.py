"""``chip_smoke.stress_phases`` at its cut recipes, dry-run on the CPU:
the robust MLP and the expert heads each trained twice (the run under
test and the CPU twin it is held to), both phases ok, each line with its
recipe, ms per step and agreement."""

import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402


def test_stress_phases_cut_recipes_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr(cs, "FAILED", [])
    cs.stress_phases("cpu", full=False, device="cpu")
    lines = {d["phase"]: d for d in map(json.loads,
                                        capsys.readouterr().out.splitlines())}
    assert cs.FAILED == []
    rows, mlp_epochs, mc_epochs = cs.STRESS_CUT
    mlp, mc = lines["train_mlp_robust"], lines["train_multiclass"]
    assert mlp["ok"] and mc["ok"]
    assert mlp["recipe"] == {"rows": rows, "augmented_rows": 3 * rows,
                             "epochs": mlp_epochs}
    assert mc["recipe"] == {"rows": rows, "epochs": mc_epochs}
    # the same recipe on the same device: the same model, bit for bit
    assert mlp["verdicts_equal_cpu"] == 1.0 and mlp["f1_diff_cpu"] == 0.0
    assert mc["classes_equal_cpu"] == 1.0 and mc["binary_f1_diff_cpu"] == 0.0
    assert mlp["steps"] == mlp_epochs * -(-3 * rows // 4096)
    assert mc["steps"] == mc_epochs * -(-rows // 4096)
    assert mlp["ms_per_step"] > 0 and mc["ms_per_step"] > 0
