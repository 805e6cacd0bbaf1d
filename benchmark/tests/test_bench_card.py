"""On the card: each cell through ``benchmark/run.py`` as the check runs
it, a short window, correct and with its metrics."""

import json
import subprocess
import sys

import pytest

from benchmark.tests.conftest import ROOT

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("trace", [0, 1])
def test_cell_on_card(cuda, trace):
    cell = "mixed_l34_1m.sharded"
    p = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
         str(2**31 + 7), "--seconds", "3", "--trace", str(trace)],
        cwd=str(ROOT), capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu" and out["metrics"]
    name = "served.records_per_s" if trace else "card_records_per_s"
    assert out["metrics"][name]["value"] > 0
    if not trace:
        # the whole window under the device trace
        assert out["served"]["device_ops"] > 0
        assert 0 < out["served"]["device_busy_s"] < out["window_s"]

