"""The card's link-health rule (``flowsentryx_tpu_torch/core/linkhealth.py``)
and its probe (``scripts/torch_link_probe.py``) against the reference's
``flowsentryx_tpu/core/linkhealth.py`` and ``scripts/link_probe.py``.

* ``classify`` gives the reference's label on a grid of inputs, each
  axis expressed relative to each side's own thresholds (the numbers
  differ: the port's are the card's), ``None`` cases included;
* ``criteria()`` has the reference's keys and names the port's probe;
* importing the module loads no torch;
* the probe at a small size on the CPU prints one line with the
  reference's keys (``e2e_mpps`` with ``--force-e2e``), labeled by
  ``classify``; without a card it exits 1 naming the missing device.
"""

import ast
import itertools
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from flowsentryx_tpu.core import linkhealth as jlinkhealth
from flowsentryx_tpu_torch.core import linkhealth

REPO = Path(__file__).resolve().parents[1]
PROBE = REPO / "scripts" / "torch_link_probe.py"

#: Multiples of a threshold: well under, just under, at, just over, well
#: over; and the missing measurement.
FACTORS = [0.25, 0.999, 1.0, 1.001, 4.0, None]


def _at(factor, threshold):
    return None if factor is None else factor * threshold


@pytest.mark.parametrize("fe", FACTORS)
def test_classify_equals_reference_relative_to_each_sides_thresholds(fe):
    for fs, fh in itertools.product(FACTORS, FACTORS):
        got = linkhealth.classify(
            _at(fs, linkhealth.HEALTHY_STEP_MS),
            _at(fh, linkhealth.HEALTHY_H2D_MBPS),
            _at(fe, linkhealth.HEALTHY_E2E_MPPS))
        want = jlinkhealth.classify(
            _at(fs, jlinkhealth.HEALTHY_STEP_MS),
            _at(fh, jlinkhealth.HEALTHY_H2D_MBPS),
            _at(fe, jlinkhealth.HEALTHY_E2E_MPPS))
        assert got == want, (fs, fh, fe)


def test_classify_rule():
    """The e2e number decides when present; a missing step or H2D number
    reads degraded."""
    s, h, e = (linkhealth.HEALTHY_STEP_MS, linkhealth.HEALTHY_H2D_MBPS,
               linkhealth.HEALTHY_E2E_MPPS)
    assert linkhealth.classify(10 * s, 0.0, e) == "healthy"
    assert linkhealth.classify(s, h, 0.99 * e) == "degraded"
    assert linkhealth.classify(None, h, None) == "degraded"
    assert linkhealth.classify(s, None, None) == "degraded"
    assert linkhealth.classify(s, h, None) == "healthy"


def test_criteria_keys_equal_reference_and_name_the_port_probe():
    got, want = linkhealth.criteria(), jlinkhealth.criteria()
    assert set(got) == set(want)
    assert got["probe"].startswith("scripts/torch_link_probe.py")
    assert (got["probe_e2e_mpps_min"], got["probe_step_ms_max"],
            got["h2d_mbps_min"]) == (linkhealth.HEALTHY_E2E_MPPS,
                                     linkhealth.HEALTHY_STEP_MS,
                                     linkhealth.HEALTHY_H2D_MBPS)


def test_thresholds_are_the_cards_not_the_references():
    assert (linkhealth.HEALTHY_STEP_MS, linkhealth.HEALTHY_H2D_MBPS,
            linkhealth.HEALTHY_E2E_MPPS) != (
        jlinkhealth.HEALTHY_STEP_MS, jlinkhealth.HEALTHY_H2D_MBPS,
        jlinkhealth.HEALTHY_E2E_MPPS)
    doc = linkhealth.__doc__
    assert "H100" in doc and "W" in doc and "torch_link_probe.py" in doc


def test_import_loads_no_torch():
    code = ("import sys\n"
            "from flowsentryx_tpu_torch.core import linkhealth\n"
            "bad = [m for m in sys.modules if m.split('.')[0] == 'torch']\n"
            "assert not bad, bad[:5]\n"
            "print('clean')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and "clean" in r.stdout, r.stderr


def _reference_probe_keys() -> set:
    """Every ``out["..."]`` the reference's probe assigns."""
    tree = ast.parse((REPO / "scripts" / "link_probe.py").read_text())
    return {node.targets[0].slice.value for node in ast.walk(tree)
            if isinstance(node, ast.Assign)
            and isinstance(node.targets[0], ast.Subscript)
            and isinstance(node.targets[0].value, ast.Name)
            and node.targets[0].value.id == "out"}


@pytest.mark.parametrize("force_e2e", [False, True])
def test_probe_on_the_cpu_prints_the_reference_keys(force_e2e):
    r = subprocess.run(
        [sys.executable, str(PROBE), "--device", "cpu", "--batch", "512",
         "--capacity", "4096"] + (["--force-e2e"] if force_e2e else []),
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    [line] = r.stdout.splitlines()
    rec = json.loads(line)
    ref = _reference_probe_keys()
    assert {"step_ms", "h2d_mbps", "e2e_mpps", "state", "error"} <= ref
    want = ref - {"error"} - ({"e2e_mpps"} if not force_e2e else set())
    assert want <= set(rec), want - set(rec)
    assert "error" not in rec
    assert rec["backend"] == "cpu" and rec["device_kind"] == "cpu"
    assert rec["power_limit_w"] is None
    assert rec["state"] == linkhealth.classify(
        rec["step_ms"], rec["h2d_mbps"], rec.get("e2e_mpps"))
    # the first call, 10 timed replays (and 50 more when one took under
    # 2 ms), the fed loop's 20
    fed = 20 if force_e2e else 0
    assert rec["step_bodies"] in (11 + fed, 61 + fed)


def test_probe_without_a_card_exits_one_naming_the_device():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the probe runs on it")
    r = subprocess.run([sys.executable, str(PROBE)], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 1 and r.stdout == ""
    assert "no CUDA device" in r.stderr
