"""The comparison fails what it must: the reference at a lower weight
precision (the control), and the program with its timed path broken
underneath (a step that keeps its state, half of each batch left out, an
answer altered where it is produced)."""

import pytest
import torch

from benchmark import harness
from benchmark.tests.tiny import CELLS, CELL_OVERRIDES


@pytest.mark.parametrize("cell", CELLS)
def test_int4_control_fails(cell, bench_root):
    out = harness.run_cell(bench_root, cell, 3, 1.5, False, device="cpu",
                           overrides=CELL_OVERRIDES[cell], control_bits=4)
    assert out["correct"]
    assert any(c["value"] > c["limit"]
               for c in out["control_checks"].values()), out["control_checks"]


def _keeps_state(base):
    def step(table, stats, params, raw):
        t = type(table)(*(x.clone() for x in table))
        s = type(stats)(*(x.clone() for x in stats))
        return (table, stats, base(t, s, params, raw)[2])
    return step


def _half_batch(base):
    def step(table, stats, params, raw):
        raw = raw.clone()
        raw[-1, 0] = torch.div(raw[-1, 0], 2, rounding_mode="floor")
        return base(table, stats, params, raw)
    return step


def _altered_answer(base):
    def step(table, stats, params, raw):
        table, stats, out = base(table, stats, params, raw)
        wire = out.wire.clone()
        wire[0] ^= 1
        return table, stats, out._replace(wire=wire)
    return step


FAULTS = {"keeps_state": _keeps_state, "half_batch": _half_batch,
          "altered_answer": _altered_answer}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_broken_step_is_not_correct(cell, fault, monkeypatch, bench_root):
    from flowsentryx_tpu_torch.ops import fused

    make = fused.make_compact_step
    monkeypatch.setattr(
        fused, "make_compact_step",
        lambda *a, **k: FAULTS[fault](make(*a, **k)))
    out = harness.run_cell(bench_root, cell, 5, 1.5, False, device="cpu",
                           overrides=CELL_OVERRIDES[cell])
    assert not out["correct"], out["checks"]
