"""The port's lane-SIMD emulator of the emitted eBPF scorer, and the
three-way parity behind ``fsx distill --emulate`` (the bytecode, the
plan's integer twin and the served int8 lane, here its plain version on
the CPU), against the reference's emulator and ``_distill_emulate``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from flowsentryx_tpu import cli as rcli
from flowsentryx_tpu.distill import emulate as remulate
from flowsentryx_tpu.distill import plan as rplan
from flowsentryx_tpu.models import logreg as rlogreg
from flowsentryx_tpu_torch.bpf import isa
from flowsentryx_tpu_torch.core import wire
from flowsentryx_tpu_torch.distill import emulate, parity, plan
from flowsentryx_tpu_torch.models import logreg

INT8 = "artifacts/logreg_int8.npz"
TIMING = {"emulator_wall_s", "emulator_vectors_per_s", "served_device"}


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _zp_params() -> dict:
    """A plain-domain artifact with a nonzero input zero point, so the
    distiller's zero-point fold is exercised (the shipped one has zp 0
    and log1p on)."""
    return dict(w_int8=np.array([23, -7, 61, -128, 5, 90, -33, 1], np.int8),
                bias=np.float32(-0.4), w_scale=np.float32(0.0123),
                in_scale=np.float32(3.5e5), in_zp=np.int32(37),
                out_scale=np.float32(0.071), out_zp=np.int32(128),
                log1p=np.int32(0))


def _pair(which: str):
    if which == "shipped":
        return logreg.load_params(INT8), rlogreg.load_params(INT8)
    if which == "golden":
        return logreg.golden_params(), rlogreg.golden_params()
    d = _zp_params()
    return logreg.params_from_numpy(d), rlogreg.make_params(**{
        k: v for k, v in d.items()})


@pytest.mark.parametrize("which,n", [("shipped", 10000), ("golden", 4000),
                                     ("zero_point", 4000)])
def test_emulate_check_equals_reference(which, n):
    tp, jp = _pair(which)
    p, rp = plan.compile_plan(tp), rplan.compile_plan(jp)
    blob = plan.pack_blob(p)
    assert blob == rplan.pack_blob(rp)
    got = parity.emulate_check(tp, p, blob, n=n)
    ref = rcli._distill_emulate(jp, rp, blob, n=n)
    assert got["served_device"] == "cpu"
    assert {k: v for k, v in got.items() if k not in TIMING} == \
        {k: v for k, v in ref.items() if k not in TIMING}
    assert got["ok"] and got["vectors"] == max(n, 512)
    assert got["jax_mismatches"] == got["sim_mismatches"] == 0


def test_emulator_bands_equal_reference_and_served_lane():
    """At the acceptance size (10,000 vectors of the reference's corpus):
    the port's emulator, the reference's emulator, the plan's twin and
    the served lane give the same band for every vector."""
    tp = logreg.load_params(INT8)
    p = plan.compile_plan(tp)
    blob = plan.pack_blob(p)
    feats = parity.corpus(p, 10000)
    assert feats.shape == (10000, 8) and feats.dtype == np.uint32
    mine = emulate.emulate_scorer(blob, feats)
    assert mine.dtype == np.uint8
    np.testing.assert_array_equal(mine, remulate.emulate_scorer(blob, feats))
    np.testing.assert_array_equal(mine, p.bands(feats))
    np.testing.assert_array_equal(mine, parity.served_bands(tp, p, feats))
    assert set(np.unique(mine)) <= {wire.ML_BAND_PASS, wire.ML_BAND_ESCALATE,
                                    wire.ML_BAND_DROP}


def test_planted_blob_drift_fails_the_check():
    """A blob whose weight drifted from the served artifact's: the
    bytecode now disagrees with the served lane, and the check says so."""
    tp = logreg.load_params(INT8)
    p = plan.compile_plan(tp)
    blob = bytearray(plan.pack_blob(p))
    off = wire.ML_MODEL_W_OFFSET + 4 * 3      # w[3] = 73 -> 23
    blob[off:off + 4] = np.int32(23).tobytes()
    got = parity.emulate_check(tp, p, bytes(blob), n=2000)
    assert not got["ok"]
    assert got["jax_mismatches"] > 0 and got["sim_mismatches"] > 0


def test_disabled_model_escalates_nothing_and_says_disabled():
    feats = np.full((4, 8), 12345, np.uint32)
    got = emulate.emulate_scorer(b"\x00" * wire.ML_MODEL_SIZE, feats)
    assert (got == wire.ML_BAND_DISABLED).all()
    np.testing.assert_array_equal(
        got, remulate.emulate_scorer(b"\x00" * wire.ML_MODEL_SIZE, feats))


def test_emulator_refusals_equal_reference():
    insns = (isa.jmp_imm(isa.BPF_JEQ, isa.R1, 0, 1)
             + isa.mov64_imm(isa.R0, 1)
             + isa.mov64_imm(isa.R0, 0) + isa.exit_())
    em = emulate.VectorEmulator(insns, relocs={}, maps={})
    with pytest.raises(emulate.EmulationError, match="divergent"):
        em.run({1: np.array([0, 1], np.uint64)})
    # a uniform condition takes one path for every lane
    assert (np.asarray(em.run({1: np.array([0, 0], np.uint64)})) == 0).all()
    with pytest.raises(ValueError, match=r"\[N, 8\]"):
        emulate.emulate_scorer(b"\x00" * wire.ML_MODEL_SIZE,
                               np.zeros((3, 7), np.uint32))
    bad = isa.mov64_imm(isa.R0, 0) + [isa.Insn(0xd4, 0, 0, 0, 16)] \
        + isa.exit_()   # a byte swap: outside the modeled subset
    with pytest.raises(emulate.EmulationError) as mine:
        emulate.VectorEmulator(bad, relocs={}, maps={}).run({})
    with pytest.raises(remulate.EmulationError) as ref:
        remulate.VectorEmulator(_ref_insns(bad), relocs={}, maps={}).run({})
    assert str(mine.value) == str(ref.value)


def _ref_insns(insns):
    from flowsentryx_tpu.bpf.isa import Insn

    return [Insn(i.op, i.dst, i.src, i.off, i.imm) for i in insns]
