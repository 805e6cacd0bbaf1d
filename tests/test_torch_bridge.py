"""The BPF containment bridge (``ranges/bridge.py``): the eBPF
verifier's ranges at the distilled scorer's accumulator and band exit
must contain the served int8 lane's, the lane's side proved by the
port's range prover over its traced aten graph.

The reference's own bridge reads a jaxpr and cannot be compared here
(its jaxpr side fails on this container's jax), so the port's stands on
three legs of its own: the verifier-side probes equal the reference
verifier's, the lane's accumulator interval equals the closed form
computed from the artifact, and a planted drift fails containment.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from flowsentryx_tpu.bpf import progs as rprogs
from flowsentryx_tpu.bpf import verifier as rverifier
from flowsentryx_tpu.ranges import bridge as rbridge
from flowsentryx_tpu_torch import cli
from flowsentryx_tpu_torch.bpf import isa, progs
from flowsentryx_tpu_torch.bpf.asm import Program
from flowsentryx_tpu_torch.core.config import (
    BatchConfig, FsxConfig, TableConfig,
)
from flowsentryx_tpu_torch.models import logreg
from flowsentryx_tpu_torch.ranges import bridge, runner

ART = "artifacts/logreg_int8.npz"


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def proof():
    return bridge.containment_proof(logreg.load_params(ART))


def _zp_params():
    return logreg.params_from_numpy(dict(
        w_int8=np.array([23, -7, 61, -128, 5, 90, -33, 1], np.int8),
        bias=np.float32(-0.4), w_scale=np.float32(0.0123),
        in_scale=np.float32(3.5e5), in_zp=np.int32(37),
        out_scale=np.float32(0.071), out_zp=np.int32(128),
        log1p=np.int32(0)))


# -- leg 1: the verifier side equals the reference verifier's -------------


def test_probe_sites_and_verifier_ranges_equal_reference(proof):
    sites = bridge.locate_probe_sites(progs.build_ml_scorer())
    assert sites == rbridge.locate_probe_sites(rprogs.build_ml_scorer())
    assert proof["mac_sites"] == sites["mac_after"]
    assert proof["band_exit"] == sites["band_exit"]
    probes = {i: 6 for i in sites["mac_after"]}
    probes[sites["band_exit"]] = 0
    ref = rverifier.check_program(rprogs.build_ml_scorer(),
                                  name="fsx_ml_scorer", probes=probes,
                                  entry_main=False)
    assert proof["bpf_mac_all"] == {str(i): ref.probes[i]
                                    for i in sites["mac_after"]}
    assert proof["bpf_final_mac"] == ref.probes[sites["mac_after"][-1]]
    assert proof["bpf_band"] == ref.probes[sites["band_exit"]]
    assert proof["bpf_band"]["umin"] == 0 and proof["bpf_band"]["umax"] == 2


# -- leg 2: the lane's interval is the closed form --------------------------


@pytest.mark.parametrize("which", ["shipped", "golden", "zero_point"])
def test_acc_interval_equals_closed_form(which):
    params = {"shipped": lambda: logreg.load_params(ART),
              "golden": logreg.golden_params, "zero_point": _zp_params}[which]()
    got = bridge.acc_interval(params)
    w = params.w_int8.numpy().astype(np.int64)
    zp = int(params.in_zp)
    lo = sum(min(wi * -zp, wi * (255 - zp)) for wi in w)
    hi = sum(max(wi * -zp, wi * (255 - zp)) for wi in w)
    assert got == (lo, hi) == bridge.closed_form_interval(params)


def test_shipped_artifact_is_contained(proof):
    assert proof["ok"] and proof["mac_contained"] and proof["band_contained"]
    assert proof["acc_zp_folded"] == proof["closed_form"] == [-43860, 23205]
    # zero point 0: the kernel's raw sum is the lane's accumulator
    assert proof["kernel_acc"] == proof["acc_zp_folded"]
    assert proof["lane_bands"] == [0, 2]
    json.dumps(proof)


def test_zero_point_folds_into_the_kernel_domain():
    p = _zp_params()
    rec = bridge.containment_proof(p)
    w_sum = int(p.w_int8.numpy().astype(np.int64).sum())
    assert rec["ok"]
    assert rec["kernel_acc"] == [rec["acc_zp_folded"][0] + 37 * w_sum,
                                 rec["acc_zp_folded"][1] + 37 * w_sum]


# -- leg 3: a planted drift fails containment ----------------------------------


def _without(prog: Program, pred) -> Program:
    """``prog`` with every instruction ``pred`` selects replaced by a
    no-op of one slot (``r0 += 0``), so that no jump moves."""
    nop = isa.alu64_imm(isa.BPF_ADD, isa.R0, 0)[0]
    return Program([nop if pred(i, ins) else ins
                    for i, ins in enumerate(prog.insns)],
                   list(prog.relocs), name=prog.name)


def test_scorer_missing_a_mac_fails():
    prog = progs.build_ml_scorer()
    add_r6 = isa.BPF_ALU64 | isa.BPF_ADD | isa.BPF_X
    last = max(i for i, ins in enumerate(prog.insns)
               if ins.op == add_r6 and ins.dst == 6 and ins.src == 4)
    drifted = _without(prog, lambda i, ins: i == last)
    with pytest.raises(ValueError, match="shape drift"):
        bridge.containment_proof(logreg.load_params(ART), prog=drifted)


def test_band_tail_drift_fails_containment():
    """The band select loses its drop term: the verifier's band range
    no longer contains the lane's DROP band."""
    prog = progs.build_ml_scorer()
    add_r0 = isa.BPF_ALU64 | isa.BPF_ADD | isa.BPF_X
    drifted = _without(prog, lambda i, ins: ins.op == add_r0
                       and ins.dst == 0 and ins.src == 2)
    rec = bridge.containment_proof(logreg.load_params(ART), prog=drifted)
    assert not rec["ok"] and rec["mac_contained"]
    assert not rec["band_contained"] and rec["bpf_band"]["umax"] < 2


# -- the runner and the verb ---------------------------------------------------

QUICK = FsxConfig(table=TableConfig(capacity=1 << 12),
                  batch=BatchConfig(max_batch=256, verdict_k=64))


def test_run_ranges_carries_the_bridge_and_refuses_a_broken_artifact(
        tmp_path):
    rep = runner.run_ranges(QUICK, variants=("compact",), device="cpu",
                            artifact=ART)
    assert rep.ok and rep.bridge["ok"] and rep.bridge["artifact"] == ART
    js = rep.to_json()
    assert js["bridge"]["kernel_acc"] == [-43860, 23205]
    assert js["negative_controls"]["ok"]
    assert js["config"]["stat_max"] == 1 << 54
    missing = runner.run_ranges(QUICK, variants=("compact",),
                                device="cpu", artifact=str(tmp_path / "no"))
    assert missing.ok and missing.bridge is None
    assert any("containment bridge skipped" in n for n in missing.notes)
    bad = tmp_path / "bad.npz"
    bad.write_bytes(b"not a zip")
    broken = runner.run_ranges(QUICK, variants=("compact",), device="cpu",
                               artifact=str(bad))
    assert not broken.ok and broken.bridge["ok"] is False
    assert "error" in broken.bridge


def test_cli_ranges_artifact_passes_with_the_bridge(capsys):
    assert cli.main(["ranges", "--quick", "--mega", "0", "--device", "cpu",
                     "--artifact", ART]) == 0
    out = capsys.readouterr().out
    assert "BPF<->served lane containment: OK (acc [-43860, 23205]" in out
    assert out.rstrip().endswith("fsx ranges: PASS")
    assert cli.main(["ranges", "--quick", "--mega", "0", "--device", "cpu",
                     "--artifact", ART, "--json"]) == 0
    js = json.loads(capsys.readouterr().out)
    assert js["ok"] and js["bridge"]["ok"]
