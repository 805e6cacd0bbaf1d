"""The port's static eBPF verifier against the reference's: the reports on
the raw48 programs (plain and ``ml``), the probe API on the distilled
scorer, and the diagnosis of every planted violation of the reference's
negative table.

Each side's verifier runs once per program in this file (module
fixtures; the compact programs are in ``test_torch_verifier_compact.py``
so that the two files' costs spread over the workers).
"""

from __future__ import annotations

import importlib.util
import pathlib

import pytest

from flowsentryx_tpu.bpf import progs as rprogs
from flowsentryx_tpu.bpf import verifier as rverifier
from flowsentryx_tpu_torch.bpf import image, loader, progs, verifier
from flowsentryx_tpu_torch.bpf.asm import MapReloc, Program
from flowsentryx_tpu_torch.bpf.isa import Insn
from flowsentryx_tpu_torch.ranges import bridge

_spec = importlib.util.spec_from_file_location(
    "_reference_verifier_cases",
    pathlib.Path(__file__).with_name("test_verifier.py"))
ref_cases = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(ref_cases)


def to_port(prog):
    """A reference-assembled program (or bare instruction list) as the
    port's: the same instructions and relocations."""
    if isinstance(prog, list):
        return [Insn(i.op, i.dst, i.src, i.off, i.imm) for i in prog]
    return Program([Insn(i.op, i.dst, i.src, i.off, i.imm)
                    for i in prog.insns],
                   [MapReloc(r.slot, r.map_name) for r in prog.relocs],
                   name=prog.name)


@pytest.fixture(scope="module", params=[False, True], ids=["raw48",
                                                          "ml_raw48"])
def reports(request):
    ml = request.param
    return (verifier.check_program_cached(progs.build(ml=ml)),
            rverifier.check_program_cached(rprogs.build(ml=ml)),
            progs.build(ml=ml))


def test_shipped_program_report_equals_reference(reports):
    mine, ref, prog = reports
    assert mine.to_json() == ref.to_json()
    assert mine.n_insns == len(prog.insns)
    assert mine.insns_visited > mine.n_insns
    assert mine.subprog_entries
    assert set(mine.map_names) == set(prog.map_names)


def test_cache_is_content_addressed(reports):
    mine, _, prog = reports
    again = progs.build(ml="ml_model_map" in prog.map_names)
    assert again is not prog
    assert verifier.check_program_cached(again) is mine


def test_scorer_probes_equal_reference():
    """The bridge's probe sites on the standalone scorer, and the
    verifier's ranges there, as the reference reads them."""
    mine, ref = progs.build_ml_scorer(), rprogs.build_ml_scorer()
    sites = bridge.locate_probe_sites(mine)
    probes = {i: 6 for i in sites["mac_after"]}
    probes[sites["band_exit"]] = 0
    a = verifier.check_program(mine, name="fsx_ml_scorer", probes=probes,
                               entry_main=False)
    b = rverifier.check_program(ref, name="fsx_ml_scorer", probes=probes,
                                entry_main=False)
    assert a.probes == b.probes
    assert a.to_json() == b.to_json()
    assert a.probes[sites["band_exit"]]["umax"] == 2
    # as an XDP entry the scorer's packed-feature arguments are unknown
    with pytest.raises(verifier.StaticVerifierError) as ei:
        verifier.check_program(mine, name="fsx_ml_scorer")
    with pytest.raises(rverifier.StaticVerifierError) as ej:
        rverifier.check_program(ref, name="fsx_ml_scorer")
    assert (ei.value.insn_idx, ei.value.reason) == \
        (ej.value.insn_idx, ej.value.reason)


@pytest.mark.parametrize(
    "name,build,pattern", ref_cases.NEGATIVE_CASES,
    ids=[c[0] for c in ref_cases.NEGATIVE_CASES])
def test_negative_case_diagnosis_equals_reference(name, build, pattern):
    prog = build()
    with pytest.raises(rverifier.StaticVerifierError) as ref:
        rverifier.check_program(prog)
    with pytest.raises(verifier.StaticVerifierError) as mine:
        verifier.check_program(to_port(prog))
    a, b = mine.value, ref.value
    assert (a.insn_idx, a.insn_txt, a.reason) == \
        (b.insn_idx, b.insn_txt, b.reason), name
    assert a.state_dump == b.state_dump
    assert str(a) == str(b)


def _diag(fn, *args, **kw):
    try:
        fn(*args, **kw)
    except Exception as e:  # noqa: BLE001 - the diagnosis is the result
        return type(e).__name__, str(e)
    return None


def test_budget_empty_and_unknown_map_equal_reference():
    prog = rprogs.build()
    assert _diag(verifier.check_program, to_port(prog), budget=500) == \
        _diag(rverifier.check_program, prog, budget=500)
    assert "budget" in _diag(verifier.check_program, to_port(prog),
                             budget=500)[1]
    assert _diag(verifier.check_program, []) == \
        _diag(rverifier.check_program, [])
    a = ref_cases.Asm("neg")
    a.ld_map(ref_cases.R1, "no_such_map")
    ref_cases._ret0(a)
    bad = a.assemble()
    assert _diag(verifier.check_program, to_port(bad)) == \
        _diag(rverifier.check_program, bad)


def test_bad_register_number_rejected():
    from flowsentryx_tpu_torch.bpf.isa import BPF_ALU64, BPF_K, BPF_MOV, exit_

    bad = [Insn(BPF_ALU64 | BPF_MOV | BPF_K, dst=13, imm=1)] + exit_()
    with pytest.raises(verifier.StaticVerifierError,
                       match="invalid register number"):
        verifier.check_program(bad)


def test_seal_and_load_hooks_refuse_a_bad_program(monkeypatch):
    bad = to_port(ref_cases.missing_bounds_check())
    # the loader verifies before any syscall, so this holds without bpf(2)
    with pytest.raises(verifier.StaticVerifierError):
        loader.prog_load(bad)
    with pytest.raises(verifier.StaticVerifierError):
        image.emit(prog=to_port(ref_cases.map_value_null_deref()))
    monkeypatch.setenv("FSX_SKIP_STATIC_VERIFY", "1")
    assert image.emit(prog=to_port(ref_cases.ringbuf_reference_leak()))
