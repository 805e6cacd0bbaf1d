"""The port's static verifier on the compact16 programs (plain and
``ml``) against the reference's reports, then the two verbs that run it
over every shipped program: ``fsx check`` on the clean tree and on a
corrupt ``--image``, and ``fsx distill --check --emulate --device cpu``
against the reference's ``distill`` on the shared keys.

Each side verifies each program once in this process (module fixtures
and the verifier's in-memory cache); the raw48 programs' reports are
held to the reference in ``test_torch_verifier.py``.
"""

from __future__ import annotations

import json

import pytest

from flowsentryx_tpu import cli as rcli
from flowsentryx_tpu.bpf import image as rimage
from flowsentryx_tpu.bpf import progs as rprogs
from flowsentryx_tpu.bpf import verifier as rverifier
from flowsentryx_tpu_torch import cli
from flowsentryx_tpu_torch.bpf import progs, verifier

ART = "artifacts/logreg_int8.npz"
PROGRAMS = {"fsx[raw48]", "fsx[compact16]", "fsx[ml_raw48]",
            "fsx[ml_compact16]"}


@pytest.fixture(scope="module")
def reports():
    """{ml: (port report, reference report)} for the compact programs."""
    return {ml: (verifier.check_program_cached(progs.build(compact=True,
                                                            ml=ml)),
                 rverifier.check_program_cached(rprogs.build(compact=True,
                                                             ml=ml)))
            for ml in (False, True)}


@pytest.mark.parametrize("ml", [False, True], ids=["compact16",
                                                   "ml_compact16"])
def test_compact_program_report_equals_reference(reports, ml):
    mine, ref = reports[ml]
    assert mine.to_json() == ref.to_json()
    prog = progs.build(compact=True, ml=ml)
    assert mine.n_insns == len(prog.insns)
    assert mine.insns_visited > mine.n_insns


@pytest.fixture(scope="module")
def check_clean(reports):
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["check", "--json"])
    return rc, json.loads(buf.getvalue())


def test_cli_check_passes_on_clean_tree(check_clean, reports):
    rc, out = check_clean
    assert rc == 0 and out["ok"]
    assert {p["program"] for p in out["programs"]} == PROGRAMS
    assert all(c["ok"] for c in out["contracts"]["checks"].values())
    assert set(out["contracts"]["checks"]) == {
        "header_fresh", "header_layouts", "header_defines",
        "progs_offsets", "map_specs", "shm_layout", "images"}
    by_name = {p["program"]: p for p in out["programs"]}
    for ml, tag in ((False, "fsx[compact16]"), (True, "fsx[ml_compact16]")):
        assert by_name[tag] == {"ok": True, **reports[ml][1].to_json(),
                                "program": tag}


def test_cli_check_text_lines(check_clean, capsys):
    assert cli.main(["check"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[-1] == "fsx check: PASS"
    assert sum("OK (" in ln for ln in lines) == 4
    assert "fsx check: contract images: OK" in lines


def test_cli_check_reports_corrupt_image(check_clean, tmp_path, capsys):
    bad = tmp_path / "corrupt.img"
    bad.write_bytes(b"\x00" * 10)
    rc = cli.main(["check", "--json", "--no-images", "--image", str(bad)])
    out = json.loads(capsys.readouterr().out)
    assert rc == 1 and not out["ok"]
    entry = next(p for p in out["programs"] if p["program"] == str(bad))
    with pytest.raises(ValueError) as ref_err:
        rimage.to_program(bad.read_bytes())
    assert entry == {"ok": False, "program": str(bad),
                     "error": str(ref_err.value)}
    assert "truncated" in entry["error"]
    assert "images" not in out["contracts"]["checks"]


def test_cli_check_verifies_a_good_image(check_clean, tmp_path, capsys):
    """A sealed image of a small program that reads the config map: the
    image path verifies under the image's own map specs."""
    from flowsentryx_tpu_torch.bpf import image, isa
    from flowsentryx_tpu_torch.bpf.asm import Asm

    a = Asm("tiny")
    a += isa.st_imm(isa.BPF_W, isa.R10, -4, 0)
    a.ld_map(isa.R1, "config_map")
    a += isa.mov64(isa.R2, isa.R10)
    a += isa.alu64_imm(isa.BPF_ADD, isa.R2, -4)
    a += isa.call(isa.FN_map_lookup_elem)
    a += isa.mov64_imm(isa.R0, 2)
    a += isa.exit_()
    img = tmp_path / "tiny.img"
    img.write_bytes(image.emit(prog=a.assemble()))
    rc = cli.main(["check", "--json", "--no-images", "--image", str(img)])
    out = json.loads(capsys.readouterr().out)
    assert rc == 0 and out["ok"]
    entry = next(p for p in out["programs"] if p["program"] == str(img))
    assert entry["ok"] and entry["insns"] == 8
    assert entry["maps"] == ["config_map"]


def test_cli_distill_check_emulate_equals_reference(check_clean, reports,
                                                    capsys):
    rc = cli.main(["distill", ART, "--check", "--emulate", "--json",
                   "--device", "cpu"])
    mine = json.loads(capsys.readouterr().out)
    assert rc == 0 and mine["ok"]
    # the reference's own run, without --check (its ml_raw48 report is
    # held to the port's in test_torch_verifier.py)
    assert rcli.main(["distill", ART, "--emulate", "--json"]) == 0
    ref = json.loads(capsys.readouterr().out)
    assert mine["plan"] == ref["plan"]
    timing = {"emulator_wall_s", "emulator_vectors_per_s"}
    em = {k: v for k, v in mine["emulate"].items() if k not in timing}
    assert em.pop("served_device") == "cpu"
    assert em == {k: v for k, v in ref["emulate"].items()
                  if k not in timing}
    assert em["vectors"] == 10000 and em["jax_mismatches"] == 0
    assert em["sim_mismatches"] == 0
    chk = mine["check"]
    assert chk["ml_compact16"] == {"ok": True, **reports[True][1].to_json()}
    assert chk["ml_raw48"]["ok"] and chk["blob_roundtrip"]["ok"]
    assert chk["progs_offsets"] == {"ok": True, "failures": []}
    assert chk["map_specs"] == {"ok": True, "failures": []}
