"""The port's eBPF programs, sealed images, generated header and kernel
config packing, byte for byte against the reference and the checked-in
files under ``kern/``.

No ``bpf(2)`` and no verifier run here: the static verifier has its own
files (``test_torch_verifier*.py``), so the image tests seal with
``FSX_SKIP_STATIC_VERIFY=1`` on both sides.  Nothing is written into
``kern/``: generated files go under ``tmp_path``.
"""

from __future__ import annotations

import json
import pathlib
import struct
import subprocess
import sys

import pytest

from flowsentryx_tpu.bpf import contracts as rcontracts
from flowsentryx_tpu.bpf import image as rimage
from flowsentryx_tpu.bpf import progs as rprogs
from flowsentryx_tpu.core import codegen as rcodegen
from flowsentryx_tpu.core import config as rconfig
from flowsentryx_tpu.core import schema as rschema
from flowsentryx_tpu_torch import cli
from flowsentryx_tpu_torch.bpf import asm, contracts, image, isa, progs
from flowsentryx_tpu_torch.core import codegen, config, schema, wire

REPO = pathlib.Path(__file__).resolve().parent.parent
VARIANTS = [dict(), dict(ml=True), dict(compact=True),
            dict(compact=True, ml=True)]
VIDS = ["raw48", "ml_raw48", "compact16", "ml_compact16"]


def _bytes(prog) -> tuple:
    return (b"".join(i.pack() for i in prog.insns),
            [(r.slot, r.map_name) for r in prog.relocs])


# -- programs -----------------------------------------------------------------


@pytest.mark.parametrize("kw", VARIANTS, ids=VIDS)
def test_program_bytes_and_relocs_equal_reference(kw):
    mine, ref = progs.build(**kw), rprogs.build(**kw)
    assert _bytes(mine) == _bytes(ref)
    assert len(mine.insns) == len(ref.insns)
    assert mine.map_names == ref.map_names


def test_ml_scorer_equals_reference_and_is_embedded():
    mine = progs.build_ml_scorer()
    assert _bytes(mine) == _bytes(rprogs.build_ml_scorer())
    # the XDP variants carry the scorer's exact instruction bytes
    body = b"".join(i.pack() for i in mine.insns)
    assert body in _bytes(progs.build(ml=True))[0]


def test_map_specs_and_offsets_equal_reference():
    assert progs.MAP_SPECS == rprogs.MAP_SPECS
    assert vars(progs.MapSizes()) == vars(rprogs.MapSizes())
    names = [n for n in dir(rprogs) if n.isupper() and isinstance(
        getattr(rprogs, n), int)]
    assert names
    assert {n: getattr(progs, n) for n in names} == \
        {n: getattr(rprogs, n) for n in names}


def test_isa_constants_equal_reference():
    from flowsentryx_tpu.bpf import isa as risa

    names = [n for n in dir(risa) if n.isupper()
             and isinstance(getattr(risa, n), int)]
    assert {n: getattr(isa, n) for n in names} == \
        {n: getattr(risa, n) for n in names}
    ins = isa.Insn(isa.BPF_ALU64 | isa.BPF_ADD | isa.BPF_K, dst=3, imm=-7)
    assert ins.pack() == risa.Insn(risa.BPF_ALU64 | risa.BPF_ADD
                                   | risa.BPF_K, dst=3, imm=-7).pack()


def test_assembler_resolves_labels_and_relocations():
    a = asm.Asm("t")
    a.ld_map(isa.R1, "config_map")
    a.jmp_imm(isa.BPF_JEQ, isa.R1, 0, "out")
    a += isa.mov64_imm(isa.R0, 1)
    a.label("out")
    a += isa.mov64_imm(isa.R0, 2)
    a += isa.exit_()
    p = a.assemble()
    assert [(r.slot, r.map_name) for r in p.relocs] == [(0, "config_map")]
    assert p.insns[2].off == 1  # over the one mov to the label


# -- sealed images -------------------------------------------------------------


@pytest.mark.parametrize("kw", VARIANTS, ids=VIDS)
def test_sealed_images_equal_checked_in_and_reference(kw, monkeypatch):
    monkeypatch.setenv("FSX_SKIP_STATIC_VERIFY", "1")
    path = contracts.IMAGE_PATHS[(kw.get("compact", False),
                                  kw.get("ml", False))]
    assert path == rcontracts.IMAGE_PATHS[(kw.get("compact", False),
                                           kw.get("ml", False))]
    mine = image.emit(**kw)
    assert mine == path.read_bytes()
    assert mine == rimage.emit(**kw)


def test_image_roundtrip_and_corrupt_blobs(monkeypatch):
    monkeypatch.setenv("FSX_SKIP_STATIC_VERIFY", "1")
    prog = progs.build()
    good = image.emit(prog=prog)
    back, maps = image.to_program(good)
    assert back.insns == prog.insns
    assert [(r.slot, r.map_name) for r in back.relocs] == \
        [(r.slot, r.map_name) for r in prog.relocs]
    assert {m.name for m in maps} == set(prog.map_names)
    mine, ref = image.parse(good), rimage.parse(good)
    assert [vars(m) for m in mine[0]] == [vars(m) for m in ref[0]]
    assert mine[1:] == ref[1:]
    for blob in (b"", good[:10], good[:60], b"XXXXXXXX" + good[8:],
                 good[:-4]):
        with pytest.raises(ValueError):
            image.to_program(blob)


def test_image_cli_writes_what_the_reference_writes(tmp_path, monkeypatch):
    monkeypatch.setenv("FSX_SKIP_STATIC_VERIFY", "1")
    for argv in (["--track-ips=64"], ["--compact", "--ring-bytes=65536"]):
        a, b = tmp_path / "mine.img", tmp_path / "ref.img"
        assert image.main(["image", str(a)] + argv) == 0
        assert rimage.main(["image", *argv, str(b)]) == 0
        assert a.read_bytes() == b.read_bytes()
    assert image.main(["image", "--frob=1"]) == 2
    assert image.main(["image", str(tmp_path / "x"), str(tmp_path / "y")]) == 2


# -- the generated header ----------------------------------------------------


def test_header_equals_checked_in_and_reference():
    text = codegen.generate()
    assert text == (REPO / "kern" / "fsx_schema.h").read_text()
    assert text == rcodegen.generate()


def test_cli_codegen_writes_under_tmp(tmp_path, capsys):
    out = tmp_path / "inc" / "fsx_schema.h"
    assert cli.main(["codegen", "--out", str(out)]) == 0
    assert capsys.readouterr().out.strip() == f"wrote {out}"
    assert out.read_text() == (REPO / "kern" / "fsx_schema.h").read_text()


def test_codegen_module_entry_point(tmp_path):
    out = tmp_path / "h.h"
    r = subprocess.run(
        [sys.executable, "-m", "flowsentryx_tpu_torch.core.codegen",
         str(out)], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert out.read_text() == codegen.generate()


def test_header_compiles_to_the_schema_sizes(tmp_path):
    src = tmp_path / "offs.c"
    src.write_text(
        '#include <stdio.h>\n#include <stddef.h>\n'
        '#define FSX_HOST_BUILD 1\n#include "fsx_schema.h"\n'
        "int main(void){\n"
        'printf("%zu %zu %zu %zu %zu\\n", sizeof(struct fsx_config),'
        " sizeof(struct fsx_ip_state), sizeof(struct fsx_flow_stats),"
        " sizeof(struct fsx_flow_record), sizeof(struct fsx_stats));\n"
        "return 0;}\n")
    codegen.write_header(tmp_path / "fsx_schema.h")
    exe = tmp_path / "offs"
    subprocess.run(["gcc", "-I", str(tmp_path), str(src), "-o", str(exe)],
                   check=True)
    out = [int(x) for x in subprocess.run(
        [str(exe)], capture_output=True, text=True, check=True).stdout.split()]
    lay = wire.struct_layouts()
    assert out == [config.FsxConfig.KERNEL_CONFIG_SIZE,
                   lay["fsx_ip_state"].size, lay["fsx_flow_stats"].size,
                   wire.FLOW_RECORD_SIZE, lay["fsx_stats"].size]
    assert out[:4] == [progs.CFG_SIZE, progs.IPS_SIZE, progs.FS_SIZE,
                       progs.REC_SIZE]


# -- schema and config packing -------------------------------------------------


def test_kernel_plane_schema_equals_reference():
    for name in ("FEATURE_NAMES", "FLOW_STATS_FIELDS", "IP_STATE_FIELDS",
                 "KERNEL_STATS_FIELDS", "MAX_RULES", "RULE_DROP",
                 "ML_MODEL_SIZE", "ML_BOUNDS_PER_FEATURE"):
        assert getattr(schema, name) == getattr(rschema, name), name
    assert {k: (v.name, v.size, tuple(tuple(f) for f in v.fields))
            for k, v in schema.struct_layouts().items()} == \
        {k: (v.name, v.size, tuple(tuple(f) for f in v.fields))
         for k, v in rschema.struct_layouts().items()}
    assert {v.name: v.value for v in schema.Verdict} == \
        {v.name: v.value for v in rschema.Verdict}
    for proto, dport in ((0, 0), (6, 22), (17, 65535), (300, 70000)):
        assert schema.pack_rule_key(proto, dport) == \
            rschema.pack_rule_key(proto, dport)
    assert schema.struct_layouts()["fsx_config"].offset_of("block_ns") == 32
    with pytest.raises(KeyError):
        schema.struct_layouts()["fsx_config"].offset_of("nope")


CONFIGS = [
    None,
    {"limiter": {"kind": "sliding_window", "pps_threshold": 5000,
                 "bps_threshold": 1e9, "window_s": 2.5, "block_s": 30}},
    {"limiter": {"kind": "token_bucket", "bucket_rate_pps": 750,
                 "bucket_burst": 1500, "bucket_rate_bps": 0,
                 "bucket_burst_bytes": 0},
     "table": {"salt": 0xDEADBEEF},
     "rules": [{"proto": "tcp", "dport": 22}, {"proto": "udp"},
               {"proto": 47}, {"dport": 8080}]},
]


@pytest.mark.parametrize("doc", CONFIGS, ids=["default", "sliding",
                                              "bucket_rules"])
def test_pack_kernel_config_bytes_equal_reference(doc):
    text = json.dumps(doc) if doc else None
    mine = (config.FsxConfig.from_json(text) if text
            else config.DEFAULT_CONFIG)
    ref = (rconfig.FsxConfig.from_json(text) if text
           else rconfig.DEFAULT_CONFIG)
    blob = mine.pack_kernel_config()
    assert blob == ref.pack_kernel_config()
    assert len(blob) == config.FsxConfig.KERNEL_CONFIG_SIZE == 88
    assert mine.rule_entries() == ref.rule_entries()
    assert config.FsxConfig.KERNEL_CONFIG_FIELDS == \
        rconfig.FsxConfig.KERNEL_CONFIG_FIELDS
    vals = dict(zip((n for n, _, _ in config.FsxConfig.KERNEL_CONFIG_FIELDS),
                    struct.unpack(config.FsxConfig.KERNEL_CONFIG_FMT, blob)))
    assert vals["valid"] == 1 and vals["rule_count"] == len(mine.rules)


@pytest.mark.parametrize("doc", CONFIGS[1:], ids=["sliding", "bucket_rules"])
def test_cli_config_show_and_pack_equal_reference(doc, tmp_path,
                                                  capsysbinary):
    from flowsentryx_tpu import cli as rcli

    f = tmp_path / "cfg.json"
    f.write_text(json.dumps(doc))
    outs = []
    for main in (cli.main, rcli.main):
        assert main(["config", "--file", str(f)]) == 0
        shown = capsysbinary.readouterr().out
        assert main(["config", "--file", str(f), "--pack"]) == 0
        outs.append((shown, capsysbinary.readouterr().out))
    assert outs[0] == outs[1]
    assert len(outs[0][1]) == 88
    # --set without --pin is refused, as the reference refuses it
    assert cli.main(["config", "--set", "pps_threshold=5"]) == 1


# -- contracts that need no verifier -----------------------------------------


def test_contracts_clean_without_images():
    rep = contracts.run_all(with_images=False)
    assert rep.ok, rep.failures
    assert set(rep.checks) == set(
        rcontracts.run_all(with_images=False).checks)


def test_header_drift_detected(tmp_path):
    bad = tmp_path / "fsx_schema.h"
    text = contracts.HEADER_PATH.read_text()
    bad.write_text(text.replace("\t__u64 block_ns;", "\t__u32 block_ns;"))
    fresh = contracts.check_header_fresh(bad)
    assert fresh and "flowsentryx_tpu_torch.core.codegen" in fresh[0]
    assert any("fsx_config" in f for f in contracts.check_header_layouts(bad))
    bad.write_text(text.replace("#define FSX_FLAG_TCP 4",
                                "#define FSX_FLAG_TCP 2"))
    assert any("FSX_FLAG_TCP" in f
               for f in contracts.check_header_defines(bad))


def test_progs_and_map_spec_drift_detected(monkeypatch):
    monkeypatch.setattr(progs, "CFG_BLOCK_NS", progs.CFG_BLOCK_NS + 8)
    assert any("CFG_BLOCK_NS" in f for f in contracts.check_progs_offsets())
    specs = dict(progs.MAP_SPECS)
    mtype, ks, vs, ent = specs["ip_state_map"]
    specs["ip_state_map"] = (mtype, ks, vs - 8, ent)
    monkeypatch.setattr(progs, "MAP_SPECS", specs)
    assert any("ip_state_map" in f for f in contracts.check_map_specs())


def test_stale_and_missing_images_detected(tmp_path, monkeypatch):
    monkeypatch.setenv("FSX_SKIP_STATIC_VERIFY", "1")
    stale = tmp_path / "fsx_prog.img"
    stale.write_bytes(image.emit(sizes=progs.MapSizes(max_track_ips=64)))
    fails = contracts.check_images({False: stale})
    assert fails and "stale" in fails[0]
    assert "flowsentryx_tpu_torch.bpf.image" in fails[0]
    fails = contracts.check_images({True: tmp_path / "nope.img"})
    assert fails and "missing" in fails[0]
