"""Cross-layer wire-format contract checker (the ``fsx check`` half
that is not the instruction verifier).

Four layers speak the same packed structs and must never disagree:

* :mod:`flowsentryx_tpu_torch.core.schema` / ``core.config`` — the ground
  truth (``schema.struct_layouts()``);
* ``kern/fsx_schema.h`` — GENERATED from it by ``core.codegen``;
  compiled into the C++ daemon (``daemon/fsxd.cpp``), the BPF C twin
  (``kern/fsx_kern.c``) and every host-side C harness, so checking the
  header checks all of C;
* ``bpf/progs.py`` — bakes the same offsets into bytecode IMMEDIATES
  (``CFG_*``/``IPS_*``/``FS_*``/``REC_*``/``ST_*``) and map value sizes
  into ``MAP_SPECS``;
* the sealed program images under ``kern/build/`` — the
  assembler→daemon hand-off, which goes stale the moment progs.py or a
  map spec changes.

Each check returns a list of human-readable failure strings; an empty
list means the layers agree.  ``run_all()`` aggregates them into the
report ``fsx check`` prints and the tier-1 test asserts on — so a
schema drift fails in pytest, not as a kernel ``EACCES`` (or worse, a
silently misdecoded wire) at load time.

The C header is parsed with a purpose-built reader for the generated
format (packed structs of ``__uNN`` scalars/arrays + ``#define``\\ s) —
not a C parser; hand-edited headers that stray from codegen's output
fail the freshness check first anyway.

Counterpart of ``flowsentryx_tpu/bpf/contracts.py``, run over the port's
own schema, codegen, programs and images.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import NamedTuple

from flowsentryx_tpu_torch.core import wire as schema

#: Repo root (contracts run against a source checkout; ``fsx check``
#: reports the header as missing otherwise).
REPO_ROOT = Path(__file__).resolve().parents[2]
HEADER_PATH = REPO_ROOT / "kern" / "fsx_schema.h"
#: How to regenerate the header, named in every header failure.
_REGEN = "run python -m flowsentryx_tpu_torch.core.codegen"
#: Sealed image per (compact, ml) build variant.  ``check_images`` also
#: accepts plain-bool keys (compact only, ml=False) for back-compat.
IMAGE_PATHS = {
    (False, False): REPO_ROOT / "kern" / "build" / "fsx_prog.img",
    (True, False): REPO_ROOT / "kern" / "build" / "fsx_prog_compact.img",
    (False, True): REPO_ROOT / "kern" / "build" / "fsx_prog_ml.img",
    (True, True): REPO_ROOT / "kern" / "build" / "fsx_prog_ml_compact.img",
}

_C_SIZES = {"__u64": 8, "__u32": 4, "__u16": 2, "__u8": 1, "float": 4}

_STRUCT_RE = re.compile(
    r"struct\s+(\w+)\s*\{(.*?)\}\s*__attribute__\(\(packed\)\)\s*;",
    re.S)
_FIELD_RE = re.compile(
    r"^\s*(__u64|__u32|__u16|__u8|float)\s+(\w+)(?:\[(\d+)\])?\s*;")
_DEFINE_RE = re.compile(
    r"^#define\s+(\w+)\s+\(?\s*([0-9xXa-fA-F]+(?:\s*<<\s*\d+)?)\s*\)?"
    r"(?:ULL)?\s*(?:/\*.*)?$")


def parse_header(text: str) -> tuple[dict[str, schema.StructLayout],
                                     dict[str, int]]:
    """(structs, defines) from a GENERATED fsx_schema.h."""
    structs: dict[str, schema.StructLayout] = {}
    for m in _STRUCT_RE.finditer(text):
        name, body = m.group(1), m.group(2)
        fields, off = [], 0
        for line in body.splitlines():
            fm = _FIELD_RE.match(line)
            if not fm:
                continue
            ctype, fname, count = fm.group(1), fm.group(2), fm.group(3)
            n = int(count) if count else 1
            size = _C_SIZES[ctype]
            fields.append(schema.FieldLayout(fname, off, size, n))
            off += size * n
        structs[name] = schema.StructLayout(name, off, tuple(fields))
    defines: dict[str, int] = {}
    for line in text.splitlines():
        dm = _DEFINE_RE.match(line.rstrip())
        if not dm:
            continue
        expr = dm.group(2)
        if "<<" in expr:
            a, b = (int(x.strip(), 0) for x in expr.split("<<"))
            defines[dm.group(1)] = a << b
        else:
            defines[dm.group(1)] = int(expr, 0)
    return structs, defines


# ---------------------------------------------------------------------------
# Individual checks — each returns failure strings, [] when clean
# ---------------------------------------------------------------------------


def check_header_fresh(header_path: Path = HEADER_PATH) -> list[str]:
    """The checked-in header is byte-identical to what codegen emits
    from the CURRENT schemas (a hand edit or a schema change without
    regeneration both trip this)."""
    from flowsentryx_tpu_torch.core import codegen

    if not header_path.exists():
        return [f"{header_path}: missing ({_REGEN})"]
    disk = header_path.read_text()
    want = codegen.generate()
    if disk == want:
        return []
    for i, (a, b) in enumerate(zip(disk.splitlines(), want.splitlines())):
        if a != b:
            return [f"{header_path}: stale — first divergence at line "
                    f"{i + 1}: {a!r} != generated {b!r} ({_REGEN})"]
    return [f"{header_path}: stale — length differs from generated "
            f"output ({_REGEN})"]


def check_header_layouts(header_path: Path = HEADER_PATH) -> list[str]:
    """Struct offsets/sizes in the C header vs schema.struct_layouts().

    Redundant with check_header_fresh only while codegen is correct —
    this one would catch a codegen bug that renders the right fields at
    the wrong width, which freshness alone blesses."""
    if not header_path.exists():
        return [f"{header_path}: missing ({_REGEN})"]
    structs, _ = parse_header(header_path.read_text())
    fails = []
    for name, want in schema.struct_layouts().items():
        got = structs.get(name)
        if got is None:
            fails.append(f"header lacks struct {name}")
            continue
        if got.size != want.size:
            fails.append(f"struct {name}: C size {got.size} != schema "
                         f"{want.size}")
        # match by offset, not name: the generated header may annotate
        # a word with its meaning (dtype "w0" -> C "w0_saddr")
        cfields = {f.offset: f for f in got.fields}
        for f in want.fields:
            cf = cfields.get(f.offset)
            if cf is None:
                fails.append(f"struct {name}: no C field at offset "
                             f"{f.offset} (schema field {f.name})")
            elif (cf.size, cf.count) != (f.size, f.count) or not (
                    cf.name == f.name or cf.name.startswith(f.name + "_")):
                fails.append(
                    f"struct {name}.{f.name}: C field {cf.name} "
                    f"(size={cf.size}, n={cf.count}) != schema "
                    f"(size={f.size}, n={f.count})")
    return fails


#: progs.py constant -> (struct, field) it must equal the offset of;
#: None field = total struct size.
_PROGS_OFFSETS: dict[str, tuple[str, str | None]] = {
    "CFG_LIMITER_KIND": ("fsx_config", "limiter_kind"),
    "CFG_VALID": ("fsx_config", "valid"),
    "CFG_PPS_THRESHOLD": ("fsx_config", "pps_threshold"),
    "CFG_BPS_THRESHOLD": ("fsx_config", "bps_threshold"),
    "CFG_WINDOW_NS": ("fsx_config", "window_ns"),
    "CFG_BLOCK_NS": ("fsx_config", "block_ns"),
    "CFG_BUCKET_RATE_PPS": ("fsx_config", "bucket_rate_pps"),
    "CFG_BUCKET_BURST": ("fsx_config", "bucket_burst"),
    "CFG_BUCKET_RATE_BPS": ("fsx_config", "bucket_rate_bps"),
    "CFG_BUCKET_BURST_BYTES": ("fsx_config", "bucket_burst_bytes"),
    "CFG_RULE_COUNT": ("fsx_config", "rule_count"),
    "CFG_HASH_SALT": ("fsx_config", "hash_salt"),
    "CFG_SIZE": ("fsx_config", None),
    "IPS_WIN_START_NS": ("fsx_ip_state", "win_start_ns"),
    "IPS_WIN_PPS": ("fsx_ip_state", "win_pps"),
    "IPS_WIN_BPS": ("fsx_ip_state", "win_bps"),
    "IPS_PREV_PPS": ("fsx_ip_state", "prev_pps"),
    "IPS_PREV_BPS": ("fsx_ip_state", "prev_bps"),
    "IPS_TOKENS_MILLI": ("fsx_ip_state", "tokens_milli"),
    "IPS_TOK_TS_NS": ("fsx_ip_state", "tok_ts_ns"),
    "IPS_TOK_BYTES": ("fsx_ip_state", "tok_bytes"),
    "IPS_SIZE": ("fsx_ip_state", None),
    "FS_PKT_COUNT": ("fsx_flow_stats", "pkt_count"),
    "FS_BYTE_SUM": ("fsx_flow_stats", "byte_sum"),
    "FS_BYTE_SQ_SUM": ("fsx_flow_stats", "byte_sq_sum"),
    "FS_FIRST_TS_NS": ("fsx_flow_stats", "first_ts_ns"),
    "FS_LAST_TS_NS": ("fsx_flow_stats", "last_ts_ns"),
    "FS_IAT_SUM_NS": ("fsx_flow_stats", "iat_sum_ns"),
    "FS_IAT_SQ_SUM_US2": ("fsx_flow_stats", "iat_sq_sum_us2"),
    "FS_IAT_MAX_NS": ("fsx_flow_stats", "iat_max_ns"),
    "FS_DST_PORT": ("fsx_flow_stats", "dst_port"),
    "FS_SIZE": ("fsx_flow_stats", None),
    "REC_TS_NS": ("fsx_flow_record", "ts_ns"),
    "REC_SADDR": ("fsx_flow_record", "saddr"),
    "REC_PKT_LEN": ("fsx_flow_record", "pkt_len"),
    "REC_IP_PROTO": ("fsx_flow_record", "ip_proto"),
    "REC_FLAGS": ("fsx_flow_record", "flags"),
    "REC_FEAT": ("fsx_flow_record", "feat"),
    "REC_SIZE": ("fsx_flow_record", None),
    "ST_ALLOWED": ("fsx_stats", "allowed"),
    "ST_DROPPED_BLACKLIST": ("fsx_stats", "dropped_blacklist"),
    "ST_DROPPED_RATE": ("fsx_stats", "dropped_rate"),
    "ST_DROPPED_ML": ("fsx_stats", "dropped_ml"),
    "ST_DROPPED_RULE": ("fsx_stats", "dropped_rule"),
    "ST_ML_PASS": ("fsx_stats", "ml_pass"),
    "ST_ML_ESCALATED": ("fsx_stats", "ml_escalated"),
    "ST_SIZE": ("fsx_stats", None),
    "MLM_VALID": ("fsx_ml_model", "valid"),
    "MLM_FLAGS": ("fsx_ml_model", "_reserved"),
    "MLM_ACC_DROP": ("fsx_ml_model", "acc_drop"),
    "MLM_ACC_PASS": ("fsx_ml_model", "acc_pass"),
    "MLM_W": ("fsx_ml_model", "w"),
    "MLM_QBASE": ("fsx_ml_model", "qbase"),
    "MLM_BOUNDS": ("fsx_ml_model", "bounds_m1"),
    "MLM_SIZE": ("fsx_ml_model", None),
}

#: map name -> (key struct-or-size, value struct-or-size).  A string
#: names a schema struct whose packed size the map must carry.
_MAP_CONTRACTS: dict[str, tuple[object, object]] = {
    "config_map": (4, "fsx_config"),
    "blacklist_map": (4, 8),
    "blacklist_v6": (16, 8),
    "ip_state_map": (4, "fsx_ip_state"),
    "flow_stats_map": (4, "fsx_flow_stats"),
    "stats_map": (4, "fsx_stats"),
    "feature_ring": (0, 0),
    "rule_map": (4, 8),
    "ml_model_map": (4, "fsx_ml_model"),
}


def check_progs_offsets() -> list[str]:
    """Every offset/size constant progs.py bakes into instruction
    immediates vs the schema layouts (the check that catches a struct
    edit that forgot the assembler)."""
    from flowsentryx_tpu_torch.bpf import progs

    layouts = schema.struct_layouts()
    fails = []
    for const, (sname, field) in _PROGS_OFFSETS.items():
        have = getattr(progs, const, None)
        if have is None:
            fails.append(f"progs.{const}: constant missing")
            continue
        lay = layouts[sname]
        try:
            want = lay.size if field is None else lay.offset_of(field)
        except KeyError:
            # a schema field removed without retiring the assembler
            # constant: that IS the drift, not an internal error
            fails.append(f"progs.{const}: schema struct {sname} has no "
                         f"field {field!r} anymore")
            continue
        if have != want:
            what = f"sizeof({sname})" if field is None \
                else f"offsetof({sname}, {field})"
            fails.append(f"progs.{const} = {have} != {what} = {want}")
    # record flags and the compact record size ride the same bus
    for flag in ("IPV6", "TCP_SYN", "TCP", "UDP", "ICMP"):
        if getattr(progs, f"FLAG_{flag}") != getattr(schema,
                                                     f"FLAG_{flag}"):
            fails.append(f"progs.FLAG_{flag} != schema.FLAG_{flag}")
    if progs.COMPACT_REC_SIZE != schema.COMPACT_RECORD_SIZE:
        fails.append(f"progs.COMPACT_REC_SIZE = {progs.COMPACT_REC_SIZE}"
                     f" != schema.COMPACT_RECORD_SIZE = "
                     f"{schema.COMPACT_RECORD_SIZE}")
    return fails


def check_map_specs() -> list[str]:
    """MAP_SPECS key/value sizes vs the structs the kernel and the
    drain side deserialize map values into."""
    from flowsentryx_tpu_torch.bpf import progs

    layouts = schema.struct_layouts()

    def resolve(x: object) -> int:
        return layouts[x].size if isinstance(x, str) else int(x)  # type: ignore[index]

    fails = []
    for name, (want_key, want_val) in _MAP_CONTRACTS.items():
        spec = progs.MAP_SPECS.get(name)
        if spec is None:
            fails.append(f"MAP_SPECS lacks map {name}")
            continue
        _, ks, vs, _ = spec
        if ks != resolve(want_key):
            fails.append(f"map {name}: key_size {ks} != "
                         f"{resolve(want_key)}")
        if vs != resolve(want_val):
            fails.append(f"map {name}: value_size {vs} != "
                         f"{resolve(want_val)}")
    extra = set(progs.MAP_SPECS) - set(_MAP_CONTRACTS)
    if extra:
        fails.append(f"maps missing a contract entry: {sorted(extra)} "
                     "(add them to contracts._MAP_CONTRACTS)")
    return fails


def check_header_defines(header_path: Path = HEADER_PATH) -> list[str]:
    """#define values the decoders/daemon compile against vs schema."""
    if not header_path.exists():
        return [f"{header_path}: missing ({_REGEN})"]
    _, defines = parse_header(header_path.read_text())
    want = {
        "FSX_NUM_FEATURES": schema.NUM_FEATURES,
        "FSX_MAX_RULES": schema.MAX_RULES,
        "FSX_RULE_DROP": schema.RULE_DROP,
        "FSX_SHM_MAGIC": schema.SHM_MAGIC,
        "FSX_ML_BOUNDS_PER_FEATURE": schema.ML_BOUNDS_PER_FEATURE,
        **{f"FSX_FLAG_{n}": getattr(schema, f"FLAG_{n}")
           for n in ("IPV6", "TCP_SYN", "TCP", "UDP", "ICMP")},
        **{f"FSX_VERDICT_{v.name}": v.value for v in schema.Verdict},
        **{f"FSX_ML_BAND_{n}": getattr(schema, f"ML_BAND_{n}")
           for n in ("PASS", "ESCALATE", "DROP", "DISABLED")},
    }
    fails = []
    for name, val in want.items():
        got = defines.get(name)
        if got is None:
            fails.append(f"header lacks #define {name}")
        elif got != val:
            fails.append(f"#define {name} = {got} != schema {val}")
    return fails


def check_images(image_paths: dict | None = None) -> list[str]:
    """The sealed FSXPROG images under kern/build/ vs a fresh emit from
    the current assembler + map specs — the artifact the daemon actually
    loads is the one that goes stale silently.  Keys are ``(compact,
    ml)`` variant tuples; a bare bool means ``(compact, ml=False)``."""
    from flowsentryx_tpu_torch.bpf import image, verifier

    fails = []
    for key, path in (image_paths or IMAGE_PATHS).items():
        compact, ml = key if isinstance(key, tuple) else (key, False)
        tag = ("ml_" if ml else "") + ("compact" if compact else "raw48")
        flags = ("--compact " if compact else "") + ("--ml " if ml else "")
        if not path.exists():
            fails.append(f"{path}: missing ({tag} image; regenerate "
                         "with python -m flowsentryx_tpu_torch.bpf.image "
                         + flags.strip() + ")")
            continue
        try:
            want = image.emit(compact=compact, ml=ml)
        except verifier.StaticVerifierError as e:
            # emit() verifies before sealing; a generation bug must
            # surface as a contract failure, not crash the report
            # (the per-program half of fsx check carries the details)
            fails.append(f"{tag} image cannot be re-emitted: the "
                         f"current assembler output fails static "
                         f"verification ({str(e).splitlines()[0]})")
            continue
        if path.read_bytes() != want:
            fails.append(
                f"{path}: stale {tag} image — progs.py/map specs "
                "changed since it was sealed; regenerate with "
                "python -m flowsentryx_tpu_torch.bpf.image " + flags + str(path))
    return fails


def check_shm_layout(header_path: Path = HEADER_PATH) -> list[str]:
    """The shm transport control-field offsets: every Python-side
    constant the engine/ingest decoders mmap at must land inside the
    header struct and on a distinct u64."""
    fails = []
    hdr = schema.struct_layouts()["fsx_shm_ring_hdr"]
    named = {
        "SHM_CAPACITY_OFFSET": schema.SHM_CAPACITY_OFFSET,
        "SHM_RECORD_SIZE_OFFSET": schema.SHM_RECORD_SIZE_OFFSET,
        "SHM_HEAD_OFFSET": schema.SHM_HEAD_OFFSET,
        "SHM_TAIL_OFFSET": schema.SHM_TAIL_OFFSET,
        "SHM_HBEAT_OFFSET": schema.SHM_HBEAT_OFFSET,
        "SHM_FIRST_TS_OFFSET": schema.SHM_FIRST_TS_OFFSET,
        "SHM_T0_OFFSET": schema.SHM_T0_OFFSET,
        "SHM_STOP_OFFSET": schema.SHM_STOP_OFFSET,
        "SHM_WSTATE_OFFSET": schema.SHM_WSTATE_OFFSET,
        "SHM_EMIT_DROP_OFFSET": schema.SHM_EMIT_DROP_OFFSET,
    }
    seen: dict[int, str] = {0: "magic"}
    for name, off in named.items():
        if off % 8 or not 0 <= off < hdr.size:
            fails.append(f"schema.{name} = {off}: not a u64 slot inside "
                         f"the {hdr.size}-byte ring header")
        if off in seen:
            fails.append(f"schema.{name} = {off} collides with "
                         f"{seen[off]}")
        seen[off] = name
    if hdr.size != schema.SHM_HDR_SIZE:
        fails.append(f"fsx_shm_ring_hdr size {hdr.size} != "
                     f"schema.SHM_HDR_SIZE {schema.SHM_HDR_SIZE}")
    # the wire record sizes the ring headers advertise
    if schema.FLOW_RECORD_SIZE != schema.FLOW_RECORD_DTYPE.itemsize:
        fails.append("FLOW_RECORD_SIZE != FLOW_RECORD_DTYPE.itemsize")
    if schema.COMPACT_RECORD_SIZE != schema.COMPACT_RECORD_DTYPE.itemsize:
        fails.append("COMPACT_RECORD_SIZE != COMPACT_RECORD_DTYPE"
                     ".itemsize")
    if header_path.exists():
        structs, _ = parse_header(header_path.read_text())
        c_hdr = structs.get("fsx_shm_ring_hdr")
        if c_hdr is None:
            fails.append("header lacks struct fsx_shm_ring_hdr")
        else:
            for fname, off in (("head", schema.SHM_HEAD_OFFSET),
                               ("tail", schema.SHM_TAIL_OFFSET)):
                try:
                    c_off = c_hdr.offset_of(fname)
                except KeyError:
                    fails.append(f"fsx_shm_ring_hdr lacks {fname}")
                    continue
                if c_off != off:
                    fails.append(f"fsx_shm_ring_hdr.{fname}: C offset "
                                 f"{c_off} != python decoder's {off}")
    return fails


class ContractReport(NamedTuple):
    """Aggregated ``fsx check`` contract result."""

    ok: bool
    checks: dict[str, list[str]]  # check name -> failures ([] = clean)

    @property
    def failures(self) -> list[str]:
        return [f"{name}: {msg}" for name, msgs in self.checks.items()
                for msg in msgs]

    def to_json(self) -> dict:
        return {
            "ok": self.ok,
            "checks": {n: {"ok": not msgs, "failures": msgs}
                       for n, msgs in self.checks.items()},
        }


def run_all(*, header_path: Path = HEADER_PATH,
            image_paths: dict[bool, Path] | None = None,
            with_images: bool = True) -> ContractReport:
    """Run every cross-layer contract check; see module docstring."""
    checks = {
        "header_fresh": check_header_fresh(header_path),
        "header_layouts": check_header_layouts(header_path),
        "header_defines": check_header_defines(header_path),
        "progs_offsets": check_progs_offsets(),
        "map_specs": check_map_specs(),
        "shm_layout": check_shm_layout(header_path),
    }
    if with_images:
        checks["images"] = check_images(image_paths)
    return ContractReport(
        ok=not any(checks.values()), checks=checks)
