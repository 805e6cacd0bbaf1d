"""Generate ``kern/fsx_schema.h`` from the port's schemas.

Counterpart of ``flowsentryx_tpu/core/codegen.py``: the C header that the
daemon, the kernel's C twin and the eBPF programs share is generated from
:mod:`flowsentryx_tpu_torch.core.wire` (the kernel plane's structs) and
:mod:`flowsentryx_tpu_torch.core.config` (``struct fsx_config``), and is
byte-equal to the checked-in header and to the reference's output.

Run ``python -m flowsentryx_tpu_torch.core.codegen [out_path]`` or ``fsx
codegen [OUT]`` to write it (the default path is ``kern/fsx_schema.h``).
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

# the kernel plane's structs live in the schema's numpy half (wire.py)
from flowsentryx_tpu_torch.core import wire as schema
from flowsentryx_tpu_torch.core.config import FsxConfig, TableConfig

_C_TYPES = {
    "u64": "__u64",
    "u32": "__u32",
    "u16": "__u16",
    "u8": "__u8",
}

#: The header's text is the checked-in ``kern/fsx_schema.h`` byte for
#: byte, which both packages generate: its comments name the module that
#: first generated it.
HEADER_TOP = """\
/* fsx_schema.h — GENERATED by flowsentryx_tpu.core.codegen. DO NOT EDIT.
 *
 * Shared kernel/user data layout, successor of the reference's
 * hand-written src/fsx_struct.h.  Regenerate with:
 *     python -m flowsentryx_tpu.core.codegen
 */
#ifndef FSX_SCHEMA_H
#define FSX_SCHEMA_H

#if defined(__bpf__) || defined(__linux__)
#include <linux/types.h>
#else
#include <stdint.h>
typedef uint64_t __u64;
typedef uint32_t __u32;
typedef uint16_t __u16;
typedef uint8_t __u8;
#endif
"""

HEADER_BOTTOM = """\
#endif /* FSX_SCHEMA_H */
"""


_RECORD_FIELD_COMMENTS = {
    "ts_ns": "bpf_ktime_get_ns() at packet arrival",
    "saddr": "IPv4 source, or 32-bit fold of IPv6",
    "pkt_len": "wire length of this packet",
    "ip_proto": "IPPROTO_*",
    "flags": "FSX_FLAG_* bits",
    "feat": "integer feature estimates (no FPU in eBPF; host casts to f32)",
}

_NP_TO_C = {
    np.dtype("<u8"): "__u64",
    np.dtype("<u4"): "__u32",
    np.dtype("<u2"): "__u16",
    np.dtype("u1"): "__u8",
    np.dtype("<f4"): "float",
}


def _flow_record_struct() -> str:
    """Emit ``struct fsx_flow_record`` directly from FLOW_RECORD_DTYPE
    so the C wire format cannot drift from the Python decoder."""
    lines = [
        "/* One feature-ring entry: kernel -> user wire format.",
        " * GENERATED from flowsentryx_tpu.core.schema.FLOW_RECORD_DTYPE"
        " (packed, %d bytes). */" % schema.FLOW_RECORD_SIZE,
        "struct fsx_flow_record {",
    ]
    for name in schema.FLOW_RECORD_DTYPE.names:
        dt, _ = schema.FLOW_RECORD_DTYPE.fields[name][:2]
        if dt.subdtype is not None:
            base, shape = dt.subdtype
            decl = f"{_NP_TO_C[base]} {name}[{shape[0]}]"
        else:
            decl = f"{_NP_TO_C[dt]} {name}"
        lines.append(f"\t{decl}; /* {_RECORD_FIELD_COMMENTS[name]} */")
    lines.append("} __attribute__((packed));")
    return "\n".join(lines)


def _fields_struct(
    cname: str, fields: tuple[tuple[str, str], ...], comment: list[str]
) -> str:
    lines = ["/* " + comment[0]] + [" * " + c for c in comment[1:]] + [" */"]
    lines.append(f"struct {cname} {{")
    for name, tp in fields:
        lines.append(f"\t{_C_TYPES[tp]} {name};")
    lines.append("} __attribute__((packed));")
    return "\n".join(lines)


def _flow_stats_struct() -> str:
    return _fields_struct(
        "fsx_flow_stats",
        schema.FLOW_STATS_FIELDS,
        [
            "Streaming per-flow statistics kept in the kernel to derive the",
            "8 model features online (train/serve skew fix; the reference's",
            "in-kernel plan stopped at a comment block, fsx_kern_ml.c:1-17).",
            "GENERATED from schema.FLOW_STATS_FIELDS.",
        ],
    )


def generate() -> str:
    parts = [HEADER_TOP]

    parts.append("/* ---- sizing ---- */")
    parts.append("#define FSX_NUM_FEATURES %d" % schema.NUM_FEATURES)
    parts.append("#define FSX_MAX_TRACK_IPS %d  /* = TableConfig.capacity default;"
                 " supersedes fsx_struct.h:7 (100000) */" % TableConfig().capacity)
    parts.append("#define FSX_RING_SIZE (1 << 22)    /* feature ringbuf bytes, per CPU */")
    parts.append("")

    parts.append("/* ---- record flags ---- */")
    for name in ("IPV6", "TCP_SYN", "TCP", "UDP", "ICMP"):
        parts.append("#define FSX_FLAG_%s %d" % (name, getattr(schema, f"FLAG_{name}")))
    parts.append("")

    parts.append("/* ---- verdict codes (drop-cause attribution) ---- */")
    for v in schema.Verdict:
        parts.append("#define FSX_VERDICT_%s %d" % (v.name, v.value))
    parts.append("")

    parts.append("/* ---- kernel-distilled classifier bands (fsx distill;"
                 " two-tier escalation) ---- */")
    parts.append("#define FSX_ML_BOUNDS_PER_FEATURE %d"
                 % schema.ML_BOUNDS_PER_FEATURE)
    for name in ("PASS", "ESCALATE", "DROP", "DISABLED"):
        parts.append("#define FSX_ML_BAND_%s %d"
                     % (name, getattr(schema, f"ML_BAND_{name}")))
    parts.append("")

    parts.append("/* ---- limiter kinds (config map) ---- */")
    parts.append("#define FSX_LIMITER_FIXED_WINDOW 0")
    parts.append("#define FSX_LIMITER_SLIDING_WINDOW 1")
    parts.append("#define FSX_LIMITER_TOKEN_BUCKET 2")
    parts.append("")
    parts.append("/* Stateless firewall rules (reference README.md:70-74"
                 " planned firewall): */")
    parts.append("/* rule_map key = (l4_proto << 16) | dport (host order,"
                 " 0 = wildcard) */")
    parts.append("#define FSX_MAX_RULES %d" % schema.MAX_RULES)
    parts.append("#define FSX_RULE_DROP %d" % schema.RULE_DROP)
    parts.append("")

    parts.append(_flow_record_struct())
    parts.append("")
    parts.append("""\
/* One COMPACT feature-ring entry (16 B): the kernel-quantized twin of
 * fsx_flow_record for deployments built with FSX_EMIT_COMPACT — 3x
 * less ring/wire traffic.  GENERATED from the layout in
 * flowsentryx_tpu.core.schema (encode_compact):
 *   w0  folded source address
 *   w1  feat[0..3] as u8 e5m3 minifloat (fsx_minifloat8)
 *   w2  feat[4..7] likewise
 *   w3  bits 0-10  pkt_len in 8-byte units (round-to-nearest, sat)
 *       bits 11-15 FSX_FLAG_* bits
 *       bits 16-31 (ktime_ns/1000) & 0xFFFF — the host unwraps this
 *                  against its own MONOTONIC clock; valid while drain
 *                  latency stays under 65 ms (ring sizing enforces) */
struct fsx_compact_record {
	__u32 w0_saddr;
	__u32 w1_feat_lo;
	__u32 w2_feat_hi;
	__u32 w3_len_flags_ts;
} __attribute__((packed));""")
    parts.append("")
    parts.append(_flow_stats_struct())
    parts.append("")

    cfg_lines = [
        "/* Runtime policy, pushed by user space into the config array map",
        " * (index 0).  Replaces the reference's compile-time constants",
        " * (fsx_kern.c:308-310).  GENERATED from",
        " * flowsentryx_tpu.core.config.FsxConfig.KERNEL_CONFIG_FIELDS. */",
        "struct fsx_config {",
    ]
    for name, tp, comment in FsxConfig.KERNEL_CONFIG_FIELDS:
        c = f" /* {comment} */" if comment else ""
        cfg_lines.append(f"\t{_C_TYPES[tp]} {name};{c}")
    cfg_lines.append("} __attribute__((packed));")
    parts.append("\n".join(cfg_lines))
    parts.append("")

    parts.append(_fields_struct(
        "fsx_ip_state",
        schema.IP_STATE_FIELDS,
        [
            "Per-source-IP fast-path counters (successor of struct ip_stats,",
            "fsx_struct.h:17-22, extended with sliding-window + token-bucket",
            "state, README.md:153-162).  tokens_milli = tokens * 1000",
            "(no floats in eBPF).  GENERATED from schema.IP_STATE_FIELDS.",
        ],
    ))
    parts.append("")
    parts.append(
        """\
/* ---- shared-memory rings (daemon <-> engine transport) ----
 * SPSC ring in a file-backed mmap: this header, then `capacity`
 * fixed-size records.  head/tail are monotonic record counts (mod
 * capacity for the slot), each on its own cache line.  GENERATED from
 * schema.SHM_* constants. */
#define FSX_SHM_MAGIC 0x%XULL
struct fsx_shm_ring_hdr {
	__u64 magic;
	__u64 capacity;      /* record slots, power of two */
	__u64 record_size;   /* bytes per record */
	__u64 _meta_pad[5];
	__u64 head;          /* producer cursor (total records written) */
	__u64 _head_pad[7];
	__u64 tail;          /* consumer cursor (total records read) */
	__u64 _tail_pad[7];
} __attribute__((packed));

/* One verdict-ring entry (engine -> daemon): newly blacklisted source.
 * GENERATED from schema.VERDICT_RECORD_DTYPE (%d bytes). */
struct fsx_verdict_record {
	__u32 saddr;         /* folded source address */
	__u32 _pad;
	__u64 until_ns;      /* blacklist expiry, kernel clock ns */
} __attribute__((packed));
"""
        % (schema.SHM_MAGIC, schema.VERDICT_RECORD_SIZE)
    )

    parts.append(_fields_struct(
        "fsx_stats",
        schema.KERNEL_STATS_FIELDS,
        [
            "Global counters (successor of struct stats, fsx_struct.h:11-15),",
            "kept in a PER_CPU array so increments are race-free; user space",
            "aggregates (the improvement proposed at fsx_kern.c:253-257).",
            "ml_pass/ml_escalated are the kernel-tier classifier's band",
            "counters (dropped_ml carries its drop band).",
            "GENERATED from schema.KERNEL_STATS_FIELDS.",
        ],
    ))
    parts.append("")

    parts.append("""\
/* Kernel-distilled int8 classifier (flowsentryx_tpu/distill/): the
 * hot-swappable value of ml_model_map.  fn_ml_score (bpf/progs.py,
 * ml=True images) computes q_i = qbase[i] + |{r : x_i > bounds_m1[i][r]}|
 * and s = sum w[i]*q[i], then bands s against acc_drop/acc_pass (s64,
 * input zero-point pre-folded by the distiller).  Boundaries are exact
 * u32 images of the engine's f32 input observer, so the kernel verdict
 * is bit-exact with the TPU int8 lane.  GENERATED from
 * flowsentryx_tpu.core.schema.ML_MODEL_* offsets. */
struct fsx_ml_model {
	__u32 valid;         /* nonzero once a model is pushed; 0 = stage off */
	__u32 _reserved;
	__u64 acc_drop;      /* s64: s >= acc_drop -> blacklist + drop */
	__u64 acc_pass;      /* s64: s <= acc_pass -> pass, emit suppressed */
	__u32 w[%d];          /* s32 weights (int8-valued, two's complement) */
	__u32 qbase[%d];      /* q_i(0) */
	__u32 bounds_m1[%d]; /* per-feature sorted boundaries - 1, 0xFFFFFFFF pad */
} __attribute__((packed));""" % (
        schema.NUM_FEATURES, schema.NUM_FEATURES,
        schema.NUM_FEATURES * schema.ML_BOUNDS_PER_FEATURE))
    parts.append("")

    parts.append(HEADER_BOTTOM)
    return "\n".join(parts)


DEFAULT_OUT = Path(__file__).resolve().parents[2] / "kern" / "fsx_schema.h"


def write_header(out: Path | None = None) -> Path:
    """Write the generated header (single write path for CLI + module)."""
    out = Path(out) if out else DEFAULT_OUT
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(generate())
    return out


def main(argv: list[str]) -> None:
    out = write_header(Path(argv[1]) if len(argv) > 1 else None)
    print(f"wrote {out}")


if __name__ == "__main__":
    main(sys.argv)
