"""The eBPF plane's verbs of ``python -m flowsentryx_tpu_torch.cli``:
``codegen``, ``config``, ``check``, ``block``, ``unblock``,
``blacklist``, ``rules``, ``top``, and the pinned-map read
(:func:`read_kernel`) behind ``status --pin`` and ``monitor --pin``.

Counterpart of the same verbs of the reference's ``fsx`` command line,
with its flags, output and exit codes.  They run on the host: the
programs and maps live in the Linux kernel, not on the card, so none of
them takes ``--device``.  ``codegen``, ``check`` and ``config`` without
``--pin`` need no kernel; the others read or write the maps a live
``fsxd --bpf --pin DIR`` deployment pins under a bpffs directory
(default ``/sys/fs/bpf/fsx``), through ``bpf(2)``
(:mod:`flowsentryx_tpu_torch.bpf.loader`).  This module imports neither
torch nor the loader until a verb runs, so building the parser stays
cheap.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

#: The bpffs directory ``fsxd --pin`` pins its maps under by default.
DEFAULT_PIN_DIR = "/sys/fs/bpf/fsx"

_STRUCT_CH = {"u64": "Q", "u32": "I", "u16": "H", "u8": "B"}


def _fmt(fields) -> str:
    return "<" + "".join(_STRUCT_CH[t] for _, t in fields)


# ---------------------------------------------------------------------------
# codegen, config, check (no kernel needed unless --pin)
# ---------------------------------------------------------------------------


def cmd_codegen(args: argparse.Namespace) -> int:
    from flowsentryx_tpu_torch.core import codegen

    print(f"wrote {codegen.write_header(args.out)}")
    return 0


#: ``config --set`` fields: the runtime-tunable limiter policy.  ``valid``
#: (daemon lifecycle), ``rule_count`` (owned by ``rules``) and
#: ``hash_salt`` (fixed at serve boot: changing it live would strand
#: every engine table row) are not settable.
_CONFIG_SETTABLE = {
    "limiter_kind", "pps_threshold", "bps_threshold", "window_ns",
    "block_ns", "bucket_rate_pps", "bucket_burst", "bucket_rate_bps",
    "bucket_burst_bytes",
}


def _limiter_codes() -> dict:
    """CLI short name -> wire code ("fixed_window" -> "fixed" ...), from
    ``FsxConfig._KIND_CODE`` so that a new limiter kind appears here."""
    from flowsentryx_tpu_torch.core.config import FsxConfig

    return {k.value.split("_")[0]: code
            for k, code in FsxConfig._KIND_CODE.items()}


def _validate_kernel_config(vals: dict) -> str | None:
    """The range checks of ``FsxConfig``'s validation: the live path
    admits no policy the offline path forbids."""
    if vals["limiter_kind"] not in set(_limiter_codes().values()):
        return f"limiter_kind {vals['limiter_kind']} unknown"
    if vals["window_ns"] <= 0 or vals["block_ns"] <= 0:
        return "window and block durations must be positive"
    for f in ("pps_threshold", "bps_threshold", "bucket_rate_pps",
              "bucket_burst", "bucket_rate_bps", "bucket_burst_bytes"):
        if not 0 <= vals[f] < 1 << 64:
            return f"{f} must be a u64 (got {vals[f]})"
    if (vals["bucket_rate_bps"] == 0) != (vals["bucket_burst_bytes"] == 0):
        return ("bucket_rate_bps and bucket_burst_bytes must be both "
                "zero or both positive")
    return None


def cmd_config(args: argparse.Namespace) -> int:
    """Show or pack a config, or with ``--pin`` read and live-update the
    kernel's config map (the program re-reads it per packet: an update
    takes effect on the next packet, with no reload)."""
    from flowsentryx_tpu_torch.core.config import DEFAULT_CONFIG, FsxConfig

    if args.pin:
        from flowsentryx_tpu_torch.bpf import rules as fsx_rules

        if args.pack:
            print("fsx config: --pack reads a config FILE; it does not "
                  "combine with --pin", file=sys.stderr)
            return 1
        kinds = _limiter_codes()
        # parse every --set before touching the map: an error in the
        # middle of config_map_edit would publish half a config
        pending: dict = {}
        for spec in args.set or ():
            field, eq, raw = spec.partition("=")
            if not eq:
                print(f"fsx config: --set wants FIELD=VALUE, got "
                      f"{spec!r}", file=sys.stderr)
                return 1
            mult = 1.0
            if field in ("window_s", "block_s"):
                field = field[:-2] + "_ns"
                mult = 1e9
            if field not in _CONFIG_SETTABLE:
                print(f"fsx config: field {field!r} is not "
                      f"runtime-settable (choose from "
                      f"{sorted(_CONFIG_SETTABLE)})", file=sys.stderr)
                return 1
            if field == "limiter_kind" and raw in kinds:
                pending[field] = kinds[raw]
            else:
                try:
                    pending[field] = int(float(raw) * mult)
                except ValueError:
                    print(f"fsx config: {field} value {raw!r} is not "
                          f"a number", file=sys.stderr)
                    return 1
        try:
            with fsx_rules.config_map_edit(args.pin) as vals:
                vals.update(pending)
                if pending:
                    err = _validate_kernel_config(vals)
                    if err:
                        # raising skips config_map_edit's write-back
                        raise ValueError(err)
                shown = dict(vals)
        except ValueError as e:
            print(f"fsx config: rejected: {e}", file=sys.stderr)
            return 1
        except (OSError, RuntimeError) as e:
            print(f"fsx config: cannot read config_map under "
                  f"{args.pin}: {e}", file=sys.stderr)
            return 1
        shown["window_s"] = shown["window_ns"] / 1e9
        shown["block_s"] = shown["block_ns"] / 1e9
        print(json.dumps({"pin": args.pin, "updated": bool(args.set),
                          "kernel_config": shown}, indent=2))
        return 0

    if args.set:
        print("fsx config: --set requires --pin (live kernel update)",
              file=sys.stderr)
        return 1
    cfg = (FsxConfig.from_json(Path(args.file).read_text()) if args.file
           else DEFAULT_CONFIG)
    if args.pack:
        sys.stdout.buffer.write(cfg.pack_kernel_config())
    else:
        print(cfg.to_json())
    return 0


def cmd_check(args: argparse.Namespace) -> int:
    """Static verification of the data plane, no kernel needed: every
    program (the four variants and any ``--image``) through the in-repo
    verifier, then the cross-layer contracts (schema, the generated
    header, the offsets baked into the bytecode, the sealed images).
    Exit 0 only when everything agrees; a rejection names the
    instruction, its disassembly and the abstract register file."""
    import struct as _struct

    from flowsentryx_tpu_torch.bpf import contracts, image, progs, verifier

    out: dict = {"programs": [], "ok": True}
    jobs: list[tuple[str, object]] = [
        ("fsx[raw48]", lambda: progs.build()),
        ("fsx[compact16]", lambda: progs.build(compact=True)),
        ("fsx[ml_raw48]", lambda: progs.build(ml=True)),
        ("fsx[ml_compact16]", lambda: progs.build(compact=True, ml=True)),
    ]
    for path in args.image or ():
        def _from_image(p: str = path):
            prog, maps = image.to_program(Path(p).read_bytes(), name=p)
            infos = {m.name: verifier.MapInfo(m.name, m.map_type,
                                              m.key_size, m.value_size)
                     for m in maps}
            return prog, infos
        jobs.append((path, _from_image))

    for name, build in jobs:
        try:
            built = build()
            prog, infos = built if isinstance(built, tuple) else (built,
                                                                  None)
            if infos is None:
                rep = verifier.check_program_cached(prog,
                                                    budget=args.budget)
            else:
                rep = verifier.check_program(prog, infos, name=name,
                                             budget=args.budget)
            out["programs"].append({"ok": True, **rep.to_json(),
                                    "program": name})
            if not args.json:
                print(f"fsx check: {name}: OK ({rep.n_insns} insns, "
                      f"{rep.insns_visited} states explored)")
        except (verifier.StaticVerifierError, OSError, ValueError,
                _struct.error) as e:
            out["ok"] = False
            entry = {"ok": False, "program": name, "error": str(e)}
            if isinstance(e, verifier.StaticVerifierError):
                entry.update(insn=e.insn_idx, insn_txt=e.insn_txt,
                             reason=e.reason, state=e.state_dump)
            out["programs"].append(entry)
            if not args.json:
                print(f"fsx check: {name}: REJECTED\n  {e}",
                      file=sys.stderr)

    crep = contracts.run_all(with_images=not args.no_images)
    out["contracts"] = crep.to_json()
    out["ok"] = out["ok"] and crep.ok
    if not args.json:
        for cname, msgs in crep.checks.items():
            if msgs:
                print(f"fsx check: contract {cname}: FAILED",
                      file=sys.stderr)
                for msg in msgs:
                    print(f"  {msg}", file=sys.stderr)
            else:
                print(f"fsx check: contract {cname}: OK")
        print(f"fsx check: {'PASS' if out['ok'] else 'FAIL'}")
    else:
        print(json.dumps(out, indent=2))
    return 0 if out["ok"] else 1


# ---------------------------------------------------------------------------
# The pinned maps
# ---------------------------------------------------------------------------


def cmd_block(args: argparse.Namespace) -> int:
    """Blacklist a source by hand.  A v6 address blocks exactly (the
    16-byte ``blacklist_v6``), never by its 32-bit fold."""
    from flowsentryx_tpu_torch.bpf import blacklist

    m = blacklist.open_map_for(args.ip, args.pin)
    try:
        e = blacklist.block(m, args.ip, ttl_s=args.ttl)
        print(json.dumps({"blocked": args.ip, **e.to_json()}))
    finally:
        m.close()
    return 0


def cmd_unblock(args: argparse.Namespace) -> int:
    from flowsentryx_tpu_torch.bpf import blacklist

    m = blacklist.open_map_for(args.ip, args.pin)
    try:
        removed = blacklist.unblock(m, args.ip)
        print(json.dumps({"unblocked": args.ip, "was_present": removed}))
    finally:
        m.close()
    return 0 if removed else 1


def cmd_blacklist(args: argparse.Namespace) -> int:
    """Print (or ``--clear``) the live blacklist, both maps."""
    from flowsentryx_tpu_torch.bpf import blacklist

    m = blacklist.open_map(args.pin)
    try:
        m6 = blacklist.open_v6_map(args.pin)
    except OSError:
        m6 = None  # a pin dir of an image without the v6 map
    try:
        if args.clear:
            n = blacklist.clear(m) + (blacklist.clear(m6) if m6 else 0)
            print(json.dumps({"cleared": n}))
            return 0
        entries = [e.to_json() for e in blacklist.entries(m)]
        if m6 is not None:
            entries += [e.to_json() for e in blacklist.entries(m6)]
        if args.json:
            print(json.dumps({"entries": entries}))
        else:
            print(f"{'key':>10}  {'source':>40}  remaining")
            for e in entries:
                src = e.get("addr") or e.get("v4")
                key = "exact-v6" if e.get("exact") else e["key"]
                print(f"{key:>10}  {src:>40}  {e['remaining_s']:.1f}s")
            print(f"{len(entries)} entr{'y' if len(entries) == 1 else 'ies'}")
    finally:
        m.close()
        if m6 is not None:
            m6.close()
    return 0


def cmd_rules(args: argparse.Namespace) -> int:
    """List, add or remove live stateless-firewall rules (per-IP
    blocks are ``block``'s)."""
    from flowsentryx_tpu_torch.bpf import rules

    m = rules.open_map(args.pin)
    try:
        if args.add:
            # validate the spec first (nothing touched on bad input),
            # raise the kernel's gate (fails cleanly when no config was
            # pushed yet), insert, then set the gate to the map's real
            # count, also after a failed insert
            try:
                rule = rules.parse_spec(args.add)
                rules.set_enabled(args.pin, len(rules.entries(m)) + 1)
                try:
                    r = rules.add(m, rule)
                finally:
                    rules.set_enabled(args.pin, len(rules.entries(m)))
            except (ValueError, RuntimeError, OSError) as e:
                raise SystemExit(f"fsx rules: {e}") from None
            print(json.dumps({"added": r.to_json()}))
            return 0
        if args.remove:
            try:
                ok = rules.remove(m, rules.parse_spec(args.remove))
                rules.set_enabled(args.pin, len(rules.entries(m)))
            except (ValueError, RuntimeError, OSError) as e:
                raise SystemExit(f"fsx rules: {e}") from None
            print(json.dumps({"removed": bool(ok)}))
            return 0
        ents = [r.to_json() for r in rules.entries(m)]
        if args.json:
            print(json.dumps({"entries": ents}))
        else:
            print(f"{'proto':>8}  {'dport':>6}  action")
            for e in ents:
                print(f"{e['proto']:>8}  {e['dport']:>6}  {e['action']}")
            print(f"{len(ents)} rule{'' if len(ents) == 1 else 's'}")
    finally:
        m.close()
    return 0


def read_kernel(pin: str) -> dict:
    """The kernel's counters (summed over CPUs) and the blacklist size
    off a bpffs pin dir, for ``status --pin`` and each ``monitor`` tick.
    The layout comes from the schema the C struct is generated from.
    A map that cannot be read gives ``{"error": ...}`` in its place."""
    import struct as _struct

    from flowsentryx_tpu_torch.bpf import blacklist, loader
    from flowsentryx_tpu_torch.core import wire

    names = [n for n, _ in wire.KERNEL_STATS_FIELDS]
    fmt = _fmt(wire.KERNEL_STATS_FIELDS)
    kern: dict = {}
    # close every map on every path: monitor calls this in an unbounded
    # loop, and a leaked fd per tick ends in EMFILE
    m = None
    try:
        fd = loader.obj_get(f"{pin}/stats_map")
        m = loader.Map(fd, loader.MAP_TYPE_PERCPU_ARRAY, 4,
                       _struct.calcsize(fmt), 1, "stats_map")
        tot = [0] * len(names)
        for v in m.lookup_percpu(b"\x00\x00\x00\x00"):
            for i, x in enumerate(_struct.unpack(fmt, v)):
                tot[i] += x
        kern["stats"] = dict(zip(names, tot))
    except OSError as e:
        kern["stats"] = {"error": str(e)}
    finally:
        if m is not None:
            m.close()
    # v6 blocks live only in the exact v6 map; an image without it has
    # no such pinned map and counts 0 there
    n = 0
    err = None
    for i, opener in enumerate((blacklist.open_map,
                                blacklist.open_v6_map)):
        bm = None
        try:
            bm = opener(pin)
            n += len(blacklist.entries(bm))
        except OSError as e:
            if i == 0:
                err = e
        finally:
            if bm is not None:
                bm.close()
    kern["blacklist_entries"] = n if err is None else {"error": str(err)}
    return kern


def kernel_alerts(args: argparse.Namespace, rec: dict, stats: dict,
                  prev: dict | None, dt: float) -> list[str]:
    """``monitor``'s two kernel-map alerts of one record, and its
    ``per_s`` deltas (set on ``rec`` when there is a previous tick)."""
    alerts = []
    if prev is not None and "error" not in stats:
        rec["per_s"] = {k: round((stats[k] - prev.get(k, 0)) / dt, 1)
                        for k in stats}
        drop_pps = sum(rec["per_s"].get(k, 0) for k in (
            "dropped_blacklist", "dropped_rate", "dropped_ml",
            "dropped_rule"))
        if args.alert_drop_pps and drop_pps >= args.alert_drop_pps:
            alerts.append(f"drop rate {drop_pps:.0f} pps >= "
                          f"{args.alert_drop_pps}")
    # an absolute gauge: it fires on a first tick too
    nbl = rec["kernel"].get("blacklist_entries", 0)
    if (args.alert_blacklist and isinstance(nbl, int)
            and nbl >= args.alert_blacklist):
        alerts.append(f"blacklist size {nbl} >= {args.alert_blacklist}")
    return alerts


def cmd_top(args: argparse.Namespace) -> int:
    """The kernel's per-flow table, formatted: the pinned LRU maps read
    through ``bpf(2)``, no daemon cooperation.  Flow keys are ``saddr ^
    (dport << 16)``; the stored ``dst_port`` recovers saddr.  A v6 flow
    is keyed by its source's 32-bit fold, which is not invertible: its
    row shows the fold in dotted-quad form."""
    import socket as _socket
    import struct as _struct

    from flowsentryx_tpu_torch.bpf import blacklist, loader
    from flowsentryx_tpu_torch.core import wire

    fs_names = [n for n, _ in wire.FLOW_STATS_FIELDS]
    fs_fmt = _fmt(wire.FLOW_STATS_FIELDS)
    ip_names = [n for n, _ in wire.IP_STATE_FIELDS]
    ip_fmt = _fmt(wire.IP_STATE_FIELDS)

    # both blacklist maps (entries() keys an exact-v6 row by its fold,
    # which is how v6 flows key flow_stats)
    blocked: dict[int, float] = {}
    for opener in (blacklist.open_map, blacklist.open_v6_map):
        try:
            m = opener(args.pin)
            for e in blacklist.entries(m):
                blocked[e.key] = e.remaining_s
            m.close()
        except OSError:
            pass  # not pinned (before attach, or an older image)

    rows = []
    try:
        fd = loader.obj_get(f"{args.pin}/flow_stats_map")
    except OSError as e:
        print(f"fsx top: no flow_stats_map pinned under {args.pin}: {e}",
              file=sys.stderr)
        return 1
    m = loader.Map(fd, loader.MAP_TYPE_LRU_HASH, 4,
                   _struct.calcsize(fs_fmt), 0, "flow_stats_map")
    for kb in m.keys():
        vb = m.lookup(kb)
        if vb is None:
            continue  # raced an LRU eviction
        (fkey,) = _struct.unpack("<I", kb)
        d = dict(zip(fs_names, _struct.unpack(fs_fmt, vb)))
        # dst_port is stored in host order; the flow key XORed the
        # network-order dport, so swap back to recover saddr
        dport_net = _socket.htons(d["dst_port"])
        saddr = fkey ^ ((dport_net << 16) & 0xFFFFFFFF)
        pkts = d["pkt_count"]
        dur_s = max(d["last_ts_ns"] - d["first_ts_ns"], 0) / 1e9
        rows.append({
            "ip": _socket.inet_ntoa(_struct.pack("<I", saddr)),
            "_saddr": saddr,
            "dport": d["dst_port"],
            "pkts": pkts,
            "bytes": d["byte_sum"],
            "len_mean": round(d["byte_sum"] / pkts, 1) if pkts else 0.0,
            "dur_s": round(dur_s, 3),
            "pps": round(pkts / dur_s, 1) if dur_s > 0 else float(pkts),
            "iat_mean_us": (round(d["iat_sum_ns"] / (pkts - 1) / 1e3, 1)
                            if pkts > 1 else 0.0),
            "iat_max_ms": round(d["iat_max_ns"] / 1e6, 3),
            "win_pps": 0,
            "win_bps": 0,
            "blocked_s": round(blocked.get(saddr, 0.0), 1),
        })
    m.close()
    rows.sort(key=lambda r: -r["pkts"])
    rows = rows[: args.n]

    # limiter state only for the rows shown: N point lookups, not a walk
    # of a million-entry map
    try:
        fd = loader.obj_get(f"{args.pin}/ip_state_map")
        m = loader.Map(fd, loader.MAP_TYPE_LRU_HASH, 4,
                       _struct.calcsize(ip_fmt), 0, "ip_state_map")
        for r in rows:
            vb = m.lookup(_struct.pack("<I", r["_saddr"]))
            if vb is not None:
                st = dict(zip(ip_names, _struct.unpack(ip_fmt, vb)))
                r["win_pps"] = st["win_pps"]
                r["win_bps"] = st["win_bps"]
        m.close()
    except OSError:
        pass
    for r in rows:
        del r["_saddr"]
    if args.json:
        print(json.dumps({"flows": rows, "n_blocked": len(blocked)},
                         indent=2))
        return 0
    cols = ("ip", "dport", "pkts", "bytes", "len_mean", "dur_s", "pps",
            "iat_mean_us", "iat_max_ms", "win_pps", "blocked_s")
    widths = {c: max(len(c), *(len(str(r[c])) for r in rows), 1)
              for c in cols}
    print("  ".join(c.rjust(widths[c]) for c in cols))
    for r in rows:
        print("  ".join(str(r[c]).rjust(widths[c]) for c in cols))
    print(f"{len(rows)} flow(s) shown; {len(blocked)} source(s) "
          "blacklisted")
    return 0


# ---------------------------------------------------------------------------
# Parser
# ---------------------------------------------------------------------------


def add_parsers(sub) -> None:
    """The verbs of this module on the command line's subparsers."""
    g = sub.add_parser("codegen",
                       help="regenerate kern/fsx_schema.h from the schemas")
    g.add_argument("--out", help="output path (default: kern/fsx_schema.h)")
    g.set_defaults(fn=cmd_codegen)

    c = sub.add_parser("config", help="show or pack the active config")
    c.add_argument("--file",
                   help="JSON config file (default: built-in defaults)")
    c.add_argument("--pack", action="store_true",
                   help="emit the binary kernel config-map blob to stdout")
    c.add_argument("--pin",
                   help="read (and with --set, live-update) the kernel "
                        "config map off this bpffs pin dir")
    c.add_argument("--set", action="append", metavar="FIELD=VALUE",
                   help="update a limiter field in the pinned kernel "
                        "config (repeatable; e.g. pps_threshold=5000, "
                        "window_s=2, limiter_kind=token); takes effect "
                        "on the next packet")
    c.set_defaults(fn=cmd_config)

    ck = sub.add_parser(
        "check",
        help="statically verify the BPF fast path and the cross-layer "
             "schema contracts (no kernel needed)")
    ck.add_argument("--image", action="append", metavar="PATH",
                    help="also verify this sealed FSXPROG image "
                         "(repeatable)")
    ck.add_argument("--no-images", action="store_true",
                    help="skip the checked-in kern/build image "
                         "freshness contract")
    ck.add_argument("--budget", type=int, default=1_000_000,
                    help="verifier state budget per program (the "
                         "kernel's 1M-insn analysis cap)")
    ck.add_argument("--json", action="store_true",
                    help="machine-readable report")
    ck.set_defaults(fn=cmd_check)

    blk = sub.add_parser("block", help="manually blacklist a source IP")
    blk.add_argument("ip", help="IPv4 or IPv6 address")
    blk.add_argument("--ttl", type=float, default=10.0,
                     help="seconds until expiry (default 10, as the "
                          "kernel's rate-limit blocks)")
    blk.add_argument("--pin", default=DEFAULT_PIN_DIR,
                     help=f"bpffs pin dir (default {DEFAULT_PIN_DIR})")
    blk.set_defaults(fn=cmd_block)

    ublk = sub.add_parser("unblock",
                          help="remove a source from the blacklist")
    ublk.add_argument("ip")
    ublk.add_argument("--pin", default=DEFAULT_PIN_DIR)
    ublk.set_defaults(fn=cmd_unblock)

    bl = sub.add_parser("blacklist",
                        help="show or clear the live blacklist")
    bl.add_argument("--pin", default=DEFAULT_PIN_DIR)
    bl.add_argument("--json", action="store_true")
    bl.add_argument("--clear", action="store_true",
                    help="delete every entry")
    bl.set_defaults(fn=cmd_blacklist)

    ru = sub.add_parser("rules",
                        help="list/add/remove stateless firewall rules")
    ru.add_argument("--pin", default=DEFAULT_PIN_DIR)
    ru.add_argument("--json", action="store_true")
    ru.add_argument("--add", metavar="PROTO:DPORT",
                    help="insert a drop rule (proto any/tcp/udp/icmp[v6]"
                         "/number; dport 0 = any)")
    ru.add_argument("--remove", metavar="PROTO:DPORT")
    ru.set_defaults(fn=cmd_rules)

    tp = sub.add_parser("top", help="per-IP kernel table, formatted")
    tp.add_argument("--pin", default=DEFAULT_PIN_DIR,
                    help="bpffs pin dir of a live fsxd deployment")
    tp.add_argument("-n", type=int, default=20, help="show top N flows")
    tp.add_argument("--json", action="store_true")
    tp.set_defaults(fn=cmd_top)
