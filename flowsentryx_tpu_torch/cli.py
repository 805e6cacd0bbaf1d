"""Command line of the port: ``python -m flowsentryx_tpu_torch.cli serve``,
``... cli pcap``, ``... cli train``, ``... cli distill``, ``... cli
cluster``, ``... cli status``, ``... cli monitor``, ``... cli bench`` and
``... cli chaos``.

Counterpart of the reference's ``fsx serve``: builds an
:class:`~.engine.Engine` on the card (or on the CPU with ``--device
cpu``) from ``--config`` (the reference's JSON config file) and serves

* the daemon's shared-memory feature ring (``--feature-ring``, 48-byte
  records or ``fsxd --compact``'s 16-byte ones), writing blocks to its
  verdict ring (``--verdict-ring``), inline or through
  ``--ingest-workers N`` spawned drain workers over ``fsxd --shards N``
  ring shards (``--strict-ingest``, ``--quarantine-dir``);
* or a synthetic scenario at ``--rate``, or a ``--records`` file of
  48-byte flow records;

and prints the report as JSON.  ``--mega N|auto`` groups backlogged
batches as the reference's does (compact16 only: refused before boot for
a model served over raw48); ``--device-loop N|auto`` adds the drain
ring above the ladder; ``--tiered-warm`` opens serving on the serving
tier while a background thread captures the rest; ``--compile-cache
DIR`` keeps the built kernel libraries across boots (and pins the boot
salt there).  ``--slo-us N`` bounds the feature -> verdict
path at N µs (latency-budget dispatch; ``--predict`` adds the burst
forecaster), ``--watchdog-s S`` sets the stall bound and
``--no-sink-thread`` sinks on the dispatch thread; the report carries
the latency, health and (with ``--predict``) predict blocks.  ``--checkpoint`` saves table, stats and
clock at exit (and every ``--checkpoint-every`` seconds); ``--restore``
resumes from a checkpoint, adopting its salt and (unless a capacity is
given) its capacity before the engine is built.  ``--artifact-reload``
hot-swaps ``--artifact`` whenever its file changes (no drain, no new
capture); ``--verdict-k K`` sets the compact verdict wire's slots (0:
the full block arrays every batch); ``--sim-kernel-tier PLAN`` puts the
simulated kernel tier of a distill plan in front of the engine (the
report's ``escalation`` block); ``--profile DIR`` writes a
``torch.profiler`` trace of the serve (host and card) that Perfetto or
TensorBoard opens.  Flag combinations are refused before boot, as the
reference refuses them.

``pcap CAPTURE OUT`` turns a classic pcap into a file of 48-byte flow
records (the kernel's parse and streaming features, :mod:`.engine.pcap`)
that ``serve --records`` replays.

``train`` trains ``logreg_int8`` (QAT), ``mlp`` or ``multiclass`` on the
CICIDS-calibrated fixture, CICIDS-format CSVs or the synthetic set and
exports the artifact (:mod:`.train`); ``distill ARTIFACT`` compiles an
int8 artifact into the kernel tier's plan (:func:`.distill.compile_plan`).
Both take the reference's flags and refusals; ``distill`` refuses
``--check``, ``--emulate``, ``--emulate-n`` and ``--pin`` by name (they
need the eBPF plane, ``bpf/``, which the port does not have).

``cluster`` runs N supervised engine processes over the daemon's shard
fan-out, sharing the gossip blacklist plane (:mod:`.cluster`).

``status`` reads the shm rings' cursors and, with ``--engine-report
GLOB`` (repeatable), merges engine reports (``serve`` output, or a
cluster dir's ``report_r*_g*.json``) into one seal -> verdict latency
block, the health ladder with the gossip counters, and the governors'
and boots' folds; ``monitor`` appends those merges every ``--interval``
to stdout and ``--out`` (JSONL) and raises the reference's four
engine-report alerts.  Both refuse ``--pin``, and ``monitor`` refuses
``--alert-drop-pps`` and ``--alert-blacklist``, by name: they read the
kernel maps, which the port does not.

``bench --scenarios [--scale S] [--only NAME]`` runs the five BASELINE
configs (:mod:`.benchmarks`), one JSON line each; a bare ``bench``,
``--smoke``, ``--scaling`` and ``--cluster`` are refused by name.

``chaos [--seed N] [--quick]`` runs the seeded fault-injection campaign
(:mod:`.chaos`) over the port's engine, ingest fleet, supervisor and
gossip plane, and names the reference's faults it does not run yet;
``chaos --list`` prints the fault registry.

Every verb that runs an engine runs on the card unless ``--device cpu``
is given, and raises without one.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import secrets
import sys
from pathlib import Path

from flowsentryx_tpu_torch.core.config import DEFAULT_CONFIG, FsxConfig


def _int_or_auto(flag: str):
    def parse(s: str) -> int | str:
        if s == "auto":
            return "auto"
        try:
            return int(s)
        except ValueError:
            raise argparse.ArgumentTypeError(
                f"{flag} takes an integer or 'auto', got {s!r}") from None
    return parse


#: ``--mega``: a fixed group size or ``auto``, the adaptive power-of-two
#: coalescing ladder (``Engine(mega_n="auto")``).
_mega_arg = _int_or_auto("--mega")
#: ``--device-loop``: a ring depth, or ``auto``, picked by a short
#: calibration drain at boot (``engine.calibrate_ring_depth``).
_device_loop_arg = _int_or_auto("--device-loop")


def _boot_salt(cache_dir: str | None, label: str) -> int:
    """The boot-time hash salt, compile-cache aware, as the reference
    draws it.  Without a cache directory: a fresh random odd u32 per
    boot.  With one (``--compile-cache``), the salt is drawn once and
    pinned in ``DIR/boot_salt``, so that every boot of the same config
    keys the same cache entries (the staged signature holds the config,
    salt included); rotating it is wiping the directory or fixing
    ``table.salt`` in the config."""
    if not cache_dir:
        return secrets.randbits(32) | 1
    path = Path(cache_dir) / "boot_salt"
    try:
        salt = int(path.read_text().strip(), 0)
        if salt & 1 and 0 < salt < 1 << 32:
            return salt
        print(f"{label}: ignoring malformed {path} (value {salt:#x}); "
              "drawing a fresh boot salt", file=sys.stderr)
    except FileNotFoundError:
        pass
    except (OSError, ValueError) as e:
        print(f"{label}: ignoring unreadable {path} ({e}); drawing a "
              "fresh boot salt", file=sys.stderr)
    salt = secrets.randbits(32) | 1
    from flowsentryx_tpu_torch.core import durable

    try:
        path.parent.mkdir(parents=True, exist_ok=True)
        durable.atomic_write(path, f"{salt:#010x}\n".encode())
    except OSError as e:
        print(f"{label}: could not pin boot salt in {path} ({e}) — the "
              "compile cache will miss on the next boot", file=sys.stderr)
        return salt
    print(f"{label}: --compile-cache: boot salt {salt:#x} pinned in "
          f"{path} so cached entries stay valid across restarts; rotate "
          "by wiping the cache dir or fixing table.salt in config",
          file=sys.stderr)
    return salt


def _refuse(args: argparse.Namespace) -> str | None:
    """The reference's pre-boot refusals of flag combinations."""
    if args.checkpoint_every < 0:
        return "--checkpoint-every must be >= 0 (0 disables)"
    if args.checkpoint_every and not args.checkpoint:
        return "--checkpoint-every requires --checkpoint PATH"
    if args.ingest_workers < 0:
        return "--ingest-workers must be >= 0 (0 = inline)"
    if args.ingest_workers and not args.feature_ring:
        return ("--ingest-workers requires --feature-ring (the sharded "
                "drain fronts the daemon's shm rings)")
    if args.strict_ingest and not args.ingest_workers:
        return ("--strict-ingest requires --ingest-workers N (>= 1): the "
                "crash posture governs the sharded drain fleet")
    if args.quarantine_dir and not args.ingest_workers:
        return ("--quarantine-dir requires --ingest-workers N (>= 1): "
                "sealed-slot validation happens on the sharded-ingest "
                "dequeue path")
    if args.verdict_k is not None and args.verdict_k < 0:
        return ("--verdict-k must be >= 0 (0 disables the compact verdict "
                "wire)")
    if args.device_loop != "auto" and args.device_loop < 0:
        return ("--device-loop must be >= 0 (0 = per-group dispatch, the "
                "parity baseline) or 'auto'")
    if args.device_loop and not args.mega:
        return ("--device-loop requires --mega N|auto: each ring slot "
                "carries one top-rung coalescing group (the deep scan is "
                "a ring of megasteps)")
    if args.device_loop and args.verdict_k == 0:
        return ("--device-loop is incompatible with --verdict-k 0: the "
                "ring's only steady-state readback is the per-slot compact "
                "verdict wire, and without it every round would fetch full "
                "[ring*mega, B] block arrays — the exact transfer the ring "
                "exists to amortize")
    if args.tiered_warm and not args.mega:
        return ("--tiered-warm requires --mega N|auto: the serving tier IS "
                "the top coalescing rung — with no ladder there is nothing "
                "to tier (plain warm() already compiles the one staged "
                "step)")
    if args.slo_us < 0:
        return ("--slo-us must be >= 0 (0 = throughput-tuned serving, no "
                "latency budget)")
    if args.predict and not args.slo_us:
        return ("--predict requires --slo-us > 0: the governor's flush, "
                "hold and pre-warm decisions are all phrased against the "
                "latency budget")
    if args.sim_kernel_tier and args.ingest_workers:
        return ("--sim-kernel-tier needs the inline record path; "
                "sealed-batch ingest bypasses the record stream (deploy "
                "the real tier via fsx distill --pin instead)")
    if args.artifact_reload and not args.artifact:
        return ("--artifact-reload requires --artifact PATH (it hot-swaps "
                "that file when its mtime changes)")
    if args.watchdog_s is not None and args.watchdog_s < 0:
        return "--watchdog-s must be >= 0 (0 disables)"
    if args.verdict_ring and not args.feature_ring:
        return "--verdict-ring requires --feature-ring"
    if args.feature_ring and args.records:
        return "--feature-ring and --records are exclusive"
    return None


def _restore_geometry(args, cfg):
    """``--restore``: read the checkpoint's header before boot, adopt its
    salt and (when no capacity was asked for) its capacity, validated as
    an explicit ``--table-capacity`` would be.  A corrupt checkpoint
    validates against its ``.prev`` generation, which the engine will
    load instead.  Returns ``(cfg, None)`` or ``(None, message)``."""
    import zipfile

    from flowsentryx_tpu_torch.engine.checkpoint import (
        CheckpointCorrupt, peek_header, prev_path,
    )
    from flowsentryx_tpu_torch.engine.table import validate_capacity

    try:
        hdr = peek_header(args.restore)
    except CheckpointCorrupt as e:
        prev = prev_path(args.restore)
        try:
            hdr = peek_header(prev)
        except (OSError, ValueError, KeyError, zipfile.BadZipFile):
            return None, (f"checkpoint {args.restore!r} is corrupt ({e}) "
                          "and no restorable previous generation exists "
                          "— refusing to boot from garbage")
        print(f"serve: checkpoint {args.restore!r} REFUSED ({e}); the "
              f"retained previous generation {prev} will be restored "
              "instead", file=sys.stderr)
    except (OSError, ValueError, KeyError, zipfile.BadZipFile) as e:
        return None, f"cannot read checkpoint {args.restore!r}: {e}"
    if cfg.table.salt and cfg.table.salt != hdr["hash_salt"]:
        return None, (f"config salt {cfg.table.salt:#x} != checkpoint salt "
                      f"{hdr['hash_salt']:#x} — refusing to restore (the "
                      "table's slot layout is bound to the salt it was "
                      "built under)")
    if not args.table_capacity and not args.config:
        problems = validate_capacity(hdr["capacity"], cfg.batch.max_batch)
        if problems:
            return None, ("checkpoint capacity: " + "; ".join(problems)
                          + " (pass --table-capacity to reshard)")
        cfg = dataclasses.replace(cfg, table=dataclasses.replace(
            cfg.table, capacity=hdr["capacity"]))
    if hdr["hash_salt"] == 0:
        print("serve: WARNING restoring a pre-salt checkpoint - running "
              "with the UNSALTED public hash", file=sys.stderr)
    if hdr["capacity"] != cfg.table.capacity or hdr["n_shards"] != 1:
        print(f"serve: checkpoint geometry {hdr['capacity']} rows x "
              f"{hdr['n_shards']} shard(s) != boot geometry "
              f"{cfg.table.capacity} rows x 1 shard: occupied rows will "
              "be resharded at restore", file=sys.stderr)
    return dataclasses.replace(cfg, table=dataclasses.replace(
        cfg.table, salt=hdr["hash_salt"])), None


def _cluster_member(args: argparse.Namespace):
    """``serve --cluster-rank R/N --cluster-dir DIR``: the reference's
    pre-boot refusals, then the rank's gossip plane and the fleet's
    epoch.  Returns ``(rank, n, plane, t0_ns)`` or a refusal message."""
    r_s, sep, n_s = args.cluster_rank.partition("/")
    try:
        rank, n = int(r_s), int(n_s)
    except ValueError:
        sep = ""
    if not sep:
        return (f"--cluster-rank wants R/N (e.g. 0/2), got "
                f"{args.cluster_rank!r}")
    if n < 2:
        return (f"--cluster-rank {args.cluster_rank}: a {n}-engine cluster "
                "is just fsx serve — drop the flag, or run >= 2 engines")
    if not 0 <= rank < n:
        return (f"--cluster-rank {args.cluster_rank}: rank must be in "
                f"[0, {n})")
    if not args.ingest_workers:
        return ("--cluster-rank requires --ingest-workers W >= 1: rank R of "
                "N owns ring shards [R*W, (R+1)*W) of the daemon's "
                "N*W-shard IP-hash fan-out (pair with fsxd --shards N*W)")
    if not args.cluster_dir:
        return ("--cluster-rank requires --cluster-dir DIR: the gossip "
                "mailboxes and status blocks live there (fsx cluster "
                "creates them)")
    from flowsentryx_tpu_torch.cluster import GossipPlane
    from flowsentryx_tpu_torch.engine.shm import RingNotReady

    try:
        plane = GossipPlane(args.cluster_dir, rank, n)
    except ValueError as e:
        return str(e)   # the plane disagrees with the flags: it says how
    except (OSError, RingNotReady) as e:
        return (f"cluster dir {args.cluster_dir!r} is not an initialized "
                f"gossip plane: {e} (fsx cluster creates the mailboxes and "
                "status blocks before any engine boots)")
    t0_ns = plane.status.ctl_get("c_t0")
    if not t0_ns:
        return ("cluster epoch not published (status c_t0 == 0): every "
                "engine's device clock — and every gossiped blacklist "
                "`until` — must share one t0; boot the fleet through fsx "
                "cluster, which stamps it")
    return rank, n, plane, t0_ns


def _cmd_serve(args: argparse.Namespace) -> int:
    bad = _refuse(args)
    if bad:
        print(f"serve: {bad}", file=sys.stderr)
        return 1
    # a cluster rank owns shards [R*W, (R+1)*W) of the N*W-shard fan-out
    # end to end and shares only the gossip plane: every structural
    # requirement is refused here, before torch boots
    cluster_rank = cluster_n = gossip = t0_ns = None
    if args.cluster_rank is not None:
        member = _cluster_member(args)
        if isinstance(member, str):
            print(f"serve: {member}", file=sys.stderr)
            return 1
        cluster_rank, cluster_n, gossip, t0_ns = member
    cfg = (FsxConfig.from_json(Path(args.config).read_text())
           if args.config else DEFAULT_CONFIG)
    if args.model:
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, name=args.model))
    if args.verdict_k is not None:
        try:
            cfg = dataclasses.replace(cfg, batch=dataclasses.replace(
                cfg.batch, verdict_k=args.verdict_k))
        except ValueError as e:
            print(f"serve: --verdict-k: {e}", file=sys.stderr)
            return 1
    if args.table_capacity:
        from flowsentryx_tpu_torch.engine.table import validate_capacity

        problems = validate_capacity(args.table_capacity,
                                     cfg.batch.max_batch)
        if problems:
            print("serve: --table-capacity: " + "; ".join(problems),
                  file=sys.stderr)
            return 1
        cfg = dataclasses.replace(cfg, table=dataclasses.replace(
            cfg.table, capacity=args.table_capacity))
    if args.restore:
        cfg, bad = _restore_geometry(args, cfg)
        if bad:
            print(f"serve: {bad}", file=sys.stderr)
            return 1
    elif cfg.table.salt == 0:
        # a random boot-time hash salt, as the reference's serve draws:
        # slot collisions cannot be precomputed by an attacker
        cfg = dataclasses.replace(cfg, table=dataclasses.replace(
            cfg.table, salt=_boot_salt(args.compile_cache, "serve")))

    # imports after argument checks: a bad flag must not pay torch's boot
    import time

    t_import = time.perf_counter()
    import numpy as np

    from flowsentryx_tpu_torch.core import schema, wire
    from flowsentryx_tpu_torch.core.device import resolve_device
    from flowsentryx_tpu_torch.engine import (
        ArraySource, Engine, NullSink, TrafficSource,
    )
    from flowsentryx_tpu_torch.engine.checkpoint import CheckpointCorrupt
    from flowsentryx_tpu_torch.engine.traffic import Scenario, TrafficSpec
    from flowsentryx_tpu_torch.models.registry import get_model, load_artifact

    import_s = time.perf_counter() - t_import
    try:
        spec = get_model(cfg.model.name)
    except KeyError as e:
        print(f"serve: {e.args[0]}", file=sys.stderr)
        return 1
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"serve: {e}", file=sys.stderr)
        return 1
    try:
        params = (load_artifact(cfg.model.name, args.artifact, device)
                  if args.artifact else spec.init(device))
    except ValueError as e:
        print(f"serve: {e}", file=sys.stderr)
        return 1
    sink = NullSink()
    if args.feature_ring:
        from flowsentryx_tpu_torch.engine.shm import (
            ShmRingSource, ShmVerdictSink,
        )

        if args.ingest_workers:
            from flowsentryx_tpu_torch.ingest import ShardedIngest

            span = {}
            if cluster_rank is not None:
                span = dict(
                    shard_offset=cluster_rank * args.ingest_workers,
                    total_shards=cluster_n * args.ingest_workers)
            source = ShardedIngest(args.feature_ring, args.ingest_workers,
                                   strict=args.strict_ingest,
                                   quarantine_dir=args.quarantine_dir,
                                   **span)
        else:
            source = ShmRingSource(args.feature_ring)
        if args.verdict_ring:
            sink = ShmVerdictSink(args.verdict_ring)
    elif args.records:
        rec = np.frombuffer(Path(args.records).read_bytes(),
                            schema.FLOW_RECORD_DTYPE)
        source = ArraySource(rec[:args.packets] if args.packets else rec)
    else:
        source = TrafficSource(TrafficSpec(scenario=Scenario(args.scenario),
                                           rate_pps=args.rate),
                               total=args.packets or None)
    if args.mega and not (getattr(source, "precompact", False)
                          or hasattr(params, "in_scale")):
        # the engine's wire rule, checked before boot
        print("serve: --mega requires the compact16 wire, but the selected "
              "model exposes no input observer so the engine would serve "
              "raw48; pass an observer-carrying artifact (e.g. --artifact "
              "artifacts/logreg_int8.npz) or drop --mega", file=sys.stderr)
        return 1
    try:
        kernel_tier = None
        if args.sim_kernel_tier:
            kernel_tier = _load_kernel_tier(args, cfg, source)
            if kernel_tier is None:
                return 1
        device_loop = args.device_loop
        if device_loop == "auto":
            device_loop = _calibrate(cfg, params, args.mega, device)
        eng = Engine(cfg, source, sink, params=params, device=device,
                     mega_n=args.mega, slo_us=args.slo_us,
                     predict=args.predict, watchdog_s=args.watchdog_s,
                     sink_thread=False if args.no_sink_thread else None,
                     kernel_tier=kernel_tier, device_loop=device_loop,
                     compile_cache=args.compile_cache, t0_ns=t0_ns,
                     gossip=gossip)
        eng.boot_import_s = round(import_s, 4)
        if args.restore:
            try:
                eng.restore(args.restore)
            except CheckpointCorrupt as e:
                print(f"serve: cannot restore: {e} — refusing to serve "
                      "from garbage", file=sys.stderr)
                return 1
        if args.artifact_reload:
            # live model swap: re-stat the artifact and swap it in
            # mid-serve when its mtime changes
            eng.watch_artifact(args.artifact)
        if args.tiered_warm:
            # only the serving tier (singles, the top rung) blocks the
            # boot; a background thread captures the rest
            eng.warm(tiered=True)
        else:
            eng.warm()
        if gossip is not None:
            gossip.set_state(wire.CSTATE_SERVING)
        rep = _profiled(eng, args, device)
        if gossip is not None:
            gossip.set_state(wire.CSTATE_DONE)
    finally:
        if hasattr(source, "close"):
            source.close()   # stop and join the ingest worker fleet
    if rep.ingest is not None:
        # close() counts the drain-on-shutdown losses: report them
        rep = rep._replace(ingest=source.ingest_stats())
    print(json.dumps(rep._asdict(), indent=None if args.json else 2))
    return 0


def _calibrate(cfg, params, mega, device) -> int:
    """``--device-loop auto``: a short calibration drain per candidate
    depth, each with a throwaway engine that frees its graphs and table
    before the next (and before the serving engine boots), judged on
    the measured H2D overlap; announced on stderr."""
    from flowsentryx_tpu_torch.engine.engine import calibrate_ring_depth

    print("serve: --device-loop auto: calibrating ring depth (one short "
          "drain and capture per candidate)...", file=sys.stderr)
    depth, detail = calibrate_ring_depth(cfg, params=params, mega_n=mega,
                                         device=device)
    print(f"serve: --device-loop auto -> ring depth {depth} "
          f"({detail['reason']}; measured: "
          + ", ".join(f"ring {m['ring']}: overlap {m['overlap_fraction']}"
                      for m in detail["candidates"]) + ")",
          file=sys.stderr)
    return depth


def _load_kernel_tier(args, cfg, source):
    """``--sim-kernel-tier PLAN``: the simulated kernel tier of a distill
    plan, or None after announcing why it cannot be built."""
    import zipfile

    from flowsentryx_tpu_torch.distill import SimKernelTier, load_plan

    if getattr(source, "precompact", False):
        print("serve: --sim-kernel-tier cannot rescore a compact-emit "
              "feature ring (records arrive kernel-quantized); serve a "
              "48 B ring or deploy the real tier via fsx distill --pin",
              file=sys.stderr)
        return None
    try:
        return SimKernelTier(load_plan(args.sim_kernel_tier),
                             block_s=cfg.model.ml_block_s)
    # ValueError covers DistillError and np.load's complaints about a
    # corrupt or pickled payload; BadZipFile is what a non-zip raises
    except (OSError, ValueError, KeyError, zipfile.BadZipFile) as e:
        print(f"serve: cannot load the distill plan "
              f"{args.sim_kernel_tier!r}: {e} (generate one with fsx "
              "distill ARTIFACT --out PLAN.npz)", file=sys.stderr)
        return None


def _profiled(eng, args, device):
    """:func:`_serve`, under ``torch.profiler`` with ``--profile DIR``
    (host activity, and the card's kernels when serving on it): the
    trace lands in DIR as ``<host>_<pid>.<ms>.pt.trace.json``, a Chrome
    trace that Perfetto opens and TensorBoard's profiler plugin reads."""
    if not args.profile:
        return _serve(eng, args)
    from torch.profiler import (
        ProfilerActivity, profile, tensorboard_trace_handler,
    )

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts,
                 on_trace_ready=tensorboard_trace_handler(args.profile)):
        rep = _serve(eng, args)
    print(f"serve: profiler trace written to {args.profile}",
          file=sys.stderr)
    return rep


def _serve(eng, args):
    """Run the engine under the CLI's bounds; with ``--checkpoint-every``
    in chunks of that many seconds, snapshotting between chunks (the
    engine's counters and the batch bound accumulate across runs, so
    chunking changes no result); the report spans the whole wall."""
    import time

    batches = args.batches or None
    if not (args.checkpoint and args.checkpoint_every):
        rep = eng.run(max_batches=batches, max_seconds=args.seconds or None)
        if args.checkpoint:
            eng.checkpoint(args.checkpoint)
        return rep
    t0 = time.perf_counter()
    rep = None
    while True:
        sec = float(args.checkpoint_every)
        if args.seconds:
            left = args.seconds - (time.perf_counter() - t0)
            if left <= 0:
                break
            sec = min(sec, left)
        rep = eng.run(max_batches=batches, max_seconds=sec)
        eng.checkpoint(args.checkpoint)
        if (batches and rep.batches >= batches) or eng.source.exhausted():
            break
    if rep is None:   # a non-positive --seconds: nothing served
        rep = eng.run(max_batches=0)
        eng.checkpoint(args.checkpoint)
    wall = time.perf_counter() - t0
    return rep._replace(wall_s=round(wall, 4), records_per_s=round(
        rep.records / max(wall, 1e-9), 1))


def _cmd_pcap(args: argparse.Namespace) -> int:
    """Convert a capture to flow records (the kernel's parse and its
    streaming features).  The output file holds raw 48-byte
    ``fsx_flow_record`` structs, which ``serve --records`` replays."""
    from flowsentryx_tpu_torch.engine import pcap

    tracker = pcap.FlowTracker(emit_all=args.emit_all)
    rec = pcap.pcap_to_records(args.pcap, emit_all=args.emit_all,
                               limit=args.limit or None, tracker=tracker)
    Path(args.out).write_bytes(rec.tobytes())
    print(json.dumps({
        "packets_emitted": int(len(rec)),
        "flows": len(tracker.flows),  # (saddr, dport) flow keys
        "out": args.out,
        "bytes": len(rec) * rec.dtype.itemsize,
    }))
    return 0


def _cmd_train(args: argparse.Namespace) -> int:
    """Train a model and export the deployable artifact (the reference's
    ``fsx train``).  ``--data`` globs CICIDS2017/CICDDoS2019 CSVs, or
    ``fixture`` for the calibrated stand-in; without it, the synthetic
    labelled set."""
    if args.epochs < 1:
        raise SystemExit("--epochs must be >= 1")
    # recipe flags are family-specific: refuse silently-ignored combos
    if args.slow_weight != 1.0 and args.model != "logreg_int8":
        raise SystemExit("--slow-weight applies to --model logreg_int8 only")
    if args.augment_shift and args.model != "mlp":
        raise SystemExit("--augment-shift applies to --model mlp only")
    if args.model == "multiclass" and args.data not in (None, "fixture"):
        raise SystemExit(
            "multiclass training needs subtype labels; use "
            "--data fixture (CSV datasets are binary-labeled)")

    import numpy as np

    from flowsentryx_tpu_torch.core.device import resolve_device
    from flowsentryx_tpu_torch.train import data, evaluate, fixture, qat

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"train: {e}") from None

    if args.model == "multiclass":
        from flowsentryx_tpu_torch.models import multiclass

        n = args.synthetic if args.synthetic is not None else 200_000
        X, _, y_class = fixture.cicids_fixture(n=n, seed=args.seed,
                                               return_classes=True)
        Xtr, Xte, ytr, yte = data.train_test_split(X, y_class)
        params, losses = qat.train_multiclass(
            Xtr, ytr, epochs=args.epochs, seed=args.seed, device=device)
        out = {
            "model": args.model, "train_n": len(Xtr), "test_n": len(Xte),
            "final_loss": float(losses[-1]),
            "test": evaluate.multiclass_report(params, Xte, yte),
        }
        if args.out:
            out["artifact"] = multiclass.save_params(params, args.out)
        print(json.dumps(out, indent=2))
        return 0

    y_class = None
    if args.data == "fixture":
        n = args.synthetic if args.synthetic is not None else fixture.N_CLEANED
        X, y, y_class = fixture.cicids_fixture(n=n, seed=args.seed,
                                               return_classes=True)
    elif args.data:
        X, y = data.load_csvs(args.data)
    else:
        n = args.synthetic if args.synthetic is not None else 50_000
        X, y = data.synthetic_dataset(n, seed=args.seed)
    Xtr, Xte, ytr, yte = data.train_test_split(X, y)

    out: dict = {"model": args.model, "train_n": len(Xtr), "test_n": len(Xte)}
    if args.model == "logreg_int8":
        from flowsentryx_tpu_torch.models import logreg

        sw = None
        if args.slow_weight != 1.0:
            # slow-attack BCE upweight: the fixture's subtype labels,
            # split with the same seed so the permutation aligns
            if y_class is None:
                raise SystemExit("--slow-weight needs --data fixture "
                                 "(CSV datasets carry no subtype labels)")
            ctr, _cte, _, _ = data.train_test_split(y_class, y)
            sw = 1.0 + (ctr == fixture.CLASS_SLOW) * (args.slow_weight - 1.0)
        res = qat.train_logreg_qat(Xtr, ytr, epochs=args.epochs,
                                   sample_weight=sw, device=device)
        out["final_loss"] = float(res.losses[-1])
        served = logreg.params_from_numpy(
            logreg.params_to_numpy(res.params), device)
        out["test"] = evaluate.evaluate_model(
            evaluate.int8_classify(served), served, Xte, yte)
        if args.out:
            out["artifact"] = logreg.save_params(res.params, args.out)
    elif args.model == "mlp":
        from flowsentryx_tpu_torch.models import mlp
        from flowsentryx_tpu_torch.train.stress import shift_augment

        if args.augment_shift:
            # sweep-matched domain randomization: the robust recipe
            rng = np.random.default_rng(args.seed)
            Xtr = np.concatenate(
                [Xtr] + [shift_augment(Xtr, rng)
                         for _ in range(args.augment_shift)])
            ytr = np.concatenate([ytr] * (args.augment_shift + 1))
        params, losses = qat.train_mlp(Xtr, ytr, epochs=args.epochs,
                                       seed=args.seed, device=device)
        out["final_loss"] = float(losses[-1])
        out["test"] = evaluate.evaluate_model(mlp.classify_batch, params,
                                              Xte, yte)
        if args.out:
            out["artifact"] = mlp.save_params(params, args.out)
    else:
        raise SystemExit(f"unknown trainable model {args.model!r}")
    print(json.dumps(out, indent=2))
    return 0


#: ``fsx distill`` flags of the reference that need the eBPF plane.
_DISTILL_REFUSED = {
    "check": "--check statically verifies the --ml XDP programs "
             "(flowsentryx_tpu/bpf/verifier.py)",
    "emulate": "--emulate runs the emitted eBPF scorer in the reference's "
               "emulator (flowsentryx_tpu/distill/emulate.py)",
    "emulate_n": "--emulate-n sizes the corpus of --emulate's eBPF "
                 "emulator run",
    "pin": "--pin pushes the blob into a pinned ml_model_map through the "
           "bpf loader",
}


def _cmd_distill(args: argparse.Namespace) -> int:
    """Compile a trained int8 artifact into the kernel tier's plan (the
    reference's ``fsx distill``, less its eBPF legs)."""
    import time

    for flag, why in _DISTILL_REFUSED.items():
        if getattr(args, flag) is not None:
            name = flag.replace("_", "-")
            print(f"fsx distill: refusing --{name}: {why}, which the port "
                  "does not have (bpf/ is not ported); run the reference's "
                  f"fsx distill --{name}", file=sys.stderr)
            return 1
    try:
        t_lo_s, _, t_hi_s = args.thresholds.partition(",")
        t_lo, t_hi = float(t_lo_s), float(t_hi_s)
    except ValueError:
        print(f"fsx distill: --thresholds wants LO,HI in [0,1], got "
              f"{args.thresholds!r}", file=sys.stderr)
        return 1
    from flowsentryx_tpu_torch.core.device import resolve_device
    from flowsentryx_tpu_torch.distill import plan as dplan
    from flowsentryx_tpu_torch.models.registry import (
        load_artifact, require_distillable,
    )

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"fsx distill: {e}", file=sys.stderr)
        return 1
    try:
        params = load_artifact(args.model, args.artifact, device)
        require_distillable(args.model, params)
    except (ValueError, KeyError, OSError) as e:
        print(f"fsx distill: {e}", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    try:
        plan = dplan.compile_plan(params, t_lo=t_lo, t_hi=t_hi)
    except dplan.DistillError as e:
        print(f"fsx distill: {e}", file=sys.stderr)
        return 1
    out: dict = {
        "ok": True,
        "artifact": args.artifact,
        "model": args.model,
        "compile_s": round(time.perf_counter() - t0, 3),
        "plan": plan.to_json(),
    }
    blob = dplan.pack_blob(plan)
    if args.out:
        out["plan_file"] = dplan.save_plan(plan, args.out)
    if args.blob:
        Path(args.blob).write_bytes(blob)
        out["blob_file"] = args.blob
    if args.report:
        Path(args.report).parent.mkdir(parents=True, exist_ok=True)
        Path(args.report).write_text(json.dumps(out, indent=2) + "\n")
    if args.json:
        print(json.dumps(out, indent=2))
    else:
        p = out["plan"]
        print(f"fsx distill: {args.artifact} [{args.model}] -> "
              f"{p['n_bounds'][0]} boundaries/feature, bands "
              f"s<={p['acc_pass']} pass | s>={p['acc_drop']} drop "
              f"(scores {args.thresholds})")
        for key in ("plan_file", "blob_file"):
            if key in out:
                print(f"fsx distill: {key.replace('_', ' ')}: {out[key]}")
        print("fsx distill: PASS")
    return 0


def _parse_gossip_addr(text: str, engines: int):
    """``IP:PORT`` -> (``[ip, port]``, None) or (None, the error): the one
    parser of ``--hosts`` entries and ``--gossip-listen``, so that the
    derived engine ports (the beacon binds PORT, engine r PORT+1+r) are
    bounded the same way everywhere."""
    ip, _, port_s = text.strip().rpartition(":")
    try:
        port = int(port_s)
    except ValueError:
        port = -1
    if not ip or not 0 < port < 65536:
        return None, ("is not IP:PORT (the gossip base port; the "
                      "supervisor beacon binds it, engine r binds "
                      "PORT+1+r)")
    if port + engines > 65535:
        # the engine ports must fit too, or the refusal would surface as
        # a bind crash-loop in a spawned child
        return None, (f"base port {port} + {engines} engine port(s) "
                      "exceeds 65535 (engine r binds PORT+1+r) — "
                      "pick a lower base port")
    return [ip, port], None


def _cluster_netspec(args: argparse.Namespace):
    """``--hosts --host-id --gossip-listen`` -> (the net spec or None,
    the refusal or None), with the reference's messages."""
    if not (args.hosts or args.host_id is not None or args.gossip_listen):
        return None, None
    if not args.hosts:
        return None, ("--host-id/--gossip-listen require --hosts "
                      "IP:PORT,IP:PORT,... (the fleet's host table — every "
                      "host runs the same list)")
    if args.host_id is None:
        return None, ("--hosts requires --host-id I (this host's index "
                      "into the --hosts list; the port layout and the "
                      "federation identity both derive from it)")
    hosts = []
    for ent in args.hosts.split(","):
        addr, err = _parse_gossip_addr(ent, args.engines)
        if err:
            return None, f"--hosts entry {ent.strip()!r} {err}"
        hosts.append(addr)
    if len(hosts) < 2:
        return None, (f"--hosts names {len(hosts)} host(s): a 1-host "
                      "fleet is fsx cluster without --hosts (the shm "
                      "gossip plane already covers it)")
    if not 0 <= args.host_id < len(hosts):
        return None, (f"--host-id {args.host_id} not in [0, {len(hosts)}) "
                      f"(the --hosts list has {len(hosts)} entries)")
    listen = None
    if args.gossip_listen:
        listen, err = _parse_gossip_addr(args.gossip_listen, args.engines)
        if err:
            return None, f"--gossip-listen {args.gossip_listen!r} {err}"
    return {"hosts": hosts, "host_id": args.host_id,
            "engines_per_host": args.engines, "listen": listen}, None


def _has_observer(model: str, artifact: str | None) -> bool:
    """Whether the served params carry an input observer (``in_scale``:
    the compact16 wire ``--mega`` needs), read without torch: the
    artifact's arrays, or the family's init (the logreg families)."""
    if artifact:
        import numpy as np

        with np.load(artifact) as z:
            return "in_scale" in z.files
    return model.startswith("logreg")


def _cmd_cluster(args: argparse.Namespace) -> int:
    """Coordinator-less multi-engine scale-out on one host (the
    reference's ``fsx cluster``).  N full engine processes,
    each owning ring shards ``[r*W, (r+1)*W)`` of the daemon's
    ``N*W``-shard IP-hash fan-out end to end (``fsxd --shards N*W``),
    sharing only the verdict-gossip blacklist plane.  This process is
    the supervisor: it creates the plane, stamps the shared epoch,
    spawns the engines and restarts any that die from their last
    checkpoint; it imports neither torch nor CUDA.  ``--elastic``
    provisions the plane at ``--max-engines`` and boots ``--engines`` of
    them, the autoscaler growing, shrinking and rebalancing the live set
    through live shard handoffs; ``--adopt`` re-attaches to a live
    plane.  ``--hosts --host-id`` make the fleet one host of a multi-host
    fleet: the engines also gossip over UDP (epoch-rebased), and this
    supervisor beacons to and watches the other hosts' supervisors.
    ``--drain`` (a port addition) serves prefilled shards to
    exhaustion, every rank starting its timed run together once all are
    warm."""
    if args.engines < 2 and not args.hosts:
        print(f"fsx cluster: --engines must be >= 2 (got "
              f"{args.engines}): a 1-engine cluster is fsx serve "
              "(unless --hosts makes it one rank of a multi-host "
              "fleet)", file=sys.stderr)
        return 1
    if args.engines < 1:
        print(f"fsx cluster: --engines must be >= 1 (got "
              f"{args.engines})", file=sys.stderr)
        return 1
    # the elastic shape: the plane is provisioned at --max-engines
    # (rings, status blocks, mailboxes) and --engines of them boot; the
    # autoscaler moves the live set inside that envelope, so
    # total_shards = max * W never changes and a reshape is a flip
    if (args.min_engines is not None or args.max_engines is not None) \
            and not args.elastic:
        print("fsx cluster: --min-engines/--max-engines require "
              "--elastic (they bound the autoscaler's live-rank "
              "envelope)", file=sys.stderr)
        return 1
    if args.elastic and args.hosts:
        print("fsx cluster: --elastic is single-host for now (the "
              "handoff mailbox and fence protocol ride the shm "
              "plane; cross-host handoff coordination is a "
              "documented follow-up — docs/CLUSTER.md §elastic)",
              file=sys.stderr)
        return 1
    n = args.engines
    if args.elastic:
        n = args.max_engines or args.engines + 1
        if n < args.engines:
            print(f"fsx cluster: --max-engines {n} < "
                  f"--engines {args.engines}: the initial live set "
                  "cannot exceed the provisioned envelope",
                  file=sys.stderr)
            return 1
        if (args.min_engines or 1) > args.engines:
            print(f"fsx cluster: --min-engines {args.min_engines} > "
                  f"--engines {args.engines}: the fleet would boot "
                  "already below its floor", file=sys.stderr)
            return 1
    if args.shards < n:
        print(f"fsx cluster: --shards {args.shards} cannot feed "
              f"{n} provisioned engines: every engine needs "
              "at least one ring shard to drain (pair with fsxd "
              "--shards N*W)", file=sys.stderr)
        return 1
    if args.shards % n:
        print(f"fsx cluster: --shards {args.shards} is not a multiple "
              f"of {n} (the provisioned engine count: "
              "--max-engines under --elastic, --engines otherwise): "
              "each engine owns an equal contiguous span of the "
              "ring-shard fan-out (rank r drains shards "
              "[r*W, (r+1)*W), W = shards/provisioned)",
              file=sys.stderr)
        return 1
    w = args.shards // n
    if args.checkpoint:
        # validate by formatting: only a {rank} placeholder, and one
        try:
            distinct = (args.checkpoint.format(rank=0)
                        != args.checkpoint.format(rank=1))
        except (KeyError, IndexError, ValueError) as e:
            print(f"fsx cluster: --checkpoint {args.checkpoint!r} "
                  f"does not format with rank= alone ({e!r}): the "
                  "template may use only a {rank} placeholder",
                  file=sys.stderr)
            return 1
        if not distinct:
            print(f"fsx cluster: --checkpoint {args.checkpoint!r} has "
                  "no {rank} placeholder: "
                  + str(args.engines) + " engines "
                  "checkpointing the same path would overwrite each "
                  "other's flow memory (and a restart would restore "
                  "the wrong shard's table)", file=sys.stderr)
            return 1
    refusal = None
    if args.checkpoint_every < 0:
        refusal = "--checkpoint-every must be >= 0 (0 disables)"
    elif args.checkpoint_every and not args.checkpoint:
        refusal = ("--checkpoint-every requires --checkpoint TEMPLATE "
                   "(with a {rank} placeholder)")
    elif args.device_loop < 0:
        refusal = "--device-loop must be >= 0"
    elif args.device_loop and not args.mega:
        refusal = ("--device-loop requires --mega N|auto (each ring slot "
                   "carries one top-rung coalescing group)")
    elif args.verdict_k is not None and args.verdict_k < 0:
        refusal = "--verdict-k must be >= 0"
    elif args.device_loop and args.verdict_k == 0:
        refusal = ("--device-loop is incompatible with --verdict-k 0 (the "
                   "ring's steady-state readback is the per-slot compact "
                   "wire)")
    elif args.tiered_warm and not args.mega:
        refusal = ("--tiered-warm requires --mega N|auto (the serving tier "
                   "IS the top coalescing rung)")
    elif args.slo_us < 0:
        refusal = "--slo-us must be >= 0"
    elif args.predict and not args.slo_us:
        refusal = ("--predict requires --slo-us > 0 (the governor acts "
                   "against each rank's latency budget)")
    elif not args.feature_ring:
        refusal = ("--feature-ring BASE is required: engines front the "
                   f"daemon's ring shards (pair with fsxd --shards "
                   f"{args.shards})")
    netspec = None
    if not refusal:
        # the multi-host leg: the host table, our index into it, and the
        # port layout (beacon at base, engine r at base+1+r), which
        # assumes the same --engines on every host
        netspec, refusal = _cluster_netspec(args)
    if refusal:
        print(f"fsx cluster: {refusal}", file=sys.stderr)
        return 1
    cfg = (FsxConfig.from_json(Path(args.config).read_text())
           if args.config else DEFAULT_CONFIG)
    if args.verdict_k is not None:
        cfg = dataclasses.replace(cfg, batch=dataclasses.replace(
            cfg.batch, verdict_k=args.verdict_k))
    if args.table_capacity is not None:
        from flowsentryx_tpu_torch.engine.table import validate_capacity

        problems = validate_capacity(args.table_capacity,
                                     cfg.batch.max_batch)
        if problems:
            for p in problems:
                print(f"fsx cluster: --table-capacity: {p}",
                      file=sys.stderr)
            return 1
        cfg = dataclasses.replace(cfg, table=dataclasses.replace(
            cfg.table, capacity=args.table_capacity))
    if cfg.table.salt == 0:
        # one shared salt: every engine's table (and checkpoint) lives
        # in one hash universe
        cfg = dataclasses.replace(cfg, table=dataclasses.replace(
            cfg.table, salt=_boot_salt(args.compile_cache, "fsx cluster")))
    if args.mega and not _has_observer(cfg.model.name, args.artifact):
        # the engines' wire rule, refused once here, not N times
        print("fsx cluster: --mega requires the compact16 wire, "
              "but the selected model exposes no input observer; "
              "pass an observer-carrying artifact (e.g. "
              "--artifact artifacts/logreg_int8.npz) or drop "
              "--mega", file=sys.stderr)
        return 1

    from flowsentryx_tpu_torch.cluster.runner import pin_core_for
    from flowsentryx_tpu_torch.cluster.supervisor import ClusterSupervisor

    cluster_dir = args.cluster_dir or f"{args.feature_ring}.cluster"
    specs = [{
        # rank r owns core r when the fleet fits the host
        "pin_core": pin_core_for(r, n, args.pin_cores),
        "device": args.device or "cuda",
        "cfg_json": cfg.to_json(),
        "ring_base": args.feature_ring,
        "workers": w,
        "total_shards": args.shards,
        "verdict_ring": (f"{args.verdict_ring}.r{r}"
                         if args.verdict_ring else None),
        "mega": args.mega or 0,
        "device_loop": args.device_loop,
        "slo_us": args.slo_us,
        "predict": bool(args.predict),
        "artifact": args.artifact,
        # one cache directory for the fleet: every rank stages the same
        # shape, so later boots load every kernel from it
        "compile_cache": args.compile_cache,
        "tiered_warm": bool(args.tiered_warm),
        "checkpoint": (args.checkpoint.format(rank=r)
                       if args.checkpoint else None),
        "checkpoint_every": args.checkpoint_every,
        "drain": bool(args.drain),
    } for r in range(n)]
    if args.drain:
        for r, spec in enumerate(specs):
            spec["ready_token"] = str(Path(cluster_dir) / f"ready_r{r}")
            spec["start_token"] = str(Path(cluster_dir) / "start")
        for p in Path(cluster_dir).glob("ready_r*"):
            p.unlink()
        Path(cluster_dir, "start").unlink(missing_ok=True)
    policy = None
    if args.elastic:
        from flowsentryx_tpu_torch.cluster.elastic import ElasticPolicy

        policy = ElasticPolicy(min_engines=args.min_engines or 1,
                               max_engines=n)
    sup = ClusterSupervisor(cluster_dir, specs,
                            max_restarts=args.max_restarts,
                            net=netspec, elastic=policy,
                            n_live=args.engines if args.elastic else None)
    try:
        sup.boot(adopt=args.adopt)
    except RuntimeError as e:
        # a live fleet already owns this plane (booting over it would
        # truncate the mmaps under its serving engines), or nothing to
        # adopt
        print(f"fsx cluster: {e}", file=sys.stderr)
        return 1
    note = ""
    if netspec:
        note = (f", host {netspec['host_id']} of {len(netspec['hosts'])} "
                "(UDP gossip + federation beacons)")
    if args.elastic:
        note += f", elastic [{args.min_engines or 1}, {n}]"
    print(f"fsx cluster: {args.engines} engines x {w} worker(s), "
          f"shards 0..{args.shards - 1}, gossip plane {cluster_dir}"
          f"{note}", file=sys.stderr)
    try:
        if args.drain:
            _start_together(sup, specs)
        agg = sup.run(max_seconds=args.seconds or None)
    except KeyboardInterrupt:
        sup.close()
        agg = sup.aggregate()
    print(json.dumps(agg, indent=2))
    return 0 if not agg["failed_ranks"] else 1


def _start_together(sup, specs, timeout_s: float = 600.0) -> None:
    """``--drain``: supervise until every rank is warm (its ready token)
    or one has failed for good, then release them all at once (the
    start token), so that the fleet's timed drains overlap."""
    import time

    deadline = time.monotonic() + timeout_s
    while (not all(Path(s["ready_token"]).exists() for s in specs)
           and not sup._failed and time.monotonic() < deadline):
        sup.poll()
        time.sleep(0.05)
    Path(specs[0]["start_token"]).touch()


# -- the operator's read side: engine reports, rings -------------------------

def _iter_engine_reports(globs: list):
    """The engine-report walk shared by the ``--engine-report GLOB``
    consumers: expand each (repeatable) glob, dedupe by realpath so that
    overlapping globs never merge a report twice, and yield ``(path, doc,
    error)``: ``doc`` the parsed JSON, or ``error`` a string when the
    file cannot be read or parsed (the caller decides whether that is a
    skip or a DEGRADED signal).  A pattern that matches nothing yields
    itself as an unreadable entry: a mistyped path surfaces instead of
    silently merging zero reports.  So does a file whose JSON is not an
    object (the reference's merges raise on one)."""
    import glob as _glob
    import os

    seen: set[str] = set()
    for pat in globs:
        for path in sorted(_glob.glob(pat)) or [pat]:
            key = os.path.realpath(path)
            if key in seen:
                continue
            seen.add(key)
            try:
                doc = json.loads(Path(path).read_text())
            except (OSError, ValueError) as e:
                yield path, None, str(e)
                continue
            if isinstance(doc, dict):
                yield path, doc, None
            else:
                yield path, None, (f"not a JSON object: "
                                   f"{type(doc).__name__}")


def _merged_latency(reports: list) -> dict:
    """Merge the ``latency`` blocks of engine-report JSONs (``serve``
    output, or a cluster dir's per-rank ``report_r*_g*.json`` wrappers)
    into ONE seal -> verdict percentile view: the HDR bucket counts are
    mergeable by construction (:class:`~.engine.metrics.LatencyHist`).
    ``reports`` is a materialized :func:`_iter_engine_reports` list, so
    that one read pass feeds every merge; the cluster supervisor's
    ``aggregate()`` applies the same fold to its ranks' reports."""
    from flowsentryx_tpu_torch.engine.metrics import LatencyHist

    merged = LatencyHist()
    sources = []
    per_report = {}
    for path, doc, err in reports:
        if err is not None:
            per_report[path] = {"error": err}
            continue
        lat = (doc.get("latency")
               or doc.get("report", {}).get("latency"))
        if not lat or not lat.get("hist"):
            per_report[path] = {"error": "no latency block"}
            continue
        try:
            h = LatencyHist.from_counts(lat["hist"])
        except ValueError as e:
            per_report[path] = {"error": str(e)}
            continue
        merged.merge(h)
        sources.append(path)
        sv = lat.get("seal_to_verdict") or {}
        per_report[path] = {
            "n": sv.get("n", 0),
            "p99_us": sv.get("p99"),
        }
    return {
        "reports_merged": len(sources),
        "per_report": per_report,
        "seal_to_verdict_us": merged.to_dict(),
    }


def _report_body(doc: dict) -> dict:
    """A bare report, or the ``report`` of a cluster rank's wrapper."""
    return doc.get("report") if isinstance(doc.get("report"), dict) else doc


#: The multi-host transport's counters a report's ``cluster.net`` block
#: carries, passed through to the health view when present.
_NET_KEYS = ("tx_wires", "tx_drop", "rx_wires", "rx_gap", "rx_dup",
             "reorder_evict", "epoch_skew_dropped", "epoch_skew_max",
             "net_digest")


def _merged_engine_health(reports: list) -> dict:
    """Merge the ``health`` and gossip-counter blocks of engine-report
    JSONs into one operator view: each report's state and reasons, the
    gossip plane's drop and seq-gap counters, and the worst-of fold
    (:func:`~.engine.health.worst`).  A report that cannot be read folds
    in as DEGRADED: the rank whose health cannot be read is not healthy,
    and a report torn mid-write is most likely exactly when the fleet is
    most broken.  The ``net`` and ``rebalance`` sub-blocks pass through
    when a report carries them (each rebalance counter also summed)."""
    from flowsentryx_tpu_torch.engine import health as health_mod

    per_report: dict = {}
    states: list[str] = []
    rebalance_totals: dict = {}
    for path, doc, err in reports:
        if err is not None:
            per_report[path] = {
                "state": health_mod.DEGRADED,
                "reasons": [f"report_unreadable:{err}"],
                "error": err,
            }
            states.append(health_mod.DEGRADED)
            continue
        rep = _report_body(doc)
        h = rep.get("health") or {}
        g = rep.get("cluster") or {}
        entry: dict = {
            "state": h.get("state"),
            "reasons": h.get("reasons", []),
        }
        if g:
            entry["gossip"] = {
                "tx_wires": g.get("tx_wires"),
                "tx_dropped": g.get("tx_dropped"),
                "rx_wires": g.get("rx_wires"),
                "rx_seq_gaps": g.get("rx_seq_gaps"),
                "merged_digest": g.get("merged_digest"),
            }
            net = g.get("net")
            if net:
                entry["gossip"]["net"] = {k: net.get(k) for k in _NET_KEYS}
        rb = rep.get("rebalance")
        if rb:
            entry["rebalance"] = rb
            for k, v in rb.items():
                if isinstance(v, int):
                    rebalance_totals[k] = rebalance_totals.get(k, 0) + v
        per_report[path] = entry
        if h.get("state"):
            states.append(h["state"])
    out = {
        "state": (health_mod.worst(*states) if states else None),
        "reports": per_report,
    }
    if rebalance_totals:
        out["rebalance"] = rebalance_totals
    return out


def _merged_predict(reports: list) -> dict | None:
    """Merge the ``predict`` blocks of engine-report JSONs (the dispatch
    governor's counters) with :meth:`~.engine.predict.DispatchGovernor
    .merge_reports`, the fold the cluster supervisor's ``aggregate()``
    applies.  None when no report carries a predict block."""
    blocks = [_report_body(doc)["predict"] for _path, doc, err in reports
              if err is None and _report_body(doc).get("predict")]
    if not blocks:
        return None
    from flowsentryx_tpu_torch.engine.predict import DispatchGovernor

    return DispatchGovernor.merge_reports(blocks)


def _merged_boot(reports: list) -> dict | None:
    """Merge the ``boot`` blocks of engine-report JSONs (the compile
    cache's hits, misses and stores, the slowest serving-ready wall) into
    one fleet view, the fold the cluster supervisor's ``aggregate()``
    applies.  None when no report carries a boot block."""
    per_report: dict = {}
    hits = misses = stores = 0
    max_ready = 0.0
    for path, doc, err in reports:
        if err is not None:
            continue
        boot = _report_body(doc).get("boot")
        if not boot:
            continue
        per_report[path] = boot
        cache = boot.get("cache")
        if isinstance(cache, dict):
            hits += cache.get("hits", 0)
            misses += cache.get("misses", 0)
            stores += cache.get("stores", 0)
        max_ready = max(max_ready, boot.get("serving_ready_s") or 0.0)
    if not per_report:
        return None
    return {
        "per_report": per_report,
        "cache_hits": hits,
        "cache_misses": misses,
        "cache_stores": stores,
        "max_serving_ready_s": round(max_ready, 4),
    }


def _ring_header(path: str) -> dict:
    """Cursors and geometry of a shm ring file, read from its header."""
    import mmap

    import numpy as np

    from flowsentryx_tpu_torch.core import wire

    with open(path, "rb") as f, mmap.mmap(f.fileno(), 0,
                                          prot=mmap.PROT_READ) as m:
        hdr = np.frombuffer(m[:wire.SHM_HDR_SIZE], np.uint64)
    head = int(hdr[wire.SHM_HEAD_OFFSET // 8])
    tail = int(hdr[wire.SHM_TAIL_OFFSET // 8])
    return {
        "present": True,
        "magic_ok": int(hdr[0]) == wire.SHM_MAGIC,
        "capacity": int(hdr[wire.SHM_CAPACITY_OFFSET // 8]),
        "record_size": int(hdr[wire.SHM_RECORD_SIZE_OFFSET // 8]),
        "produced": head,
        "consumed": tail,
        "backlog": head - tail,
    }


def _merged_reports(globs: list) -> dict:
    """One read pass over the engine reports feeding all four merges:
    ``latency`` and ``health`` always, ``predict`` and ``boot`` when a
    report carries them."""
    reports = list(_iter_engine_reports(globs))
    out = {"latency": _merged_latency(reports),
           "health": _merged_engine_health(reports)}
    predict = _merged_predict(reports)
    if predict is not None:
        out["predict"] = predict
    boot = _merged_boot(reports)
    if boot is not None:
        out["boot"] = boot
    return out


#: What the refused ``--pin`` and kernel-map alerts would read.
_NO_KERNEL_MAPS = ("the eBPF plane's pinned maps (bpf/ is not ported: the "
                   "port reads no kernel maps)")


def _cmd_status(args: argparse.Namespace) -> int:
    """Inspect the shm transport (ring cursors and backlog) and, with
    ``--engine-report``, the merged engine reports."""
    if args.pin is not None:
        print(f"fsx status: refusing --pin: it reads {_NO_KERNEL_MAPS}; "
              "run the reference's fsx status --pin", file=sys.stderr)
        return 1
    out = {}
    for name, path in (("feature_ring", args.feature_ring),
                       ("verdict_ring", args.verdict_ring)):
        out[name] = (_ring_header(path) if Path(path).exists()
                     else {"present": False})
    if args.engine_report:
        out.update(_merged_reports(args.engine_report))
    print(json.dumps(out, indent=2))
    return 0


#: ``monitor`` flags of the reference that read only the kernel maps.
_MONITOR_REFUSED = ("pin", "alert_drop_pps", "alert_blacklist")

#: The reference's refusals of an engine-report alert without a report.
_MONITOR_NEEDS_REPORTS = {
    "alert_degraded":
        "fsx monitor: --alert-degraded requires --engine-report GLOB "
        "(health rides the engine reports; the kernel maps cannot carry "
        "it)",
    "alert_p99_us":
        "fsx monitor: --alert-p99-us requires --engine-report GLOB (the "
        "p99 comes from merged engine reports; the kernel maps cannot "
        "carry it)",
    "alert_prewarm_miss":
        "fsx monitor: --alert-prewarm-miss requires --engine-report GLOB "
        "(the governor's pre-warm counters ride the engine reports; the "
        "kernel maps cannot carry them)",
    "alert_cold_boot":
        "fsx monitor: --alert-cold-boot requires --engine-report GLOB "
        "(the compile-cache hit/miss story rides the engine reports' boot "
        "block; the kernel maps cannot carry it)",
}


def _monitor_alerts(args: argparse.Namespace, rec: dict) -> list[str]:
    """The four engine-report alerts of one ``monitor`` record."""
    alerts = []
    p99 = rec["latency"]["seal_to_verdict_us"].get("p99", 0)
    if args.alert_p99_us and p99 and p99 >= args.alert_p99_us:
        alerts.append(f"engine p99 latency {p99:.0f} us >= "
                      f"{args.alert_p99_us:.0f}")
    hl = rec["health"]
    if args.alert_degraded and hl["state"] and hl["state"] != "healthy":
        reasons = sorted({r for e in hl["reports"].values()
                          for r in e.get("reasons", [])})
        # the fleet's reshaping friction gets its own line, so that
        # "serving is degraded" reads apart from "reshaping is degraded"
        reshape = [r for r in reasons
                   if r.startswith(("rebalance_", "elastic_"))]
        steady = [r for r in reasons if r not in reshape]
        if steady or not reshape:
            alerts.append(f"engine health {hl['state'].upper()}: "
                          + (", ".join(steady) or "rank-level failure"))
        if reshape:
            alerts.append(f"fleet reshaping {hl['state'].upper()}: "
                          + ", ".join(reshape))
    boot = rec.get("boot")
    if boot is not None and args.alert_cold_boot:
        # a rank whose boot names a cache yet loaded nothing from it paid
        # the full build the cache exists to prevent
        cold = sorted(p for p, b in boot["per_report"].items()
                      if isinstance(b.get("cache"), dict)
                      and b["cache"].get("hits", 0) == 0)
        if cold:
            alerts.append("cold boot under a configured compile cache "
                          "(zero hits): " + ", ".join(cold))
    predict = rec.get("predict")
    if predict is not None:
        misses = predict.get("prewarm_misses", 0)
        if args.alert_prewarm_miss and misses >= args.alert_prewarm_miss:
            alerts.append(
                f"governor prewarm misses {misses} >= "
                f"{args.alert_prewarm_miss} (forecast pre-warmed rungs the "
                "traffic never filled — compile/warm work wasted on a "
                "stale or wrong burst model)")
    return alerts


def _cmd_monitor(args: argparse.Namespace) -> int:
    """Periodic snapshots of the merged engine reports -> JSONL and
    threshold alerts.  Each tick appends one JSON line with the merged
    ``latency``, ``health``, ``boot`` and ``predict`` blocks; alerts
    print to stderr and ride the record.  The record's ``kernel`` key
    says that the port reads no kernel maps (the reference's counters,
    their ``per_s`` deltas and the drop and blacklist alerts come from
    them)."""
    import time

    for flag in _MONITOR_REFUSED:
        if getattr(args, flag) is not None:
            name = flag.replace("_", "-")
            print(f"fsx monitor: refusing --{name}: it reads "
                  f"{_NO_KERNEL_MAPS}; run the reference's fsx monitor "
                  f"--{name}", file=sys.stderr)
            return 1
    if not args.engine_report:
        for flag, msg in _MONITOR_NEEDS_REPORTS.items():
            if getattr(args, flag):
                print(msg, file=sys.stderr)
                return 1
        print("fsx monitor: requires --engine-report GLOB (the port reads "
              "no kernel maps: the engine reports are its only source)",
              file=sys.stderr)
        return 1
    kernel = {"error": "the port reads no kernel maps (bpf/ is not "
                       "ported); kernel counters come from the "
                       "reference's fsx monitor --pin"}
    fh = open(args.out, "a") if args.out else None
    try:
        for tick in range(args.count) if args.count else iter(int, 1):
            rec: dict = {"ts": round(time.time(), 3), "kernel": kernel,
                         **_merged_reports(args.engine_report)}
            alerts = _monitor_alerts(args, rec)
            if alerts:
                rec["alerts"] = alerts
                for a in alerts:
                    print(f"fsx monitor: ALERT {a}", file=sys.stderr)
            line = json.dumps(rec)
            print(line, flush=True)
            if fh:
                fh.write(line + "\n")
                fh.flush()
            if args.count and tick == args.count - 1:
                break
            time.sleep(args.interval)
    except KeyboardInterrupt:
        pass
    finally:
        if fh:
            fh.close()
    return 0


#: ``bench`` flags of the reference that the port refuses by name.
_BENCH_REFUSED = {
    "smoke": "the headline benchmark, bench.py, is the reference's JAX/TPU "
             "harness; the port's card check is chip_smoke.py",
    "scaling": "the step time over a device mesh needs the sharded step "
               "(parallel/step.py), which is not ported",
    "cluster": "the paced fleet comparison runs the reference's "
               "scripts/cluster_bench.py against a pre-cluster checkout",
    "baseline_repo": "it names the pre-cluster checkout of --cluster",
}


def _cmd_bench(args: argparse.Namespace) -> int:
    """The five BASELINE configs (``--scenarios``), one JSON line each."""
    for flag, why in _BENCH_REFUSED.items():
        if getattr(args, flag) not in (None, False):
            name = flag.replace("_", "-")
            print(f"fsx bench: refusing --{name}: {why}", file=sys.stderr)
            return 1
    if not args.scenarios:
        print("fsx bench: refusing a bare bench: "
              f"{_BENCH_REFUSED['smoke']}; run bench --scenarios",
              file=sys.stderr)
        return 1
    from flowsentryx_tpu_torch import benchmarks
    from flowsentryx_tpu_torch.core.device import resolve_device

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"fsx bench: {e}", file=sys.stderr)
        return 1
    for result in benchmarks.run_suite(scale=args.scale,
                                       names=args.only or None,
                                       device=device):
        print(json.dumps(result), flush=True)
    return 0


def _cmd_chaos(args: argparse.Namespace) -> int:
    """The deterministic fault-injection campaign over the port's stack
    (:mod:`.chaos`), printed as the reference's ``fsx chaos`` prints it,
    plus one line per fault or plant the port does not run yet.
    ``--list`` prints the reference's registry and imports no torch."""
    from flowsentryx_tpu_torch.chaos import faults as chaos_faults

    if args.list:
        for name, (cls, desc) in chaos_faults.FAULTS.items():
            print(f"{name:20s} [{cls}]\n    {desc}")
        return 0
    from flowsentryx_tpu_torch.chaos import run_campaign
    from flowsentryx_tpu_torch.core.device import resolve_device

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"fsx chaos: {e}", file=sys.stderr)
        return 1
    rep = run_campaign(seed=args.seed, quick=args.quick,
                       workdir=args.workdir, out=args.out, device=device)
    if args.json:
        print(json.dumps(rep, indent=2))
    else:
        for r in rep["faults"]:
            status = "OK" if r["ok"] else "FAILED"
            invs = ", ".join(
                f"{i['name']}{'' if i['ok'] else '!'}"
                for i in r["invariants"])
            print(f"fsx chaos: {r['fault']:40s} {status}  ({invs})")
            if not r["ok"]:
                for i in r["invariants"]:
                    if not i["ok"]:
                        print(f"  INVARIANT {i['name']}: {i['detail']}",
                              file=sys.stderr)
        for p in rep["planted_regressions"]:
            status = "CAUGHT" if p["ok"] else "MISSED"
            print(f"fsx chaos: plant {p['plant']:32s} {status}  "
                  f"(by {p['caught_by']})")
        print(f"fsx chaos: {rep['n_fault_classes']} fault classes, "
              f"{rep['invariants_checked']} invariant checks, "
              f"{len(rep['planted_regressions'])} planted regressions, "
              f"seed {rep['seed']}, {rep['wall_s']}s")
    if args.out and not args.json:
        print(f"fsx chaos: report -> {args.out}")
    if rep["ok"]:
        if not args.json:
            print("fsx chaos: PASS")
        return 0
    print("fsx chaos: FAIL", file=sys.stderr)
    return 1


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m flowsentryx_tpu_torch.cli",
        description="FlowSentryX inference plane on PyTorch/CUDA")
    sub = ap.add_subparsers(dest="cmd", required=True)
    s = sub.add_parser("serve", help="serve a synthetic scenario or a "
                       "record file")
    s.add_argument("--config", help="JSON config file (the reference's "
                   "FsxConfig format)")
    s.add_argument("--records",
                   help="replay a raw file of 48-byte flow records")
    s.add_argument("--scenario", default="syn_benign_mix",
                   help="synthetic scenario (engine/traffic.py Scenario)")
    s.add_argument("--rate", type=float, default=1e6, help="synthetic pps")
    s.add_argument("--packets", type=int, default=0,
                   help="stop after N records")
    s.add_argument("--batches", type=int, default=0,
                   help="stop after N batches")
    s.add_argument("--seconds", type=float, default=0,
                   help="stop after S seconds")
    s.add_argument("--table-capacity", type=int, default=None,
                   help="state-table rows (power of two); default the "
                        "config's (2^20)")
    s.add_argument("--model", default=None,
                   help="registered model name (logreg_int8, "
                        "logreg_int8_pallas, logreg_float, mlp, "
                        "multiclass); default the config's")
    s.add_argument("--artifact", help="trained .npz artifact to serve")
    s.add_argument("--mega", type=_mega_arg, default=0,
                   help="group N backlogged batches into one megastep "
                        "dispatch (one CUDA graph replay on the card); "
                        "'auto' = adaptive coalescing: every power-of-two "
                        "group size up to 8, the largest the backlog fills")
    s.add_argument("--device-loop", type=_device_loop_arg, default=0,
                   metavar="N",
                   help="drain ring of depth N: a backlog of N top-rung "
                        "--mega groups goes to the card as ONE captured "
                        "round, each slot uploaded on a copy stream while "
                        "the previous round computes; needs --mega; 0 = "
                        "per-group dispatch. 'auto' picks the depth from "
                        "a short boot-time calibration drain (announced)")
    s.add_argument("--compile-cache", metavar="DIR",
                   help="keep the nvcc-built kernel libraries here: a "
                        "later boot of the same staged shape and toolchain "
                        "loads them instead of running nvcc. Fail-open: a "
                        "miss, drift or corrupt entry rebuilds, counted in "
                        "the report's boot block")
    s.add_argument("--tiered-warm", action="store_true",
                   help="open serving once the single step and the top "
                        "--mega rung are captured; a background thread "
                        "captures the other rungs and the ring (the same "
                        "verdicts throughout; needs --mega)")
    s.add_argument("--slo-us", type=int, default=0, metavar="N",
                   help="latency-budget serving: bound the feature->verdict "
                        "path at N µs — the oldest pending record's age and "
                        "the warm-measured step time of each rung cap how "
                        "long the engine holds for a deeper backlog, which "
                        "rung it climbs to and when the batcher flushes. 0 "
                        "(default) is the throughput-tuned engine. The "
                        "report's latency block carries p50/p90/p99/p999 "
                        "and budget misses either way")
    s.add_argument("--predict", action="store_true",
                   help="predictive dispatch governor (requires --slo-us): "
                        "a burst forecaster over arrival stamps pre-warms "
                        "the predicted rung before each onset and flushes "
                        "at the forecast burst end, inside the budget; "
                        "quiescent on aperiodic traffic. Counters in the "
                        "report's predict block")
    s.add_argument("--watchdog-s", type=float, default=None, metavar="S",
                   help="dispatch-watchdog stall bound: batches in flight "
                        "and no completion for S seconds dump every "
                        "thread's stack (soft trip), for 2S fail the drain "
                        "loudly (default 10; 0 disables)")
    s.add_argument("--no-sink-thread", action="store_true",
                   help="sink verdicts on the dispatch thread (default: a "
                        "sink thread where the host has >= 3 cores)")
    s.add_argument("--feature-ring", help="the daemon's shm feature ring "
                   "(48-byte records, or fsxd --compact's 16-byte ones)")
    s.add_argument("--verdict-ring", help="the daemon's shm verdict ring "
                   "(blocked sources and their expiry go back to it)")
    s.add_argument("--ingest-workers", type=int, default=0,
                   help="drain the feature ring with N spawned worker "
                        "processes that hand the engine sealed batches "
                        "(pair with fsxd --shards N; N=1 fronts an "
                        "unsharded daemon; 0 = the inline drain)")
    s.add_argument("--strict-ingest", action="store_true",
                   help="raise on an ingest-worker crash (after its queue "
                        "drains) instead of the default per-shard "
                        "fail-open")
    s.add_argument("--quarantine-dir", metavar="DIR",
                   help="spool refused sealed batches here (count-only "
                        "without it)")
    s.add_argument("--artifact-reload", action="store_true",
                   help="watch --artifact's mtime and hot-swap the model "
                        "live when the file changes: no drain, no new "
                        "capture, in-flight dispatches finish on the old "
                        "model (the same family and shapes, and on the "
                        "compact16 wire the same input observer; a bad "
                        "push is announced and serving continues on the "
                        "incumbent)")
    s.add_argument("--verdict-k", type=int, default=None, metavar="K",
                   help="compact verdict-wire slots per batch (overrides "
                        "the config's batch.verdict_k, default 64): the "
                        "step compacts newly blocked flows into a K-slot "
                        "readback, falling back to the full block arrays "
                        "only on overflow; 0 fetches the full block "
                        "arrays every batch")
    s.add_argument("--sim-kernel-tier", metavar="PLAN",
                   help="simulate the distilled kernel tier in front of the "
                        "engine with this fsx-distill plan (.npz): "
                        "confident-attack records drop (plus a simulated "
                        "blacklist TTL), confident-benign records are "
                        "suppressed, only the uncertain band reaches the "
                        "step; per-band counters land in the report's "
                        "escalation block. Record path only (no "
                        "--ingest-workers / compact-emit rings)")
    s.add_argument("--profile", metavar="DIR",
                   help="write a torch.profiler trace of the serve (host "
                        "and, on the card, its kernels) to this directory")
    s.add_argument("--checkpoint", help="save table, stats and clock here "
                                        "on exit")
    s.add_argument("--checkpoint-every", type=float, default=0,
                   help="also checkpoint every S seconds while serving "
                        "(requires --checkpoint)")
    s.add_argument("--restore", help="resume from a checkpoint file "
                                     "(either package's)")
    s.add_argument("--cluster-rank", metavar="R/N", default=None,
                   help="serve as engine R of an N-engine cluster: own ring "
                        "shards [R*W, (R+1)*W) of the daemon's N*W-shard "
                        "fan-out end to end (W = --ingest-workers) and "
                        "gossip verdicts with the peers; requires "
                        "--ingest-workers and --cluster-dir (cli cluster "
                        "is the supervised form)")
    s.add_argument("--cluster-dir", default=None,
                   help="the cluster's gossip and status plane directory "
                        "(cli cluster creates it before any engine boots)")
    s.add_argument("--device", default=None,
                   help="torch device; default the card (raises without one)")
    s.add_argument("--json", action="store_true",
                   help="print the report as one JSON line")
    s.set_defaults(fn=_cmd_serve)

    pc = sub.add_parser("pcap", help="convert a capture to flow records")
    pc.add_argument("pcap", help="classic-pcap capture file")
    pc.add_argument("out", help="output file (raw fsx_flow_record structs)")
    pc.add_argument("--emit-all", action="store_true",
                    help="emit every packet (default: kernel gating — "
                         "every packet while young, then every 16th)")
    pc.add_argument("--limit", type=int, default=0,
                    help="stop after N emitted records")
    pc.set_defaults(fn=_cmd_pcap)

    t = sub.add_parser("train", help="train a model, export the artifact")
    t.add_argument("--model", default="logreg_int8",
                   choices=["logreg_int8", "mlp", "multiclass"])
    t.add_argument("--data",
                   help="CSV glob (CICIDS2017/CICDDoS2019 format), or "
                        "'fixture' for the CICIDS-calibrated stand-in")
    t.add_argument("--synthetic", type=int, default=None,
                   help="dataset size for synthetic/fixture data "
                        "(default 50000 synthetic; full 2.52M fixture; "
                        "200000 for multiclass)")
    t.add_argument("--epochs", type=int, default=200)
    t.add_argument("--seed", type=int, default=0)
    t.add_argument("--slow-weight", type=float, default=1.0,
                   dest="slow_weight",
                   help="BCE upweight for slow-attack rows (fixture "
                        "data only; x4 is the deployed artifact's "
                        "recipe)")
    t.add_argument("--augment-shift", type=int, default=0,
                   dest="augment_shift",
                   help="add N domain-randomized training copies "
                        "(stress.shift_augment; 2 is the robust-MLP "
                        "recipe)")
    t.add_argument("--out", help="artifact output path (.npz)")
    t.add_argument("--device", default=None,
                   help="torch device; default the card (raises without one)")
    t.set_defaults(fn=_cmd_train)

    di = sub.add_parser(
        "distill",
        help="compile a trained int8 artifact into the kernel tier's plan")
    di.add_argument("artifact",
                    help="trained model artifact (.npz), e.g. "
                         "artifacts/logreg_int8.npz")
    di.add_argument("--model", default="logreg_int8",
                    help="model family the artifact was trained as "
                         "(must be distillable; default logreg_int8)")
    di.add_argument("--thresholds", default="0.1,0.9", metavar="LO,HI",
                    help="escalation band edges in probability space: "
                         "score<LO passes in-kernel, score>HI drops "
                         "in-kernel, the band between escalates "
                         "(default 0.1,0.9)")
    di.add_argument("--out", metavar="PLAN.npz",
                    help="write the compiled plan here (consumed by "
                         "serve --sim-kernel-tier)")
    di.add_argument("--blob", metavar="PATH",
                    help="write the raw ml_model_map value bytes "
                         "(struct fsx_ml_model) here")
    di.add_argument("--check", action="store_true", default=None,
                    help="refused: needs the eBPF verifier (bpf/)")
    di.add_argument("--emulate", action="store_true", default=None,
                    help="refused: needs the eBPF emulator (bpf/)")
    di.add_argument("--emulate-n", type=int,
                    help="refused: sizes the corpus of --emulate")
    di.add_argument("--report", metavar="PATH",
                    help="also write the JSON report here")
    di.add_argument("--pin",
                    help="refused: needs the bpf loader and a pinned "
                         "ml_model_map")
    di.add_argument("--json", action="store_true",
                    help="machine-readable report")
    di.add_argument("--device", default=None,
                    help="torch device; default the card (raises without one)")
    di.set_defaults(fn=_cmd_distill)

    cl = sub.add_parser(
        "cluster",
        help="multi-engine scale-out on one host: N supervised engine "
             "processes, each owning a shard span end to end, sharing "
             "only the gossip blacklist plane")
    cl.add_argument("--engines", type=int, default=2, metavar="N",
                    help="engine processes (>= 2; each owns "
                         "shards/engines ring shards end to end)")
    cl.add_argument("--shards", type=int, default=2,
                    help="TOTAL daemon ring shards (fsxd --shards); a "
                         "multiple of --engines")
    cl.add_argument("--config", help="JSON config file (shared)")
    cl.add_argument("--feature-ring", default=None,
                    help="the daemon's shm feature-ring base path")
    cl.add_argument("--verdict-ring", default=None,
                    help="verdict-ring base path: engine r produces "
                         "BASE.r<r>; omit for NullSink engines")
    cl.add_argument("--cluster-dir", default=None,
                    help="gossip/status plane directory (default: "
                         "<feature-ring>.cluster)")
    cl.add_argument("--artifact", help="trained model artifact (.npz), "
                    "served by every engine")
    cl.add_argument("--mega", type=_mega_arg, default=0,
                    help="per-engine coalescing ladder (serve --mega)")
    cl.add_argument("--device-loop", type=int, default=0, metavar="N",
                    help="per-engine drain-ring depth (explicit only; "
                         "requires --mega)")
    cl.add_argument("--compile-cache", metavar="DIR",
                    help="the fleet's kernel-library cache (serve "
                         "--compile-cache; every rank shares DIR)")
    cl.add_argument("--tiered-warm", action="store_true",
                    help="per-engine tiered warm (serve --tiered-warm; "
                         "requires --mega)")
    cl.add_argument("--verdict-k", type=int, default=None,
                    help="compact verdict-wire slots (serve --verdict-k)")
    cl.add_argument("--table-capacity", type=int, default=None,
                    metavar="N", help="PER-ENGINE flow-table rows")
    cl.add_argument("--seconds", type=float, default=0,
                    help="serve for S seconds, then stop-drain every "
                         "engine (0 = until ^C, or the end of --drain)")
    cl.add_argument("--drain", action="store_true",
                    help="the ring shards are prefilled: every rank serves "
                         "its shards to exhaustion in one timed run, all "
                         "ranks starting together once warm, then exits")
    cl.add_argument("--checkpoint", metavar="TEMPLATE",
                    help="per-engine checkpoint path template; MUST "
                         "contain {rank} (restarts restore from it)")
    cl.add_argument("--checkpoint-every", type=float, default=0,
                    help="checkpoint every S seconds while serving "
                         "(requires --checkpoint)")
    cl.add_argument("--max-restarts", type=int, default=2,
                    help="crash restarts per rank before it is parked as "
                         "failed (default 2)")
    cl.add_argument("--slo-us", type=int, default=0, metavar="N",
                    help="per-engine latency budget (serve --slo-us)")
    cl.add_argument("--predict", action="store_true",
                    help="per-engine burst forecaster (serve --predict; "
                         "requires --slo-us)")
    cl.add_argument("--pin-cores", choices=("auto", "on", "off"),
                    default="auto",
                    help="pin rank r (and its drain workers) to core r "
                         "with a one-thread torch pool (auto: only when "
                         "the fleet fits the host's cores)")
    cl.add_argument("--device", default=None,
                    help="torch device of every engine; default the card "
                         "(a rank without one fails, it never serves on "
                         "the CPU unless asked)")
    cl.add_argument("--elastic", action="store_true",
                    help="self-reshaping fleet: provision the plane at "
                         "--max-engines, boot --engines of them live, and "
                         "let the autoscaler grow, shrink and rebalance "
                         "through live shard handoffs (hysteresis and "
                         "cooldown; every decision logged with its "
                         "signal vector)")
    cl.add_argument("--min-engines", type=int, default=None, metavar="N",
                    help="autoscaler floor: never shrink the live set "
                         "below N engines (requires --elastic; default 1)")
    cl.add_argument("--max-engines", type=int, default=None, metavar="N",
                    help="autoscaler ceiling and the provisioned plane: "
                         "rings, status blocks and mailboxes for N ranks "
                         "exist from boot, so a grow is a spawn (requires "
                         "--elastic; default --engines + 1; --shards must "
                         "divide by it)")
    cl.add_argument("--adopt", action="store_true",
                    help="re-attach to a LIVE plane instead of refusing "
                         "it: census the ranks from their status blocks "
                         "(serving ranks keep serving, dead ranks "
                         "respawn from their checkpoints)")
    cl.add_argument("--hosts", default=None, metavar="IP:PORT,...",
                    help="multi-host fleet: every host's gossip base "
                         "address, the same list on every host (the "
                         "supervisor's federation beacon binds the base "
                         "port, engine r binds PORT+1+r; verdict wires "
                         "gossip over UDP with epoch rebase)")
    cl.add_argument("--host-id", type=int, default=None, metavar="I",
                    help="this host's index into --hosts (required with "
                         "--hosts)")
    cl.add_argument("--gossip-listen", default=None, metavar="IP:PORT",
                    help="local bind address instead of this host's "
                         "--hosts entry (e.g. 0.0.0.0:9000 behind NAT)")
    cl.set_defaults(fn=_cmd_cluster)

    reports_help = ("merge engine-report JSONs matching this glob (serve "
                    "output, or a cluster dir's report_r*_g*.json); "
                    "repeatable")
    st = sub.add_parser("status", help="inspect the shm transport and the "
                        "merged engine reports")
    st.add_argument("--feature-ring", default="/tmp/fsx_feature_ring")
    st.add_argument("--verdict-ring", default="/tmp/fsx_verdict_ring")
    st.add_argument("--pin", default=None,
                    help=f"refused: reads {_NO_KERNEL_MAPS}")
    st.add_argument("--engine-report", action="append", default=None,
                    metavar="GLOB",
                    help=reports_help + ": one seal->verdict latency "
                         "block (HDR bucket merge), the health ladder "
                         "with the gossip counters, the governors' and "
                         "the boots' folds")
    st.set_defaults(fn=_cmd_status)

    mo = sub.add_parser(
        "monitor", help="periodic merged engine-report snapshots -> JSONL "
                        "+ alerts",
        description="Periodic merged engine-report snapshots -> JSONL + "
                    "alerts.  The port reads no kernel maps: each record's "
                    "'kernel' key says so, and the reference's per_s "
                    "deltas and its drop-rate and blacklist-size alerts, "
                    "which derive from the kernel counters, do not appear.")
    mo.add_argument("--interval", type=float, default=2.0,
                    help="seconds between snapshots")
    mo.add_argument("--count", type=int, default=0,
                    help="stop after N snapshots (0 = run until ^C)")
    mo.add_argument("--out", help="append JSONL history to this file")
    mo.add_argument("--engine-report", action="append", default=None,
                    metavar="GLOB",
                    help=reports_help + "; read every tick (required)")
    mo.add_argument("--alert-p99-us", type=float, default=0,
                    help="alert when the merged engine p99 seal->verdict "
                         "latency reaches N µs")
    mo.add_argument("--alert-degraded", action="store_true",
                    help="alert when any merged report's health ladder "
                         "reads DEGRADED or FAILED, naming the reasons; "
                         "rebalance_*/elastic_* reasons get their own line")
    mo.add_argument("--alert-prewarm-miss", type=int, default=0,
                    metavar="N",
                    help="alert when the merged governor prewarm-miss "
                         "count reaches N")
    mo.add_argument("--alert-cold-boot", action="store_true",
                    help="alert when a report's boot block names a "
                         "compile-cache dir yet loaded zero entries from it")
    for flag in _MONITOR_REFUSED:
        mo.add_argument("--" + flag.replace("_", "-"), default=None,
                        help=f"refused: reads {_NO_KERNEL_MAPS}")
    mo.set_defaults(fn=_cmd_monitor)

    b = sub.add_parser("bench", help="run the five BASELINE configs "
                       "(--scenarios)")
    b.add_argument("--scenarios", action="store_true",
                   help="run the five BASELINE configs, one JSON line each")
    b.add_argument("--scale", type=float, default=1.0,
                   help="packet-count multiplier for --scenarios")
    b.add_argument("--only", action="append",
                   help="substring filter on scenario names (repeatable)")
    b.add_argument("--device", default=None,
                   help="torch device; default the card (raises without one)")
    for flag, why in _BENCH_REFUSED.items():
        b.add_argument("--" + flag.replace("_", "-"),
                       action=None if flag == "baseline_repo"
                       else "store_true",
                       default=None, help=f"refused: {why}")
    b.set_defaults(fn=_cmd_bench)

    ch = sub.add_parser(
        "chaos",
        help="deterministic fault-injection campaign over the port's "
             "stack: kills, crash loops, corrupt checkpoints, shm slot "
             "corruption, poisoned batches, gossip floods, clock jumps, "
             "a wedged sink — judged by named invariants, with planted "
             "regressions as negative controls")
    ch.add_argument("--seed", type=int, default=17,
                    help="campaign seed: fixes traffic, corruption "
                         "offsets and kill schedule (default 17)")
    ch.add_argument("--quick", action="store_true",
                    help="trim traffic volume, keep full fault-class "
                         "and plant coverage")
    ch.add_argument("--workdir", metavar="DIR",
                    help="scratch dir for rings/checkpoints/"
                         "quarantine spools (default: a fresh tempdir)")
    ch.add_argument("--list", action="store_true",
                    help="print the fault registry and exit")
    ch.add_argument("--json", action="store_true",
                    help="machine-readable report")
    ch.add_argument("--out", metavar="PATH",
                    help="also write the JSON report here")
    ch.add_argument("--device", default=None,
                    help="torch device of the campaign's engine; default "
                         "the card (refused without one)")
    ch.set_defaults(fn=_cmd_chaos)
    return ap


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
