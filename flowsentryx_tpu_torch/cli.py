"""Command line of the port: ``python -m flowsentryx_tpu_torch.cli serve``,
``... cli pcap``, ``... cli train`` and ``... cli distill``.

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
need the eBPF plane, ``bpf/``, which the port does not have).  Every verb runs on the
card unless ``--device cpu`` is given, and raises without one.
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


def _cmd_serve(args: argparse.Namespace) -> int:
    bad = _refuse(args)
    if bad:
        print(f"serve: {bad}", file=sys.stderr)
        return 1
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

    from flowsentryx_tpu_torch.core import schema
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

            source = ShardedIngest(args.feature_ring, args.ingest_workers,
                                   strict=args.strict_ingest,
                                   quarantine_dir=args.quarantine_dir)
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
                     compile_cache=args.compile_cache)
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
        rep = _profiled(eng, args, device)
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
    return ap


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
