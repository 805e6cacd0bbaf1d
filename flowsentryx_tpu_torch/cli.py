"""Command line of the port: ``python -m flowsentryx_tpu_torch.cli serve``.

Counterpart of the reference's ``fsx serve`` on its in-process sources:
builds an :class:`~.engine.Engine` on the card (or on the CPU with
``--device cpu``) from ``--config`` (the reference's JSON config file),
serves a synthetic scenario at ``--rate`` or a ``--records`` file of
48-byte flow records, and prints the report as JSON; ``--mega N|auto``
groups backlogged batches as the reference's does (compact16 only: it is
refused before boot for a model served over raw48).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import secrets
import sys
from pathlib import Path

from flowsentryx_tpu_torch.core.config import DEFAULT_CONFIG, FsxConfig


def _mega_arg(s: str) -> int | str:
    """``--mega``: a fixed group size or ``auto``, the adaptive
    power-of-two coalescing ladder (``Engine(mega_n="auto")``)."""
    if s == "auto":
        return "auto"
    try:
        return int(s)
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"--mega takes an integer or 'auto', got {s!r}") from None


def _cmd_serve(args: argparse.Namespace) -> int:
    # imports after argument parsing: a bad flag must not pay torch's boot
    import numpy as np

    from flowsentryx_tpu_torch.core import schema
    from flowsentryx_tpu_torch.core.device import resolve_device
    from flowsentryx_tpu_torch.engine import (
        ArraySource, Engine, NullSink, TrafficSource,
    )
    from flowsentryx_tpu_torch.engine.traffic import Scenario, TrafficSpec
    from flowsentryx_tpu_torch.models.registry import get_model, load_artifact

    cfg = (FsxConfig.from_json(Path(args.config).read_text())
           if args.config else DEFAULT_CONFIG)
    if args.model:
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, name=args.model))
    if args.table_capacity:
        cfg = dataclasses.replace(cfg, table=dataclasses.replace(
            cfg.table, capacity=args.table_capacity))
    if cfg.table.salt == 0:
        # a random boot-time hash salt, as the reference's serve draws:
        # slot collisions cannot be precomputed by an attacker
        cfg = dataclasses.replace(cfg, table=dataclasses.replace(
            cfg.table, salt=secrets.randbits(32)))
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
    if args.mega and not hasattr(params, "in_scale"):
        # the engine's wire rule, checked before boot
        print("serve: --mega requires the compact16 wire, but the selected "
              "model exposes no input observer so the engine would serve "
              "raw48; pass an observer-carrying artifact (e.g. --artifact "
              "artifacts/logreg_int8.npz) or drop --mega", file=sys.stderr)
        return 1
    if args.records:
        rec = np.frombuffer(Path(args.records).read_bytes(),
                            schema.FLOW_RECORD_DTYPE)
        source = ArraySource(rec[:args.packets] if args.packets else rec)
    else:
        source = TrafficSource(TrafficSpec(scenario=Scenario(args.scenario),
                                           rate_pps=args.rate),
                               total=args.packets or None)
    eng = Engine(cfg, source, NullSink(), params=params, device=device,
                 mega_n=args.mega)
    eng.warm()
    rep = eng.run(max_batches=args.batches or None,
                  max_seconds=args.seconds or None)
    out = rep._asdict()
    print(json.dumps(out, indent=None if args.json else 2))
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
    s.add_argument("--device", default=None,
                   help="torch device; default the card (raises without one)")
    s.add_argument("--json", action="store_true",
                   help="print the report as one JSON line")
    s.set_defaults(fn=_cmd_serve)
    return ap


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
