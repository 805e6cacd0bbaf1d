"""Command line of the port: ``python -m flowsentryx_tpu_torch.cli serve``.

Counterpart of the reference's ``fsx serve`` on its synthetic-scenario
path: builds an :class:`~.engine.Engine` on the card (or on the CPU with
``--device cpu``), serves a scenario, and prints the report as JSON;
``--mega N|auto`` groups backlogged batches as the reference's does.
"""

from __future__ import annotations

import argparse
import json
import secrets
import sys

from flowsentryx_tpu_torch.core.config import FsxConfig, ModelConfig, TableConfig


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
    from flowsentryx_tpu_torch.core.device import resolve_device
    from flowsentryx_tpu_torch.engine import Engine, NullSink, TrafficSource
    from flowsentryx_tpu_torch.engine.traffic import Scenario, TrafficSpec
    from flowsentryx_tpu_torch.models.registry import load_artifact

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"serve: {e}", file=sys.stderr)
        return 1
    # a random boot-time hash salt, as the reference's serve draws: slot
    # collisions cannot be precomputed by an attacker
    cfg = FsxConfig(
        model=ModelConfig(name=args.model),
        table=TableConfig(capacity=args.table_capacity,
                          salt=secrets.randbits(32)))
    params = (load_artifact(cfg.model.name, args.artifact, device)
              if args.artifact else None)
    source = TrafficSource(TrafficSpec(scenario=Scenario(args.scenario),
                                       rate_pps=1e6),
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
    s = sub.add_parser("serve", help="serve a synthetic scenario")
    s.add_argument("--scenario", default="syn_benign_mix",
                   help="synthetic scenario (engine/traffic.py Scenario)")
    s.add_argument("--packets", type=int, default=0,
                   help="stop after N records")
    s.add_argument("--batches", type=int, default=0,
                   help="stop after N batches")
    s.add_argument("--seconds", type=float, default=0,
                   help="stop after S seconds")
    s.add_argument("--table-capacity", type=int, default=1 << 20,
                   help="state-table rows (power of two)")
    s.add_argument("--model", default="logreg_int8",
                   help="model name (logreg_int8 or logreg_int8_pallas)")
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
