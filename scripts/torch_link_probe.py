"""One-shot health probe of the card's host link: prints ONE JSON line.

The port's counterpart of ``scripts/link_probe.py``.  It measures, in
escalating cost order, the axes that decide whether a benchmark window
is worth measuring, and skips the costly one when a cheap one already
shows the window degraded:

* ``dispatch_ms`` -- 100 launches of a trivial op (``tanh(x @ x)``) and
  one synchronize, per launch.  Not a health signal alone: kept beside
  the step's time for the comparison.
* ``step_ms`` / ``step_mpps`` -- the captured compact16 step
  (:class:`~flowsentryx_tpu_torch.ops.graph.StepGraph`) at B=16,384 over
  a 2^16-row table, the golden ``logreg_int8`` params on the compact16
  wire, replayed from feeds already on the card: 10 replays, or 50 when
  a replay takes under 2 ms.  No host link in the loop.
* ``h2d_mbps`` -- one 8 MB copy from pinned host memory, the kind the
  engine stages from.
* ``e2e_mpps`` -- 20 steps, each fed by a host -> card copy of the 16
  B/record wire, 3 copies in flight on a copy stream ordered by events:
  a miniature of the bench's fed loop.  Runs only when the step passes
  and H2D reaches half its minimum (:mod:`~flowsentryx_tpu_torch.core.
  linkhealth`), or with ``--force-e2e`` (the runs that derive the
  thresholds).

``state`` is :func:`~flowsentryx_tpu_torch.core.linkhealth.classify` of
those numbers.  On an exception the line carries ``error`` and ``state:
"wedged"``: a probe never crashes its caller.  ``launches`` counts the
kernels the probe launched (``score_int8`` once per step replay),
``step_bodies`` the step replays.

    python3 scripts/torch_link_probe.py [--device D] [--batch B]
        [--capacity C] [--force-e2e]

Without a card and without ``--device cpu`` it exits 1 naming the
missing device, printing no line.  ``--batch`` and ``--capacity`` shrink
the probe for the CPU (the tests).
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from flowsentryx_tpu_torch.core import linkhealth  # noqa: E402

B = 16384
#: A small table: the probe measures the link, not the table's size.
CAP = 1 << 16
#: Step replays timed, and the count when one replay takes under 2 ms.
STEP_REPS, STEP_REPS_FAST = 10, 50
#: The fed loop's steps and copies in flight.
E2E_STEPS, E2E_IN_FLIGHT = 20, 3
H2D_BYTES = 8 << 20


def step_fixture(dev, batch: int, capacity: int):
    """``(run, wire)``: the captured compact16 step over a fresh
    ``capacity``-row table (a :class:`~flowsentryx_tpu_torch.bench.
    Replayer`: one graph launch per call on the card) and one encoded
    batch of flood-mix records, the statistics of ``_probe_common.
    make_step_fixture``."""
    from flowsentryx_tpu_torch import bench
    from flowsentryx_tpu_torch.core import schema, wire
    from flowsentryx_tpu_torch.core.config import (
        BatchConfig, FsxConfig, TableConfig,
    )
    from flowsentryx_tpu_torch.models.registry import get_model
    from flowsentryx_tpu_torch.ops import fused

    cfg = FsxConfig(table=TableConfig(capacity=capacity),
                    batch=BatchConfig(max_batch=batch))
    spec = get_model(cfg.model.name)
    quant = wire.model_quant_args(spec.init("cpu"))
    params = spec.init(dev)
    rng = np.random.default_rng(0)
    raw = np.zeros(batch, dtype=wire.FLOW_RECORD_DTYPE)
    raw["saddr"] = rng.integers(1, 1 << 15, batch).astype(np.uint32)
    raw["pkt_len"] = rng.integers(64, 1500, batch)
    raw["ts_ns"] = np.arange(batch) * 100
    raw["ip_proto"] = rng.choice([1, 6, 17], batch)
    raw["feat"] = rng.integers(0, 1 << 20, (batch, wire.NUM_FEATURES))
    encoded = wire.encode_compact(raw, batch, t0_ns=0, **quant)
    step = fused.make_compact_step(cfg, bench.classify_for(params), **quant)
    table, stats = schema.make_table(capacity, dev), schema.make_stats(dev)
    run = bench.Replayer(step, table, stats, params, encoded.shape)
    return run, encoded


def probe(dev, batch: int = B, capacity: int = CAP,
          force_e2e: bool = False) -> dict:
    """The probe's line (module docstring) on ``dev``."""
    import torch

    from flowsentryx_tpu_torch import bench
    from flowsentryx_tpu_torch.ops import kernels

    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    out: dict = {"ts": time.time()}
    try:
        t0 = time.perf_counter()
        if cuda:
            torch.cuda.init()
        torch.empty(1, device=dev)
        sync()
        out["init_s"] = round(time.perf_counter() - t0, 1)
        out["backend"] = dev.type
        out["device_kind"] = bench.device_kind(dev)
        out["power_limit_w"] = bench.smi_power()[1] if cuda else None

        n = 1024 if cuda else 64
        x = torch.ones(n, n, dtype=torch.bfloat16 if cuda else torch.float32,
                       device=dev)
        torch.tanh(x @ x)
        sync()
        t0 = time.perf_counter()
        for _ in range(100):
            y = torch.tanh(x @ x)
        sync()
        out["dispatch_ms"] = round((time.perf_counter() - t0) / 100 * 1e3, 3)
        del x, y

        t0 = time.perf_counter()
        run, encoded = step_fixture(dev, batch, capacity)
        host = torch.from_numpy(encoded.view(np.int32))
        feeds = [host.to(dev) for _ in range(4)]
        kernels.reset_launches()
        run(feeds[0])
        sync()
        out["compile_s"] = round(time.perf_counter() - t0, 1)

        def loop(iters: int) -> float:
            t0 = time.perf_counter()
            for i in range(iters):
                run(feeds[i % 4])
            sync()
            return (time.perf_counter() - t0) / iters

        per = loop(STEP_REPS)
        if per < 2e-3:
            per = loop(STEP_REPS_FAST)
        out["step_ms"] = round(per * 1e3, 3)
        out["step_mpps"] = round(batch / per / 1e6, 1)
        del feeds

        buf = torch.zeros(H2D_BYTES, dtype=torch.uint8)
        if cuda:
            buf = buf.pin_memory()
        buf[:1024].to(dev)
        sync()
        t0 = time.perf_counter()
        buf.to(dev, non_blocking=True)
        sync()
        out["h2d_mbps"] = round(buf.numel() / (time.perf_counter() - t0)
                                / 1e6, 1)
        del buf

        if force_e2e or (
                out["step_ms"] <= linkhealth.HEALTHY_STEP_MS
                and out["h2d_mbps"] >= 0.5 * linkhealth.HEALTHY_H2D_MBPS):
            per = fed_loop(run, host, dev)
            out["e2e_mpps"] = round(batch / per / 1e6, 2)
            out["state"] = linkhealth.classify(
                out["step_ms"], out["h2d_mbps"], out["e2e_mpps"])
        else:
            out["state"] = linkhealth.classify(
                out.get("step_ms"), out.get("h2d_mbps"), None)
        out["launches"] = dict(kernels.LAUNCHES)
        out["step_bodies"] = run.bodies
    except Exception as e:  # noqa: BLE001 -- a probe never crashes its caller
        out["error"] = f"{type(e).__name__}: {e}"
        out["state"] = "wedged"
    return out


def fed_loop(run, host, dev) -> float:
    """Seconds per step of :data:`E2E_STEPS` steps, each fed by a host ->
    card copy of the wire.  On the card the copies run on a copy stream,
    :data:`E2E_IN_FLIGHT` ahead of the step: a slot's copy waits for the
    step that last read the slot, and the step waits for its copy."""
    import torch

    if dev.type != "cuda":
        pre = [host.to(dev) for _ in range(E2E_IN_FLIGHT)]
        t0 = time.perf_counter()
        for _ in range(E2E_STEPS):
            pre.append(host.to(dev))
            run(pre.pop(0))
        return (time.perf_counter() - t0) / E2E_STEPS
    wire = host.pin_memory()
    copy = torch.cuda.Stream(dev)
    main = torch.cuda.current_stream(dev)
    slots = [torch.empty_like(wire, device=dev)
             for _ in range(E2E_IN_FLIGHT)]
    landed = [torch.cuda.Event() for _ in slots]
    read = [torch.cuda.Event() for _ in slots]

    def upload(k: int) -> None:
        with torch.cuda.stream(copy):
            copy.wait_event(read[k])
            slots[k].copy_(wire, non_blocking=True)
            landed[k].record(copy)

    for k in range(E2E_IN_FLIGHT):
        read[k].record(main)
        upload(k)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for i in range(E2E_STEPS):
        k = i % E2E_IN_FLIGHT
        main.wait_event(landed[k])
        run(slots[k])
        read[k].record(main)
        upload(k)
    torch.cuda.synchronize(dev)
    return (time.perf_counter() - t0) / E2E_STEPS


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device; default the card (exits 1 without "
                         "one)")
    ap.add_argument("--batch", type=int, default=B)
    ap.add_argument("--capacity", type=int, default=CAP)
    ap.add_argument("--force-e2e", action="store_true",
                    help="run the fed loop whatever the step and H2D say")
    args = ap.parse_args(argv)
    from flowsentryx_tpu_torch.core.device import resolve_device

    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        print(f"torch_link_probe: {e}", file=sys.stderr)
        return 1
    print(json.dumps(probe(dev, args.batch, args.capacity, args.force_e2e)),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
