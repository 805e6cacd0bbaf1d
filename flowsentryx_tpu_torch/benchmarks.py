"""The per-record latency methodology: a paced open-loop run and its
percentile summary.

Counterpart of the methodology half of ``flowsentryx_tpu/benchmarks.py``
(``paced_latency_run``, ``summarize_latencies``); the reference's
scenario suite is not ported.  ``chip_smoke.py`` measures the card's
feature -> verdict latency with these.
"""

from __future__ import annotations

import time

import numpy as np


def paced_latency_run(eng, src, readback_depth=None, max_seconds=6.0):
    """Open-loop paced run through a warmed engine: rebind the stream
    (:meth:`~flowsentryx_tpu_torch.engine.Engine.reset_stream`), attach
    the reap hook that pairs each sunk record with its scheduled arrival
    (:class:`~flowsentryx_tpu_torch.engine.sources.PacedSource`
    ``.pop_scheduled``), run, and return ``(latencies_s, wall_s,
    EngineReport)``.  The report carries the engine's own seal -> verdict
    histogram (``latency``), to hold against the hook's arrival -> sunk
    numbers.  The caller warms the engine outside the paced clock (the
    open-loop clock starts at the first poll, so a capture inside the
    run would read as queueing)."""
    eng.reset_stream(src, readback_depth=readback_depth)
    lats: list = []
    eng.on_reap = lambda n, t, s=src, out=lats: out.extend(
        t - s.pop_scheduled(n))
    t0 = time.perf_counter()
    rep = eng.run(max_seconds=max_seconds)
    wall = time.perf_counter() - t0
    return np.asarray(lats), wall, rep


def summarize_latencies(lats_s) -> dict:
    """Percentile summary (ms) of a :func:`paced_latency_run` latency
    array."""
    a = np.asarray(lats_s, np.float64) * 1e3
    if not len(a):
        return {"n": 0}
    return {
        "n": int(len(a)),
        "p50_ms": round(float(np.percentile(a, 50)), 3),
        "p90_ms": round(float(np.percentile(a, 90)), 3),
        "p99_ms": round(float(np.percentile(a, 99)), 3),
        "p999_ms": round(float(np.percentile(a, 99.9)), 3),
        "max_ms": round(float(a.max()), 3),
    }
