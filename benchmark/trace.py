"""The device trace (``torch.profiler``, CUDA activity through CUPTI):
over a traced run's profiled span, the device's busy time as the union
of its kernels' and copies' intervals, each device operation's time, and
the longest idle gaps named by what the host was doing in them; over the
whole window of an untraced run, the card's busy time alone.

Under the profiler a graph replay costs the host far more than without
it (CUPTI instruments every node), so host times and the idle share of
the profiled span read high; the device's own times do not move.
"""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def profiled(cuda: bool):
    """A ``torch.profiler`` session over the block, or nothing off the
    card."""
    if not cuda:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        yield prof


@contextlib.contextmanager
def device_only():
    """A ``torch.profiler`` session recording the card's activity alone
    (every kernel and copy, no host operations) over the block: the
    whole window of an untraced run.  Its events are read raw (see
    :func:`device_busy`), since a window holds millions of kernels."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        yield prof


def device_busy(prof) -> tuple[int, float]:
    """``(device operations, busy seconds)`` of a :func:`device_only`
    session: the union of every kernel's and copy's interval."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    ev = [(e.start_ns(), e.duration_ns())
          for e in prof.profiler.kineto_results.events()
          if e.device_type() == cuda]
    ev.sort()
    busy, start, end = 0, None, None
    for s, d in ev:
        if start is None or s > end:
            if start is not None:
                busy += end - start
            start, end = s, s + d
        elif s + d > end:
            end = s + d
    if start is not None:
        busy += end - start
    return len(ev), busy * 1e-9


def _union(intervals: list[tuple[float, float]]):
    """Merged ``[(start, end)]`` of the intervals, in order."""
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summarize(prof, window_s: float, top: int = 10) -> dict:
    """``busy_s`` (union of device intervals), ``window_s``, per-name
    device seconds and launches (``ops``), and the ``breakdown`` the
    result line carries."""
    import torch

    dev_ev, host_ev = [], []
    for e in prof.events():
        tr = e.time_range
        if e.device_type == torch.autograd.DeviceType.CUDA:
            dev_ev.append((tr.start, tr.end, e.name))
        else:
            host_ev.append((tr.start, tr.end, e.name))
    merged = _union([(s, e) for s, e, _ in dev_ev])
    busy_us = sum(e - s for s, e in merged)
    ops: dict[str, list] = {}
    for s, e, name in dev_ev:
        o = ops.setdefault(name, [0, 0.0])
        o[0] += 1
        o[1] += (e - s) * 1e-6
    device_ops = sorted(([n, v[1]] for n, v in ops.items()),
                        key=lambda x: -x[1])[:top]
    gaps = sorted(((b[0] - a[1], a[1], b[0])
                   for a, b in zip(merged, merged[1:])), reverse=True)[:top]
    idle = []
    for length, s, e in gaps:
        # the host operation that overlaps the gap most
        best, name = 0.0, "no host operation"
        for hs, he, hn in host_ev:
            ov = min(he, e) - max(hs, s)
            if ov > best:
                best, name = ov, hn
        idle.append([name, length * 1e-6])
    return {"busy_s": busy_us * 1e-6, "window_s": window_s,
            "ops": {n: {"launches": v[0], "seconds": v[1]}
                    for n, v in ops.items()},
            "breakdown": {"device_ops": device_ops, "idle_gaps": idle}}


def idle_share(run) -> float | None:
    """The device's idle share of the profiled span: one less the union
    of its kernels' and copies' intervals over the span's wall."""
    t = run.trace_summary
    if not t or t["window_s"] <= 0:
        return None
    return 1.0 - t["busy_s"] / t["window_s"]
