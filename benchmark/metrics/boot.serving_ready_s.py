"""Seconds from the engine's construction to serving ready (the
kernels from the compile cache, every graph captured and warmed), from
the engine's boot report."""


def read(run):
    boot = run.reports[0].boot if run.reports else None
    return (boot or {}).get("serving_ready_s")
