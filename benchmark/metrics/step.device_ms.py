"""Device time a batch in the profiled span: the union of every
kernel's and copy's interval, over the batches dispatched in it."""


def read(run):
    t = run.trace_summary
    if not t or not run.segments:
        return None
    b0, b1, _ = run.segments[0]
    if b1 <= b0 or t["busy_s"] <= 0:
        return None
    return t["busy_s"] * 1e3 / (b1 - b0)
