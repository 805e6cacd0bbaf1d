"""The wait from a batch's first record to its launch (the batcher
and the pending queue), 99th percentile over records, in µs (the
engine's latency plane)."""


def read(run):
    lat = run.reports[0].latency if run.reports else None
    h = (lat or {}).get("stages", {}).get("staged_wait", {})
    return h.get("p99") if h.get("n") else None
