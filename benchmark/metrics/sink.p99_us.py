"""The sink's time a dispatch (verdict wire fetch to the blocks
applied), 99th percentile over records, in µs (the engine's latency
plane)."""


def read(run):
    lat = run.reports[0].latency if run.reports else None
    h = (lat or {}).get("stages", {}).get("sink", {})
    return h.get("p99") if h.get("n") else None
