"""The inline loop's fill a loop turn (the source poll and the
batcher's packing), median, in ms."""


def read(run):
    st = run.reports[0].stages_ms if run.reports else None
    if not st or not st.get("fill"):
        return None
    return st["fill"]["p50"]
