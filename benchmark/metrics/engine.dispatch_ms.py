"""The dispatch thread's host time a dispatch on the sealed path: the
medians of ``pop`` (queue peek and bookkeeping), ``stage`` (the one copy
into the dispatch arena) and ``dispatch`` (upload and graph launch)."""


def read(run):
    st = run.reports[0].stages_ms if run.reports else None
    if not st or not all(st.get(k) for k in ("pop", "stage", "dispatch")):
        return None
    return st["pop"]["p50"] + st["stage"]["p50"] + st["dispatch"]["p50"]
