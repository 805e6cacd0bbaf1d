"""The drain workers' fill time a sealed batch (first record in ->
seal, inside the worker), the median of each worker's median."""

import numpy as np


def read(run):
    ing = run.reports[0].ingest if run.reports else None
    if not ing:
        return None
    p50 = [w["fill_ms"]["p50"] for w in ing["workers"].values()
           if w.get("fill_ms")]
    return float(np.median(p50)) if p50 else None
