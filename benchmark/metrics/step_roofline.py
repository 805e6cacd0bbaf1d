"""The fused step's share of its roofline (%): the least time the
card's memory could move what a batch needs, over the step's device time
a batch.  What a batch needs: its wire in (``B + 1`` rows of 16 bytes),
its verdict wire out (``2K + 4`` words), and one read and one write of
the table row (a 4-byte key and 12 float32 columns) of each distinct
source in it.  Bound: HBM bandwidth."""

from benchmark import peaks

ROW_BYTES = 4 + 12 * 4


def read(run):
    t = run.trace_summary
    bw = peaks.hbm_bytes_per_s(run)
    if not t or not run.segments or bw is None:
        return None
    b0, b1, _ = run.segments[0]
    if b1 <= b0 or t["busy_s"] <= 0:
        return None
    distinct = run.distinct_per_batch[b0:b1].mean()
    b = run.fsx.batch
    need = (b.max_batch + 1) * 16 + (2 * b.verdict_k + 4) * 4 \
        + 2 * ROW_BYTES * distinct
    return 100.0 * (need / bw) / (t["busy_s"] / (b1 - b0))
