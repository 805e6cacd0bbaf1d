"""The ``score_int8`` kernel's share of its roofline (%): the bytes it
must move at the batch size (``[B, 8]`` float32 features in, ``[B]``
float32 scores out, its 1,060-byte argument block) at HBM bandwidth,
over its profiled device time a launch."""

from benchmark import peaks

ARGS_BYTES = 1060


def read(run):
    t = run.trace_summary
    bw = peaks.hbm_bytes_per_s(run)
    if not t or bw is None:
        return None
    hits = [v for n, v in t["ops"].items() if "score_int8" in n]
    launches = sum(v["launches"] for v in hits)
    seconds = sum(v["seconds"] for v in hits)
    if not launches or seconds <= 0:
        return None
    b = run.fsx.batch.max_batch
    need = b * 8 * 4 + b * 4 + ARGS_BYTES
    return 100.0 * (need / bw) / (seconds / launches)
