"""Per-stage timing and the per-record latency plane of the pipeline.

Counterpart of ``flowsentryx_tpu/engine/metrics.py``, copied (numpy
only: the spawned ingest workers' fleet imports it, and so may any
reporting tool without torch):

* :class:`StageTimer` — a ring of the most recent per-batch durations of
  one stage, with its percentiles (``EngineReport.stages_ms``);
* :class:`LatencyHist` / :class:`LatencyRecorder` — the seal->verdict
  latency plane: an HDR-style log-bucketed histogram of fixed memory
  whose percentiles are an O(buckets) walk, mergeable across runs, with
  the stage split (``EngineReport.latency``);
* :class:`WorkerIngestMetrics` and :class:`PipelineMetrics` — the ingest
  workers' and the engine's stage sets.
"""

from __future__ import annotations

import numpy as np


class StageTimer:
    """Rolling record of one stage's per-batch durations (seconds).

    A RING of the most recent ``keep`` samples: once full, new samples
    overwrite the oldest, so a week-long serve reports percentiles of
    its recent window — not of its first 100k batches (the old
    stop-at-keep behavior silently froze the distribution early in long
    runs).  ``percentiles_ms()["n"]`` stays the TOTAL sample count ever
    recorded; ``max`` likewise tracks the all-time maximum (a one-off
    stall must not age out of the report)."""

    def __init__(self, name: str, keep: int = 100_000):
        self.name = name
        self.keep = keep
        self._samples: list[float] = []  # grows to keep, then ring-writes
        self._n = 0                       # total ever recorded
        self._max = 0.0

    def add(self, seconds: float) -> None:
        if len(self._samples) < self.keep:
            self._samples.append(seconds)
        else:
            self._samples[self._n % self.keep] = seconds
        self._n += 1
        if seconds > self._max:
            self._max = seconds

    def percentiles_ms(self) -> dict[str, float]:
        if not self._n:
            return {}
        a = np.asarray(self._samples) * 1e3
        return {
            "p50": round(float(np.percentile(a, 50)), 4),
            "p99": round(float(np.percentile(a, 99)), 4),
            "max": round(self._max * 1e3, 4),
            "mean": round(float(a.mean()), 4),
            "n": self._n,
        }


#: LatencyHist geometry: 16 linear sub-buckets per power-of-two octave
#: over [1 µs, 2^26 µs ≈ 67 s].  16 sub-buckets bound the relative
#: quantization error of a reported percentile at 1/16 ≈ 6.25 % — the
#: same fidelity class as the compact16 wire's minifloat — for 432
#: int64 buckets ≈ 3.5 KB per histogram, fixed for the life of a serve.
LAT_SUB = 16
LAT_OCTAVES = 27
LAT_BUCKETS = LAT_OCTAVES * LAT_SUB


def _lat_bucket(us: float) -> int:
    """Bucket index of a µs value (scalar; the engine records per
    sunk BATCH, so this is never a per-record hot path).  CEILING to
    whole µs before bucketing: truncation would drop sub-16 µs values
    into buckets whose upper edge is BELOW the true value, breaking
    the conservative-upper-edge percentile guarantee exactly in the
    octaves where the 1 µs truncation step exceeds the sub-bucket
    width."""
    u = max(-int(-us // 1), 1)
    e = u.bit_length() - 1
    if e >= LAT_OCTAVES:
        return LAT_BUCKETS - 1
    sub = ((u - (1 << e)) * LAT_SUB) >> e
    return e * LAT_SUB + sub


def _lat_edge_us(idx: int) -> float:
    """UPPER edge (µs) of bucket ``idx`` — percentiles report the
    conservative edge, so a quoted p99 is never under the true one by
    more than the 1/16 sub-bucket width."""
    e, sub = divmod(idx + 1, LAT_SUB)
    return float((1 << e) * (1.0 + sub / LAT_SUB))


class LatencyHist:
    """HDR-style log-bucketed latency histogram (module docstring).

    ``add(seconds, n)`` charges ``n`` records one latency value (the
    engine's per-record accounting anchors every record of a batch at
    the batch's OLDEST-record stamp — a conservative per-record upper
    bound, matching how ``e2e`` has always been anchored); ``merge``
    sums another histogram in; ``percentile_us`` walks the cumulative
    counts.  ``to_counts()``/``from_counts()`` round-trip the nonzero
    buckets through JSON, to merge runs or engines."""

    def __init__(self) -> None:
        self.counts = np.zeros(LAT_BUCKETS, np.int64)
        self.n = 0
        self.sum_us = 0.0
        self.max_us = 0.0

    def add(self, seconds: float, n: int = 1) -> None:
        if n <= 0:
            return
        us = seconds * 1e6
        self.counts[_lat_bucket(us)] += n
        self.n += n
        self.sum_us += us * n
        if us > self.max_us:
            self.max_us = us

    def merge(self, other: "LatencyHist") -> "LatencyHist":
        self.counts += other.counts
        self.n += other.n
        self.sum_us += other.sum_us
        self.max_us = max(self.max_us, other.max_us)
        return self

    def percentile_us(self, q: float) -> float:
        """Value (µs, conservative bucket upper edge) at percentile
        ``q`` — O(buckets) cumulative walk, no sort.  The all-time max
        is exact, so ``q=100`` reports it rather than an edge."""
        if not self.n:
            return 0.0
        if q >= 100.0:
            return round(self.max_us, 1)
        rank = max(int(np.ceil(self.n * q / 100.0)), 1)
        cum = np.cumsum(self.counts)
        idx = int(np.searchsorted(cum, rank))
        # the top bucket holds the >67 s clamp; its "edge" is the max
        if idx >= LAT_BUCKETS - 1:
            return round(self.max_us, 1)
        return round(min(_lat_edge_us(idx), self.max_us), 1)

    def to_dict(self) -> dict:
        """Percentile summary (µs) — the report-facing face."""
        if not self.n:
            return {"n": 0}
        return {
            "n": int(self.n),
            "p50": self.percentile_us(50),
            "p90": self.percentile_us(90),
            "p99": self.percentile_us(99),
            "p999": self.percentile_us(99.9),
            "max": round(self.max_us, 1),
            "mean": round(self.sum_us / self.n, 1),
        }

    def to_counts(self) -> dict:
        """JSON-able mergeable form: nonzero buckets only."""
        nz = np.nonzero(self.counts)[0]
        return {
            "scheme": f"log2x{LAT_SUB}us",
            "buckets": {str(int(i)): int(self.counts[i]) for i in nz},
            "n": int(self.n),
            "sum_us": round(self.sum_us, 1),
            "max_us": round(self.max_us, 1),
        }

    @classmethod
    def from_counts(cls, d: dict) -> "LatencyHist":
        h = cls()
        scheme = d.get("scheme")
        if scheme != f"log2x{LAT_SUB}us":
            raise ValueError(
                f"latency histogram scheme {scheme!r} != "
                f"log2x{LAT_SUB}us — refusing a silent mis-merge")
        for i, c in d.get("buckets", {}).items():
            idx = int(i)
            if not 0 <= idx < LAT_BUCKETS:
                # a negative index would silently wrap into the top
                # octave and skew every merged percentile — the exact
                # mis-merge the scheme check refuses; and IndexError
                # would escape callers' ValueError armor
                raise ValueError(
                    f"latency histogram bucket {idx} outside "
                    f"[0, {LAT_BUCKETS}) — corrupt or foreign counts")
            h.counts[idx] += int(c)
        h.n = int(d.get("n", 0))
        h.sum_us = float(d.get("sum_us", 0.0))
        h.max_us = float(d.get("max_us", 0.0))
        return h


class LatencyRecorder:
    """The engine's per-record latency plane: one total (seal→verdict)
    histogram plus the stage decomposition the SLO mode is tuned by —
    ``staged_wait`` (seal → launch: batcher/pending/arena/sink-queue
    residency), ``upload`` (the H2D put), ``compute`` (the step call's
    wall — on the CPU, where the step runs eagerly, this IS the compute;
    on the card it is the graph replay's enqueue and the compute lands
    in the sink's wait instead — disclosed in the report's
    ``compute_is_wall`` flag), and ``sink`` (wire fetch → writeback
    applied).  All histograms weight by the batch's record
    count; a batch with zero valid records (warm) records nothing.

    ``negatives`` counts stage deltas that arrived negative (clock
    inversion between the seal and sink stamps) — the smoke gate pins
    it at 0 every run."""

    STAGES = ("staged_wait", "upload", "compute", "sink")

    def __init__(self) -> None:
        self.total = LatencyHist()
        self.stages = {s: LatencyHist() for s in self.STAGES}
        self.negatives = 0
        self.slo_miss_records = 0

    def record(self, total_s: float, staged_s: float, upload_s: float,
               compute_s: float, sink_s: float, n: int,
               budget_s: float = 0.0) -> None:
        if n <= 0:
            return
        for v in (total_s, staged_s, upload_s, compute_s, sink_s):
            if v < 0.0:
                self.negatives += 1
        self.total.add(max(total_s, 0.0), n)
        for name, v in zip(self.STAGES,
                           (staged_s, upload_s, compute_s, sink_s)):
            self.stages[name].add(max(v, 0.0), n)
        if budget_s and total_s > budget_s:
            self.slo_miss_records += n

    def merge(self, other: "LatencyRecorder") -> "LatencyRecorder":
        self.total.merge(other.total)
        for s in self.STAGES:
            self.stages[s].merge(other.stages[s])
        self.negatives += other.negatives
        self.slo_miss_records += other.slo_miss_records
        return self

    def to_dict(self, slo_us: int = 0,
                compute_is_wall: bool = True) -> dict:
        out = {
            "unit": "us",
            "seal_to_verdict": self.total.to_dict(),
            "stages": {s: self.stages[s].to_dict()
                       for s in self.STAGES},
            "compute_is_wall": bool(compute_is_wall),
            "negatives": int(self.negatives),
            "hist": self.total.to_counts(),
        }
        if slo_us:
            n = max(self.total.n, 1)
            out["slo"] = {
                "slo_us": int(slo_us),
                "miss_records": int(self.slo_miss_records),
                "miss_fraction": round(self.slo_miss_records / n, 6),
            }
        return out


class WorkerIngestMetrics:
    """Per-drain-worker stage timers of the sharded ingest subsystem
    (flowsentryx_tpu/ingest/): ``fill`` is first-record-arrival → seal
    inside the worker (the parallelized decode/assembly stage), ``queue``
    is seal → engine dequeue (sealed-batch queue residency — the
    pipelining debt the engine's dispatch loop imposes).  Surfaced per
    worker in the engine report's ``ingest`` block."""

    def __init__(self, worker: int):
        self.worker = worker
        self.fill = StageTimer(f"w{worker}.fill")
        self.queue = StageTimer(f"w{worker}.queue")

    def to_dict(self) -> dict:
        return {
            "fill_ms": self.fill.percentiles_ms(),
            "queue_ms": self.queue.percentiles_ms(),
        }


class PipelineMetrics:
    """The engine's stage set.

    ``fill`` covers the inline loop's source poll + batcher pack; the
    sealed-batch loop splits its half of that work into ``pop`` (queue
    peek + header decode + seq/metrics bookkeeping) and ``stage`` (the
    ONE shm-slot-view → dispatch-arena memcpy of the zero-copy
    pipeline) so the dispatch-thread budget is attributable per
    sub-stage — a regression that re-grows a second copy shows up as a
    ``stage`` p50 jump, not as undifferentiated ``fill`` noise.  The
    inline loop also records ``stage`` when it packs a mega group into
    the arena."""

    def __init__(self) -> None:
        self.fill = StageTimer("fill")          # source poll + batcher copy
        self.pop = StageTimer("pop")            # sealed-queue peek/bookkeeping
        self.stage = StageTimer("stage")        # slot view -> arena memcpy
        self.dispatch = StageTimer("dispatch")  # step call (async enqueue)
        self.readback = StageTimer("readback")  # D2H verdict fetch
        self.e2e = StageTimer("e2e")            # first record in -> sink

    def to_dict(self) -> dict:
        return {
            t.name: t.percentiles_ms()
            for t in (self.fill, self.pop, self.stage, self.dispatch,
                      self.readback, self.e2e)
        }
