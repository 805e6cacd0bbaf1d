"""The port's latency plane, sink thread, watchdog and health ladder
against the reference's.

The same inputs, made from a seed with numpy, go through the reference
(``flowsentryx_tpu``, JAX on the CPU) and the port (``device="cpu"``):
the histogram's buckets, percentiles, mergeable counts and merges are
equal on the same intervals; the engine's stats, blacklist and table
are the same bytes with the sink thread on or off and with the watchdog
at its default or off; and the reference's own oracles for the sink
thread (``tests/test_engine.py::TestSinkThread``), the stage timer, the
hand-off channel (``tests/test_sync.py::TestSinkChannel``), paced
latency (``TestPacedLatency``) and the watchdog and health ladder
(``tests/test_chaos.py``) hold for the port's copies."""

import json
import sys
import threading
import time

import numpy as np
import pytest
import torch

from flowsentryx_tpu.core import config as jconfig
from flowsentryx_tpu.engine import ArraySource as JArraySource
from flowsentryx_tpu.engine import CollectSink as JCollectSink
from flowsentryx_tpu.engine import Engine as JEngine
from flowsentryx_tpu.engine import health as jhealth
from flowsentryx_tpu.engine import metrics as jmetrics
from flowsentryx_tpu_torch.benchmarks import (
    paced_latency_run, summarize_latencies,
)
from flowsentryx_tpu_torch.core import config, schema
from flowsentryx_tpu_torch.engine import (
    ArraySource, CollectSink, Engine, PacedSource, Scenario,
    TrafficGen, TrafficSource, TrafficSpec,
)
from flowsentryx_tpu_torch.engine import health, metrics
from flowsentryx_tpu_torch.engine.watchdog import (
    DispatchWatchdog, WatchdogStall,
)
from flowsentryx_tpu_torch.sync.channel import SinkChannel, WorkerCrash


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The plain CPU step is many small ops: a thread per core costs
    more in hand-offs than it gains."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfgs(batch=256, cap=1 << 12, verdict_k=64, depth=4, **lim):
    """The same config for the reference and for the port."""
    kw = dict(table=dict(capacity=cap, salt=0x1234),
              batch=dict(max_batch=batch, verdict_k=verdict_k,
                         readback_depth=depth),
              limiter=lim)
    return tuple(m.FsxConfig(
        table=m.TableConfig(**kw["table"]),
        batch=m.BatchConfig(**kw["batch"]),
        limiter=m.LimiterConfig(**kw["limiter"])) for m in (jconfig, config))


def _flood(n, seed=17, n_attack=8):
    return TrafficGen(TrafficSpec(
        scenario=Scenario.UDP_FLOOD_MULTI, rate_pps=1e6,
        n_attack_ips=n_attack, attack_fraction=0.8, seed=seed)
    ).next_records(n)


def _table_bytes(e) -> tuple:
    key, state = schema.table_to_numpy(e.table)
    return key.tobytes(), state.tobytes()


# -- the histogram ----------------------------------------------------------


class TestLatencyHist:
    def test_equal_to_reference_on_same_intervals(self):
        """Buckets, edges, percentiles, ``to_dict``, ``to_counts`` and
        merges are the reference's on the same intervals (including
        weighted adds, sub-µs values and values past the 67 s cap)."""
        rng = np.random.default_rng(7)
        vals = np.concatenate([rng.lognormal(5.5, 1.2, 20_000) * 1e-6,
                               [0.0, 1e-9, 3600.0, 2.0 ** 26 * 1e-6]])
        weights = rng.integers(1, 64, len(vals))
        for v in (0.0, 0.5, 1.0, 15.9, 16.0, 17.0, 1e3, 2.0 ** 25, 1e9):
            assert metrics._lat_bucket(v) == jmetrics._lat_bucket(v)
        for i in range(metrics.LAT_BUCKETS - 1):
            assert metrics._lat_edge_us(i) == jmetrics._lat_edge_us(i)
        hs = []
        for mod in (jmetrics, metrics):
            a, b = mod.LatencyHist(), mod.LatencyHist()
            for v, w in zip(vals, weights):
                a.add(float(v), int(w))
            for v in vals[::3]:
                b.add(float(v) * 7)
            merged = mod.LatencyHist.from_counts(a.to_counts()).merge(b)
            hs.append((a, b, merged))
        for (ja, jb, jm), (ta, tb, tm) in zip(*[iter(hs)] * 2):
            for j, t in ((ja, ta), (jb, tb), (jm, tm)):
                np.testing.assert_array_equal(t.counts, j.counts)
                assert t.to_dict() == j.to_dict()
                assert t.to_counts() == j.to_counts()
                for q in (1, 50, 90, 99, 99.9, 100):
                    assert t.percentile_us(q) == j.percentile_us(q)

    def test_recorder_equal_to_reference(self):
        rng = np.random.default_rng(3)
        recs = []
        for mod in (jmetrics, metrics):
            r = mod.LatencyRecorder()
            for row in rng.uniform(-1e-5, 5e-3, (500, 5)):
                r.record(*row, n=7, budget_s=2e-3)
            recs.append(r.to_dict(slo_us=2000, compute_is_wall=False))
            rng = np.random.default_rng(3)
        assert recs[0] == recs[1]
        assert recs[1]["negatives"] > 0 and recs[1]["slo"]["miss_records"]

    def test_percentiles_within_bucket_error(self):
        rng = np.random.default_rng(7)
        vals_us = rng.lognormal(5.5, 1.2, 50_000)
        h = metrics.LatencyHist()
        for v in vals_us:
            h.add(v * 1e-6)
        for q in (50, 90, 99, 99.9):
            true = float(np.percentile(vals_us, q))
            est = h.percentile_us(q)
            assert est >= true * (1 - 0.02)
            assert est <= true * (1 + 1 / metrics.LAT_SUB + 0.02)
        assert h.percentile_us(100) == round(float(vals_us.max()), 1)

    def test_weighted_add_and_ordering(self):
        h = metrics.LatencyHist()
        h.add(100e-6, n=99)
        h.add(10e-3, n=1)
        assert h.n == 100
        assert h.percentile_us(50) < 200
        assert h.percentile_us(99.9) > 5000
        d = h.to_dict()
        chain = [d[k] for k in ("p50", "p90", "p99", "p999", "max")]
        assert all(a <= b for a, b in zip(chain, chain[1:]))

    def test_counts_roundtrip_merge_and_scheme(self):
        rng = np.random.default_rng(3)
        a, b = metrics.LatencyHist(), metrics.LatencyHist()
        for v in rng.lognormal(4, 1, 2000):
            a.add(v * 1e-6)
        for v in rng.lognormal(7, 1, 2000):
            b.add(v * 1e-6)
        a2 = metrics.LatencyHist.from_counts(
            json.loads(json.dumps(a.to_counts())))
        assert a2.to_dict() == a.to_dict()
        merged = metrics.LatencyHist.from_counts(a.to_counts()).merge(b)
        assert merged.n == a.n + b.n
        np.testing.assert_array_equal(merged.counts, a.counts + b.counts)
        assert merged.max_us == max(a.max_us, b.max_us)
        with pytest.raises(ValueError, match="scheme"):
            metrics.LatencyHist.from_counts({"scheme": "linear",
                                             "buckets": {}})
        with pytest.raises(ValueError, match="outside"):
            metrics.LatencyHist.from_counts({
                "scheme": f"log2x{metrics.LAT_SUB}us",
                "buckets": {str(metrics.LAT_BUCKETS): 1}})

    def test_cap_boundary_buckets(self):
        top = metrics.LAT_BUCKETS - 1
        cap_us = 1 << metrics.LAT_OCTAVES
        assert metrics._lat_bucket(float(cap_us)) == top
        assert metrics._lat_bucket(float(cap_us) * 1000.0) == top
        assert metrics._lat_bucket(0.0) == metrics._lat_bucket(1.0) == 0
        h = metrics.LatencyHist()
        h.add(3600.0)
        h.add(cap_us * 1e-6)
        h.add(1e-9)
        assert h.n == 3 and int(h.counts[top]) == 2
        assert h.percentile_us(99) == round(h.max_us, 1)


class TestStageTimer:
    def test_ring_late_samples_influence_percentiles(self):
        t = metrics.StageTimer("x", keep=8)
        for _ in range(8):
            t.add(0.001)
        assert t.percentiles_ms()["p50"] == pytest.approx(1.0)
        for _ in range(8):
            t.add(0.1)
        p = t.percentiles_ms()
        assert p["p50"] == pytest.approx(100.0) and p["n"] == 16
        t2 = metrics.StageTimer("y", keep=4)
        t2.add(0.5)
        for _ in range(8):
            t2.add(0.001)
        assert t2.percentiles_ms()["max"] == pytest.approx(500.0)

    def test_equal_to_reference(self):
        rng = np.random.default_rng(5)
        vals = rng.uniform(0, 0.01, 300)
        out = []
        for mod in (jmetrics, metrics):
            t = mod.StageTimer("s", keep=64)
            for v in vals:
                t.add(float(v))
            out.append(t.percentiles_ms())
        assert out[0] == out[1]
        assert set(metrics.PipelineMetrics().to_dict()) == set(
            jmetrics.PipelineMetrics().to_dict()) == {
            "fill", "pop", "stage", "dispatch", "readback", "e2e"}


# -- the hand-off channel -----------------------------------------------------


class TestSinkChannel:
    def test_pending_counts_chunks_not_entries(self):
        ch = SinkChannel()
        ch.submit("mega", n_chunks=4)
        ch.submit_many(["a", "b"], lambda _: 2)
        assert ch.pending == 8
        assert ch.try_pop() == ["mega"]
        ch.complete(4)
        assert ch.pending == 4

    def test_coalesce_folds_consecutive_ready(self):
        ch = SinkChannel()
        ch.submit_many([1, 2, 9, 3], lambda _: 1)
        assert ch.try_pop(coalesce=lambda x: x < 5) == [1, 2]
        assert ch.try_pop(coalesce=lambda x: x < 5) == [9, 3]
        assert ch.try_pop() is None

    def test_check_raises_named_worker_crash(self):
        ch = SinkChannel("sink thread")
        ch.complete(0, exc=ValueError("boom"))
        with pytest.raises(WorkerCrash, match="sink thread crashed"):
            ch.check()
        assert isinstance(ch.crashed(), ValueError)

    def test_wait_below_released_by_crash(self):
        ch = SinkChannel()
        ch.submit("x", 3)
        t = threading.Thread(target=lambda: ch.record_exc(
            RuntimeError("dead")))
        t.start()
        ch.wait_below(0, quantum=0.01)  # must not hang
        t.join()
        with pytest.raises(WorkerCrash):
            ch.check()

    def test_blocking_pop_drains_then_none_after_stop(self):
        ch = SinkChannel()
        ch.submit("tail", 1)
        ch.request_stop()
        assert ch.pop(quantum=0.01) == ["tail"]
        assert ch.pop(quantum=0.01) is None
        assert ch.drained()


# -- the sink thread ----------------------------------------------------------


class TestSinkThread:
    def test_sink_crash_fails_engine_loudly(self):
        class BoomSink:
            def apply(self, update):
                if len(update.key):
                    raise ValueError("boom: verdict ring gone")

        _, cfg = _cfgs(pps_threshold=200.0, bps_threshold=1e9)
        eng = Engine(cfg, ArraySource(_flood(256 * 30, seed=7, n_attack=8)),
                     BoomSink(), device="cpu", sink_thread=True)
        with pytest.raises(WorkerCrash, match="sink thread crashed"):
            eng.run()
        assert not eng._sink_active      # joined, not wedged

    def test_drain_on_shutdown_with_inflight_batches(self):
        """A deep pipe at source exhaustion: every dispatched batch is
        sunk, in record order, before the report is built."""
        _, cfg = _cfgs(batch=128, depth=8)
        eng = Engine(cfg, TrafficSource(TrafficSpec(seed=5), total=128 * 10),
                     CollectSink(), device="cpu", sink_thread=True)
        seen, times = [], []
        eng.on_reap = lambda n, t: (seen.append(n), times.append(t))
        rep = eng.run()
        assert rep.records == sum(seen) == 128 * 10
        assert times == sorted(times)
        assert rep.stages_ms["e2e"]["n"] == len(seen)
        assert rep.latency["seal_to_verdict"]["n"] == rep.records

    def test_threaded_sink_stress(self):
        """A flood through the two-thread engine with the interpreter's
        switch interval cut to 10 µs (the threads interleave at nearly
        every bytecode): every record classified once, every dispatch
        sunk once, the latency plane counting every record."""
        _, cfg = _cfgs(pps_threshold=500.0, bps_threshold=1e9, depth=2)
        sink = CollectSink()
        eng = Engine(cfg, ArraySource(_flood(256 * 40, seed=23, n_attack=16)),
                     sink, device="cpu", sink_thread=True, mega_n="auto")
        prev = sys.getswitchinterval()
        sys.setswitchinterval(1e-5)
        try:
            rep = eng.run()
        finally:
            sys.setswitchinterval(prev)
        assert rep.records == 256 * 40
        assert rep.latency["seal_to_verdict"]["n"] == rep.records
        assert (rep.readback["compact_sinks"] + rep.readback["fallback_sinks"]
                == rep.dispatch["dispatches"])
        assert sum(int(g) * n for g, n in rep.dispatch["group_hist"].items()
                   ) == rep.batches
        classes = ("allowed", "dropped_blacklist", "dropped_rate",
                   "dropped_ml")
        assert sum(rep.stats[k] for k in classes) == rep.records
        assert sink.blocked
        rb = rep.readback
        assert rb["sink_thread"] is True
        assert 0.0 <= rb["sink_occupancy"] <= 1.0
        assert rb["compact_sinks"] > 0 and rb["d2h_bytes"] > 0

    @pytest.mark.parametrize("mega_n", [0, "auto"])
    def test_sink_thread_parity_with_reference(self, mega_n):
        """The sink thread on and off decide exactly as the reference's
        single-thread engine: stats, blacklist (keys and untils) and the
        table bytes; the single-thread report has no occupancy."""
        jcfg, tcfg = _cfgs(pps_threshold=200.0, bps_threshold=1e9)
        recs = _flood(256 * 12 + 77)
        jsink = JCollectSink()
        jrep = JEngine(jcfg, JArraySource(recs.copy()), jsink,
                       sink_thread=False, mega_n=mega_n).run()
        out = {}
        for on in (True, False):
            sink = CollectSink()
            e = Engine(tcfg, ArraySource(recs.copy()), sink, device="cpu",
                       sink_thread=on, mega_n=mega_n)
            r = e.run()
            out[on] = (r.stats, sink.blocked, _table_bytes(e))
            assert r.stats == jrep.stats
            assert sink.blocked == jsink.blocked
            assert r.table == jrep.table
            assert r.latency["seal_to_verdict"]["n"] == r.records
            assert r.latency["negatives"] == 0
            assert (r.readback["sink_occupancy"] is None) is (not on)
        assert out[True] == out[False]
        assert len(jsink.blocked) >= 8


# -- paced, open-loop latency -------------------------------------------------


def _pool(n=2048, seed=3):
    return TrafficGen(TrafficSpec(seed=seed)).next_records(n)


class TestPacedLatency:
    def test_paced_source_open_loop_schedule(self):
        src = PacedSource(_pool(), rate_pps=1e6, total=5000)
        got = 0
        t0 = time.perf_counter()
        while not src.exhausted():
            got += len(src.poll(512))
        wall = time.perf_counter() - t0
        assert got == 5000
        st = src.pop_scheduled(5000) - src.t_start
        assert np.allclose(np.diff(st), 1e-6, atol=1e-9)
        assert wall >= 4e-3

    def test_paced_source_stamps_scheduled_ts(self):
        src = PacedSource(_pool(), rate_pps=1e5, total=100)
        recs = []
        while not src.exhausted():
            r = src.poll(64)
            if len(r):
                recs.append(r)
        ts = np.concatenate([r["ts_ns"] for r in recs]).astype(np.int64)
        assert np.array_equal(np.diff(ts), np.full(99, 10_000))

    @pytest.mark.parametrize("sink_thread", [False, True])
    def test_per_record_reap_latencies(self, sink_thread):
        """Every offered record gets exactly one latency sample, FIFO;
        the engine's own seal -> verdict plane counts every record."""
        _, cfg = _cfgs(batch=128)
        total = 128 * 6
        src = PacedSource(_pool(), rate_pps=5e5, total=total)
        eng = Engine(cfg, src, CollectSink(), device="cpu",
                     readback_depth=0, sink_thread=sink_thread)
        lats: list[float] = []
        eng.on_reap = lambda n, t: lats.extend(t - src.pop_scheduled(n))
        rep = eng.run()
        assert rep.records == total == len(lats) == src.popped
        lats_a = np.array(lats)
        assert (lats_a > 0).all() and np.percentile(lats_a, 50) < 5.0
        lat = rep.latency
        assert lat["seal_to_verdict"]["n"] == total
        assert lat["negatives"] == 0
        assert lat["compute_is_wall"] is True
        for s in ("staged_wait", "upload", "compute", "sink"):
            assert lat["stages"][s]["n"] == total

    def test_verdicts_sink_when_ready_not_at_depth(self):
        """A deep pipe must not defer verdicts: with batches ~32 ms apart
        and ``readback_depth`` 8, the first batch's records sink as soon
        as its step is done — a reap deferred by the depth would hold
        them ~8 x 32 = 256 ms (the bound leaves room for a loaded
        host)."""
        _, cfg = _cfgs(batch=64, depth=8)
        eng = Engine(cfg, PacedSource(_pool(), rate_pps=1e6, total=64),
                     CollectSink(), device="cpu", sink_thread=False)
        eng.run()
        src = PacedSource(_pool(), rate_pps=2000, total=64 * 12)
        eng.reset_stream(src)
        lats = []
        eng.on_reap = lambda n, t: lats.extend(t - src.pop_scheduled(n))
        eng.run()
        assert len(lats) == 64 * 12
        assert float(np.median(np.asarray(lats[:64]) * 1e3)) < 128.0

    def test_deadline_flush_waits_for_idle_pipe(self):
        _, cfg = _cfgs(batch=256, depth=2)
        src = PacedSource(_pool(), rate_pps=3e4, total=3000)
        rep = Engine(cfg, src, CollectSink(), device="cpu").run()
        assert rep.records == 3000
        assert rep.batches <= 30, rep.batches

    def test_reset_stream_keeps_table_and_epoch(self):
        _, cfg = _cfgs(batch=64, depth=2)
        src1 = PacedSource(_pool(), rate_pps=2e5, total=64 * 3)
        eng = Engine(cfg, src1, CollectSink(), device="cpu")
        rep1 = eng.run()
        tracked, t0 = rep1.table["tracked"], eng.batcher.t0_ns
        src2 = PacedSource(_pool(seed=9), rate_pps=2e5, total=64 * 4)
        lats = []
        eng.reset_stream(src2, readback_depth=1)
        eng.on_reap = lambda n, t: lats.extend(t - src2.pop_scheduled(n))
        rep2 = eng.run()
        assert rep2.records == len(lats) == 64 * 4
        # the stream's counters restarted, the device's did not
        assert rep2.batches == sum(rep2.dispatch["group_hist"].values())
        assert eng.stats.to_dict()["batches"] == rep1.batches + rep2.batches
        assert eng.readback_depth == 1 and eng._n_slots == 3
        assert eng.batcher.t0_ns == t0 and not eng._t0_auto
        assert rep2.table["tracked"] >= tracked

    def test_paced_source_pulse_schedule_and_pop(self):
        pool = TrafficGen(TrafficSpec(seed=1)).next_records(512)
        src = PacedSource(pool, rate_pps=2e5, total=400,
                          burst_period_s=4e-3, duty_cycle=0.25)
        got = []
        while not src.exhausted():
            r = src.poll(10_000)
            if len(r):
                got.append(r)
            time.sleep(0.0005)
        recs = np.concatenate(got)
        assert len(recs) == 400
        sch = src.pop_scheduled(400)
        rel = recs["ts_ns"].astype(np.int64) / 1e9
        np.testing.assert_allclose(sch - src.t_start, rel, atol=1e-6)
        assert (np.diff(sch) >= -1e-9).all()
        off = (sch - src.t_start) % 4e-3
        assert (off <= 1e-3 + 1e-6).all()

    def test_paced_latency_run_and_summary(self):
        _, cfg = _cfgs(batch=128)
        eng = Engine(cfg, ArraySource(_pool(0)), CollectSink(), device="cpu",
                     mega_n="auto", slo_us=50_000)
        eng.warm()
        src = PacedSource(_pool(), rate_pps=2e5, total=128 * 8,
                          burst_period_s=5e-3, duty_cycle=0.25)
        lats, wall, rep = paced_latency_run(eng, src, max_seconds=5.0)
        s = summarize_latencies(lats)
        assert s["n"] == rep.records == 128 * 8
        assert s["p50_ms"] <= s["p99_ms"] <= s["max_ms"]
        assert rep.latency["seal_to_verdict"]["n"] == rep.records
        assert rep.latency["slo"]["slo_us"] == 50_000
        assert summarize_latencies([]) == {"n": 0}


# -- the watchdog and the health ladder ---------------------------------------


class TestDispatchWatchdog:
    def test_disabled_and_idle_never_trip(self):
        wd = DispatchWatchdog(0.0)
        wd.check(busy=5)
        wd = DispatchWatchdog(10.0)
        wd._last_progress -= 100.0
        wd.check(busy=0)
        assert wd.trips == 0 and not wd.tripped

    def test_soft_then_hard_trip(self, capsys):
        wd = DispatchWatchdog(0.05)
        wd._last_progress -= 1.0
        wd.check(busy=3)
        assert wd.trips == 1 and not wd.tripped
        assert "per-thread stacks" in capsys.readouterr().err
        wd._soft_at -= 1.0
        with pytest.raises(WatchdogStall, match="refusing to hang"):
            wd.check(busy=3)
        assert wd.tripped and wd.to_dict()["hard_tripped"] is True

    def test_progress_rearms(self):
        wd = DispatchWatchdog(0.05)
        wd._last_progress -= 1.0
        wd.check(busy=1)
        assert wd.trips == 1
        wd.note_progress()
        wd.check(busy=1)
        assert wd.trips == 1 and not wd.tripped

    def test_wedged_sink_trips_engine_and_shutdown_is_bounded(self, capsys):
        """A sink thread that stops making progress (its ``apply``
        blocks) with batches in flight: a soft trip, then
        :class:`WatchdogStall` on the dispatch thread; the health ladder
        reads FAILED, and shutdown does not wait for the wedged
        thread."""
        release = threading.Event()

        class WedgedSink:
            def apply(self, update):
                release.wait(10.0)

        _, cfg = _cfgs(depth=2)
        eng = Engine(cfg, ArraySource(_flood(256 * 12)), WedgedSink(),
                     device="cpu", sink_thread=True, watchdog_s=0.2)
        t = time.perf_counter()
        with pytest.raises(WatchdogStall):
            eng.run()
        assert time.perf_counter() - t < 5.0
        release.set()
        wd = eng._watchdog.to_dict()
        assert wd["soft_trips"] == 1 and wd["hard_tripped"]
        assert health.engine_health(watchdog=wd)["state"] == "failed"
        assert "soft trip" in capsys.readouterr().err


class TestHealthLadder:
    CASES = [
        dict(ingest={"n_workers": 2, "dead_workers": [], "workers": {}},
             gossip={"tx_dropped": 0, "rx_seq_gaps": 0},
             watchdog={"soft_trips": 0, "hard_tripped": False}),
        dict(ingest={"n_workers": 2, "dead_workers": [1],
                     "dropped_emit_batches": 3, "quarantined_batches": 2,
                     "bad_wire_slots": 1,
                     "workers": {"0": {"seq_gaps": 4, "stalled": True}}},
             gossip={"tx_dropped": 7, "rx_seq_gaps": 1},
             restore_fallbacks=1),
        dict(ingest={"n_workers": 2, "dead_workers": [0, 1],
                     "workers": {}}),
        dict(watchdog={"soft_trips": 2, "hard_tripped": True}),
        dict(watchdog={"soft_trips": 1, "hard_tripped": False},
             rebalance={"adopt_dropped": 3}),
    ]

    def test_ladder_equals_reference(self):
        states = []
        for kw in self.CASES:
            got = health.engine_health(**kw)
            assert got == jhealth.engine_health(**kw)
            states.append(got["state"])
        assert states == ["healthy", "degraded", "failed", "failed",
                          "degraded"]
        assert set(health.engine_health(**self.CASES[1])["reasons"]) == {
            "ingest_shards_dead:1", "ingest_shards_stalled:1",
            "ingest_seq_gaps:4", "ingest_emit_drops:3",
            "quarantined_batches:2", "bad_wire_slots:1",
            "gossip_tx_dropped:7", "gossip_rx_seq_gaps:1",
            "restore_fallbacks:1"}

    def test_cluster_worst_of_equals_reference(self):
        per = {0: {"state": "healthy", "reasons": []},
               1: {"state": "degraded", "reasons": ["bad_wire_slots:1"]}}
        for failed, stalled in (([], []), ([1], []), ([], [0])):
            assert health.cluster_health(per, failed, stalled) == \
                jhealth.cluster_health(per, failed, stalled)
        assert health.worst("healthy", "bogus") == "degraded"

    def test_defaults_byte_identical(self):
        """At defaults the watchdog and health plane change nothing:
        stats, blacklist and table bytes equal a watchdog-disabled run
        and the reference engine's; the report reads healthy."""
        jcfg, tcfg = _cfgs(pps_threshold=200.0, bps_threshold=1e9)
        recs = _flood(256 * 6, seed=13)
        jsink = JCollectSink()
        jrep = JEngine(jcfg, JArraySource(recs.copy()), jsink,
                       sink_thread=False).run()
        out = []
        for wd in (None, 0.0):
            sink = CollectSink()
            e = Engine(tcfg, ArraySource(recs.copy()), sink, device="cpu",
                       watchdog_s=wd)
            r = e.run()
            out.append((r.stats, sink.blocked, _table_bytes(e)))
            assert r.stats == jrep.stats and sink.blocked == jsink.blocked
            assert r.health == {"state": "healthy", "reasons": []}
            assert r.health == jrep.health
        assert out[0] == out[1]

    def test_cli_report_blocks(self, capsys):
        from flowsentryx_tpu_torch import cli

        rc = cli.main(["serve", "--device", "cpu", "--table-capacity",
                       "4096", "--batches", "2", "--no-sink-thread",
                       "--watchdog-s", "0", "--json"])
        assert rc == 0
        rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert rep["health"]["state"] == "healthy"
        assert rep["latency"]["seal_to_verdict"]["n"] == rep["records"]
        assert rep["readback"]["sink_thread"] is False
        assert rep["predict"] is None
        assert cli.main(["serve", "--device", "cpu", "--watchdog-s",
                         "-1"]) == 1
