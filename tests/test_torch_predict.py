"""The port's burst forecaster and predictive dispatch governor
(``engine/predict.py``, ``serve --predict``) against the reference's.

The estimator and the governor are copies: on the same arrival stamps
and the same clocks they give the same forecasts, decisions and
counters as the reference's (``flowsentryx_tpu/engine/predict.py``).
The reference's own unit oracles (``tests/test_predict.py``:
``TestBurstPredictor``, ``TestDispatchGovernor``) hold for the port's
copies, driven with the shared pulse schedule
(``engine/traffic.py::pulse_offsets_ns``), and the engine integration
(``TestPredictEngine`` without its mesh case): the governor moves flush
timing, never verdicts."""

import math
import time
import types

import numpy as np
import pytest
import torch

from flowsentryx_tpu.core import config as jconfig
from flowsentryx_tpu.engine import ArraySource as JArraySource
from flowsentryx_tpu.engine import CollectSink as JCollectSink
from flowsentryx_tpu.engine import Engine as JEngine
from flowsentryx_tpu.engine import predict as jpredict
from flowsentryx_tpu_torch import cli
from flowsentryx_tpu_torch.core import config, schema
from flowsentryx_tpu_torch.engine import (
    ArraySource, CollectSink, Engine, NullSink,
)
from flowsentryx_tpu_torch.engine.predict import (
    BurstPredictor,
    DispatchGovernor,
    Forecast,
)
from flowsentryx_tpu_torch.engine.traffic import (
    Scenario,
    TrafficGen,
    TrafficSpec,
    pulse_offsets_ns,
)
from flowsentryx_tpu_torch.sync import tuning


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _pulse_forecast(period=0.01, duty=0.2, confidence=0.9, anchor=0.0,
                    records_per_burst=96.0, made_at=0.0, mod=None):
    cls = Forecast if mod is None else mod.Forecast
    return cls(period_s=period, duty=duty, amplitude=1.0 / duty,
               confidence=confidence, anchor_s=anchor,
               records_per_burst=records_per_burst, made_at=made_at)


# -- the copies against the reference, on the same inputs ----------------------


def _arrivals(kind: str, seconds: float = 0.6):
    """(stamp, count) arrivals: the pulse corpus, a jittered pulse, a
    short-duty pulse, or Poisson traffic; all from a seed."""
    rng = np.random.default_rng(11)
    rate = 0.0128e6
    if kind == "poisson":
        t = np.cumsum(rng.exponential(1.0 / rate, int(rate * seconds)))
    else:
        duty = 0.05 if kind == "short" else 0.2
        t = pulse_offsets_ns(np.arange(int(rate * seconds)), rate, 0.0075,
                             duty) / 1e9
        if kind == "jitter":
            t = np.sort(t + rng.uniform(0, 1e-3, len(t)))
    # observed in poll-sized clumps, as the dispatch loop sees them
    cuts = np.cumsum(rng.integers(1, 40, len(t)))
    cuts = cuts[cuts < len(t)]
    return [(float(c[-1]), len(c)) for c in np.split(t, cuts) if len(c)]


@pytest.mark.parametrize("kind", ["pulse", "jitter", "short", "poisson"])
def test_predictor_and_governor_equal_reference(kind):
    """The same arrivals into both governors, with the same heartbeat,
    flush, pre-warm and pressure calls: the same forecast (every field),
    the same decisions, the same report."""
    arr = _arrivals(kind)
    govs = [jpredict.DispatchGovernor(rung_sizes=(8, 4, 2),
                                      batch_records=256),
            DispatchGovernor(rung_sizes=(8, 4, 2), batch_records=256)]
    decisions = [[], []]
    for i, (t, n) in enumerate(arr):
        for g, d in zip(govs, decisions):
            g.note_arrivals(t, n)
            g.update(t + 1e-4)
            age = (i % 7) * 4e-4
            d.append((g.flush_decision(t + 2e-4, age, 6e-4, 2e-3),
                      g.prewarm_rung(t + 3e-4, 6e-4),
                      g.pressure(age, 2e-3)))
    assert decisions[0] == decisions[1]
    assert govs[0].report() == govs[1].report()
    f0, f1 = (g.predictor.estimate(arr[-1][0]) for g in govs)
    assert (f0 is None) == (f1 is None)
    if f0 is not None:
        assert tuple(f0) == tuple(f1)
    rep = govs[1].report()
    if kind == "pulse":
        assert rep["confident"] and rep["onset_hits"] > 0
    if kind == "poisson":
        assert not rep["confident"]
    assert DispatchGovernor.merge_reports([rep, rep]) == \
        jpredict.DispatchGovernor.merge_reports([rep, rep])


def test_forecast_arithmetic_equal_reference():
    for now in np.linspace(0.0, 0.05, 101):
        a = _pulse_forecast(period=0.0075, duty=0.2, anchor=0.003,
                            mod=jpredict)
        b = _pulse_forecast(period=0.0075, duty=0.2, anchor=0.003)
        for m in ("last_onset", "next_onset", "on_end", "in_on_window"):
            assert getattr(a, m)(float(now)) == getattr(b, m)(float(now))


# -- the reference's unit oracles, on the port's copies ------------------------


class TestBurstPredictor:
    # the reference's pulse corpus: 96-record bursts every 7.5 ms
    RATE = 0.0128e6
    PERIOD = 0.0075
    DUTY = 0.20

    def _feed_pulse(self, pred, seconds):
        n = int(self.RATE * seconds)
        off = pulse_offsets_ns(np.arange(n), self.RATE, self.PERIOD,
                               self.DUTY) / 1e9
        for t in off:
            pred.observe(float(t), 1)
        return float(off[-1])

    def test_recovers_pulse_period_duty_confidently(self):
        """The estimator recovers the pulse wave's period, duty and
        per-burst volume from the exact schedule the paced bench
        offers, with confidence ABOVE the actuation gate."""
        pred = BurstPredictor()
        end = self._feed_pulse(pred, 0.3)
        f = pred.estimate(end)
        assert f is not None
        assert f.period_s == pytest.approx(self.PERIOD,
                                           abs=tuning.PREDICT_BIN_S)
        assert 0.1 < f.duty < 0.4
        assert f.confidence >= tuning.PREDICT_CONF_MIN
        assert f.amplitude > 2.0  # bursts at 5x mean rate
        assert f.records_per_burst == pytest.approx(
            self.RATE * self.PERIOD, rel=0.15)
        # the phase anchor is a measured onset: within a bin or two of
        # a true k*period boundary
        phase = math.fmod(f.anchor_s, self.PERIOD)
        assert min(phase, self.PERIOD - phase) <= 2 * tuning.PREDICT_BIN_S
        # and forward onset prediction lands on the true grid
        nxt = f.next_onset(end)
        assert nxt > end
        phase = math.fmod(nxt, self.PERIOD)
        assert min(phase, self.PERIOD - phase) <= 2 * tuning.PREDICT_BIN_S

    def test_aperiodic_stream_stays_below_gate(self):
        """Poisson arrivals (seeded): no period to find — confidence
        must stay under the actuation gate, so the governor would
        actuate NOTHING (the quiescent fallback)."""
        rng = np.random.default_rng(7)
        pred = BurstPredictor()
        t = 0.0
        for gap in rng.exponential(1.0 / self.RATE, int(self.RATE * 0.3)):
            t += float(gap)
            pred.observe(t, 1)
        f = pred.estimate(t)
        assert f is None or f.confidence < tuning.PREDICT_CONF_MIN

    def test_empty_and_silent_windows_return_none(self):
        pred = BurstPredictor()
        assert pred.estimate(1.0) is None
        pred.observe(0.5, 4)
        # the whole observation history has slid out of the window
        assert pred.estimate(0.5 + 2 * pred.window_s) is None

    def test_window_prunes_from_front(self):
        pred = BurstPredictor()
        for k in range(100):
            pred.observe(k * 0.01, 1)
        assert pred.observed == 100
        # only stamps within window_s of the newest survive
        assert pred._t[0] >= 0.99 - pred.window_s

    def test_forecast_phase_arithmetic(self):
        f = _pulse_forecast(period=0.01, duty=0.2, anchor=1.0)
        assert f.last_onset(1.023) == pytest.approx(1.02)
        assert f.next_onset(1.023) == pytest.approx(1.03)
        assert f.on_end(1.023) == pytest.approx(1.022)
        assert f.in_on_window(1.021)
        assert not f.in_on_window(1.023)
        # exactly at an onset: the window just opened
        assert f.in_on_window(1.02)

    def test_pulse_schedule_validation_corners(self):
        """The shared schedule function owns the spec rules — every
        corner refused with the actual problem named, so a bench can
        never silently offer a different mean rate than it records."""
        idx = np.arange(4)
        with pytest.raises(ValueError, match="rate_pps"):
            pulse_offsets_ns(idx, 0.0, 0.01, 0.2)
        with pytest.raises(ValueError, match="rate_pps"):
            pulse_offsets_ns(idx, -5.0, 0.01, 0.2)
        with pytest.raises(ValueError, match="burst_period_s"):
            pulse_offsets_ns(idx, 1e4, -0.01, 0.2)
        with pytest.raises(ValueError, match="duty_cycle"):
            pulse_offsets_ns(idx, 1e4, 0.01, 0.0)
        with pytest.raises(ValueError, match="duty_cycle"):
            pulse_offsets_ns(idx, 1e4, 0.01, 1.2)
        # a period holding < 1 record would multiply the offered rate
        with pytest.raises(ValueError, match="fewer than one"):
            pulse_offsets_ns(idx, 100.0, 0.001, 0.2)
        # > 5 % per-period quota rounding skews the realized mean rate
        with pytest.raises(ValueError, match="5"):
            pulse_offsets_ns(idx, 1000.0, 0.0014, 0.2)
        # degenerate steady cases stay valid
        steady = pulse_offsets_ns(idx, 1e4, 0.0, 1.0)
        assert steady[0] == 100_000  # (0+1)/1e4 s in ns


class TestDispatchGovernor:
    def test_confidence_gate_sets_and_drops_forecast(self):
        gov = DispatchGovernor()
        scripted = {}
        gov.predictor = types.SimpleNamespace(
            observed=0, observe=lambda t, n: None,
            estimate=lambda now: scripted.get("f"))
        step = tuning.PREDICT_REESTIMATE_S
        gov.update(step)
        assert gov.forecast is None and gov.forecasts == 0
        scripted["f"] = _pulse_forecast(confidence=0.9, anchor=0.0)
        gov.update(2 * step)
        assert gov.forecast is not None and gov.forecasts == 1
        # confidence lost -> forecast expires, actuation stops
        scripted["f"] = _pulse_forecast(confidence=0.1)
        gov.update(3 * step)
        assert gov.forecast is None and gov.forecast_dropped == 1
        assert gov.flush_decision(3 * step, 0.001, 0.0005, 0.005) is None
        assert gov.prewarm_rung(3 * step, 0.0005) == 0

    def test_confidence_hysteresis_tracks_then_drops(self):
        """Schmitt-trigger gate: LOCK needs the full conf_min, but a
        locked forecast tracks estimates down to conf_min *
        PREDICT_CONF_EXIT_FRAC (observation jitter leaves a real pulse
        hovering around the entry gate — a single threshold flaps);
        below the exit gate the forecast drops, and a sub-entry
        estimate can never lock from quiescence."""
        gov = DispatchGovernor()
        scripted = {}
        gov.predictor = types.SimpleNamespace(
            observed=0, observe=lambda t, n: None,
            estimate=lambda now: scripted.get("f"))
        # 1.1x the throttle so successive updates always re-estimate
        # (exact multiples of the cadence lose to float rounding)
        step = tuning.PREDICT_REESTIMATE_S * 1.1
        exit_gate = tuning.PREDICT_CONF_MIN * tuning.PREDICT_CONF_EXIT_FRAC
        # between exit and entry while UNLOCKED: no lock (the
        # quiescent guarantee is phrased against the full entry gate)
        scripted["f"] = _pulse_forecast(confidence=exit_gate + 0.05)
        gov.update(step)
        assert gov.forecast is None and gov.forecasts == 0
        # entry gate reached: lock
        scripted["f"] = _pulse_forecast(confidence=0.6, anchor=0.0)
        gov.update(2 * step)
        assert gov.forecast is not None and gov.forecasts == 1
        # hovering below entry but above exit: the lock TRACKS (the
        # fresh estimate replaces the stale one — phase re-anchors)
        tracking = _pulse_forecast(confidence=exit_gate + 0.05,
                                   anchor=0.001)
        scripted["f"] = tracking
        gov.update(3 * step)
        assert gov.forecast is tracking
        assert gov.forecast_dropped == 0
        # below the exit gate: dropped
        scripted["f"] = _pulse_forecast(confidence=exit_gate - 0.05)
        gov.update(4 * step)
        assert gov.forecast is None and gov.forecast_dropped == 1
        # and the sub-entry estimate STILL cannot re-lock
        scripted["f"] = _pulse_forecast(confidence=exit_gate + 0.05)
        gov.update(5 * step)
        assert gov.forecast is None and gov.forecasts == 1

    def test_onset_hit_and_miss_accounting(self):
        gov = DispatchGovernor()
        f = _pulse_forecast(period=0.01, duty=0.2, anchor=0.0)
        gov.predictor = types.SimpleNamespace(
            observed=0, observe=lambda t, n: None,
            estimate=lambda now: f)
        tol = tuning.PREDICT_ONSET_TOL_S
        # first estimate fires only past the re-estimation throttle
        gov.update(0.055)           # arms next onset at 0.06
        assert gov._armed_onset == pytest.approx(0.06)
        gov.note_arrivals(0.0601, 32)  # traffic lands on the onset
        gov.update(0.06 + 2 * tol)     # judged: hit, re-armed at 0.07
        assert gov.onset_hits == 1 and gov.onset_misses == 0
        assert gov._armed_onset == pytest.approx(0.07)
        gov.update(0.07 + 2 * tol)     # no arrivals near 0.07: miss
        assert gov.onset_misses == 1

    def test_flush_decision_moves_the_point_both_ways(self):
        gov = DispatchGovernor()
        gov.forecast = _pulse_forecast(period=0.01, duty=0.2, anchor=0.0)
        budget, step = 0.005, 0.0005
        # mid-burst, end-of-burst flush still lands inside the budget:
        # HOLD (False) — one flush for the whole burst
        assert gov.flush_decision(0.001, 0.0005, step, budget) is False
        # mid-burst but the end flush would breach: reactive rule
        # decides (None) — the budget law is never loosened
        assert gov.flush_decision(0.001, 0.0042, step, budget) is None
        # just past the burst end, long before the aged-record floor:
        # flush NOW (True) — the predictive p99 lever
        assert gov.flush_decision(0.0025, 0.0021, step, budget) is True
        assert gov.early_flushes == 1
        # no forecast / no age: reactive decides
        assert gov.flush_decision(0.0025, 0.0, step, budget) is None
        gov.forecast = None
        assert gov.flush_decision(0.0025, 0.002, step, budget) is None

    def test_hold_never_outlives_the_reactive_point(self):
        """The safety inequality, exhaustively on a grid: whenever the
        reactive rule says FLUSH, the governor never answers hold —
        its hold condition is strictly tighter, so a confident (even
        wrong) forecast can only move flushes EARLIER, never let a
        record age past the reactive rule."""
        gov = DispatchGovernor()
        gov.forecast = _pulse_forecast(period=0.01, duty=0.2, anchor=0.0)
        budget = 0.005
        for now in np.linspace(0.0, 0.02, 41):
            for age in np.linspace(0.0001, 0.008, 20):
                for step in (0.0002, 0.002, 0.004):
                    due = age >= max(budget - step, budget / 2)
                    d = gov.flush_decision(float(now), float(age),
                                           step, budget)
                    if due:
                        assert d is not False

    def test_prewarm_once_per_onset_sized_from_forecast(self):
        gov = DispatchGovernor(rung_sizes=(8, 4, 2), batch_records=256)
        gov.forecast = _pulse_forecast(period=0.01, duty=0.2, anchor=0.0,
                                       records_per_burst=5 * 256)
        gov._armed_onset = 0.01
        step = 0.0005
        # too early: outside the lead window
        assert gov.prewarm_rung(0.005, step) == 0
        # in the lead window: 5 batches of burst -> rung 4, once
        t = 0.01 - step
        assert gov.prewarm_rung(t, step) == 4
        assert gov.prewarm_issued == 1
        assert gov.prewarm_rung(t, step) == 0  # once per onset
        # a small forecast volume pre-warms nothing but singles
        gov.forecast = gov.forecast._replace(records_per_burst=100)
        gov._armed_onset = 0.02
        assert gov.prewarm_rung(0.02 - step, step) == 1

    def test_pressure_fires_only_under_squeezed_headroom(self):
        gov = DispatchGovernor()
        budget = 0.005
        assert gov.pressure(0.001, budget) == 0.0     # 80 % headroom
        assert gov.pressure(0.0, budget) == 0.0       # nothing staged
        assert gov.pressure(0.001, 0.0) == 0.0        # no budget
        assert gov.pressure_ticks == 0
        assert gov.pressure(0.004, budget) == 1.0     # 20 % < 25 %
        assert gov.pressure_ticks == 1

    def test_reset_counters_keeps_learned_state(self):
        gov = DispatchGovernor()
        gov.predictor.observe(1.0, 64)
        gov.forecast = _pulse_forecast()
        gov.early_flushes = 5
        gov.reset_counters()
        assert gov.early_flushes == 0
        assert gov.forecast is not None          # survives, like EWMA
        assert gov.predictor.observed == 64      # window survives

    def test_merge_reports_sums_and_picks_best_estimate(self):
        a = DispatchGovernor()
        a.forecast = _pulse_forecast(confidence=0.8)
        a.early_flushes, a.prewarm_hits = 3, 2
        b = DispatchGovernor()
        b.forecast = _pulse_forecast(confidence=0.95, period=0.02)
        b.early_flushes, b.onset_misses = 4, 1
        ra, rb = a.report(), b.report()
        ra["gossip_ticks_deferred"] = 7
        rb["net_resync_deferred"] = 2
        merged = DispatchGovernor.merge_reports([ra, rb, None, "junk"])
        assert merged["early_flushes"] == 7
        assert merged["prewarm_hits"] == 2
        assert merged["onset_misses"] == 1
        assert merged["gossip_ticks_deferred"] == 7
        assert merged["net_resync_deferred"] == 2
        assert merged["confident"] is True
        assert merged["estimate"]["confidence"] == pytest.approx(0.95)
        quiet = DispatchGovernor.merge_reports(
            [DispatchGovernor().report()])
        assert quiet["confident"] is False and quiet["estimate"] is None


# -- the engine with the governor ----------------------------------------------


def _cfgs():
    kw = dict(table=dict(capacity=1 << 12, salt=0x1234),
              batch=dict(max_batch=256, readback_depth=4),
              limiter=dict(pps_threshold=200.0, bps_threshold=1e9))
    return tuple(m.FsxConfig(
        table=m.TableConfig(**kw["table"]),
        batch=m.BatchConfig(**kw["batch"]),
        limiter=m.LimiterConfig(**kw["limiter"])) for m in (jconfig, config))


def _recs(n_batches, seed=17):
    return TrafficGen(TrafficSpec(
        scenario=Scenario.UDP_FLOOD_MULTI, rate_pps=1e6, n_attack_ips=8,
        attack_fraction=0.8, seed=seed)).next_records(256 * n_batches)


def _run(recs, tweak=None, **kw):
    _, tcfg = _cfgs()
    sink = CollectSink()
    e = Engine(tcfg, ArraySource(recs.copy()), sink, device="cpu", **kw)
    if kw.get("slo_us"):
        e.warm()
        e.reset_stream(ArraySource(recs.copy()))
    if tweak is not None:
        tweak(e)
    rep = e.run()
    key, st = schema.table_to_numpy(e.table)
    return rep, sink, (rep.stats, dict(sink.blocked), key.tobytes(),
                       st.tobytes()), e


class TestPredictEngine:
    def test_predict_requires_slo_budget(self):
        _, tcfg = _cfgs()
        with pytest.raises(ValueError, match="predict"):
            Engine(tcfg, ArraySource(_recs(1)), NullSink(), device="cpu",
                   predict=True)
        assert cli.main(["serve", "--device", "cpu", "--predict"]) == 1

    def test_predict_off_has_no_governor_or_report_block(self):
        rep, _, _, e = _run(_recs(4), mega_n="auto", slo_us=250_000)
        assert e._gov is None and rep.predict is None

    def test_predict_parity_byte_identical(self):
        """predict=True against the reactive budget engine, the port's
        singles and the reference engine: the same stats, blacklist and
        table bytes.  A saturating drain is aperiodic, so the governor
        observes every record and actuates nothing."""
        recs = _recs(14)
        jcfg, _ = _cfgs()
        jsink = JCollectSink()
        jrep = JEngine(jcfg, JArraySource(recs.copy()), jsink,
                       sink_thread=False).run()
        rep1, _, s1, _ = _run(recs)
        reps, _, ss, _ = _run(recs, mega_n="auto", slo_us=250_000)
        repp, sinkp, sp, _ = _run(recs, mega_n="auto", slo_us=250_000,
                                  predict=True)
        assert s1 == ss == sp
        assert repp.stats == jrep.stats and sinkp.blocked == jsink.blocked
        p = repp.predict
        assert p["observed_records"] == repp.records
        assert p["confident"] is False
        assert p["prewarm_issued"] == 0 and p["early_flushes"] == 0

    def test_forecast_miss_degrades_to_reactive_never_worse(self):
        """A confidently WRONG forecast (planted, pinned against
        re-estimation) changes no verdict: the drain ends byte-identical
        to the reactive run."""

        def plant_wrong(e):
            now = time.perf_counter()
            e._gov.forecast = _pulse_forecast(
                period=0.003, duty=0.3, confidence=0.99,
                anchor=now - 10.0, records_per_burst=512.0, made_at=now)
            e._gov._last_estimate_t = now + 3600.0

        recs = _recs(12, seed=23)
        reps, _, ss, _ = _run(recs, mega_n="auto", slo_us=5000)
        repw, _, sw, _ = _run(recs, mega_n="auto", slo_us=5000,
                              predict=True, tweak=plant_wrong)
        assert repw.records == reps.records and sw == ss
        assert repw.latency["negatives"] == 0

    def test_reset_stream_resets_counters_keeps_window(self):
        recs = _recs(3)
        _, tcfg = _cfgs()
        e = Engine(tcfg, ArraySource(recs.copy()), NullSink(), device="cpu",
                   mega_n="auto", slo_us=250_000, predict=True)
        e.warm()
        e.run()
        seen = e._gov.predictor.observed
        assert seen == len(recs)
        e._gov.early_flushes = 3
        e.reset_stream(ArraySource(recs.copy()))
        assert e._gov.early_flushes == 0
        assert e._gov.predictor.observed == seen

    def test_prewarm_dispatch_is_result_free(self):
        """A pre-warm through a rung retires fully, touches no table
        state and records no latency sample."""
        _, tcfg = _cfgs()
        e = Engine(tcfg, ArraySource(_recs(1)), NullSink(), device="cpu",
                   sink_thread=False, mega_n="auto", slo_us=250_000,
                   predict=True)
        e.warm()
        before = dict(e._rung_ewma_s)
        for rung in (4, 1):
            e._prewarm_dispatch(rung)
        assert e._busy_depth() == 0
        assert e._lat.total.n == 0
        assert set(e._rung_ewma_s) == set(before)
        assert e.stats.to_dict()["batches"] == 0
        assert not e.table.key.any()
        assert e._group_hist == {4: 1, 1: 1}
