"""Burst forecasting and the predictive dispatch governor.

Counterpart of ``flowsentryx_tpu/engine/predict.py``, copied.  The
latency-budget engine (``serve --slo-us``) is reactive: its deadline
flush fires only once a record has aged toward its budget.  With
``--predict`` the engine forecasts the arrival process from the arrival
stamps its dispatch loop already takes, and acts ahead of it:

* :class:`BurstPredictor` — online period / duty / amplitude estimation
  over arrival stamps: arrivals binned at ``tuning.PREDICT_BIN_S`` over
  a ``PREDICT_WINDOW_S`` window, the period is the autocorrelation peak
  of the smoothed, mean-removed counts, the CONFIDENCE its normalized
  height (near 1 for a clean pulse wave, near 0 for steady or aperiodic
  traffic).  A forecast below ``PREDICT_CONF_MIN`` actuates nothing:
  the engine is then exactly the reactive one.
* :class:`DispatchGovernor` — the actuation policy around a forecast;
  every engine number it needs (step-time EWMA, budget, pending age) is
  passed in per call:

  - **forecast-end flush** (:meth:`~DispatchGovernor.flush_decision`):
    past the predicted end of a burst, flush now; inside it, hold only
    while the end-of-burst flush still lands the oldest record inside
    the budget;
  - **pre-warm** (:meth:`~DispatchGovernor.prewarm_rung`): one masked
    dispatch through the predicted rung, issued ``ewma + margin`` ahead
    of the predicted onset; hits and misses counted per onset;
  - **budget pressure** (:meth:`~DispatchGovernor.pressure`): 1.0 while
    the oldest staged work's remaining headroom fraction is below
    ``PREDICT_SHED_HEADROOM``.  It is computed and counted; the port has
    no consumer for it yet (the reference defers gossip anti-entropy
    with it).

An existing backlog is never capped, and an already late record keeps
the greedy flush: every decision goes through the engine's own
``_deadline_flush_due`` and ``_drain_pending``, so the governor moves
flush timing, never verdicts.  numpy only.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np

from flowsentryx_tpu_torch.sync import tuning


class Forecast(NamedTuple):
    """One confident estimate of the arrival process, phase-anchored.

    ``anchor_s`` is a MEASURED burst onset (same clock as
    ``BurstPredictor.observe``); every predicted onset is
    ``anchor_s + k * period_s``.  ``records_per_burst`` is the mean
    arrival volume of one on-window — the number the pre-warm rung is
    sized from."""

    period_s: float
    duty: float
    amplitude: float          # on-window rate / mean rate
    confidence: float         # normalized autocorr peak, [0, 1]
    anchor_s: float           # a measured onset (observe() clock)
    records_per_burst: float
    made_at: float

    def last_onset(self, now: float) -> float:
        """The latest predicted onset <= now."""
        k = math.floor((now - self.anchor_s) / self.period_s)
        return self.anchor_s + k * self.period_s

    def next_onset(self, now: float) -> float:
        """The earliest predicted onset > now."""
        return self.last_onset(now) + self.period_s

    def on_end(self, now: float) -> float:
        """End of the on-window opened by ``last_onset(now)``."""
        return self.last_onset(now) + self.duty * self.period_s

    def in_on_window(self, now: float) -> bool:
        return now < self.on_end(now)


class BurstPredictor:
    """Online period/duty/amplitude estimator over arrival stamps.

    ``observe(t, n)`` records ``n`` arrivals at time ``t`` (any
    monotone clock; the engine uses ``perf_counter``);
    ``estimate(now)`` returns a :class:`Forecast` or ``None``.  The
    estimator is deterministic in its inputs — the unit tests drive it
    with ``traffic.pulse_offsets_ns`` schedules and pin the recovered
    period/duty/confidence."""

    def __init__(self, bin_s: float = tuning.PREDICT_BIN_S,
                 window_s: float = tuning.PREDICT_WINDOW_S,
                 min_periods: int = tuning.PREDICT_MIN_PERIODS,
                 smooth_bins: int = tuning.PREDICT_SMOOTH_BINS):
        self.bin_s = float(bin_s)
        self.window_s = float(window_s)
        self.min_periods = int(min_periods)
        self.smooth_bins = max(int(smooth_bins), 1)
        self._t: list[float] = []   # arrival stamps (one per observe)
        self._n: list[int] = []     # arrival counts
        self.observed = 0           # total records ever observed

    def observe(self, t: float, n: int) -> None:
        if n <= 0:
            return
        self._t.append(float(t))
        self._n.append(int(n))
        self.observed += n
        # prune from the front: observe() times are monotone (one
        # dispatch-thread caller), so the window is a contiguous tail
        cut = t - self.window_s
        drop = 0
        for v in self._t:
            if v >= cut:
                break
            drop += 1
        if drop:
            del self._t[:drop]
            del self._n[:drop]

    def estimate(self, now: float) -> Forecast | None:
        """One estimator pass over the current window (module
        docstring has the math).  Returns ``None`` when the window is
        empty or no burst onset is observable; a LOW-CONFIDENCE
        forecast is still returned — the caller gates actuation on
        ``confidence`` so the gate threshold lives in one place
        (``DispatchGovernor``)."""
        if not self._t:
            return None
        t = np.asarray(self._t, np.float64)
        w = np.asarray(self._n, np.float64)
        t0 = now - self.window_s
        nbins = max(int(round(self.window_s / self.bin_s)), 4)
        counts, _ = np.histogram(
            t, bins=nbins, range=(t0, now), weights=w)
        total = counts.sum()
        if total <= 0:
            return None
        # The dispatch loop observes arrivals at POLL times: a whole
        # burst lands as 1-3 clumps jittered by however long the loop
        # was inside dispatch/reap when the records arrived.  Raw
        # per-bin autocorrelation decorrelates under that jitter (the
        # clump positions shift period to period); a box smooth the
        # width of the expected jitter restores it.  The smoothed
        # series feeds the period search ONLY through lags past the
        # kernel's own correlation length (the lag floor below) —
        # short lags would otherwise see the box correlating with
        # itself and report any noise as a sub-millisecond pulse.
        smooth = self.smooth_bins
        sm = (np.convolve(counts, np.ones(smooth, dtype=np.float64),
                          mode="same")
              if smooth > 1 else counts)
        mean = sm.mean()
        x = sm - mean
        # non-negative-lag autocorrelation; lag bound = window must
        # span >= min_periods whole cycles of any eligible period
        ac = np.correlate(x, x, "full")[nbins - 1:]
        if ac[0] <= 0:
            return None
        max_lag = nbins // max(self.min_periods, 1)
        lo = max(2, 2 * smooth if smooth > 1 else 2)
        if max_lag < lo:
            return None
        lags = np.arange(lo, max_lag + 1, dtype=np.int64)
        peak = int(lags[np.argmax(ac[lo:max_lag + 1])])
        # harmonic folding: observation jitter can push the argmax to
        # a MULTIPLE of the true period (the fundamental's peak is
        # blunted more than the aggregate longer-lag peaks).  A
        # sub-multiple carrying comparable correlation IS the
        # fundamental — take the smallest such.
        for div in range(5, 1, -1):
            cand = int(round(peak / div))
            if cand >= lo and ac[cand] >= 0.8 * ac[peak]:
                peak = cand
                break
        confidence = float(max(ac[peak] / ac[0], 0.0))
        period_s = peak * self.bin_s
        on = sm > mean
        if not on.any():
            return None
        # duty from the smoothed above-mean fraction, deconvolved: the
        # box widens every burst by ~(smooth-1) bins, and the window
        # holds nbins/peak bursts
        widen = (smooth - 1) / peak if smooth > 1 else 0.0
        duty = float(min(max(on.mean() - widen,
                             self.bin_s / period_s), 1.0))
        on_rate = sm[on].mean()
        amplitude = float(on_rate / mean) if mean > 0 else 1.0
        # phase anchor: the last off->on transition in the window.
        # The centered box kernel crosses the above-mean threshold
        # ~one bin before the true onset (the box must cover ~1/
        # amplitude of a burst bin to clear the mean) — shift one bin
        # back; residual error is EARLY, which every actuation
        # tolerates (pre-warm leads more, the hold window opens
        # sooner) where late would miss the pre-warm window outright.
        rising = np.flatnonzero(on[1:] & ~on[:-1]) + 1
        if not len(rising):
            return None
        anchor = t0 + (float(rising[-1])
                       + (1 if smooth > 1 else 0)) * self.bin_s
        records_per_burst = float(total) * period_s / self.window_s
        return Forecast(period_s=period_s, duty=duty,
                        amplitude=amplitude, confidence=confidence,
                        anchor_s=anchor,
                        records_per_burst=records_per_burst,
                        made_at=now)


class DispatchGovernor:
    """Actuation policy around a :class:`BurstPredictor` (module
    docstring).  Owned by the dispatch thread; the engine report reads
    it only at quiescence (``_build_report``)."""

    def __init__(self, rung_sizes=(), batch_records: int = 1,
                 conf_min: float = tuning.PREDICT_CONF_MIN,
                 predictor: BurstPredictor | None = None):
        self.predictor = predictor or BurstPredictor()
        #: mega-ladder rung sizes, largest first (engine ``_mega_sizes``)
        self.rung_sizes = tuple(rung_sizes)
        self.batch_records = max(int(batch_records), 1)
        self.conf_min = float(conf_min)
        self.forecast: Forecast | None = None
        self._last_estimate_t = 0.0
        self._last_arrival_t = -math.inf
        self._armed_onset = 0.0      # the future onset under watch
        self._prewarmed_onset = 0.0  # onset a pre-warm was issued for
        self.reset_counters()

    def reset_counters(self) -> None:
        """Per-stream counter reset (engine ``reset_stream`` — same
        lifecycle as ``_lat``; the predictor's learned state survives
        like the rung EWMA table does)."""
        self.forecasts = 0
        self.forecast_dropped = 0
        self.onset_hits = 0
        self.onset_misses = 0
        self.prewarm_issued = 0
        self.prewarm_hits = 0
        self.prewarm_misses = 0
        self.early_flushes = 0
        self.holds = 0
        self.pressure_ticks = 0

    # -- observation --------------------------------------------------------

    def note_arrivals(self, now: float, n: int) -> None:
        """Feed ``n`` arrivals at ``now`` to the predictor."""
        if n <= 0:
            return
        self.predictor.observe(now, n)
        self._last_arrival_t = now

    # -- forecast lifecycle -------------------------------------------------

    def update(self, now: float) -> None:
        """Throttled re-estimation + per-onset hit/miss accounting.
        Called from the dispatch loop (engine ``_reap_ready``)."""
        if now - self._last_estimate_t >= tuning.PREDICT_REESTIMATE_S:
            self._last_estimate_t = now
            f = self.predictor.estimate(now)
            # Schmitt-trigger gate: LOCK requires the full conf_min
            # (the quiescent guarantee); once locked, tracking
            # estimates re-anchor the phase down to conf_min *
            # PREDICT_CONF_EXIT_FRAC — observation jitter leaves a
            # real pulse wave hovering around the entry gate, and a
            # single threshold flaps the forecast off for most bursts.
            gate = self.conf_min * (tuning.PREDICT_CONF_EXIT_FRAC
                                    if self.forecast is not None
                                    else 1.0)
            if f is not None and f.confidence >= gate:
                if self.forecast is None:
                    self.forecasts += 1
                self.forecast = f
            elif self.forecast is not None:
                # confidence lost: forecast expires, actuation stops,
                # the engine is reactive again (the quiescent fallback)
                self.forecast_dropped += 1
                self.forecast = None
        f = self.forecast
        tol = tuning.PREDICT_ONSET_TOL_S
        if self._armed_onset and now > self._armed_onset + tol:
            # the predicted onset has passed: judge it against the
            # arrivals actually seen near it
            hit = self._last_arrival_t >= self._armed_onset - tol
            prewarmed = self._prewarmed_onset == self._armed_onset
            if hit:
                self.onset_hits += 1
                if prewarmed:
                    self.prewarm_hits += 1
            else:
                self.onset_misses += 1
                if prewarmed:
                    self.prewarm_misses += 1
            self._armed_onset = 0.0
        if f is None:
            self._armed_onset = 0.0
        elif not self._armed_onset:
            self._armed_onset = f.next_onset(now)

    # -- actuation ----------------------------------------------------------

    def flush_decision(self, now: float, age_s: float, step_s: float,
                       budget_s: float) -> bool | None:
        """Move the deadline-flush point inside the budget.

        Returns ``True`` (flush now — predicted burst over), ``False``
        (hold — burst still arriving AND the end-of-burst flush still
        lands the oldest record inside the budget), or ``None``
        (no confident forecast: the reactive rule decides).  The
        caller (engine ``_deadline_flush_due``) has already
        established ``age_s > 0``, an idle pipe, and an SLO budget."""
        f = self.forecast
        if f is None or age_s <= 0.0:
            return None
        reactive_due = age_s >= max(budget_s - step_s, budget_s / 2)
        on_end = f.on_end(now)
        if f.in_on_window(now):
            # hold for ONE end-of-burst flush only while that flush
            # would still land the oldest record inside the budget —
            # otherwise fall back to the reactive rule (never loosen
            # the budget law)
            if (on_end - now) + age_s + step_s <= budget_s:
                if reactive_due:
                    self.holds += 1
                return False
            return None
        if now - on_end <= f.period_s - f.duty * f.period_s:
            # inside the off-window after a burst: everything the
            # burst delivered is staged — flush it as one group now
            # instead of waiting out the aged-record floor
            if not reactive_due:
                self.early_flushes += 1
            return True
        return None

    def prewarm_rung(self, now: float, step_s: float) -> int:
        """The rung to pre-warm right now, or 0.

        Nonzero exactly once per predicted onset, inside the
        ``[onset - (step_s + margin), onset)`` lead window — early
        enough that the zero-valid dispatch retires (and refreshes
        the rung's EWMA) before the burst lands.  The rung is sized
        from the forecast burst volume via the shared ladder policy
        (``fused.rung_for_volume``)."""
        f = self.forecast
        onset = self._armed_onset
        if f is None or not onset or self._prewarmed_onset == onset:
            return 0
        lead = step_s + tuning.PREDICT_PREWARM_MARGIN_S
        if not (onset - lead <= now < onset):
            return 0
        from flowsentryx_tpu_torch.ops import fused

        vol = max(int(math.ceil(
            f.records_per_burst / self.batch_records)), 1)
        rung = fused.rung_for_volume(vol, self.rung_sizes)
        self._prewarmed_onset = onset
        self.prewarm_issued += 1
        return rung

    def pressure(self, age_s: float, budget_s: float) -> float:
        """Budget-pressure signal for the shedding plane: 1.0 when the
        oldest staged work's remaining headroom fraction is under
        ``PREDICT_SHED_HEADROOM``, else 0.0 (counted in
        ``pressure_ticks``)."""
        if budget_s <= 0.0 or age_s <= 0.0:
            return 0.0
        if 1.0 - age_s / budget_s < tuning.PREDICT_SHED_HEADROOM:
            self.pressure_ticks += 1
            return 1.0
        return 0.0

    # -- reporting ----------------------------------------------------------

    def report(self) -> dict:
        f = self.forecast
        est = None
        if f is not None:
            est = {
                "period_ms": round(f.period_s * 1e3, 3),
                "duty": round(f.duty, 3),
                "amplitude": round(f.amplitude, 2),
                "confidence": round(f.confidence, 3),
                "records_per_burst": round(f.records_per_burst, 1),
            }
        return {
            "confident": f is not None,
            "estimate": est,
            "observed_records": int(self.predictor.observed),
            "forecasts": self.forecasts,
            "forecast_dropped": self.forecast_dropped,
            "onset_hits": self.onset_hits,
            "onset_misses": self.onset_misses,
            "prewarm_issued": self.prewarm_issued,
            "prewarm_hits": self.prewarm_hits,
            "prewarm_misses": self.prewarm_misses,
            "early_flushes": self.early_flushes,
            "holds": self.holds,
            "pressure_ticks": self.pressure_ticks,
        }

    @staticmethod
    def merge_reports(blocks: list[dict]) -> dict:
        """Sum the counter fields of several ``report()`` dicts into
        one view (several engines or runs);
        ``confident`` is any-of, the estimate shown is the highest-
        confidence one.  Jax-free, tolerant of partial blocks."""
        keys = ("observed_records", "forecasts", "forecast_dropped",
                "onset_hits", "onset_misses", "prewarm_issued",
                "prewarm_hits", "prewarm_misses", "early_flushes",
                "holds", "pressure_ticks",
                "gossip_ticks_deferred", "net_resync_deferred")
        out: dict = {k: 0 for k in keys}
        out["confident"] = False
        out["estimate"] = None
        best = -1.0
        for b in blocks:
            if not isinstance(b, dict):
                continue
            for k in keys:
                v = b.get(k)
                if isinstance(v, (int, float)):
                    out[k] += int(v)
            if b.get("confident"):
                out["confident"] = True
            est = b.get("estimate")
            if isinstance(est, dict) and est.get(
                    "confidence", 0.0) is not None:
                c = float(est.get("confidence") or 0.0)
                if c > best:
                    best = c
                    out["estimate"] = est
        return out
