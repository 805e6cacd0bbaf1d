"""Autoscaling policy: the fleet's pure decide function.

Counterpart of ``flowsentryx_tpu/cluster/elastic.py``.
:class:`ElasticPolicy` turns the signal vector the cluster already has
— the ring backlog (read off the shm ring cursors), the per-rank
record-rate skew, and a report's p99 / gossip ``tx_dropped`` / watchdog
trips — into grow, shrink or rebalance plans.  It is a pure function of
(signals, clock): no I/O, no process handles, no torch.  The supervisor
executes (spawn, handoff, park); this module only decides.

Three disciplines keep it from oscillating (``sync/tuning.py``):

* **hysteresis** — a breach must hold ``ELASTIC_HYSTERESIS_TICKS``
  consecutive ticks;
* **cooldown** — ``ELASTIC_COOLDOWN_S`` of enforced quiet after an
  executed plan; suppressed decisions are counted and logged;
* **clamps** — ``min_engines <= n_live <= max_engines``; a clamped
  decision is a suppression, visible in the log.

Every plan carries the signal vector that produced it.
"""

from __future__ import annotations

import dataclasses

from flowsentryx_tpu_torch.sync import tuning

#: Plan actions (strings, not an enum — they go straight into JSON
#: logs and the supervisor's decision history).
HOLD = "hold"
GROW = "grow"
SHRINK = "shrink"
REBALANCE = "rebalance"


@dataclasses.dataclass
class ElasticPolicy:
    """Grow/shrink/rebalance decider (module docstring).

    Call :meth:`decide` once per elastic tick with the current signal
    vector; it returns a plan dict ``{"action", "reason", "signals",
    ...}`` — ``HOLD`` most ticks.  Call :meth:`executed` after the
    supervisor actually carries a plan out (starts the cooldown);
    plans the supervisor could not execute (no spare rank, handoff in
    flight) do NOT start it.
    """

    min_engines: int = 1
    max_engines: int = 2
    grow_backlog: float = tuning.ELASTIC_GROW_BACKLOG
    shrink_backlog: float = tuning.ELASTIC_SHRINK_BACKLOG
    skew_ratio: float = tuning.ELASTIC_SKEW_RATIO
    hysteresis_ticks: int = tuning.ELASTIC_HYSTERESIS_TICKS
    cooldown_s: float = tuning.ELASTIC_COOLDOWN_S

    def __post_init__(self):
        if not 1 <= self.min_engines <= self.max_engines:
            raise ValueError(
                f"need 1 <= min {self.min_engines} <= max "
                f"{self.max_engines}")
        self._streak = {GROW: 0, SHRINK: 0, REBALANCE: 0}
        self._cooldown_until = 0.0
        self.suppressed = 0
        self.decisions: list[dict] = []

    # -- the decide function -------------------------------------------------

    def decide(self, signals: dict, n_live: int, now: float) -> dict:
        """One tick.  ``signals`` keys (all optional, absent reads as
        quiet): ``backlog_per_engine`` (mean shm-ring backlog per live
        engine, records), ``backlog_max`` (worst single engine),
        ``rate_skew`` (max/mean per-rank record rate), ``p99_us`` +
        ``slo_us``, ``tx_dropped``, ``watchdog_trips``, ``degraded``
        (health-ladder fold).  ``n_live`` is the live engine count the
        plan would act on."""
        want, reason = self._raw_want(signals, n_live)
        # hysteresis: only a streak of identical wants past the bar
        # becomes a plan; any tick that wants something else resets
        # the other streaks (a flapping signal never accumulates)
        for action in self._streak:
            self._streak[action] = (
                self._streak[action] + 1 if action == want else 0)
        plan = {"action": HOLD, "reason": reason, "signals": dict(signals),
                "n_live": n_live, "streak": dict(self._streak)}
        if want != HOLD and self._streak[want] >= self.hysteresis_ticks:
            if now < self._cooldown_until:
                self.suppressed += 1
                plan["reason"] = (f"{want} suppressed: cooldown for "
                                  f"{self._cooldown_until - now:.1f}s "
                                  f"more ({reason})")
                plan["suppressed"] = want
            else:
                plan["action"] = want
        self.decisions.append(plan)
        return plan

    def executed(self, now: float) -> None:
        """The supervisor carried the last plan out: start the
        cooldown and reset every streak (the next decision starts
        from fresh evidence of the NEW shape)."""
        self._cooldown_until = now + self.cooldown_s
        for action in self._streak:
            self._streak[action] = 0

    # -- internal ------------------------------------------------------------

    def _raw_want(self, s: dict, n_live: int) -> tuple[str, str]:
        """The un-hysteresised, un-cooled want for this single tick,
        most-urgent first.  Clamp violations fold to HOLD with the
        clamp named (a visible suppression, not silence)."""
        backlog = float(s.get("backlog_per_engine", 0.0))
        backlog_max = float(s.get("backlog_max", backlog))
        skew = float(s.get("rate_skew", 1.0))
        p99 = float(s.get("p99_us", 0.0))
        slo = float(s.get("slo_us", 0.0))
        pressure = []
        if backlog > self.grow_backlog:
            pressure.append(f"backlog/engine {backlog:.0f} > "
                            f"{self.grow_backlog:.0f}")
        if slo and p99 > slo:
            pressure.append(f"p99 {p99:.0f}us > slo {slo:.0f}us")
        if float(s.get("tx_dropped", 0)) > 0:
            pressure.append(f"gossip tx_dropped {s['tx_dropped']}")
        if float(s.get("watchdog_trips", 0)) > 0:
            pressure.append(f"watchdog trips {s['watchdog_trips']}")
        if pressure:
            if n_live >= self.max_engines:
                self.suppressed += 1
                return HOLD, ("grow clamped at max_engines "
                              f"{self.max_engines} ({'; '.join(pressure)})")
            return GROW, "; ".join(pressure)
        if skew > self.skew_ratio and n_live >= 2:
            return REBALANCE, (f"record-rate skew {skew:.2f} > "
                               f"{self.skew_ratio:.2f}")
        if backlog_max < self.shrink_backlog and not s.get("degraded"):
            if n_live <= self.min_engines:
                return HOLD, (f"quiet (backlog max {backlog_max:.0f}) "
                              f"but at min_engines {self.min_engines}")
            return SHRINK, (f"backlog max {backlog_max:.0f} < "
                            f"{self.shrink_backlog:.0f} on every engine")
        return HOLD, "signals nominal"
