"""Latency-budget dispatch (``Engine(slo_us=N)`` / ``serve --slo-us``)
of the port against the reference's.

The policy bounds COALESCING only, so stats, blacklist and table are the
same bytes as the reference engine's and as the ``slo_us=0`` port run at
any budget, with the sink thread on or off, with the predictor, from
records and from sealed batches; under a budget the greedy flush picks
the same rungs as the reference's on the same backlog and EWMA table.
The reference's oracles (``tests/test_engine.py::TestSloServing``, the
paced half of ``TestPulseTraffic``) hold for the port."""

import dataclasses
import time

import numpy as np
import pytest
import torch

from flowsentryx_tpu.core import config as jconfig
from flowsentryx_tpu.engine import ArraySource as JArraySource
from flowsentryx_tpu.engine import CollectSink as JCollectSink
from flowsentryx_tpu.engine import Engine as JEngine
from flowsentryx_tpu.engine import NullSink as JNullSink
from flowsentryx_tpu_torch import cli
from flowsentryx_tpu_torch.benchmarks import paced_latency_run
from flowsentryx_tpu_torch.core import config, schema
from flowsentryx_tpu_torch.engine import (
    ArraySource, CollectSink, Engine, NullSink, PacedSource, Scenario,
    TrafficGen, TrafficSpec,
)
from flowsentryx_tpu_torch.engine.engine import _InFlight

B = 256


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfgs(deadline_us=200, depth=4):
    kw = dict(table=dict(capacity=1 << 12, salt=0x1234),
              batch=dict(max_batch=B, deadline_us=deadline_us,
                         readback_depth=depth),
              limiter=dict(pps_threshold=200.0, bps_threshold=1e9))
    return tuple(m.FsxConfig(
        table=m.TableConfig(**kw["table"]),
        batch=m.BatchConfig(**kw["batch"]),
        limiter=m.LimiterConfig(**kw["limiter"])) for m in (jconfig, config))


def _recs(n_batches, seed=17):
    return TrafficGen(TrafficSpec(
        scenario=Scenario.UDP_FLOOD_MULTI, rate_pps=1e6, n_attack_ips=8,
        attack_fraction=0.8, seed=seed)).next_records(B * n_batches + 77)


def _state(e, rep, sink) -> tuple:
    key, st = schema.table_to_numpy(e.table)
    return rep.stats, dict(sink.blocked), key.tobytes(), st.tobytes()


@pytest.fixture(scope="module")
def reference_run():
    """The reference engine at ``slo_us=0`` over the parity stream."""
    jcfg, _ = _cfgs()
    recs = _recs(14)
    sink = JCollectSink()
    rep = JEngine(jcfg, JArraySource(recs.copy()), sink, sink_thread=False,
                  mega_n="auto").run()
    return recs, rep, sink


@pytest.fixture(scope="module")
def port_slo0(reference_run):
    recs, _, _ = reference_run
    _, tcfg = _cfgs()
    sink = CollectSink()
    e = Engine(tcfg, ArraySource(recs.copy()), sink, device="cpu",
               mega_n="auto", sink_thread=False)
    rep = e.run()
    return _state(e, rep, sink)


@pytest.mark.parametrize("slo_us,sink_thread,predict", [
    (slo, on, pred) for slo in (0, 1, 2000) for on in (False, True)
    for pred in ((False, True) if slo else (False,))])
def test_slo_parity_with_reference(reference_run, port_slo0, slo_us,
                                   sink_thread, predict):
    """Any budget, the predictor (which needs a budget), the sink thread
    on or off: stats, blacklist (keys and untils) and table bytes equal
    the reference engine's and the ``slo_us=0`` port run's."""
    recs, jrep, jsink = reference_run
    _, tcfg = _cfgs()
    sink = CollectSink()
    e = Engine(tcfg, ArraySource(recs.copy()), sink, device="cpu",
               mega_n="auto", slo_us=slo_us, predict=predict,
               sink_thread=sink_thread)
    if slo_us:
        e.warm()
        e.reset_stream(ArraySource(recs.copy()))
    rep = e.run()
    got = _state(e, rep, sink)
    assert got == port_slo0
    assert rep.stats == jrep.stats and sink.blocked == jsink.blocked
    assert rep.table == jrep.table
    assert len(sink.blocked) >= 8
    lat = rep.latency
    assert lat["seal_to_verdict"]["n"] == rep.records
    assert lat["negatives"] == 0
    if slo_us:
        assert rep.dispatch["slo"]["slo_us"] == slo_us
        assert set(rep.dispatch["slo"]["rung_ewma_ms"]) == {"1", "2", "4", "8"}
        assert lat["slo"]["slo_us"] == slo_us
    else:
        assert rep.dispatch["slo"] is None and "slo" not in lat
    if slo_us == 1:
        # a 1 µs budget is missed by every record
        assert lat["slo"]["miss_records"] == rep.records
        assert lat["slo"]["miss_fraction"] == 1.0
    assert (rep.predict is not None) is predict


def test_slo_zero_is_todays_path_and_refusals():
    _, tcfg = _cfgs()
    e = Engine(tcfg, ArraySource(_recs(6)), NullSink(), device="cpu",
               mega_n="auto")
    rep = e.run()
    assert e.slo_us == 0 and e._rung_ewma_s == {}
    assert rep.dispatch["slo"] is None
    assert rep.latency["seal_to_verdict"]["n"] == rep.records
    assert "slo" not in rep.latency
    with pytest.raises(ValueError, match="slo_us"):
        Engine(tcfg, ArraySource(_recs(1)), NullSink(), device="cpu",
               slo_us=-1)
    assert cli.main(["serve", "--device", "cpu", "--slo-us", "-1"]) == 1


# -- the greedy flush under a budget, against the reference -------------------

#: (budget s, EWMA table s, oldest record's age s, backlog, short poll) —
#: second-scale budgets and estimates, so the ms a CPU dispatch takes
#: (and the online refinement it feeds) cannot flip a decision.
_EWMA = {1: 0.5, 2: 1.0, 4: 3.0, 8: 20.0}
DRAIN_CASES = [
    (10.0, _EWMA, 0.0, 5, True),        # capped at 4: a 4, then a single
    (10.0, _EWMA, 0.0, 7, True),        # 4, 2, 1
    (10.0, _EWMA, 0.0, 8, True),        # an existing top rung: uncapped
    (10.0, _EWMA, 0.0, 5, False),       # top unaffordable: pressed, flush
    (10.0, {**_EWMA, 8: 1.0}, 0.0, 5, False),   # not pressed: hold
    (10.0, _EWMA, 8.0, 7, True),        # 2 s left: rung 2 at most
    (10.0, _EWMA, 9.8, 5, True),        # 0.2 s left: singles
    (10.0, _EWMA, 11.0, 5, True),       # already late: no cap
    (10.0, {2: 9e9, 4: 9e9, 8: 9e9}, 0.0, 5, True),   # skip the climb
    (1e-6, {2: 9e9, 4: 9e9, 8: 9e9}, 1.0, 5, True),   # late: greedy
]


@pytest.fixture(scope="module")
def drain_engines():
    jcfg, tcfg = _cfgs()
    je = JEngine(jcfg, JArraySource(_recs(1)), JNullSink(), sink_thread=False,
                 mega_n="auto", slo_us=10_000_000)
    te = Engine(tcfg, ArraySource(_recs(1)), NullSink(), device="cpu",
                sink_thread=False, mega_n="auto", slo_us=10_000_000)
    return je, te


@pytest.mark.parametrize("case", DRAIN_CASES)
def test_drain_pending_picks_reference_rungs(drain_engines, case):
    """``_drain_pending`` under a budget dispatches the same group
    shapes as the reference's on the same backlog, EWMA table and
    record age (the deterministic degradation proof of
    ``TestSloServing``, on both engines)."""
    budget, ewma, age, n, short = case
    hists = []
    for e in drain_engines:
        e._slo_budget_s = budget
        e._rung_ewma_s = dict(ewma)
        e._group_hist = {}
        warm = np.zeros((B + 1, schema.COMPACT_RECORD_WORDS), np.uint32)
        t = time.perf_counter() - age
        e._pending = [(warm.copy(), t) for _ in range(n)]
        e._drain_pending(short=short)
        e._pending = []
        e._reap(0)
        hists.append({int(g): c for g, c in e._group_hist.items()})
    assert hists[0] == hists[1]
    want = {0: {4: 1, 1: 1}, 1: {4: 1, 2: 1, 1: 1}, 2: {8: 1},
            3: {4: 1, 1: 1}, 4: {}, 5: {2: 3, 1: 1}, 6: {1: 5},
            7: {4: 1, 1: 1}, 8: {1: 5}, 9: {4: 1, 1: 1}}
    assert hists[1] == want[DRAIN_CASES.index(case)]


def test_slo_cap_and_pressed_equal_reference(drain_engines):
    """The policy predicates on a hand-set EWMA table, both engines."""
    for e in drain_engines:
        e._slo_budget_s = 10e-3
        e._rung_ewma_s = {1: 0.0005, 2: 0.001, 4: 0.003, 8: 0.02}
        now = time.perf_counter()
        assert e._slo_cap(now) == 4
        assert e._slo_cap(now - 0.008) == 2
        assert e._slo_cap(now - 0.0098) == 1
        assert e._slo_cap(now - 0.011) == 8
        assert e._slo_pressed(now)
        e._rung_ewma_s[8] = 0.001
        assert not e._slo_pressed(now)
        assert e._slo_pressed(now - 0.0095)
        assert e._slo_pressed(now - 0.011)


def test_warm_seeds_rung_ewma():
    jcfg, tcfg = _cfgs()
    je = JEngine(jcfg, JArraySource(_recs(1)), JNullSink(), sink_thread=False,
                 mega_n="auto", slo_us=10_000)
    je.warm()
    te = Engine(tcfg, ArraySource(_recs(1)), NullSink(), device="cpu",
                mega_n="auto", slo_us=10_000)
    assert te._rung_ewma_s == {}
    te.warm()
    assert set(te._rung_ewma_s) == set(je._rung_ewma_s) == {1, 2, 4, 8}
    assert all(v > 0 for v in te._rung_ewma_s.values())
    te.reset_stream(ArraySource(_recs(1)))    # a rebind keeps the seed
    assert set(te._rung_ewma_s) == {1, 2, 4, 8}


# -- the deadline flush --------------------------------------------------------


def test_deadline_flush_only_into_idle_pipe():
    _, tcfg = _cfgs(deadline_us=1)
    e = Engine(tcfg, ArraySource(_recs(1)), NullSink(), device="cpu",
               sink_thread=False)
    e.batcher.add(TrafficGen(TrafficSpec(seed=2)).next_records(10))
    time.sleep(0.001)
    assert e.batcher.flush_due() and e._deadline_flush_due()
    e._inflight.append(_InFlight(1, None, None, None, n_records=1))
    assert e._busy_depth() == 1 and not e._deadline_flush_due()
    e._inflight.clear()
    e._chan.submit("queued to the sink thread", 1)   # still a busy pipe
    assert e._busy_depth() == 1 and not e._deadline_flush_due()
    e._chan.reset()
    assert e._deadline_flush_due()


def test_deadline_flush_slo_budget_bound():
    """Under a budget the batcher's residency is bounded by it (before
    a far ``deadline_us``), floored at half the budget, and only into
    an idle pipe."""
    _, tcfg = _cfgs(deadline_us=50_000)
    gen = TrafficGen(TrafficSpec(seed=2))
    e = Engine(tcfg, ArraySource(_recs(1)), NullSink(), device="cpu",
               sink_thread=False, slo_us=5_000)
    e._rung_ewma_s = {1: 0.001}
    e.batcher.add(gen.next_records(10))
    assert not e._deadline_flush_due()
    time.sleep(0.006)
    assert not e.batcher.flush_due() and e._deadline_flush_due()
    e2 = Engine(tcfg, ArraySource(_recs(1)), NullSink(), device="cpu",
                sink_thread=False, slo_us=5_000)
    e2._rung_ewma_s = {1: 9.0}
    e2.batcher.add(gen.next_records(10))
    assert not e2._deadline_flush_due()
    time.sleep(0.003)
    assert e2._deadline_flush_due()
    e._inflight.append(_InFlight(1, None, None, None, n_records=1))
    assert not e._deadline_flush_due()


# -- sealed batches and paced pulses -------------------------------------------


class _ListSealed:
    """A sealed-batch source over pre-sealed wire buffers."""

    provides_sealed = True
    t0_ns = 1

    def __init__(self, bufs):
        self.bufs, self.i = bufs, 0

    def start(self, *a):
        pass

    def poll_batches_into(self, dst, max_batches, **timers):
        out = []
        while len(out) < min(max_batches, len(dst)) and self.i < len(
                self.bufs):
            dst[len(out)] = self.bufs[self.i]
            out.append(type("SB", (), {
                "n_records": int(self.bufs[self.i][-1, 0]),
                "t_enqueue": time.perf_counter()})())
            self.i += 1
        return out

    def exhausted(self):
        return self.i >= len(self.bufs)


def test_sealed_loop_slo_parity():
    """The sealed-batch loop with a budget that presses every hold
    (a planted top-rung EWMA past the budget) against ``slo_us=0``."""
    _, tcfg = _cfgs()
    recs = _recs(20, seed=5)
    t0 = int(recs["ts_ns"][0])
    quant = Engine(tcfg, ArraySource(recs[:0]), NullSink(),
                   device="cpu").quant
    bufs = [schema.encode_compact(recs[i * B:(i + 1) * B], B, t0, **quant)
            for i in range(20)]
    out = []
    for slo in (0, 2000):
        sink = CollectSink()
        e = Engine(tcfg, _ListSealed([b.copy() for b in bufs]), sink,
                   device="cpu", mega_n="auto", slo_us=slo, t0_ns=t0)
        if slo:
            e._rung_ewma_s = {1: 1e-4, 2: 1e-4, 4: 1e-4, 8: 9e9}
        rep = e.run()
        out.append(_state(e, rep, sink))
        assert rep.records == sum(int(b[-1, 0]) for b in bufs)
        assert rep.latency["seal_to_verdict"]["n"] == rep.records
    assert out[0] == out[1]


@pytest.mark.parametrize("predict", [False, True])
def test_paced_pulse_arms_equal(predict):
    """The reference's pulse tier, paced on the CPU: instantaneous
    pulses of 96 records every 80 ms (each one batch in either arm:
    the drain-tuned 5 ms deadline and the 2 ms budget both flush after
    the pulse is complete, long before the next one on a loaded host), ``slo_us`` 0 against 2,000 (and with the
    predictor): the arms end in the same state, every record has a
    latency, none negative."""
    _, tcfg = _cfgs(deadline_us=5000)
    pool = TrafficGen(TrafficSpec(scenario=Scenario.SYN_BENIGN_MIX,
                                  seed=4)).next_records(4096)
    out, lat = [], []
    for slo in (0, 2000):
        sink = CollectSink()
        e = Engine(tcfg, ArraySource(pool[:0]), sink, device="cpu",
                   mega_n="auto", slo_us=slo, predict=predict and slo > 0)
        e.warm()
        src = PacedSource(pool, rate_pps=96 / 0.08, total=96 * 10,
                          burst_period_s=0.08, duty_cycle=1e-7)
        lats, _, rep = paced_latency_run(e, src, max_seconds=30.0)
        assert len(lats) == rep.records == 96 * 10
        assert rep.latency["negatives"] == 0
        assert rep.batches == 10
        out.append(_state(e, rep, sink))
        lat.append(rep.latency)
    assert out[0] == out[1]
    assert "slo" in lat[1] and "slo" not in lat[0]


def test_cli_slo_and_predict(capsys):
    import json

    rc = cli.main(["serve", "--device", "cpu", "--table-capacity", "4096",
                   "--batches", "3", "--mega", "auto", "--slo-us", "2000",
                   "--predict", "--json"])
    assert rc == 0
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rep["dispatch"]["slo"]["slo_us"] == 2000
    assert rep["latency"]["slo"]["slo_us"] == 2000
    assert rep["predict"]["observed_records"] == rep["records"]
    assert dataclasses.is_dataclass(config.DEFAULT_CONFIG)
