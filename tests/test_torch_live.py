"""``fsx live`` of the port (``flowsentryx_tpu_torch/live/`` and
``sync/interleave.explore_live``) against the JAX package's, on the CPU:
the explorer's detectors, the PROGRESS registry's two-way closure over
the port's scope (``Engine._wait_event`` and every ``synchronize()``
site included), each check's states, edges and terminals against the
reference's, the four plants caught by the reference's detector class,
and the CLI."""

import json

import pytest

from flowsentryx_tpu.live import checker as rchecker
from flowsentryx_tpu_torch.live import checker, registry
from flowsentryx_tpu_torch.sync import tuning
from flowsentryx_tpu_torch.sync.interleave import (
    CvWait, InstrumentedCv, LiveSpec, ModelViolation, Obligation,
    explore_live,
)

ENGINE = "flowsentryx_tpu_torch/engine/engine.py"


# ---------------------------------------------------------------------------
# the explorer's detectors
# ---------------------------------------------------------------------------

def test_deadlock_names_wait_and_wake_source():
    def mk():
        cv = InstrumentedCv()

        def a():
            yield CvWait(lambda: False, "ready-wait", cv,
                         source="b's notify (never sent)")

        return [("a", a())], LiveSpec(fingerprint=lambda: ())

    r = explore_live("deadlock-unit", mk)
    assert not r.ok and r.detector == "deadlock"
    assert "a waits on ready-wait" in r.counterexample.detail
    assert "wake source: b's notify (never sent)" in r.counterexample.detail


def test_missed_wakeup_is_deadlock():
    def mk():
        cv = InstrumentedCv()
        box = {"n": 0}

        def waiter():
            yield CvWait(lambda: box["n"] >= 2, "n>=2", cv,
                         source="bump notify")

        def bumper():
            yield "bump"
            with cv:
                box["n"] += 1
                cv.notify_all()

        return ([("waiter", waiter()), ("bumper", bumper())],
                LiveSpec(fingerprint=lambda: (box["n"],)))

    r = explore_live("missed-wakeup", mk)
    assert not r.ok and r.detector == "deadlock"


def test_livelock_and_fair_poll():
    def mk(with_setter):
        box = {"flag": False}

        def spinner():
            while not box["flag"]:
                yield "spin"

        def setter():
            yield "set"
            box["flag"] = True

        threads = [("spinner", spinner())]
        if with_setter:
            threads.append(("setter", setter()))
        return threads, LiveSpec(fingerprint=lambda: (box["flag"],))

    r = explore_live("livelock-unit", lambda: mk(False))
    assert not r.ok and r.detector == "livelock"
    assert "[cycle]" in r.counterexample.schedule[-1]
    assert explore_live("fair-poll", lambda: mk(True)).ok


def test_starvation_trips_at_the_declared_bound():
    def mk(fires):
        box = {"i": 0}

        def t():
            for _ in range(10):
                yield "tick"
                box["i"] += 1

        spec = LiveSpec(fingerprint=lambda: (box["i"],), obligations=[
            Obligation("ob", lambda: True,
                       (lambda: box["i"]) if fires else (lambda: 0), 4)])
        return [("t", t())], spec

    r = explore_live("starve", lambda: mk(False))
    assert not r.ok and r.detector == "starvation"
    assert "> 4 steps" in r.counterexample.detail
    assert explore_live("oblige", lambda: mk(True)).ok


def test_finale_violation_and_state_cap():
    def fin_mk():
        def t():
            yield "step"

        def finale():
            raise ModelViolation("work never done")

        return [("t", t())], LiveSpec(fingerprint=lambda: (),
                                      finale=finale)

    r = explore_live("finale", fin_mk)
    assert not r.ok and r.detector == "violation"

    def cap_mk():
        box = {"i": 0}

        def t():
            while True:
                yield "grow"
                box["i"] += 1

        return [("t", t())], LiveSpec(fingerprint=lambda: (box["i"],))

    r = explore_live("cap", cap_mk, max_states=10)
    assert r.capped and not r.ok


# ---------------------------------------------------------------------------
# the PROGRESS registry over the port's scope
# ---------------------------------------------------------------------------

def test_registry_validates_clean_over_the_ports_scope():
    rep = registry.validate()
    assert rep["ok"], rep["findings"]
    # the reference registers 13 entries over 13 sites; the port drops
    # Engine._ring_worker (no ring worker), and adds _wait_event's poll,
    # the sealed loops (sleeping through Engine._idle), the five
    # synchronize() device waits, and the process mesh's collective
    # wait, follower loop and step timer's event wait
    assert (rep["entries"], rep["sites"]) == (23, 22)
    assert all(e.path.startswith("flowsentryx_tpu_torch/")
               for e in registry.PROGRESS)
    assert all(m.startswith("flowsentryx_tpu_torch/")
               for m in registry.SCAN_MODULES)


def test_every_bound_names_a_port_tuning_constant():
    for e in registry.PROGRESS:
        assert getattr(tuning, e.bound) > 0, e.name
    by_site = {}
    for e in registry.PROGRESS:
        by_site.setdefault(e.qualname, []).append(e)
    assert "Engine._ring_worker" not in by_site
    assert by_site["Engine._run_inline"][0].bound == "IDLE_SLEEP_S"
    kinds = {e.kind: e for e in by_site["Engine._wait_event"]}
    assert kinds["poll"].bound == "WATCHDOG_STALL_S"
    assert "CUDA event" in kinds["poll"].wake
    sync = kinds["device-wait"]
    assert sync.bound == "WATCHDOG_STALL_S"
    assert "hard timeout only" in sync.obligation


def test_scan_finds_wait_event_and_every_synchronize_site():
    sites = {(s["path"], s["qualname"]): s
             for s in registry.scan_blocking_sites()}
    we = sites[(ENGINE, "Engine._wait_event")]
    assert set(we["kinds"]) == {"poll", "device-wait"}
    src = (registry.repo_root() / ENGINE).read_text()
    n_sync = src.count(".synchronize(")
    scanned = sum(1 for s in sites.values() if s["path"] == ENGINE
                  for k in s["kinds"] if k == "device-wait")
    lines = [ln for s in sites.values() if s["path"] == ENGINE
             and "device-wait" in s["kinds"] for ln in s["lines"]]
    assert n_sync == 5 and scanned == 5 and len(lines) >= 5
    for qn in ("Engine.warm", "Engine.restore", "Engine._quiescent_table",
               "Engine._write_table"):
        assert sites[(ENGINE, qn)]["kinds"] == ["device-wait"], qn
    for qn in ("Engine._run_inline", "Engine._run_sealed",
               "Engine._sealed_loop_ring"):
        assert sites[(ENGINE, qn)]["kinds"] == ["poll"], qn


def test_unregistered_and_stale_entries_are_findings(tmp_path):
    mod = tmp_path / registry.SCAN_MODULES[0]
    mod.parent.mkdir(parents=True)
    mod.write_text(
        "import time\n"
        "class C:\n"
        "    def rogue(self):\n"
        "        while True:\n"
        "            pass\n"
        "    def dev(self, ev):\n"
        "        ev.synchronize()\n"
        "    def _nap(self):\n"
        "        time.sleep(0.1)\n"
        "    def loop(self):\n"
        "        while self.x:\n"
        "            self._nap()\n"
        "    def exempt(self):\n"
        "        while True:  # noqa: licensed spin\n"
        "            pass\n")
    rep = registry.validate(root=tmp_path)
    f = "\n".join(rep["findings"])
    assert "unregistered blocking loop" in f and "C.rogue" in f
    assert "C.dev" in f and "C.loop" in f and "C.exempt" not in f
    assert "stale entry" in f
    by_qn = {s["qualname"]: s for s in registry.scan_blocking_sites(tmp_path)}
    assert by_qn["C.dev"]["kinds"] == ["device-wait"]
    assert by_qn["C.loop"]["kinds"] == ["poll"]


def test_device_wait_needs_an_entry_of_its_kind(monkeypatch):
    """Dropping the sink thread's synchronize entry leaves _wait_event
    registered by its poll entry, which must not cover the device
    wait."""
    kept = tuple(e for e in registry.PROGRESS
                 if e.name != "engine_wait_event_sink_sync")
    monkeypatch.setattr(registry, "PROGRESS", kept)
    rep = registry.validate()
    assert not rep["ok"]
    assert any("unregistered device wait" in f and "_wait_event" in f
               for f in rep["findings"])


def test_never_exercised_proof_is_a_finding():
    rep = registry.validate(exercised=set())
    assert any("never exercised" in f for f in rep["findings"])
    proved = {e.proof for e in registry.PROGRESS if e.proof}
    assert not any("never exercised" in f for f in
                   registry.validate(exercised=proved)["findings"])


# ---------------------------------------------------------------------------
# the checks and plants against the reference
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reports():
    return rchecker.run_live(quick=True), checker.run_live(quick=True)


def test_report_green(reports):
    _, port = reports
    assert port["ok"] and port["schema"] == "fsx-live-report-v1"
    assert port["quick"] is True and port["registry"]["ok"]
    json.dumps(port)


def test_every_check_equals_the_reference(reports):
    ref, port = reports
    keys = ("check", "ok", "states", "edges", "terminals", "steps",
            "capped", "detector")
    assert [{k: c[k] for k in keys} for c in port["checks"]] == \
        [{k: c[k] for k in keys} for c in ref["checks"]]
    assert port["totals"] == ref["totals"]


def test_plants_caught_by_the_reference_detector(reports):
    ref, port = reports
    r = {p["plant"]: p for p in ref["plants"]}
    for p in port["plants"]:
        assert p["caught"] and p["control_ok"], p["plant"]
        assert p["caught_by"] == r[p["plant"]]["caught_by"], p["plant"]
        assert p["schedule"] == r[p["plant"]]["schedule"], p["plant"]
    assert {p["caught_by"] for p in port["plants"]} == {
        "deadlock", "livelock", "starvation", "violation"}


def test_plants_restore_the_real_functions():
    from flowsentryx_tpu_torch.cluster import supervisor as sup_mod
    from flowsentryx_tpu_torch.sync import channel as channel_mod

    orig = (channel_mod.SinkChannel.complete,
            sup_mod.ClusterSupervisor._redeliver_stamps,
            tuning.SHED_MAX_DEFER)
    with checker._plant_notify_deleted():
        assert channel_mod.SinkChannel.complete is not orig[0]
    with checker._plant_fence_lift_dropped():
        assert sup_mod.ClusterSupervisor._redeliver_stamps is not orig[1]
    with checker._plant_streak_cap_removed():
        assert tuning.SHED_MAX_DEFER == 1 << 30
    assert (channel_mod.SinkChannel.complete,
            sup_mod.ClusterSupervisor._redeliver_stamps,
            tuning.SHED_MAX_DEFER) == orig


def test_quiesce_generator_is_the_real_loop(tmp_path):
    from flowsentryx_tpu_torch.cluster.gossip import GossipPlane, create_plane

    create_plane(str(tmp_path), 2)
    plane = GossipPlane(str(tmp_path), 0, 2)
    plane.tick = lambda force=False, pressure=0.0: 7   # never idle
    t = {"v": 0.0}
    n = 0
    for _ in plane._quiesce_steps(1.0, clock=lambda: t["v"]):
        n += 1
        t["v"] += 0.25
    assert n <= 5
    plane.tick = lambda force=False, pressure=0.0: 0   # idle at once
    plane.merge_interval_s = 0.0
    plane.quiesce(5.0)   # returns after 3 idle ticks, not at 5 s


def test_live_cli_quick_json_out(tmp_path, capsys):
    from flowsentryx_tpu_torch.cli import main

    out = tmp_path / "LIVE.json"
    assert main(["live", "--quick", "--json", "--out", str(out)]) == 0
    rep = json.loads(capsys.readouterr().out)
    assert rep["ok"] and rep["schema"] == "fsx-live-report-v1"
    assert len(json.loads(out.read_text())["plants"]) == 4
