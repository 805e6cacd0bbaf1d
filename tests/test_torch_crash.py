"""``fsx crash`` of the port (``flowsentryx_tpu_torch/crash/``) against the
JAX package's, on the CPU: the simulated filesystem and tracer, each
scenario's crash points, durable states and recoveries in ``--quick``
mode against the reference's, each plant caught by the reference's
invariant, the plants and the seams restoring the port's real functions,
and the world's plumbing."""

import numpy as np
import pytest

from flowsentryx_tpu.crash import checker as rchecker
from flowsentryx_tpu.crash import simfs as rsimfs
from flowsentryx_tpu_torch.cluster import rebalance as rb
from flowsentryx_tpu_torch.core import durable, wire
from flowsentryx_tpu_torch.crash import checker
from flowsentryx_tpu_torch.crash.simfs import (
    CrashNow, SimFS, Tracer, eligible_points,
)
from flowsentryx_tpu_torch.crash.world import World


def _fs(**kw):
    t = Tracer()
    t.enabled = True
    return SimFS(t, **kw), t


class TestSimFS:
    def test_write_atomic_traces_the_publish_steps(self):
        fs, t = _fs()
        fs.write_atomic("/d/f", b"abc")
        assert [op for _, op in t.ops] == [
            "write f.tmp (3 B)", "fsync f.tmp", "rename f.tmp -> f",
            "fsync parent dir of f"]
        assert fs.read_bytes("/d/f") == b"abc"

    def test_synced_publish_is_durable(self):
        fs, _ = _fs()
        fs.write_atomic("/d/f", b"abc")
        states, capped = fs.durable_states()
        assert not capped and [st for _, st in states] == [{"/d/f": b"abc"}]

    def test_unsynced_write_tears(self):
        fs, _ = _fs()
        fs.write_atomic("/d/f", b"abcdef", fsync=False)
        states, _ = fs.durable_states()
        visible = sorted(st["/d/f"] for _, st in states if "/d/f" in st)
        assert b"" in visible and b"abcdef" in visible
        assert any(0 < len(v) < 6 for v in visible)
        assert any("/d/f" not in st for _, st in states)

    def test_fsync_noop_plant_loses_the_publish(self):
        fs, _ = _fs(fsync_is_noop=True)
        fs.write_atomic("/d/f", b"abc")
        assert any("/d/f" not in st for _, st in fs.durable_states()[0])

    def test_rotate_prev_and_media_fault(self):
        fs, t = _fs()
        fs.write_atomic("/d/f", b"g1")
        fs.write_atomic("/d/f", b"g2", rotate_prev="/d/f.prev")
        assert fs.read_bytes("/d/f.prev") == b"g1"
        assert "rename f -> f.prev" in [op for _, op in t.ops]
        datas = [st["/d/f"] for _, st in
                 fs.durable_states(media_fault=True)[0]]
        assert b"g2" in datas
        flipped = [d for d in datas if d != b"g2"]
        assert len(flipped) == 1 and len(flipped[0]) == 2

    def test_from_state_round_trip(self):
        fs = SimFS.from_state({"/d/a": b"x"}, Tracer())
        assert fs.read_bytes("/d/a") == b"x"
        assert [st for _, st in fs.durable_states()[0]] == [{"/d/a": b"x"}]

    def test_same_states_as_the_reference(self):
        """The port's fs is the reference's, op for op: the same publish
        sequence leaves the same durable states."""
        outs = []
        for mod in (rsimfs, __import__(
                "flowsentryx_tpu_torch.crash.simfs", fromlist=["SimFS"])):
            t = mod.Tracer()
            t.enabled = True
            fs = mod.SimFS(t)
            fs.write_atomic("/d/f", b"old")
            fs.write_atomic("/d/f", b"newer", fsync=False,
                            rotate_prev="/d/f.prev")
            outs.append((t.rendered(), fs.durable_states(media_fault=True)))
        assert outs[0] == outs[1]


class TestTracer:
    def test_crash_at_fires_before_the_op(self):
        fs, t = _fs()
        t.crash_at, t.crash_actor = 2, None
        with pytest.raises(CrashNow):
            fs.write_atomic("/d/f", b"abc")
        assert t.fired and "rename" in t.crashed_op and len(t.ops) == 2

    def test_actor_filtering(self):
        fs, t = _fs()
        t.actor = "rank0"
        fs.write_atomic("/d/a", b"x")
        t.actor = "rank1"
        fs.write_atomic("/d/b", b"y")
        assert eligible_points(t.ops, None) == 8
        assert eligible_points(t.ops, "rank0") == 4
        t2 = Tracer()
        t2.enabled, t2.crash_at, t2.crash_actor = True, 0, "rank1"
        fs2 = SimFS(t2)
        t2.actor = "rank0"
        fs2.write_atomic("/d/a", b"x")
        t2.actor = "rank1"
        with pytest.raises(CrashNow):
            fs2.write_atomic("/d/b", b"y")
        assert t2.crashed_op.startswith("rank1:")


_SCENARIOS = [("checkpoint_rotate", "CheckpointScenario"),
              ("layout_flip", "FlipScenario"),
              ("handoff", "HandoffScenario"),
              ("adoption", "AdoptionScenario")]


@pytest.mark.parametrize("name,cls", _SCENARIOS, ids=[s[0] for s in
                                                      _SCENARIOS])
def test_scenario_counts_equal_the_reference(name, cls):
    """Crash points, durable states and recoveries equal the reference's
    in ``--quick`` mode: the port's protocols issue the same durable
    writes, ctl stamps and mailbox ops in the same order, and recover
    through the same paths, with zero violations."""
    port = checker.explore_scenario(getattr(checker, cls)(), quick=True)
    ref = rchecker.explore_scenario(getattr(rchecker, cls)(), quick=True)
    keys = ("scenario", "modes", "crash_points", "states_explored",
            "recoveries", "violations", "capped")
    assert {k: port[k] for k in keys} == {k: ref[k] for k in keys}
    assert port["scenario"] == name and port["violations"] == 0
    assert port["crash_points"] > 10 and port["recoveries"] > 0


def test_handoff_trace_equals_the_reference():
    """The clean handoff's op trace is the reference's, label for
    label: the crash-point enumeration is the same sequence."""
    port = checker._run(checker.HandoffScenario())
    ref = rchecker._run(rchecker.HandoffScenario())
    assert port.tracer.rendered() == ref.tracer.rendered()
    assert checker.HandoffScenario().judge(port) == []


def _assert_schedule(res, invariant):
    assert res["violations"] > 0, "plant NOT caught"
    assert res["first_invariant"] == invariant
    cx = res["counterexample"]
    assert ">>> CRASH" in cx and invariant in cx and "  0. " in cx


#: plant -> (context manager, scenario, explore kwargs, invariant that
#: catches it in the reference)
_PLANTS = [
    ("fsync_skipped", "plant_fsync_skipped", "FlipScenario",
     {"build_kw": {"fsync_is_noop": True}}, "layout_gen_monotone"),
    ("prev_rotation_dropped", "plant_prev_rotation_dropped",
     "CheckpointScenario", {}, "ckpt_current_or_prev"),
    ("spool_ack_reorder", "plant_spool_ack_reorder", "HandoffScenario",
     {"modes": ("power",)}, "row_conservation"),
    ("dual_ownership_flip", "plant_dual_ownership_flip", "HandoffScenario",
     {"modes": ("rank0",)}, "no_dual_ownership"),
]


@pytest.mark.parametrize("plant,cm,cls,kw,inv", _PLANTS,
                         ids=[p[0] for p in _PLANTS])
def test_plant_caught_by_the_reference_invariant(plant, cm, cls, kw, inv):
    res = {}
    for side, mod in (("port", checker), ("ref", rchecker)):
        with getattr(mod, cm)():
            res[side] = mod.explore_scenario(
                getattr(mod, cls)(), quick=True, stop_on_violation=True,
                **kw)
    _assert_schedule(res["ref"], inv)
    _assert_schedule(res["port"], inv)
    assert res["port"]["crash_points"] == res["ref"]["crash_points"]


def test_plants_and_seams_restore_the_real_functions():
    from flowsentryx_tpu_torch.engine import checkpoint as ckpt

    orig = (rb.save_spool, rb.EngineRebalancer.step,
            rb.EngineRebalancer.reconcile, durable.atomic_write,
            ckpt.save_state)
    with checker.plant_spool_ack_reorder():
        assert rb.save_spool is not orig[0]
        assert rb.EngineRebalancer.step is not orig[1]
    with checker.plant_dual_ownership_flip():
        assert rb.EngineRebalancer.reconcile is not orig[2]
    with checker.plant_prev_rotation_dropped():
        assert durable.atomic_write is not orig[3]
    assert (rb.save_spool, rb.EngineRebalancer.step,
            rb.EngineRebalancer.reconcile, durable.atomic_write,
            ckpt.save_state) == orig
    real_fs = durable.get_fs()
    assert isinstance(real_fs, durable.RealFS)
    assert rb.mailbox_cls() is rb.HandoffMailbox
    w = World(n=2)
    with w.installed():
        assert durable.get_fs() is w.fs
        assert rb.mailbox_cls() is w.hub
    assert durable.get_fs() is real_fs
    assert rb.mailbox_cls() is rb.HandoffMailbox


def test_run_crash_quick_report():
    rep = checker.run_crash(quick=True)
    assert rep["ok"] and rep["protocols_ok"] and rep["plants_ok"]
    assert rep["schema"] == "fsx-crash-report-v1"
    assert rep["totals"] == {"crash_points": 176, "states_explored": 229,
                             "recoveries": 302, "violations": 0}
    assert rep["invariants"] == rchecker.INVARIANTS
    for p in rep["plants"]:
        assert p["caught"] and p["control_ok"], p["plant"]
        assert ">>> CRASH" in p["schedule"]


class TestWorldPlumbing:
    def test_party_crash_kills_only_that_actor(self):
        w = World(n=2)
        t = w.tracer
        t.enabled, t.crash_at, t.crash_actor = True, 0, "rank0"
        with w.installed():
            w.act("rank0", lambda: durable.atomic_write(w.dir / "a", b"x"))
            assert "rank0" in w.dead
            w.act("rank1", lambda: durable.atomic_write(w.dir / "b", b"y"))
            assert w.fs.exists(w.dir / "b")
            assert w.act("rank0", lambda: 1 / 0) is None

    def test_handoff_rows_survive_sup_death_before_stamp(self):
        sc = checker.HandoffScenario()
        ops = checker._run(sc).tracer.ops
        stamp = next(i for i, (a, op) in enumerate(ops)
                     if a == "supervisor" and "c_layout_gen" in op)
        sup_pts = sum(1 for a, _ in ops[:stamp] if a == "supervisor")
        w = checker._run(sc, crash_at=sup_pts - 1, crash_actor="supervisor")
        assert w.tracer.fired and sc.judge(w) == []

    def test_keys_for_shard_places_rows_by_the_ports_hash(self):
        keys = checker._keys_for_shard(2, 4, 5)
        assert all(int(wire.shard_of(np.uint32(k), 4)) == 2 for k in keys)
        assert np.array_equal(keys, rchecker._keys_for_shard(2, 4, 5))
        assert np.array_equal(checker._states_for(keys),
                              rchecker._states_for(keys))

    def test_mini_engine_checkpoint_round_trip(self):
        from flowsentryx_tpu_torch.crash.world import (
            MiniEngine, ckpt_path, restore_mini,
        )

        w = World(n=1)
        with w.installed():
            eng = MiniEngine()
            keys = np.arange(1, 5, dtype=np.uint32)
            eng.adopt_rows(keys, checker._states_for(keys))
            eng.save(ckpt_path(w.dir, 0), 7)
            got, marker = restore_mini(ckpt_path(w.dir, 0))
        assert marker == 7
        assert checker._row_bytes(got.rows()) == \
            checker._row_bytes(eng.rows())


def test_crash_cli_json_out(tmp_path, capsys):
    import json

    from flowsentryx_tpu_torch.cli import main

    out = tmp_path / "CRASH.json"
    assert main(["crash", "--quick", "--json", "--out", str(out)]) == 0
    rep = json.loads(capsys.readouterr().out)
    assert rep["ok"] and len(rep["plants"]) == 4
    assert json.loads(out.read_text())["schema"] == "fsx-crash-report-v1"
