"""``fsx sync`` of the port (``flowsentryx_tpu_torch/sync/contracts.py``
and ``sync/interleave.py``) against the JAX package's, on the CPU.

* The port's contract lint is clean on the port's tree, and its plans
  name the port's own classes and fields.
* Every planted-violation case of the reference's suite is planted into
  the REAL source of both packages (a copy in a temp tree): the port's
  checker must give the finding kind the reference's checker gives on
  the reference's source.  Port-only entries get planted cases of their
  own.
* Every interleave check gives the reference's verdict and counts,
  except the arena check: the port's claim waits for the slot's CUDA
  event (``Engine._claim``), so one slot below ``ring_safe_slots`` every
  interleaving passes (the reference finds the staged-copy overwrite
  there), and only a planted claim without the wait finds it.
* The lint and the registry scan load no torch.
"""

import ast
import contextlib
import dataclasses
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from flowsentryx_tpu.sync import contracts as rcon
from flowsentryx_tpu.sync import interleave as ril
from flowsentryx_tpu_torch.core import wire
from flowsentryx_tpu_torch.sync import contracts as pcon
from flowsentryx_tpu_torch.sync import interleave as pil

REPO = Path(__file__).resolve().parents[1]
PKG = {"ref": "flowsentryx_tpu", "port": "flowsentryx_tpu_torch"}
CON = {"ref": rcon, "port": pcon}


# ---------------------------------------------------------------------------
# the port's tree
# ---------------------------------------------------------------------------

def test_port_contracts_clean_on_port_tree():
    rep = pcon.run_contracts()
    assert rep.ok, "\n".join(str(f) for f in rep.findings)
    assert rep.stats == {"classes": 8, "registered_fields": 169,
                         "cursor_classes": 4, "ctl_fields": 21,
                         "ctl_sites": 36, "quick": False}
    assert pcon.run_contracts(quick=True).stats["quick"] is True


def test_every_plan_names_the_port_tree():
    mods = ([p.module for p in pcon.REGISTRY]
            + [c.module for c in pcon.CURSORS]
            + list(pcon.CTL_MODULE_SIDE) + list(pcon._CTL_SCOPE))
    assert all(m.startswith("flowsentryx_tpu_torch/") for m in mods), mods
    assert {p.cls for p in pcon.REGISTRY} == {p.cls for p in rcon.REGISTRY}
    assert ({(c.cls, c.producer, c.consumer) for c in pcon.CURSORS}
            == {(c.cls, c.producer, c.consumer) for c in rcon.CURSORS})


def test_engine_plan_is_the_ports_own():
    plan = pcon.ENGINE_PLAN
    # no ring worker in the port: the copy stream uploads the ring
    assert plan.worker_targets == ("_sink_worker", "_warm_worker")
    f = plan.fields
    assert f["_graphs"].discipline == "atomic-ref"
    for name in ("_arena_event", "_ring_dev_free", "_ring_dev_next",
                 "_arena", "_ring_dev", "_copy_stream"):
        assert f[name].discipline == "dispatch", name
    # the sink thread's readback writes
    for name in ("_d2h_bytes", "_sink_compact", "_sink_fallback",
                 "_route_drop", "_lat", "_first_verdict_s"):
        assert f[name].discipline == "section:sink", name
    assert plan.sections == {"sink": ("_sink_one",)}
    for name in ("_batches_launched", "_swap_at", "_swap_staging"):
        assert f[name].discipline == "cv", name
    assert plan.lock_attr == "_launch_lock"
    # the reference's launch section and AOT fields have no port code
    for gone in ("_dispatch_calls", "_dispatched_chunks", "_aot_specs",
                 "_pipe_active"):
        assert gone not in f
    for fc in f.values():
        assert fc.rationale


def test_ctl_writers_match_the_reference_and_the_wire_layout():
    assert pcon.CTL_WRITERS == rcon.CTL_WRITERS
    for name in pcon.CTL_WRITERS:
        if name.startswith("c_"):
            assert hasattr(wire, f"STATUS_{name[2:].upper()}_OFFSET")
        else:
            assert hasattr(wire, f"SHM_{name.upper()}_OFFSET")
    assert pcon.CTL_MODULE_SIDE[
        "flowsentryx_tpu_torch/cluster/rebalance.py"] == "cluster-engine"


def test_netmailbox_and_rebalance_plans_pin_the_reference_disciplines():
    for name in ("NETMAILBOX_PLAN", "REBALANCE_PLAN", "ELASTIC_PLAN",
                 "PREDICT_PLAN", "CHANNEL_PLAN", "INGEST_PLAN"):
        p, r = getattr(pcon, name), getattr(rcon, name)
        assert p.sections == r.sections, name
        assert p.quiescent == r.quiescent, name
        assert ({k: v.discipline for k, v in p.fields.items()}
                == {k: v.discipline for k, v in r.fields.items()}), name
    # the port's quiesce loop is a generator the liveness checker drives
    assert pcon.GOSSIP_PLAN.sections["merge"] == (
        "tick", "quiesce", "_quiesce_steps")


def test_lint_and_registry_scan_load_no_torch():
    r = subprocess.run(
        [sys.executable, "-c",
         "import sys\n"
         "from flowsentryx_tpu_torch.sync.contracts import run_contracts\n"
         "from flowsentryx_tpu_torch.live import registry\n"
         "assert run_contracts().ok\n"
         "assert registry.validate()['ok']\n"
         "bad = [m for m in ('torch', 'jax', 'flowsentryx_tpu') "
         "if m in sys.modules]\n"
         "sys.exit(1 if bad else 0)"],
        capture_output=True, cwd=REPO)
    assert r.returncode == 0, r.stderr.decode()


# ---------------------------------------------------------------------------
# planted violations in the real source of both packages
# ---------------------------------------------------------------------------

def _find_def(tree: ast.Module, qual: str) -> ast.AST:
    parts = qual.split(".")
    scope = tree.body
    node = None
    for part in parts:
        node = next(n for n in scope
                    if isinstance(n, (ast.ClassDef, ast.FunctionDef))
                    and n.name == part)
        scope = node.body
    return node


def _apply(src: str, edit: tuple) -> str:
    """One source edit: ``("stmt", qual, code)`` inserts ``code`` as the
    first statement of function ``qual``; ``("method", qual, code)``
    inserts a method (``code`` at class-body indentation) before method
    ``qual``; ``("rename", old, new)`` renames an identifier;
    ``("replace", old, new)`` swaps the one occurrence of a text."""
    op = edit[0]
    if op == "rename":
        return re.sub(rf"\b{re.escape(edit[1])}\b", edit[2], src)
    if op == "replace":
        assert src.count(edit[1]) == 1, edit[1]
        return src.replace(edit[1], edit[2])
    node = _find_def(ast.parse(src), edit[1])
    lines = src.splitlines(keepends=True)
    if op == "stmt":
        first = node.body[0]
        at, indent = first.lineno - 1, " " * first.col_offset
    else:
        start = node.decorator_list[0] if node.decorator_list else node
        at, indent = start.lineno - 1, " " * node.col_offset
    code = "".join(indent + ln + "\n" for ln in edit[2].splitlines())
    lines.insert(at, code)
    return "".join(lines)


def _py_only(d, names):
    return [n for n in names if n == "__pycache__"
            or (not n.endswith(".py") and not (Path(d) / n).is_dir())]


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    roots = {}
    for side, pkg in PKG.items():
        root = tmp_path_factory.mktemp(f"tree_{side}")
        shutil.copytree(REPO / pkg, root / pkg, ignore=_py_only)
        roots[side] = root
    return roots


@contextlib.contextmanager
def _planted(root: Path, pkg: str, edits: dict):
    saved = {}
    try:
        for rel, ops in edits.items():
            p = root / pkg / rel
            saved[p] = src = p.read_text()
            for op in ops:
                src = _apply(src, op)
            ast.parse(src)
            p.write_text(src)
        yield
    finally:
        for p, src in saved.items():
            p.write_text(src)


def _kinds(side, root, plan_override=None, monkeypatch=None) -> set:
    con = CON[side]
    if plan_override is not None:
        plans = tuple(plan_override(p) for p in con.REGISTRY)
        monkeypatch.setattr(con, "REGISTRY", plans)
    rep = con.run_contracts(root=root)
    return {f.contract for f in rep.findings}


E = "engine/engine.py"
CH = "sync/channel.py"
SHM = "engine/shm.py"
NET = "cluster/transport.py"
RB = "cluster/rebalance.py"


def _both(edits):
    return {"ref": edits, "port": edits}


def _no_extra(cls, field):
    def override(plan):
        if plan.cls != cls:
            return plan
        fields = dict(plan.fields)
        fields[field] = dataclasses.replace(fields[field], extra=())
        return dataclasses.replace(plan, fields=fields)
    return override


def _rebalance_worker(plan):
    if plan.cls != "EngineRebalancer":
        return plan
    return dataclasses.replace(plan, worker_targets=("_planted_worker",))


#: (case, expected finding kinds, {side: {module: [edits]}}, plan
#: override).  The reference's planted cases (tests/test_sync.py
#: TestPlantedViolations, TestCursorAndCtlViolations, TestNetRegistry,
#: TestRebalanceRegistry), each planted into the real modules.
PLANTS = [
    ("dispatch_field_touched_from_worker", {"discipline"},
     _both({E: [("stmt", "Engine._sink_worker",
                 "self._pending.append(None)")]}), None),
    ("worker_context_propagates_through_calls", {"discipline"},
     {"ref": {E: [("stmt", "Engine._apply_updates",
                   "self._pending.append(None)")]},
      "port": {E: [("stmt", "Engine._sink_one",
                    "self._pending.append(None)")]}}, None),
    ("cv_field_accessed_unlocked", {"discipline"},
     _both({CH: [("stmt", "SinkChannel.crashed", "self._q.clear()")]}),
     None),
    ("cv_write_allows_unlocked_read", set(),
     _both({CH: [("stmt", "SinkChannel.crashed", "_ = self._pending")]}),
     None),
    ("cv_write_rejects_unlocked_write", {"discipline"},
     _both({CH: [("stmt", "SinkChannel.crashed", "self._pending += 0")]}),
     None),
    ("atomic_ref_rejects_read_modify_write", {"discipline"},
     _both({E: [("stmt", "Engine._warm_worker",
                 "self._boot['planted'] = 1")]}), None),
    ("quiescent_write_outside_quiescent_set", {"discipline"},
     _both({E: [("stmt", "Engine._reap_ready",
                 "self._sink_active = True")]}), None),
    ("section_field_touched_outside_section", {"discipline"},
     _both({E: [("stmt", "Engine._reap_ready", "self._lat = None")]}),
     None),
    ("unregistered_shared_state_detected", {"unregistered"},
     _both({E: [("stmt", "Engine._sink_worker", "self._planted_n = 0"),
                ("stmt", "Engine._reap_ready", "self._planted_n = 1")]}),
     None),
    ("single_context_mutation_not_flagged", set(),
     _both({E: [("stmt", "Engine._reap_ready", "self._planted_n = 1")]}),
     None),
    ("undeclared_thread_target", {"registry"},
     _both({E: [("method", "Engine._start_sink_thread",
                 "def _planted_target(self):\n    pass\n"),
                ("stmt", "Engine._start_sink_thread",
                 "threading.Thread(target=self._planted_target)")]}),
     None),
    ("stale_field_entry", {"registry"},
     _both({E: [("rename", "_h2d_puts_overlapped", "_h2d_puts_late")]}),
     None),
    ("stale_quiescent_method", {"registry"},
     _both({E: [("rename", "watch_artifact", "watch_artifact_v2")]}),
     None),
    ("stale_worker_target", {"registry"},
     _both({E: [("rename", "_warm_worker", "_warm_worker_v2")]}), None),
    ("missing_class", {"registry"},
     _both({CH: [("rename", "SinkChannel", "SinkChannel2")]}), None),
    ("extra_grant_withdrawn", {"discipline"},
     {"ref": {}, "port": {}},
     {"ref": _no_extra("Engine", "_last_sink_t"),
      "port": _no_extra("Engine", "_inflight")}),
    # -- cursors and ctl words -----------------------------------------
    ("tail_store_on_producer_side", {"cursor"},
     _both({SHM: [("stmt", "SealedBatchQueue.produce_batch",
                   "self._tail[0] = 0")]}), None),
    ("head_store_on_consumer_side", {"cursor"},
     _both({SHM: [("stmt", "SealedBatchQueue.release",
                   "self._head[0] = 0")]}), None),
    ("undeclared_ctl_field", {"ctl"},
     _both({"ingest/sharded.py": [("stmt", "ShardedIngest.close",
                                   "self.ctl_set('rogue_field', 1)")]}),
     None),
    ("ctl_write_from_wrong_side", {"ctl"},
     _both({"ingest/sharded.py": [("stmt", "ShardedIngest.close",
                                   "self.ctl_set('hbeat', 1)")]}), None),
    ("ctl_write_with_no_declared_side", {"ctl"},
     _both({SHM: [("stmt", "SealedBatchQueue.release",
                   "self.ctl_set('stop', 1)")]}), None),
    ("cluster_supervisor_field_written_from_engine", {"ctl"},
     _both({"cluster/runner.py": [("stmt", "engine_main",
                                   "spec.ctl_set('c_gen', 2)")]}), None),
    ("cluster_mailbox_tail_store_on_publish_side", {"cursor"},
     _both({"cluster/mailbox.py": [("stmt", "VerdictMailbox.publish",
                                    "self._tail[0] = 0")]}), None),
    # -- the net leg -----------------------------------------------------
    ("publish_counter_written_from_merge_side", {"discipline"},
     _both({NET: [("stmt", "NetMailbox.pump", "self.txq_dropped += 1")]}),
     None),
    ("canonical_map_written_from_publish_side", {"discipline"},
     _both({NET: [("stmt", "NetMailbox.queue_tx", "self.net_map[0] = 0")]}),
     None),
    ("peer_table_written_while_serving", {"discipline"},
     _both({NET: [("stmt", "NetMailbox.pump", "self.peers[0] = None")]}),
     None),
    ("ctl_t0_wall_written_by_engine", {"ctl"},
     _both({"cluster/runner.py": [("stmt", "engine_main",
                                   "spec.ctl_set('c_t0_wall', 5)")]}),
     None),
    # -- the rebalance plane ---------------------------------------------
    ("rebalancer_state_written_from_worker", {"discipline"},
     _both({RB: [("method", "EngineRebalancer.step",
                  "def _planted_worker(self):\n"
                  "    self._staged = None\n")]}),
     {"ref": _rebalance_worker, "port": _rebalance_worker}),
    ("fence_stamped_from_engine_side", {"ctl"},
     _both({RB: [("stmt", "EngineRebalancer.step",
                  "self.status.ctl_set('c_fence', 0)")]}), None),
    ("layout_ack_forged_by_supervisor", {"ctl"},
     _both({"cluster/supervisor.py": [
         ("stmt", "ClusterSupervisor._handoff_tick",
          "self._status[0].ctl_set('c_layout_ack', 2)")]}), None),
    ("handoff_mailbox_consumer_stores_head", {"cursor"},
     _both({RB: [("stmt", "HandoffMailbox.pop_slots",
                  "self._head[0] = 0")]}), None),
]


@pytest.mark.parametrize("case,kinds,edits,override", PLANTS,
                         ids=[p[0] for p in PLANTS])
def test_planted_violation_matches_reference(trees, monkeypatch, case,
                                             kinds, edits, override):
    got = {}
    for side in ("ref", "port"):
        with _planted(trees[side], PKG[side], edits[side]):
            with monkeypatch.context() as m:
                got[side] = _kinds(
                    side, trees[side],
                    override[side] if override else None, m)
    assert got["ref"] == kinds, (case, got)
    assert got["port"] == got["ref"], (case, got)


def test_pristine_trees_are_clean(trees):
    for side in ("ref", "port"):
        assert CON[side].run_contracts(root=trees[side]).ok, side


#: Port-only entries: the planted access and the kind it must give.
PORT_PLANTS = [
    ("graphs_item_store_from_fill_thread", {"discipline"},
     {E: [("replace", "self._graphs = {**self._graphs, key: gr}",
           "self._graphs[key] = gr")]}),
    ("graphs_item_store_planted", {"discipline"},
     {E: [("stmt", "Engine._warm_worker", "self._graphs[0] = None")]}),
    ("arena_event_written_by_sink_thread", {"discipline"},
     {E: [("stmt", "Engine._sink_one", "self._arena_event[0] = None")]}),
    ("ring_buffer_guard_written_by_sink_thread", {"discipline"},
     {E: [("stmt", "Engine._sink_one", "self._ring_dev_free[0] = None")]}),
    ("ring_cursor_advanced_by_fill_thread", {"discipline"},
     {E: [("stmt", "Engine._warm_worker", "self._ring_dev_next += 1")]}),
    ("readback_counter_written_at_launch", {"discipline"},
     {E: [("stmt", "Engine._launch", "self._d2h_bytes += 1")]}),
    ("swap_accounting_outside_launch_lock", {"discipline"},
     {E: [("stmt", "Engine._dispatch", "self._batches_launched += 1")]}),
    ("table_rebound_by_fill_thread", {"discipline"},
     {E: [("stmt", "Engine._warm_worker", "self.table = None")]}),
    ("inflight_read_by_sink_thread", {"discipline"},
     {E: [("stmt", "Engine._sink_one", "_ = len(self._inflight)")]}),
    ("step_function_rebound_while_serving", {"discipline"},
     {E: [("stmt", "Engine._reap_ready", "self.step = None")]}),
]


@pytest.mark.parametrize("case,kinds,edits", PORT_PLANTS,
                         ids=[p[0] for p in PORT_PLANTS])
def test_port_only_planted_violation(trees, case, kinds, edits):
    with _planted(trees["port"], PKG["port"], edits):
        got = _kinds("port", trees["port"])
    assert got == kinds, (case, got)


# ---------------------------------------------------------------------------
# the interleaving model checker
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def interleave_reports(tmp_path_factory):
    d = tmp_path_factory.mktemp("il")
    return ril.run_interleave(d), pil.run_interleave(d)


_SAME = ("channel_crash_atomicity", "channel_split_complete",
         "channel_stop_drain", "queue_wraparound",
         "queue_premature_release", "arena_bound@4_slots")


@pytest.mark.parametrize("check", _SAME)
def test_interleave_check_equals_reference(interleave_reports, check):
    ref, port = interleave_reports
    r = next(c for c in ref.checks if c.check == check)
    p = next(c for c in port.checks if c.check == check)
    assert (p.ok, p.expect_violation, p.interleavings, p.steps, p.capped) \
        == (r.ok, r.expect_violation, r.interleavings, r.steps, r.capped)
    assert p.ok and not p.capped
    if r.counterexample is not None:
        assert p.counterexample.schedule == r.counterexample.schedule


def test_arena_one_below_the_bound_is_safe_under_the_event_guard(
        interleave_reports):
    """The divergence: the reference's claim needs only "the previous
    slot dispatched" and at 3 slots finds the staged-copy overwrite; the
    port's ``Engine._claim`` also waits for the slot's CUDA event, so
    all 50 interleavings pass and 4 of them wait on an event."""
    ref, port = interleave_reports
    r = next(c for c in ref.checks if c.check == "arena_bound@3_slots")
    assert r.expect_violation and r.ok and r.steps == 36
    p = next(c for c in port.checks if c.check == "arena_bound@3_slots")
    assert not p.expect_violation and p.ok and not p.capped
    assert (p.interleavings, p.steps) == (50, 5256)
    b = port.bound
    assert b["safe_slots"] == 4 and b["waited_at_safe"] == 0
    assert (b["below_slots"], b["interleavings_below"],
            b["waited_below"]) == (3, 50, 4)
    assert b["below_ok"] and b["counterexample_without_event_wait"]


def test_arena_claim_without_event_wait_finds_the_reference_overwrite(
        interleave_reports):
    ref, port = interleave_reports
    r = next(c for c in ref.checks if c.check == "arena_bound@3_slots")
    p = next(c for c in port.checks
             if c.check == "arena_claim_no_event_wait@3_slots")
    assert p.expect_violation and p.ok
    cx = p.counterexample
    assert "staged-copy overwrite" in cx.detail
    assert "WITHOUT its event wait" in cx.detail
    # the reference's schedule, step for step (the port's model names
    # the launch at submit time and the device's read as "execute")
    assert p.steps == r.steps == 36
    assert len(cx.schedule) == len(r.counterexample.schedule)
    assert cx.schedule[-1].startswith("device:execute")
    assert sum(s.startswith("dispatch:claim") for s in cx.schedule) == \
        sum(s.startswith("dispatch:claim") for s in r.counterexample.schedule)


def test_arena_model_claims_through_the_ports_engine():
    from flowsentryx_tpu_torch.engine.arena import DispatchArena
    from flowsentryx_tpu_torch.engine.engine import Engine

    host = pil._claim_host(DispatchArena(3, 1, 1, 4))
    assert type(host)._claim is Engine._claim
    assert type(host)._wait_event is Engine._wait_event
    ev = pil._ModelEvent()
    host._arena_event[0] = ev
    ev.fired = True
    assert host._claim() == 0 and host._arena_event[0] is None


def test_explore_framework_units():
    def racer_mk():
        box = [0]

        def racer(name):
            yield f"{name}:read"
            v = box[0]
            yield f"{name}:write"
            box[0] = v + 1

        def finale():
            if box[0] != 2:
                raise pil.ModelViolation(f"lost update: {box[0]}")

        return [("a", racer("a")), ("b", racer("b"))], finale

    res = pil.explore("lost_update", racer_mk, expect_violation=True)
    assert res.ok and "lost update" in res.counterexample.detail

    def stuck_mk():
        def stuck():
            yield (lambda: False, "never")
        return [("t", stuck())], None

    res = pil.explore("deadlock", stuck_mk)
    assert not res.ok and "deadlock" in res.counterexample.detail

    def count_mk():
        def t(name):
            for i in range(2):
                yield f"{name}{i}"
        return [("a", t("a")), ("b", t("b"))], None

    assert pil.explore("count", count_mk).interleavings == 6


def test_sync_cli_json_out(tmp_path, capsys):
    from flowsentryx_tpu_torch.cli import main

    out = tmp_path / "SYNC.json"
    assert main(["sync", "--json", "--out", str(out)]) == 0
    rep = json.loads(capsys.readouterr().out)
    assert rep["ok"] and rep["contracts"]["ok"]
    assert rep["interleave"]["bound"]["below_ok"]
    assert json.loads(out.read_text())["ok"]
    assert main(["sync", "--quick"]) == 0
    text = capsys.readouterr().out
    assert "fsx sync: contracts: OK (8 classes, 169 fields" in text
    assert text.rstrip().endswith("fsx sync: PASS")
