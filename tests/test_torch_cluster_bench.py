"""The paced scale-out comparison (``scripts/torch_cluster_bench.py``,
``fsx bench --cluster``) against the reference's
``scripts/cluster_bench.py``, loaded by path, JAX on the CPU.

* ``_records``, ``_cfg``, ``_queue_slots`` and ``_summarize``, and
  ``_prefill``'s shard counts and ring bytes, equal the reference's;
* on the same prefilled two-shard rings (B=128, 16 batches: the bench's
  own corpus, and a slower flood that blocks sources) the port's
  ``_drain_one`` over the port's engine serves the records and batches,
  blocks the sources and leaves the stats and table of the reference's
  over its engine; each rank of a two-rank gossip plane likewise, with
  the same published and merged digests;
* the orchestrator end to end at ``--trials 1 --cut 150`` on the CPU,
  against the tree under test (through ``fsx bench --cluster``) and
  against ``git archive c8043dd`` (skipped where the history lacks the
  commit): no failure of the four checks, the reference's artifact keys;
* a baseline tree without the package exits 2 naming the git commands.
"""

import ast
import dataclasses
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from flowsentryx_tpu.cluster import gossip as jgossip
from flowsentryx_tpu.engine import ArraySource as JArraySource
from flowsentryx_tpu.engine import CollectSink as JCollectSink
from flowsentryx_tpu.engine import Engine as JEngine
from flowsentryx_tpu.engine.traffic import Scenario as JScenario
from flowsentryx_tpu.engine.traffic import TrafficGen as JTrafficGen
from flowsentryx_tpu.engine.traffic import TrafficSpec as JTrafficSpec
from flowsentryx_tpu.ingest import ShardedIngest as JShardedIngest
from flowsentryx_tpu_torch import cli
from flowsentryx_tpu_torch.cluster import gossip
from flowsentryx_tpu_torch.core import schema
from flowsentryx_tpu_torch.engine import ArraySource, CollectSink, Engine
from flowsentryx_tpu_torch.ingest import ShardedIngest

REPO = Path(__file__).resolve().parents[1]
SCRIPT = REPO / "scripts" / "torch_cluster_bench.py"
REF_SCRIPT = REPO / "scripts" / "cluster_bench.py"
B, N_BATCHES, CUT = 128, 16, 150


def _load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


tcb = _load("torch_cluster_bench", SCRIPT)
rcb = _load("ref_cluster_bench", REF_SCRIPT)


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the pure helpers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,seed,batch", [(16, 100, 128), (10, 101, 256),
                                          (1, 0, 1)])
def test_records_equal_reference(n, seed, batch):
    got, want = tcb._records(n, seed, batch), rcb._records(n, seed, batch)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


@pytest.mark.parametrize("batch", [128, 256])
def test_cfg_equals_reference(batch):
    def plain(cfg):         # each package's enums by their values
        return json.loads(json.dumps(dataclasses.asdict(cfg),
                                     default=lambda e: e.value))

    got, want = plain(tcb._cfg(batch)), plain(rcb._cfg(batch))
    assert got == want
    assert got["batch"]["max_batch"] == batch
    assert got["table"]["capacity"] == 1 << 16


def test_queue_slots_and_shapes_equal_reference():
    for tb in [1, 2, 10, 16, 254, 255, 256, 1600, 2400, 4094]:
        assert tcb._queue_slots(tb) == rcb._queue_slots(tb), tb
    assert tcb.SHAPES == rcb.SHAPES
    assert tcb.shapes_for(1) == rcb.SHAPES
    assert tcb.shapes_for(CUT) == [("latency", 128, 0, 16),
                                   ("throughput", 256, "auto", 10)]


TRIALS = [
    [{"scaling_x": 1.1, "single_mpps": 0.5, "cluster_agg_mpps": 0.55}],
    [{"scaling_x": x, "single_mpps": s, "cluster_agg_mpps": c}
     for x, s, c in [(0.9, 0.61, 0.55), (1.3, 0.4, 0.52), (1.0, 0.5, 0.5),
                     (2.0, 0.3, 0.6)]],
    [{"scaling_x": x, "single_mpps": s, "cluster_agg_mpps": c}
     for x, s, c in [(1.7, 0.2, 0.34), (1.9, 0.21, 0.4), (1.8, 0.19, 0.342)]],
]


@pytest.mark.parametrize("trials", TRIALS)
def test_summarize_equals_reference(trials):
    assert tcb._summarize(trials) == rcb._summarize(trials)


def _flood(seed: int):
    """A slower flood over 8 attackers: its 16 batches block sources."""
    kw = dict(rate_pps=2e4, n_attack_ips=8, n_benign_ips=4096,
              attack_fraction=0.8, seed=seed)
    from flowsentryx_tpu_torch.engine.traffic import (
        Scenario, TrafficGen, TrafficSpec,
    )

    got = TrafficGen(TrafficSpec(scenario=Scenario.UDP_FLOOD_MULTI,
                                 **kw)).next_records(B * N_BATCHES)
    want = JTrafficGen(JTrafficSpec(scenario=JScenario.UDP_FLOOD_MULTI,
                                    **kw)).next_records(B * N_BATCHES)
    assert got.tobytes() == want.tobytes()
    return got


CORPORA = {"bench": lambda: tcb._records(N_BATCHES, 100, B),
           "flood": lambda: _flood(7)}


@pytest.mark.parametrize("corpus", sorted(CORPORA))
def test_prefill_counts_and_rings_equal_reference(corpus, tmp_path):
    recs = CORPORA[corpus]()
    got = tcb._prefill(str(tmp_path / "p"), "c", "latency", 0, recs)
    want = rcb._prefill(str(tmp_path / "r"), "c", "latency", 0, recs)
    assert got == want and sum(got) == len(recs)
    for k in range(2):
        a = Path(tcb._ring_base(str(tmp_path / "p"), "c", "latency", 0)
                 + f".{k}").read_bytes()
        b = Path(rcb._ring_base(str(tmp_path / "r"), "c", "latency", 0)
                 + f".{k}").read_bytes()
        assert a == b


# ---------------------------------------------------------------------------
# the roles' drains against the reference's
# ---------------------------------------------------------------------------


def _engine(mod, eng_cls, src_cls, sink_cls, t0_ns, **kw):
    eng = eng_cls(mod._cfg(B), src_cls(np.empty(0, schema.FLOW_RECORD_DTYPE)),
                  sink_cls(), mega_n=0, sink_thread=False, t0_ns=t0_ns, **kw)
    eng.warm()
    return eng


def _drain(mod, eng, ingest_cls, base, sink_cls, t0_ns, **src_kw):
    src = ingest_cls(base, src_kw.pop("n", 2),
                     queue_slots=mod._queue_slots(N_BATCHES),
                     precompact=False, **src_kw)
    sink = sink_cls()
    eng.reset_stream(src, sink, t0_ns=t0_ns)
    try:
        rep, _ = mod._drain_one(eng, src, t0_ns)
    finally:
        src.close()
    return rep, sink


@pytest.mark.parametrize("corpus", sorted(CORPORA))
def test_single_drain_equals_reference(corpus, tmp_path):
    """The baseline role's trial: two drain workers over the two-shard
    fan-out into one engine, the whole corpus sealed before the timed
    drain."""
    recs = CORPORA[corpus]()
    t0 = int(recs["ts_ns"].min())
    base = tcb._ring_base(str(tmp_path / "p"), "s", "latency", 0)
    jbase = rcb._ring_base(str(tmp_path / "r"), "s", "latency", 0)
    tcb._prefill(str(tmp_path / "p"), "s", "latency", 0, recs)
    rcb._prefill(str(tmp_path / "r"), "s", "latency", 0, recs)
    eng = _engine(tcb, Engine, ArraySource, CollectSink, t0, device="cpu")
    jeng = _engine(rcb, JEngine, JArraySource, JCollectSink, t0)
    rep, sink = _drain(tcb, eng, ShardedIngest, base, CollectSink, t0)
    jrep, jsink = _drain(rcb, jeng, JShardedIngest, jbase, JCollectSink, t0)
    assert (rep.records, rep.batches) == (jrep.records, jrep.batches)
    assert rep.records == len(recs)
    assert sink.blocked == jsink.blocked
    assert (len(sink.blocked) > 0) == (corpus == "flood")
    assert eng.stats.to_dict() == {k: int(v) for k, v in
                                   jeng.stats.to_dict().items()}
    key, state = schema.table_to_numpy(eng.table)
    np.testing.assert_array_equal(key, np.asarray(jeng.table.key))
    np.testing.assert_array_equal(
        state.view(np.uint32), np.asarray(jeng.table.state).view(np.uint32))


@pytest.mark.parametrize("corpus", sorted(CORPORA))
def test_rank_drains_on_a_gossip_plane_equal_reference(corpus, tmp_path):
    """The cluster roles' trial: each rank's own shard through one worker,
    both ranks on a two-rank gossip plane, then the quiesce: records,
    blocked sources and the plane's published and merged digests equal
    the reference's ranks'."""
    recs = CORPORA[corpus]()
    t0 = int(recs["ts_ns"].min())
    sides = {}
    for tag, mod, pkg in (("port", tcb, None), ("ref", rcb, None)):
        root = tmp_path / tag
        mod._prefill(str(root), "c", "latency", 0, recs)
        base = mod._ring_base(str(root), "c", "latency", 0)
        if tag == "port":
            gossip.create_plane(root / "plane", 2)
            planes = [gossip.GossipPlane(root / "plane", r, 2,
                                         sink=CollectSink())
                      for r in range(2)]
            engines = [_engine(mod, Engine, ArraySource, CollectSink, t0,
                               device="cpu", gossip=planes[r])
                       for r in range(2)]
            ingest, sink_cls = ShardedIngest, CollectSink
        else:
            jgossip.create_plane(str(root / "plane"), 2)
            planes = [jgossip.GossipPlane(str(root / "plane"), r, 2,
                                          sink=JCollectSink())
                      for r in range(2)]
            engines = [_engine(mod, JEngine, JArraySource, JCollectSink, t0,
                               gossip=planes[r]) for r in range(2)]
            ingest, sink_cls = JShardedIngest, JCollectSink
        out = []
        for r in range(2):
            rep, sink = _drain(mod, engines[r], ingest, base, sink_cls, t0,
                               n=1, shard_offset=r, total_shards=2)
            out.append({"records": rep.records, "batches": rep.batches,
                        "blocked": dict(sink.blocked)})
        for r in range(2):
            planes[r].quiesce(10.0)
            g = planes[r].report()
            out[r].update({k: g[k] for k in ("published_digest",
                                             "merged_digest", "rx_seq_gaps")})
        sides[tag] = out
    assert sides["port"] == sides["ref"]
    port = sides["port"]
    assert sum(r["records"] for r in port) == len(recs)
    for a, b in ((port[0], port[1]), (port[1], port[0])):
        assert a["merged_digest"] == b["published_digest"]
        assert a["rx_seq_gaps"] == 0
    assert (sum(len(r["blocked"]) for r in port) > 0) == (corpus == "flood")


# ---------------------------------------------------------------------------
# the orchestrator end to end
# ---------------------------------------------------------------------------


def _dict_keys(fn_name: str, target: str) -> set:
    """The keys of the dict literal the reference assigns to ``target``
    (a name) or appends (``by_shape[...].append``) in ``fn_name``."""
    tree = ast.parse(REF_SCRIPT.read_text())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == fn_name)
    for node in ast.walk(fn):
        if (target != "append" and isinstance(node, ast.Assign)
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id == target
                and isinstance(node.value, ast.Dict)):
            return {k.value for k in node.value.keys}
        if (target == "append" and isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "append" and node.args
                and isinstance(node.args[0], ast.Dict)):
            return {k.value for k in node.args[0].keys}
    raise AssertionError(f"no {target} dict in {fn_name}")


def _held_to_the_reference(paced: dict) -> None:
    assert _dict_keys("orchestrate", "paced") <= set(paced)
    assert paced["ok"] and paced["failures"] == [], paced["failures"]
    assert paced["lost_batches"] == 0
    assert paced["config"]["cut"] == CUT and paced["config"]["trials"] == 1
    assert paced["device_kind"] == "cpu" and paced["power_limit_w"] is None
    trial_keys = _dict_keys("orchestrate", "append")
    for name, shp in paced["shapes"].items():
        assert set(shp["headline"]) == set(rcb._summarize(shp["trials"]))
        [tr] = shp["trials"]
        assert trial_keys <= set(tr)
        # the four checks, restated on the trial's own numbers
        assert sum(tr["produced_per_shard"]) == dict(
            latency=16, throughput=10)[name] * shp["config"]["batch"]
    head = paced["headline"]
    assert head["meets_target"] == (head["median_scaling_x"] >= 1.6)


def test_cli_bench_cluster_against_the_tree_under_test(tmp_path, capfd,
                                                      monkeypatch):
    """``fsx bench --cluster --baseline-repo <this tree> --device cpu``:
    the CLI's checks, then the script by path with both flags passed
    through (a wrapper adds the test's cut and output)."""
    out = tmp_path / "CLUSTER_torch.json"
    wrapper = tmp_path / "torch_cluster_bench.py"
    wrapper.write_text(
        "import importlib.util, sys\n"
        f"_s = importlib.util.spec_from_file_location('tcb', {str(SCRIPT)!r})\n"
        "_m = importlib.util.module_from_spec(_s)\n"
        "_s.loader.exec_module(_m)\n"
        "DEFAULT_BASELINE, preflight = _m.DEFAULT_BASELINE, _m.preflight\n"
        "if __name__ == '__main__':\n"
        "    sys.exit(_m.main(sys.argv[1:] + ['--trials', '1', '--cut', "
        f"'{CUT}', '--out', {str(out)!r}]))\n")
    monkeypatch.setattr(cli, "CLUSTER_BENCH", wrapper)
    rc = cli.main(["bench", "--cluster", "--baseline-repo", str(REPO),
                   "--device", "cpu"])
    stdout, err = capfd.readouterr()
    [line] = [ln for ln in stdout.splitlines() if ln.strip()]
    head = json.loads(line)
    assert rc == (0 if head["meets_target"] else 1), err[-3000:]
    paced = json.loads(out.read_text())["paced"]
    assert paced["baseline_is_tree_under_test"]
    assert paced["baseline_repo"] == str(REPO)
    _held_to_the_reference(paced)
    assert head["median_scaling_x"] == paced["headline"]["median_scaling_x"]


def _has_commit(commit: str) -> bool:
    try:
        return subprocess.run(
            ["git", "-C", str(REPO), "cat-file", "-e", f"{commit}^{{commit}}"],
            capture_output=True, timeout=60).returncode == 0
    except (OSError, subprocess.SubprocessError):
        return False


def test_script_against_the_pre_cluster_commit(tmp_path):
    """The orchestrator against ``git archive c8043dd``: the baseline's own
    package in the single role, prefilled rings it reads."""
    if not _has_commit(tcb.BASELINE_COMMIT):
        pytest.skip(f"the checkout's history lacks {tcb.BASELINE_COMMIT}, "
                    "the pre-cluster commit the baseline tree is made from")
    tree = tmp_path / "pr9"
    tree.mkdir()
    arch = subprocess.run(["git", "-C", str(REPO), "archive",
                           tcb.BASELINE_COMMIT, "flowsentryx_tpu_torch"],
                          capture_output=True, check=True, timeout=120)
    subprocess.run(["tar", "-x", "-C", str(tree)], input=arch.stdout,
                   check=True, timeout=120)
    assert not (tree / "flowsentryx_tpu_torch" / "cluster").exists()
    out = tmp_path / "CLUSTER_torch.json"
    r = subprocess.run(
        [sys.executable, str(SCRIPT), "--device", "cpu", "--trials", "1",
         "--cut", str(CUT), "--baseline-repo", str(tree), "--out", str(out)],
        capture_output=True, text=True, timeout=600, cwd=REPO)
    [line] = [ln for ln in r.stdout.splitlines() if ln.strip()]
    head = json.loads(line)
    assert r.returncode == (0 if head["meets_target"] else 1), \
        r.stderr[-3000:]
    paced = json.loads(out.read_text())["paced"]
    assert not paced["baseline_is_tree_under_test"]
    assert paced["baseline_rings"].startswith("prefilled by the orchestrator")
    _held_to_the_reference(paced)


@pytest.mark.parametrize("how", ["script", "cli"])
def test_a_baseline_without_the_package_exits_two(tmp_path, capfd, how):
    empty = tmp_path / "empty"
    empty.mkdir()
    if how == "script":
        r = subprocess.run([sys.executable, str(SCRIPT), "--baseline-repo",
                            str(empty), "--device", "cpu"],
                           capture_output=True, text=True, timeout=120)
        rc, err = r.returncode, r.stderr
    else:
        rc = cli.main(["bench", "--cluster", "--baseline-repo", str(empty),
                       "--device", "cpu"])
        err = capfd.readouterr().err
    assert rc == 2
    assert f"git worktree add --detach {empty} c8043dd" in err
    assert "git archive c8043dd flowsentryx_tpu_torch" in err
    assert "no CUDA device" not in err
