"""The port's read side (``cli status``, ``cli monitor`` and the report
merges behind them) against the JAX package's.

* each ``_merged_*`` fold gives the reference's dict over the same
  report globs: bare and wrapped reports, a glob that matches nothing,
  a torn file, overlapping globs, health states with gossip, ``net`` and
  ``rebalance`` blocks, governor and boot blocks, a cluster directory's
  ``report_r*_g*.json`` set, and a real report of each package's CPU
  engine (so each package's merges read the other's reports);
* ``main(["status", ...])`` prints the reference's JSON, over ring
  files made by the port's ``ShmRing``;
* the merged latency, predict and boot blocks equal the port
  supervisor's ``aggregate()`` over the same directory of rank reports;
* ``monitor --count 2 --interval 0`` records equal the reference's in
  every key but ``ts`` (the ``kernel`` key reads the default pin
  directory, here without maps, as the reference's does), with each of
  the four alerts made to fire and not to fire, and each refusal names
  its flag.  The pinned-map reads over live maps are held to the
  reference in ``test_torch_bpf_maps.py``.
"""

import contextlib
import io
import json
import platform
from pathlib import Path

import numpy as np
import pytest

from flowsentryx_tpu import cli as jcli
from flowsentryx_tpu.engine.metrics import LatencyHist as JLatencyHist
from flowsentryx_tpu_torch import cli
from flowsentryx_tpu_torch.cluster.runner import stub_engine_main
from flowsentryx_tpu_torch.cluster.supervisor import ClusterSupervisor
from flowsentryx_tpu_torch.core import wire
from flowsentryx_tpu_torch.engine.metrics import LatencyHist
from flowsentryx_tpu_torch.engine.predict import DispatchGovernor

MERGES = ("_merged_latency", "_merged_engine_health")
FOLDS = ("_merged_predict", "_merged_boot")


def _hist(base_s: float, n: int, tail_s: float) -> LatencyHist:
    h = LatencyHist()
    for i in range(n):
        h.add(base_s * (1 + i % 7))
    h.add(tail_s)
    return h


def _report(h: LatencyHist | None, state="healthy", reasons=(), *,
            predict=None, boot=None, cluster=None, rebalance=None):
    rep = {"records": h.n if h else 0, "batches": 1, "wall_s": 1.0,
           "health": {"state": state, "reasons": list(reasons)}}
    if h is not None:
        rep["latency"] = {"unit": "us", "seal_to_verdict": h.to_dict(),
                          "hist": h.to_counts()}
    for key, block in (("predict", predict), ("boot", boot),
                       ("cluster", cluster), ("rebalance", rebalance)):
        if block is not None:
            rep[key] = block
    return rep


def _gov(**kw):
    return dict(DispatchGovernor(rung_sizes=(8, 4, 2),
                                 batch_records=256).report(), **kw)


def _gossip(**kw):
    return {"tx_wires": 12, "tx_dropped": 0, "rx_wires": 11,
            "rx_seq_gaps": 0, "merged_digest": "ab12", **kw}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Hand-written reports in every shape the merges meet, plus one real
    report of each package's CPU engine (``serve --slo-us --predict``)."""
    d = tmp_path_factory.mktemp("reports")
    cl_dir = d / "cl"
    cl_dir.mkdir()
    (d / "bare_healthy.json").write_text(json.dumps(_report(
        _hist(90e-6, 50, 4e-3), predict=_gov(prewarm_misses=0, holds=2),
        boot={"serving_ready_s": 0.8, "import_s": 1.1,
              "cache": {"hits": 4, "misses": 0, "stores": 0}})))
    (d / "bare_no_latency.json").write_text(json.dumps(_report(None)))
    (d / "foreign_scheme.json").write_text(json.dumps(_report(
        _hist(1e-4, 3, 1e-3)) | {"latency": {"hist": {
            "scheme": "linear_ms", "buckets": {}}}}))
    (d / "torn.json").write_text("{torn")
    ranks = [
        # rank 0: healthy, a governor that pre-warmed in vain, cold boot
        _report(_hist(120e-6, 99, 30e-3), predict=_gov(
            prewarm_issued=6, prewarm_misses=5, onset_hits=3,
            confident=True, estimate={"period_s": 0.0075,
                                      "confidence": 0.91}),
            boot={"serving_ready_s": 1.5, "import_s": 5.2,
                  "cache": {"hits": 0, "misses": 4, "stores": 4}},
            cluster=_gossip()),
        # rank 1: degraded by the gossip plane, warm boot, net counters
        _report(_hist(210e-6, 99, 60e-3), "degraded",
                ["gossip_tx_dropped:3", "ingest_seq_gaps:1"],
                predict=_gov(prewarm_misses=1, confident=True,
                             estimate={"period_s": 0.01,
                                       "confidence": 0.5}),
                boot={"serving_ready_s": 2.25, "import_s": 5.9,
                      "cache": {"hits": 4, "misses": 0, "stores": 0}},
                cluster=_gossip(tx_dropped=3, net={
                    "tx_wires": 5, "tx_drop": 1, "rx_wires": 4,
                    "rx_gap": 0, "rx_dup": 2, "reorder_evict": 0,
                    "epoch_skew_dropped": 0, "epoch_skew_max": 0,
                    "net_digest": "cd34", "extra": 9})),
        # rank 2: a reshaping fleet's friction, and a rebalance block
        _report(_hist(150e-6, 40, 9e-3), "degraded",
                ["rebalance_refused:2", "elastic_plans_suppressed:1"],
                rebalance={"handoffs": 2, "rows_moved": 4096,
                           "refused": 2, "note": "span 3"}),
    ]
    for r, rep in enumerate(ranks):
        (cl_dir / f"report_r{r}_g0.json").write_text(json.dumps(
            {"rank": r, "gen": 0, "pid": 100 + r, "report": rep}))
    for name, main, argv in (
            ("port_engine.json", cli.main, ["--device", "cpu"]),
            ("reference_engine.json", jcli.main, [])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = main(["serve", "--table-capacity", "4096", "--batches",
                       "3", "--slo-us", "5000", "--predict", *argv])
        assert rc == 0
        (d / name).write_text(buf.getvalue())
    return d


GLOB_SETS = {
    "bare": ["bare_healthy.json"],
    "wrapped_cluster_dir": ["cl/report_r*_g*.json"],
    "missing_glob": ["nothing_here_*.json", "bare_healthy.json"],
    "torn_and_foreign": ["torn.json", "foreign_scheme.json",
                         "bare_no_latency.json"],
    "overlapping_globs": ["cl/report_r0_g0.json", "cl/report_r*_g*.json",
                          "*.json", "bare_*.json"],
    "real_engines": ["port_engine.json", "reference_engine.json"],
    "everything": ["*.json", "cl/*.json", "missing_*.json"],
}


def _globs(d: Path, key: str) -> list[str]:
    return [str(d / g) for g in GLOB_SETS[key]]


@pytest.mark.parametrize("key", sorted(GLOB_SETS))
def test_merges_equal_reference(corpus, key):
    globs = _globs(corpus, key)
    reports = list(cli._iter_engine_reports(globs))
    j_reports = list(jcli._iter_engine_reports(globs))
    assert reports == j_reports
    for name in MERGES:
        got = getattr(cli, name)(reports)
        assert got == getattr(jcli, name)(globs, reports=j_reports), name
        # the reference merge's own walk: the same view
        assert got == getattr(jcli, name)(globs), name
    for name in FOLDS:
        assert getattr(cli, name)(reports) == getattr(jcli, name)(
            j_reports), name


def test_merge_rules(corpus):
    """The reference's rules, spelled out: an unreadable report and a
    glob that matches nothing fold in as DEGRADED entries, overlapping
    globs merge each file once, wrapped and bare reports both count, and
    the ``net`` and ``rebalance`` blocks pass through."""
    globs = _globs(corpus, "everything")
    reports = list(cli._iter_engine_reports(globs))
    paths = [p for p, _, _ in reports]
    assert len(paths) == len(set(paths))
    h = cli._merged_engine_health(reports)
    missing = str(corpus / "missing_*.json")
    assert h["reports"][missing]["state"] == "degraded"
    assert h["reports"][str(corpus / "torn.json")]["reasons"][0].startswith(
        "report_unreadable:")
    assert h["state"] == "degraded"
    r1 = h["reports"][str(corpus / "cl" / "report_r1_g0.json")]
    assert r1["gossip"]["net"]["rx_dup"] == 2 and "extra" not in r1[
        "gossip"]["net"]
    assert h["rebalance"] == {"handoffs": 2, "rows_moved": 4096,
                              "refused": 2}
    lat = cli._merged_latency(reports)
    # the two real engines, the bare report and three ranks
    assert lat["reports_merged"] == 6
    assert lat["per_report"][str(corpus / "foreign_scheme.json")][
        "error"].startswith("latency histogram scheme")
    assert lat["seal_to_verdict_us"]["n"] == sum(
        e.get("n", 0) for e in lat["per_report"].values())


def test_each_package_reads_the_others_reports(corpus):
    """The report format is the interface: the reference engine's report
    merges in the port's folds and the port engine's in the reference's,
    the same way each package merges its own."""
    for name, other_main in (("reference_engine.json", cli),
                             ("port_engine.json", jcli)):
        globs = [str(corpus / name)]
        reports = list(other_main._iter_engine_reports(globs))
        args = ((reports,) if other_main is cli
                else (globs, reports))
        lat = other_main._merged_latency(*args)
        assert lat["reports_merged"] == 1
        assert lat["seal_to_verdict_us"]["n"] == 3 * 2048
        health = other_main._merged_engine_health(*args)
        assert health["state"] == "healthy"
        predict = other_main._merged_predict(reports)
        assert predict["observed_records"] == 3 * 2048
        boot = other_main._merged_boot(reports)
        assert boot["max_serving_ready_s"] > 0


def _run(main, argv) -> tuple[int, str, str]:
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(list(argv))
    return rc, out.getvalue(), err.getvalue()


@pytest.mark.skipif(platform.machine() not in ("x86_64", "AMD64"),
                    reason="the shm rings refuse non-x86-TSO hosts")
@pytest.mark.parametrize("key", ["everything", "wrapped_cluster_dir"])
def test_status_equals_reference(corpus, tmp_path, key):
    from flowsentryx_tpu_torch.engine.shm import ShmRing

    feat = ShmRing.create(tmp_path / "feat", 1 << 10, wire.FLOW_RECORD_DTYPE)
    rec = np.zeros(300, wire.FLOW_RECORD_DTYPE)
    rec["saddr"] = np.arange(300)
    assert feat.produce(rec) == 300
    assert len(feat.consume(120)) == 120
    verd = ShmRing.create(tmp_path / "verd", 1 << 8,
                          wire.VERDICT_RECORD_DTYPE)
    assert verd.produce(np.zeros(7, wire.VERDICT_RECORD_DTYPE)) == 7
    argv = ["status", "--feature-ring", str(tmp_path / "feat"),
            "--verdict-ring", str(tmp_path / "verd")]
    for g in _globs(corpus, key):
        argv += ["--engine-report", g]
    rc, out, _ = _run(cli.main, argv)
    jrc, jout, _ = _run(jcli.main, argv)
    assert rc == jrc == 0
    got = json.loads(out)
    assert got == json.loads(jout)
    assert got["feature_ring"] == {
        "present": True, "magic_ok": True, "capacity": 1 << 10,
        "record_size": wire.FLOW_RECORD_DTYPE.itemsize, "produced": 300,
        "consumed": 120, "backlog": 180}
    assert got["verdict_ring"]["backlog"] == 7
    # no rings, no reports: the reference's empty view
    bare = ["status", "--feature-ring", str(tmp_path / "none_f"),
            "--verdict-ring", str(tmp_path / "none_v")]
    assert json.loads(_run(cli.main, bare)[1]) == json.loads(
        _run(jcli.main, bare)[1]) == {"feature_ring": {"present": False},
                                      "verdict_ring": {"present": False}}


def test_merges_equal_supervisor_aggregate(corpus):
    """Over a cluster directory of rank reports (one generation each) the
    merged latency, predict and boot blocks are the supervisor's own
    ``aggregate()`` folds."""
    d = corpus / "cl"
    globs = [str(d / "report_r*_g*.json")]
    agg = ClusterSupervisor(d, [{}, {}, {}],
                            entry=stub_engine_main).aggregate()
    reports = list(cli._iter_engine_reports(globs))
    lat = cli._merged_latency(reports)
    assert lat["seal_to_verdict_us"] == agg["latency"]["seal_to_verdict"]
    assert {Path(p).name[8]: e["p99_us"] for p, e in lat[
        "per_report"].items()} == agg["latency"]["per_rank_p99"]
    assert cli._merged_predict(reports) == agg["predict"]
    boot = cli._merged_boot(reports)
    assert list(boot["per_report"].values()) == list(
        agg["boot"]["per_rank"].values())
    for k in ("cache_hits", "cache_misses", "cache_stores",
              "max_serving_ready_s"):
        assert boot[k] == agg["boot"][k], k
    merged = JLatencyHist()
    for _, doc, _ in reports:
        merged.merge(JLatencyHist.from_counts(doc["report"]["latency"][
            "hist"]))
    assert lat["seal_to_verdict_us"] == merged.to_dict()


#: Each alert made to fire and not to fire: (flags, glob set, fires).
ALERT_CASES = {
    "p99_fires": (["--alert-p99-us", "1"], "wrapped_cluster_dir", True),
    "p99_quiet": (["--alert-p99-us", "1e9"], "wrapped_cluster_dir", False),
    "degraded_fires": (["--alert-degraded"], "wrapped_cluster_dir", True),
    "degraded_unreadable": (["--alert-degraded"], "missing_glob", True),
    "degraded_quiet": (["--alert-degraded"], "real_engines", False),
    "prewarm_fires": (["--alert-prewarm-miss", "6"], "wrapped_cluster_dir",
                      True),
    "prewarm_quiet": (["--alert-prewarm-miss", "7"], "wrapped_cluster_dir",
                      False),
    "cold_boot_fires": (["--alert-cold-boot"], "wrapped_cluster_dir", True),
    "cold_boot_quiet": (["--alert-cold-boot"], "bare", False),
}


@pytest.mark.parametrize("case", sorted(ALERT_CASES))
def test_monitor_records_equal_reference(corpus, tmp_path, case):
    flags, key, fires = ALERT_CASES[case]
    out_file = tmp_path / "history.jsonl"
    argv = ["monitor", "--count", "2", "--interval", "0", *flags]
    for g in _globs(corpus, key):
        argv += ["--engine-report", g]
    rc, out, err = _run(cli.main, argv + ["--out", str(out_file)])
    jrc, jout, jerr = _run(jcli.main, argv)
    assert rc == jrc == 0
    recs = [json.loads(x) for x in out.splitlines()]
    jrecs = [json.loads(x) for x in jout.splitlines()]
    assert len(recs) == len(jrecs) == 2
    for r, j in zip(recs, jrecs):
        for rec in (r, j):
            del rec["ts"]
        assert r == j
        assert ("alerts" in r) == fires
    assert err.count("ALERT") == jerr.count("ALERT")
    assert [json.loads(x) for x in out_file.read_text().splitlines()] == [
        json.loads(x) for x in out.splitlines()]


def test_monitor_kernel_key_names_what_is_missing(corpus, tmp_path):
    argv = ["monitor", "--count", "2", "--interval", "0", "--pin",
            str(tmp_path / "no_pin"), "--engine-report",
            str(corpus / "bare_healthy.json")]
    rc, out, _ = _run(cli.main, argv)
    jrc, jout, _ = _run(jcli.main, argv)
    assert rc == jrc == 0
    rec = json.loads(out.splitlines()[0])
    assert list(rec["kernel"]) == ["stats", "blacklist_entries"]
    assert "No such file" in rec["kernel"]["stats"]["error"]
    assert "error" in rec["kernel"]["blacklist_entries"]
    assert rec["kernel"] == json.loads(jout.splitlines()[0])["kernel"]
    # no counters read: no per-second deltas on any tick
    assert all("per_s" not in json.loads(x) for x in out.splitlines())


@pytest.mark.parametrize("flag", ["--alert-degraded", "--alert-p99-us",
                                  "--alert-prewarm-miss",
                                  "--alert-cold-boot"])
def test_monitor_report_refusals_equal_reference(flag):
    argv = ["monitor", flag] + ([] if flag in ("--alert-degraded",
                                               "--alert-cold-boot")
                                else ["5"])
    rc, _, err = _run(cli.main, argv)
    jrc, _, jerr = _run(jcli.main, argv)
    assert rc == jrc == 1
    assert err == jerr and flag in err


@pytest.mark.parametrize("argv", [[]], ids=["no-engine-report"])
def test_monitor_refuses_kernel_flags_by_name(corpus, argv):
    # without --engine-report the monitor reads only the kernel maps of
    # the default pin directory, as the reference's does
    rc, out, err = _run(cli.main, ["monitor", "--count", "1", *argv])
    jrc, jout, jerr = _run(jcli.main, ["monitor", "--count", "1", *argv])
    assert rc == jrc == 0 and err == jerr
    rec, jrec = json.loads(out), json.loads(jout)
    del rec["ts"], jrec["ts"]
    assert rec == jrec and list(rec) == ["kernel"]


def test_a_report_that_is_not_an_object_reads_as_unreadable(corpus,
                                                            tmp_path):
    """A report file holding JSON that is not an object (the reference's
    merges raise AttributeError on it) folds in as an unreadable entry:
    DEGRADED in the health view, an error in the latency view, and
    ``monitor`` keeps running."""
    bad = tmp_path / "list.json"
    bad.write_text("[1, 2]")
    globs = [str(bad), str(corpus / "bare_healthy.json")]
    reports = list(cli._iter_engine_reports(globs))
    assert reports[0] == (str(bad), None, "not a JSON object: list")
    h = cli._merged_engine_health(reports)
    assert h["state"] == "degraded"
    assert h["reports"][str(bad)]["reasons"] == [
        "report_unreadable:not a JSON object: list"]
    lat = cli._merged_latency(reports)
    assert lat["reports_merged"] == 1 and "error" in lat["per_report"][
        str(bad)]
    rc, out, _ = _run(cli.main, ["monitor", "--count", "1", "--interval",
                                 "0", "--alert-degraded",
                                 "--engine-report", globs[0],
                                 "--engine-report", globs[1]])
    assert rc == 0 and "alerts" in json.loads(out)
    with pytest.raises(AttributeError):
        jcli._merged_engine_health(globs)
