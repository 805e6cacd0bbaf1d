"""The port's BASELINE scenario suite (``benchmarks.scenario_suite``,
``run_suite``, ``cli bench --scenarios``) against the JAX package's.

* ``scenario_suite(scale)`` equals the reference's field for field at
  three scales: names, configs, traffic specs and packet counts;
* ``run_suite(scale=0.02, device="cpu")`` equals the reference's
  ``run_suite(scale=0.02)`` for each of the five configs in every field
  but ``wall_s``, ``mpps`` and ``stages_ms`` (timings), and each run's
  blocked sources are the same set;
* config 2 at full scale, where the 256-source flood trips the sliding
  window, as the reference's own suite test runs it;
* ``cli bench --scenarios`` prints what the reference's prints, and the
  reference's flags the port does not carry are refused by name.
"""

import contextlib
import dataclasses
import io
import json
from pathlib import Path

import pytest
import torch

from flowsentryx_tpu import benchmarks as jbench
from flowsentryx_tpu import cli as jcli
from flowsentryx_tpu_torch import benchmarks, cli

#: The result fields that are timings, excluded by name.
TIMING = ("wall_s", "mpps", "stages_ms")
NAMES = [sb.name for sb in jbench.scenario_suite()]


@pytest.fixture(autouse=True)
def two_threads():
    # the plain CPU step runs several times faster on 2 threads than on
    # one thread per core (thread hand-offs)
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _plain(spec) -> dict:
    d = dataclasses.asdict(spec)
    d["scenario"] = d["scenario"].value
    return d


@pytest.mark.parametrize("scale", [0.02, 0.5, 1.0])
def test_scenario_suite_equals_reference(scale):
    got = benchmarks.scenario_suite(scale)
    want = jbench.scenario_suite(scale)
    assert [s.name for s in got] == [s.name for s in want]
    for g, w in zip(got, want):
        assert g.cfg.to_dict() == w.cfg.to_dict(), g.name
        assert _plain(g.traffic) == _plain(w.traffic), g.name
        assert g.packets == w.packets == max(2048, int(
            {"config5_mixed_l34_1m_ips": 1_048_576}.get(g.name, 262_144)
            * scale)), g.name


def _suite(mod, monkeypatch, **kw) -> dict:
    """``mod.run_suite(**kw)`` by scenario name, each result with the
    blocked sources its run handed to ``_source_quality``."""
    blocked: list[set] = []
    quality = mod._source_quality

    def recording(spec, b):
        blocked.append(set(b))
        return quality(spec, b)

    with monkeypatch.context() as m:
        m.setattr(mod, "_source_quality", recording)
        results = mod.run_suite(**kw)
    assert len(blocked) == len(results)
    return {r["scenario"]: (r, b) for r, b in zip(results, blocked)}


@pytest.fixture(scope="module")
def small_suites():
    with pytest.MonkeyPatch.context() as mp:
        prev = torch.get_num_threads()
        torch.set_num_threads(2)
        try:
            port = _suite(benchmarks, mp, scale=0.02, device="cpu")
        finally:
            torch.set_num_threads(prev)
        ref = _suite(jbench, mp, scale=0.02)
    return port, ref


def _untimed(r: dict) -> dict:
    assert all(k in r for k in TIMING)
    return {k: v for k, v in r.items() if k not in TIMING}


@pytest.mark.parametrize("name", NAMES)
def test_run_suite_equals_reference(small_suites, name):
    port, ref = small_suites
    (got, got_blocked), (want, want_blocked) = port[name], ref[name]
    assert _untimed(got) == _untimed(want)
    assert got_blocked == want_blocked
    assert got["params"] == "logreg_int8.npz"
    assert got["stats"]["allowed"] + got["stats"]["dropped"] == got[
        "packets"]


def test_config2_full_scale_trips_the_window_as_reference(monkeypatch):
    [(got, got_blocked)] = _suite(benchmarks, monkeypatch, scale=1.0,
                                  names=["config2"], device="cpu").values()
    [(want, want_blocked)] = _suite(jbench, monkeypatch, scale=1.0,
                                    names=["config2"]).values()
    assert _untimed(got) == _untimed(want)
    assert got_blocked == want_blocked
    # the reference suite test's own checks
    assert got["packets"] == 262_144
    assert got["stats"]["dropped"] > 0
    assert got["blocked_attack"] > 0 and got["source_recall"] > 0.5


def test_run_suite_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        benchmarks.run_suite(scale=0.02, names=["config1"])


def _run(main, argv) -> tuple[int, str, str]:
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(list(argv))
    return rc, out.getvalue(), err.getvalue()


def test_bench_scenarios_cli_equals_reference():
    argv = ["bench", "--scenarios", "--scale", "0.02", "--only", "config1"]
    rc, out, _ = _run(cli.main, argv + ["--device", "cpu"])
    jrc, jout, _ = _run(jcli.main, argv)
    assert rc == jrc == 0
    got = [json.loads(x) for x in out.splitlines()]
    want = [json.loads(x) for x in jout.splitlines()]
    assert len(got) == len(want) == 1
    assert _untimed(got[0]) == _untimed(want[0])
    assert got[0]["scenario"] == NAMES[0]


@pytest.mark.parametrize("argv,rc,message", [
    ([], 1, None), (["--smoke"], 1, None), (["--scaling"], 1, None),
    (["--cluster", "--baseline-repo",
      str(Path(__file__).resolve().parents[1])], 1, None),
    (["--cluster", "--baseline-repo", "/nonexistent/fsx_pr9"], 2,
     "git archive c8043dd flowsentryx_tpu_torch"),
    (["--scenarios", "--scaling"], 1, None),
    (["--host-ingest", "4"], 1, None)],
    ids=["bare", "smoke", "scaling", "cluster", "baseline-repo",
         "scenarios-scaling", "host-ingest"])
def test_bench_refuses_unported_modes_by_name(argv, rc, message):
    """Every mode of ``bench`` is ported, and none is refused by name any
    more.  A bare ``bench``, ``--smoke`` (the headline benchmark),
    ``--scaling`` (the sharded step), ``--host-ingest`` (the headline
    benchmark after the sharded host-ingest suite) and ``--cluster``
    (the paced scale-out comparison, here against this tree) run on the
    card without ``--device``, and a host without one refuses them by
    that reason, printing no line; ``--cluster`` with a ``--baseline-repo``
    that holds no package exits 2 naming how to make the tree, before it
    asks for the card."""
    got_rc, out, err = _run(cli.main, ["bench", *argv])
    assert got_rc == rc and out == ""
    assert "refusing" not in err
    if message is None:
        assert "no CUDA device" in err
    else:
        assert message in err and "no CUDA device" not in err
