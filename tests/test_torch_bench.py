"""The port's headline benchmark (``flowsentryx_tpu_torch/bench.py``,
``fsx bench``, ``fsx bench --smoke``) and ``fsx version`` against the
reference's root ``bench.py`` and ``fsx version``.

* ``make_raw_batches`` draws the reference's records, byte for byte;
* the 16 ``--smoke`` batches (B=1024, 2^12 rows) through the bench's
  single step, n=8 megastep and 2 x 8 drain ring equal the reference's
  jitted step, megastep and device loop under ``JAX_PLATFORMS=cpu``:
  table, stats and every verdict wire, byte-equal;
* the fold of chunk series equals the reference's ``_finalize`` (taken
  from its source) on crafted series;
* the reference's ``main`` with its two phases replaced by crafted
  results prints a line whose keys, less the tunnel keys the port drops,
  plus the keys it adds, are the port's line's keys, and whose headline
  fields (value, tiers, the canonical latency pick) equal the port's;
* ``fsx bench --smoke --device cpu`` prints one line and exits 0;
  ``--host-ingest N`` puts the sharded host-ingest suite's headline,
  with the reference's keys, under ``host_ingest``, and a child that
  fails gives ``{"error": ...}``; a raising phase still prints the line
  and exits 1; without a card the run exits 1 naming it.
"""

import ast
import contextlib
import io
import json
import sys
import time
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowsentryx_tpu import cli as jcli
from flowsentryx_tpu.core import schema as jschema
from flowsentryx_tpu.core.config import BatchConfig as JBatchConfig
from flowsentryx_tpu.core.config import FsxConfig as JFsxConfig
from flowsentryx_tpu.core.config import TableConfig as JTableConfig
from flowsentryx_tpu.fused import device_loop as jdl
from flowsentryx_tpu.models import get_model as jget_model
from flowsentryx_tpu.ops import fused as jfused
from flowsentryx_tpu_torch import bench, cli
from flowsentryx_tpu_torch.core import schema
from flowsentryx_tpu_torch.fused import device_loop as dl
from flowsentryx_tpu_torch.models.registry import get_model
from flowsentryx_tpu_torch.ops import fused

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
import bench as rbench  # noqa: E402  (the reference's root bench.py)


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _run(main, argv) -> tuple[int, str, str]:
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(list(argv))
    return rc, out.getvalue(), err.getvalue()


@pytest.mark.parametrize("n,b,ips", [(16, 1024, 1 << 20), (4, 2048, 1 << 14),
                                     (1, 1 << 14, 1 << 13)])
def test_make_raw_batches_equals_reference(n, b, ips):
    got = bench.make_raw_batches(n, b, n_ips=ips)
    want = rbench.make_raw_batches(n, b, n_ips=ips)
    assert len(got) == len(want) == n
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes()


# ---------------------------------------------------------------------------
# the smoke batches through the three throughput tiers
# ---------------------------------------------------------------------------


def _state_equal(table, stats, jt, js):
    key, state = schema.table_to_numpy(table)
    np.testing.assert_array_equal(key, np.asarray(jt.key))
    np.testing.assert_array_equal(state.view(np.uint32),
                                  np.asarray(jt.state).view(np.uint32))
    ref = schema.stats_to_numpy(stats)
    for f in jschema.GlobalStats._fields:
        np.testing.assert_array_equal(ref[f], np.asarray(getattr(js, f)))


@pytest.mark.parametrize("tier", ["single", "mega8", "devloop2x8"])
def test_smoke_batches_through_each_tier_equal_reference(tier):
    """The bench's 16 smoke batches (its own setup, encoded with the
    golden params' observer) through the tier's :class:`bench.Replayer`
    on the CPU and through the reference's jitted function: the wire of
    every call, then the table and stats, byte-equal."""
    b, cap = bench.shape_for(True)
    cfg, quant, raws = bench.headline_setup(b, cap)
    jcfg = JFsxConfig(table=JTableConfig(capacity=cap),
                      batch=JBatchConfig(max_batch=b))
    jspec = jget_model(jcfg.model.name)
    jp = jspec.init()
    jquant = jschema.model_quant_args(jp)
    assert quant == jquant
    jraws = [jschema.encode_compact(x, b, t0_ns=0, **jquant)
             for x in rbench.make_raw_batches(16, b, n_ips=1 << 20)]
    assert all(r.tobytes() == j.tobytes() for r, j in zip(raws, jraws))
    params = get_model(cfg.model.name).init("cpu")
    classify = bench.classify_for(params)
    table, stats = schema.make_table(cap), schema.make_stats()
    jt, js = jschema.make_table(cap), jschema.make_stats()
    host = torch.from_numpy(np.stack(raws).view(np.int32))
    if tier == "single":
        run = bench.Replayer(fused.make_compact_step(cfg, classify, **quant),
                             table, stats, params, host.shape[1:])
        jstep = jfused.make_jitted_compact_step(
            jcfg, jspec.classify_batch, donate=False, **jquant)
        calls = [((host[i],), (jnp.asarray(jraws[i]),)) for i in range(16)]
    elif tier == "mega8":
        run = bench.Replayer(
            fused.make_compact_megastep(cfg, classify, 8, **quant),
            table, stats, params, (8, *host.shape[1:]))
        jstep = jfused.make_jitted_compact_megastep(
            jcfg, jspec.classify_batch, n_chunks=8, donate=False, **jquant)
        calls = [((host[g * 8:(g + 1) * 8],),
                  (jnp.asarray(np.stack(jraws[g * 8:(g + 1) * 8])),))
                 for g in range(2)]
    else:
        run = bench.Replayer(
            dl.make_compact_device_loop(cfg, classify, 2, 8, **quant),
            table, stats, params, (2, 8, *host.shape[1:]), slots=True)
        jstep = jdl.make_compact_device_loop(
            jcfg, jspec.classify_batch, 2, 8, donate=False, **jquant)
        calls = [((host[:8], host[8:]),
                  (jnp.asarray(np.stack(jraws[:8])),
                   jnp.asarray(np.stack(jraws[8:]))))]
    for targs, jargs in calls:
        out = run(*targs)
        jt, js, jo = jstep(jt, js, jp, *jargs)
        np.testing.assert_array_equal(out.wire.numpy().view(np.uint32),
                                      np.asarray(jo.wire).view(np.uint32))
    _state_equal(table, stats, jt, js)
    assert stats.to_dict()["batches"] == 16


# ---------------------------------------------------------------------------
# the fold: chunk series and the headline latency pick
# ---------------------------------------------------------------------------


def _ref_finalize():
    """The reference's ``_finalize``, compiled from its source (a
    function nested in ``phase_throughput``)."""
    tree = ast.parse((REPO / "bench.py").read_text())
    phase = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
                 and n.name == "phase_throughput")
    fn = next(n for n in phase.body if isinstance(n, ast.FunctionDef)
              and n.name == "_finalize")
    ns = {"np": np}
    exec(compile(ast.Module(body=[fn], type_ignores=[]), "bench.py",
                 "exec"), ns)
    return ns["_finalize"]


SERIES = [
    {"chunk_mpps": [3.1]},
    {"chunk_mpps": [1.0, 9.5, 9.7, 9.6]},
    {"chunk_mpps": [1.0, 9.5, 9.7], "mega_chunk_mpps": [14.1, 15.0]},
    {"chunk_mpps": [2.0, 3.0, 3.2], "mega_chunk_mpps": [3.9, 4.1],
     "mega32_chunk_mpps": [4.6, 4.4], "devloop_chunk_mpps": [4.5, 4.55]},
    {"chunk_mpps": [2.0, 16.9], "mega_chunk_mpps": [16.1, 16.2],
     "devloop_chunk_mpps": [16.3, 18.0]},
    {"chunk_mpps": [5.0, 5.0], "mega_chunk_mpps": [],
     "dispatch_mode": "stale", "mega_mpps": 99.0},
]


@pytest.mark.parametrize("series", SERIES)
def test_finalize_equals_reference(series):
    got, want = json.loads(json.dumps(series)), json.loads(json.dumps(series))
    bench.finalize(got)
    _ref_finalize()(want)
    assert got == want


def _paced(batch, depth, load, achieved, p50, p99, n=1000):
    return {"batch": batch, "depth": depth, "load_mpps": load,
            "achieved_mpps": achieved, "p50_ms": p50, "p99_ms": p99,
            "n": n}


PACED = {
    "sustained": [_paced(1024, 0, 0.25, 0.25, 0.4, 0.9),
                  _paced(1024, 0, 1.0, 0.95, 0.5, 1.2),
                  _paced(2048, 0, 1.0, 0.99, 0.6, 1.1),
                  _paced(1024, 0, 5.0, 2.1, 9.0, 30.0),
                  _paced(2048, 1, 5.0, 4.9, 0.7, 1.4)],
    "none_sustained": [_paced(2048, 0, 0.25, 0.1, 3.0, 9.0),
                       _paced(1024, 0, 1.0, 0.2, 2.0, 8.0),
                       _paced(1024, 0, 0.25, 0.15, 1.0, 7.0),
                       _paced(2048, 1, 0.25, 0.25, 0.5, 0.8)],
    "no_depth0": [_paced(2048, 1, 0.25, 0.25, 0.5, 0.8)],
}


def _phases(paced):
    tput = {"chunk_mpps": [1.2, 17.1, 17.3, 17.2],
            "mega_chunk_mpps": [16.8, 16.9], "devloop_chunk_mpps": [16.5],
            "compile_s": 1.5, "backend": "cuda", "device_kind": "card",
            "h2d_mbps": 21000.0, "device_mpps": 17.4, "iters": 610,
            "init_s": 0.3}
    bench.finalize(tput)
    lat = {"backend": "cuda", "device_kind": "card",
           "step_ms": {"1024": 0.61, "2048": 0.71, "16384": 0.95},
           "micro": {"batch": 2048, "fill_ms": 0.5, "h2d_ms": 0.03,
                     "wire_bytes": 32784, "d2h_ms": 0.04,
                     "d2h_wire_bytes": 528, "d2h_fallback_ms": 0.08},
           "sync_floor_ms": 0.021, "paced": paced,
           "pulse": [{"slo_us": 0, "p99_ms": 5.0}],
           "stats": {"allowed": 10, "dropped": 0}}
    return tput, lat


#: A healthy probe whose fed loop ran far above the crafted singles' 17.2
#: M records/s: every window it opens flaps (singles < 0.3x its e2e).
FLAP_PROBE = {"backend": "cuda", "device_kind": "card", "init_s": 0.4,
              "dispatch_ms": 0.02, "compile_s": 1.1, "step_ms": 0.9,
              "step_mpps": 18.2, "h2d_mbps": 30000.0, "e2e_mpps": 100.0,
              "state": "healthy"}


def _ref_main(monkeypatch, tmp_path, probe, run_phase) -> dict:
    """The reference's ``main`` with its link probe ``probe`` and its
    phase children ``run_phase``, its link baseline in ``tmp_path``: its
    line."""
    monkeypatch.delenv("JAX_PLATFORMS", raising=False)
    monkeypatch.setenv("FSX_BENCH_NO_MERGE", "1")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "jc"))
    monkeypatch.setattr(rbench, "LINK_BASELINE_PATH", tmp_path / "bl.json")
    probe_script = tmp_path / "probe.py"
    probe_script.write_text("")
    monkeypatch.setattr(rbench, "PROBE_SCRIPT", probe_script)
    monkeypatch.setattr(rbench, "_probe_link", probe)
    monkeypatch.setattr(rbench, "_run_phase", run_phase)
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        assert rbench.main() == 0
    [line] = out.getvalue().splitlines()
    return json.loads(line)


def _ref_line(monkeypatch, tmp_path, tput, lat) -> dict:
    """The reference's ``main`` with its phase children replaced by
    ``tput``/``lat``, every link probe :data:`FLAP_PROBE` (so the line
    carries all four link keys), its link baseline in ``tmp_path``."""
    monkeypatch.setattr(rbench, "T_START", time.perf_counter())
    return _ref_main(monkeypatch, tmp_path,
                     lambda timeout_s=120.0: dict(FLAP_PROBE),
                     lambda phase, *a, **k: dict(
                         tput if phase == "throughput" else lat))


def _port_link(tput) -> dict:
    """The port's gate over the same probes and phase, on a clock that
    only the phase and the probes move."""
    clock = [0.0]

    def probe(timeout_s):
        clock[0] += 10.0
        return dict(FLAP_PROBE)

    def run_phase():
        clock[0] += 100.0
        return dict(tput)

    link = bench.new_link()
    bench.gated_throughput(run_phase, link,
                           lambda: bench.DEFAULT_BUDGET_S - clock[0],
                           bench.DEFAULT_BUDGET_S, probe=probe,
                           sleep=lambda s: None, at=lambda: clock[0])
    return link


def _port_line(tput, lat, link=None) -> dict:
    return bench.fold_line(tput, lat, batch=rbench.B,
                           capacity=rbench.TABLE_CAP,
                           budget_s=rbench.BUDGET_S, device_kind_="card",
                           power_limit_w=700.0, link=link)


@pytest.mark.parametrize("case", sorted(PACED))
def test_line_keys_and_headline_equal_reference(case, monkeypatch,
                                                tmp_path):
    """The keys: the reference's less :data:`bench.DROPPED_KEYS`, plus
    :data:`bench.ADDED_KEYS` (the budget's likewise, the pulse tier kept
    under ``latency``); the values of the headline, the tiers and the
    canonical latency pick: the reference's."""
    tput, lat = _phases(PACED[case])
    want = _ref_line(monkeypatch, tmp_path, tput, lat)
    got = _port_line(tput, lat, _port_link(tput))
    # wall_s is added by main, after the fold
    assert set(got) | {"wall_s"} == (set(want) - set(bench.DROPPED_KEYS)
                                     ) | set(bench.ADDED_KEYS)
    assert "transport_limited" in want and "tpu_init_attempts" in want
    # the four link keys, now printed: the same probes, state and flaps
    link_keys = {"link_probes", "link_state", "healthy_link_criteria",
                 "window_flaps"}
    assert link_keys <= set(got) and not link_keys & set(bench.DROPPED_KEYS)
    assert got["link_state"] == want["link_state"] == "healthy"
    assert got["window_flaps"] == want["window_flaps"] == 2
    strip = [{k: v for k, v in p.items() if k != "at_s"}
             for p in want["link_probes"]]
    assert [{k: v for k, v in p.items() if k != "at_s"}
            for p in got["link_probes"]] == strip
    assert set(got["healthy_link_criteria"]) == set(
        want["healthy_link_criteria"])
    for k in ("value", "vs_baseline", "chunk_mpps", "compile_s", "backend",
              "h2d_mbps", "device_mpps", "burst_mpps", "single_mpps",
              "mega_mpps", "mega_chunk_mpps", "devloop_chunk_mpps",
              "dispatch_mode", "p50_ms", "p99_ms", "n_lat_records",
              "latency_config", "p99_minus_floor_ms", "stats", "metric",
              "unit", "target_mpps", "target_p99_ms", "batch",
              "table_capacity", "wire_format", "bytes_per_record",
              "latency_backend"):
        assert got.get(k) == want.get(k), k
    assert set(got["latency"]) == set(want["latency"]) | {"pulse"}
    assert set(got["latency"]["budget"]) == set(
        want["latency"]["budget"]) - set(bench.DROPPED_BUDGET_KEYS)
    for k in ("step_ms", "micro", "paced"):
        assert got["latency"][k] == want["latency"][k]
    assert got["power_limit_w"] == 700.0 and got["device_kind"] == "card"
    assert ("p99_ms" in got) == (case != "no_depth0")
    if case != "no_depth0":
        assert got["latency_config"]["sustained"] == (case == "sustained")


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------


def test_cli_bench_smoke_on_the_cpu_prints_one_line():
    rc, out, err = _run(cli.main, ["bench", "--smoke", "--device", "cpu",
                                   "--budget-s", "20"])
    assert rc == 0, err
    [line] = out.splitlines()
    rec = json.loads(line)
    assert rec["value"] > 0 and rec["backend"] == "cpu"
    assert rec["batch"] == 1024 and rec["table_capacity"] == 1 << 12
    assert rec["device_kind"] == "cpu" and rec["power_limit_w"] is None
    assert "error" not in rec and rec["wall_s"] <= 20
    assert not set(rec) & set(bench.DROPPED_KEYS)


def _ref_sharded_headline_keys() -> set:
    """The keys of the reference's ``scripts/shm_stress.py`` sharded
    headline (``out["headline"] = {...}`` in ``run_sharded_suite``)."""
    tree = ast.parse((REPO / "scripts" / "shm_stress.py").read_text())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == "run_sharded_suite")
    for node in ast.walk(fn):
        if (isinstance(node, ast.Assign)
                and isinstance(node.targets[0], ast.Subscript)
                and isinstance(node.value, ast.Dict)
                and node.targets[0].slice.value == "headline"):
            return {k.value for k in node.value.keys}
    raise AssertionError("no headline in the reference's sharded suite")


def test_host_ingest_line_has_the_reference_headline_keys():
    """``--host-ingest 2`` runs the sharded suite of the port's harness
    (1 s per row, the engine row on the CPU) before the card phases."""
    rc, out, err = _run(bench.main, ["--host-ingest", "2",
                                     "--host-ingest-dur", "1", "--smoke",
                                     "--device", "cpu", "--budget-s", "20"])
    assert rc == 0, err
    [line] = out.splitlines()
    hi = json.loads(line)["host_ingest"]
    assert "error" not in hi, hi
    # 2 workers on a host with 2 or more cores: no cores-matched row
    assert set(hi) == _ref_sharded_headline_keys() | {"artifact"}
    assert hi["sharded_lossless_mpps"] > 0 and hi["inline_host_mpps"] > 0
    report = json.loads((REPO / hi["artifact"]).read_text())
    assert report["headline"] == {k: v for k, v in hi.items()
                                  if k != "artifact"}
    assert report["device_kind"] == "cpu" and report["power_limit_w"] is None
    assert report["inline_engine"]["wire"] == "compact16"


def test_host_ingest_child_that_fails_gives_an_error(monkeypatch):
    tput, lat = _phases([])
    monkeypatch.setattr(bench, "phase_throughput", lambda *a, **k: dict(tput))
    monkeypatch.setattr(bench, "phase_latency", lambda *a, **k: dict(lat))
    monkeypatch.setattr(bench, "HOST_INGEST_MODULE",
                        "flowsentryx_tpu_torch.no_such_harness")
    rc, out, err = _run(bench.main, ["--host-ingest", "2", "--smoke",
                                     "--device", "cpu", "--budget-s", "60"])
    assert rc == 0, err
    [line] = out.splitlines()
    rec = json.loads(line)
    assert set(rec["host_ingest"]) == {"error"}
    assert "no_such_harness" in rec["host_ingest"]["error"]
    assert len(rec["host_ingest"]["error"]) <= 500
    assert "error" not in rec and rec["value"] > 0


@pytest.mark.parametrize("which", ["throughput", "latency"])
def test_a_raising_phase_prints_the_line_and_exits_one(which, monkeypatch):
    tput, _ = _phases([])

    def boom(*a, **k):
        raise RuntimeError("the phase broke")

    if which == "throughput":
        monkeypatch.setattr(bench, "phase_throughput", boom)
    else:
        monkeypatch.setattr(bench, "phase_throughput",
                            lambda *a, **k: dict(tput))
        monkeypatch.setattr(bench, "phase_latency", boom)
    rc, out, err = _run(bench.main, ["--smoke", "--device", "cpu",
                                     "--budget-s", "60"])
    assert rc == 1
    [line] = out.splitlines()
    rec = json.loads(line)
    assert "RuntimeError: the phase broke" in rec["error"]
    assert (rec["value"] > 0) == (which == "latency")


# ---------------------------------------------------------------------------
# the healthy-window gate, on a fake clock
# ---------------------------------------------------------------------------


def _probe(state, e2e=None):
    p = {"backend": "cuda", "step_ms": 0.9, "h2d_mbps": 30000.0,
         "dispatch_ms": 0.02, "init_s": 0.4, "state": state}
    if e2e is not None:
        p["e2e_mpps"] = e2e
    return p


GOOD = {"mpps": 17.2, "single_mpps": 17.2}
HEALTHY, DEGRADED = _probe("healthy", 15.0), _probe("degraded")
FLAP = _probe("healthy", 100.0)

#: name: (budget s, probes, phases, retry, want: link state, probes,
#: sleeps, phases run, flaps)
GATE_CASES = {
    "healthy_at_once": (840.0, [HEALTHY], [GOOD], True,
                        ("healthy", 1, [], 1, 0)),
    "degraded_then_healthy": (840.0, [DEGRADED, HEALTHY], [GOOD], True,
                              ("healthy", 2, [45.0], 1, 0)),
    "backoff_grows": (840.0, [DEGRADED] * 3 + [HEALTHY], [GOOD], True,
                      ("healthy", 4, [45.0, 67.5, 101.25], 1, 0)),
    "budget_runs_out": (840.0, [DEGRADED] * 6, [GOOD], True,
                        ("degraded", 4, [45.0, 67.5, 101.25], 1, 0)),
    "no_budget_left": (120.0, [DEGRADED], [GOOD], True,
                       ("degraded", 1, [], 1, 0)),
    "cpu_probes_once": (840.0, [DEGRADED], [GOOD], False,
                        ("degraded", 1, [], 1, 0)),
    "wedged_probe": (120.0, [{"error": "RuntimeError: x"}], [GOOD], True,
                     ("wedged", 1, [], 1, 0)),
    "flap_regates_once": (840.0, [FLAP, FLAP], [GOOD, GOOD], True,
                          ("healthy", 2, [], 2, 2)),
    "flap_without_room": (150.0, [FLAP], [GOOD], True,
                          ("healthy", 1, [], 1, 1)),
    "flap_then_degraded": (840.0, [FLAP, DEGRADED, HEALTHY],
                           [GOOD, {"mpps": 9.0, "single_mpps": 9.0}], True,
                           ("healthy", 3, [45.0], 2, 1)),
}


def _port_gate(budget, probes, phases, retry=True):
    """The port's gate on the fake clock: probes take 10 s, a throughput
    phase 100 s, a sleep its backoff.  ``(link, sleeps, probe timeouts,
    phases run, kept phase)``."""
    probes, phases = list(probes), list(phases)
    clock, sleeps, timeouts, ran = [0.0], [], [], []

    def probe(timeout_s):
        timeouts.append(timeout_s)
        clock[0] += 10.0
        return dict(probes.pop(0))

    def sleep(s):
        sleeps.append(s)
        clock[0] += s

    def run_phase():
        clock[0] += 100.0
        ran.append(phases[0])
        return dict(phases.pop(0))

    link = bench.new_link()
    tput = bench.gated_throughput(
        run_phase, link, lambda: budget - clock[0], budget, probe=probe,
        sleep=sleep, at=lambda: clock[0], retry=retry)
    return link, sleeps, timeouts, ran, tput


def _ref_gate(monkeypatch, tmp_path, probes, phases):
    """The reference's ``main`` at its own 840 s budget on the same fake
    clock (its ``time.perf_counter`` and ``time.sleep`` replaced, its
    ``T_START`` at 0): ``(line, sleeps, probe timeouts, phases run)``."""
    probes, phases = list(probes), list(phases)
    clock, sleeps, timeouts, ran = [0.0], [], [], []
    fake = types.SimpleNamespace(**{k: getattr(time, k) for k in dir(time)
                                    if not k.startswith("_")})
    fake.perf_counter = lambda: clock[0]

    def sleep(s):
        sleeps.append(s)
        clock[0] += s

    fake.sleep = sleep

    def probe(timeout_s=120.0):
        timeouts.append(timeout_s)
        clock[0] += 10.0
        return dict(probes.pop(0))

    lat = _phases(PACED["sustained"])[1]

    def run_phase(phase, *a, **k):
        if phase != "throughput":
            return dict(lat)
        clock[0] += 100.0
        ran.append(phases[0])
        return dict(phases.pop(0))

    monkeypatch.setattr(rbench, "time", fake)
    monkeypatch.setattr(rbench, "T_START", 0.0)
    monkeypatch.setattr(rbench, "BUDGET_S", bench.REF_BUDGET_S)
    line = _ref_main(monkeypatch, tmp_path, probe, run_phase)
    return line, sleeps, timeouts, ran


def _probe_rows(probes):
    return [(p["state"], p.get("e2e_mpps"), p["at_s"]) for p in probes]


@pytest.mark.parametrize("case", sorted(GATE_CASES))
def test_gate_decisions_on_a_fake_clock(case):
    """Probes take 10 s, a phase 100 s, a sleep its backoff: the gate
    keeps the reference's rule with its reserves scaled to the budget,
    and retries a probe only when the backoff and a 30 s probe fit."""
    budget, probes, phases, retry, want = GATE_CASES[case]
    link, sleeps, timeouts, ran, tput = _port_gate(budget, probes, phases,
                                                    retry)
    state, n_probes, want_sleeps, n_phases, flaps = want
    assert link["link_state"] == state
    assert len(link["link_probes"]) == n_probes
    assert sleeps == want_sleeps
    assert len(ran) == n_phases and link["window_flaps"] == flaps
    assert tput["mpps"] == max(p["mpps"] for p in ran)
    # a probe's timeout never reaches into the last pass's reserve (but
    # the first probe always runs, with at least 30 s)
    scale = budget / bench.REF_BUDGET_S
    assert timeouts[0] == max(30.0, min(240.0, budget - 430.0 * scale))
    assert all(30.0 <= t <= 240.0 for t in timeouts)
    assert [p["at_s"] for p in link["link_probes"]] == sorted(
        p["at_s"] for p in link["link_probes"])
    line = _port_line(*_phases([])[:1], None, link)
    assert line["link_state"] == state and line["window_flaps"] == flaps


#: the gate cases at the reference's own budget whose every decision the
#: port shares with it (``budget_runs_out`` is the one divergence below)
REF_GATE_CASES = ("backoff_grows", "degraded_then_healthy",
                  "flap_regates_once", "flap_then_degraded",
                  "healthy_at_once")


@pytest.mark.parametrize("case", REF_GATE_CASES)
def test_gate_decisions_equal_the_references_at_its_budget(
        case, monkeypatch, tmp_path):
    """At 840 s the port's reserves are the reference's (scale 1): on the
    same scripted probes and fake clock, its ``main`` and the port's gate
    take the same probes (state, fed loop, time, timeout), sleep the same
    backoffs, run the same phases and count the same flaps."""
    budget, probes, phases, retry, _ = GATE_CASES[case]
    assert budget == bench.REF_BUDGET_S and retry
    link, sleeps, timeouts, ran, _ = _port_gate(budget, probes, phases)
    line, rsleeps, rtimeouts, rran = _ref_gate(monkeypatch, tmp_path,
                                               probes, phases)
    assert _probe_rows(link["link_probes"]) == _probe_rows(
        line["link_probes"])
    assert link["link_state"] == line["link_state"]
    assert sleeps == rsleeps and timeouts == rtimeouts and ran == rran
    assert link["window_flaps"] == line.get("window_flaps", 0)


def test_gate_retries_only_when_a_probe_still_fits(monkeypatch, tmp_path):
    """Where the two gates part: after four degraded probes (t = 253.75
    s, 586.25 s left, the next backoff 151.875 s) the reference still
    sleeps, because the backoff alone fits above its 430 s reserve, and
    then finds no room for the probe (4.375 s); the port stops at once,
    because the backoff and a 30 s probe do not fit.  Same probes and
    label; one sleep fewer."""
    probes, phases = [DEGRADED] * 6, [GOOD]
    link, sleeps, timeouts, ran, _ = _port_gate(840.0, probes, phases)
    line, rsleeps, rtimeouts, rran = _ref_gate(monkeypatch, tmp_path,
                                               probes, phases)
    assert _probe_rows(link["link_probes"]) == _probe_rows(
        line["link_probes"])
    assert link["link_state"] == line["link_state"] == "degraded"
    assert timeouts == rtimeouts and ran == rran == [GOOD]
    assert sleeps == [45.0, 67.5, 101.25]
    assert rsleeps == sleeps + [151.875]
    # the reference's extra sleep ends with no probe: 840 - 253.75 -
    # 151.875 - 430 s is under its 30 s minimum
    assert 840.0 - 253.75 - 151.875 - 430.0 < 30.0


def test_the_cpu_run_labels_its_window_with_one_probe():
    rc, out, err = _run(bench.main, ["--smoke", "--device", "cpu",
                                     "--budget-s", "20"])
    assert rc == 0, err
    rec = json.loads(out)
    assert rec["link_state"] == "degraded" and rec["window_flaps"] == 0
    [p] = rec["link_probes"]
    assert set(p) <= set(bench.PROBE_KEYS) and "error" not in p
    assert rec["healthy_link_criteria"]["probe"].startswith(
        "scripts/torch_link_probe.py")


def test_without_a_card_exits_one_naming_the_device():
    rc, out, err = _run(bench.main, ["--smoke"])
    assert rc == 1 and out == ""
    assert "no CUDA device" in err


def test_version_equals_reference():
    rc, out, _ = _run(cli.main, ["version"])
    jrc, jout, _ = _run(jcli.main, ["version"])
    assert rc == jrc == 0
    assert json.loads(out) == json.loads(jout) == {"version": "0.1.0"}
