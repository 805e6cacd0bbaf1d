"""``serve --verdict-k`` and ``serve --profile`` of the port's command
line, on the CPU, against the JAX package's engine; and their pre-boot
refusals.

``--verdict-k 0`` is the full-fetch path (every batch's block arrays,
no compact wire) and ``--verdict-k 8`` a wire that overflows on a
multi-source flood; both give the reference engine's stats, blacklist
size and table summary at the same K.  ``--profile DIR`` writes a
``torch.profiler`` trace (a Chrome trace JSON).  Capacity 2^12, B = 256.
"""

import json
from pathlib import Path

import pytest

from flowsentryx_tpu.core import config as jconfig
from flowsentryx_tpu.engine import ArraySource as JArraySource
from flowsentryx_tpu.engine import CollectSink as JCollectSink
from flowsentryx_tpu.engine import Engine as JEngine
from flowsentryx_tpu.models import logreg as jlogreg
from flowsentryx_tpu_torch import cli
from flowsentryx_tpu_torch.engine.traffic import (
    Scenario, TrafficGen, TrafficSpec,
)

REPO = Path(__file__).resolve().parents[1]
INT8 = str(REPO / "artifacts" / "logreg_int8.npz")
B, CAP, SALT = 256, 1 << 12, 0x5EED


@pytest.fixture(scope="module")
def flood(tmp_path_factory):
    """A multi-source flood as a record file, and a config for it."""
    d = tmp_path_factory.mktemp("flood")
    rec = TrafficGen(TrafficSpec(
        scenario=Scenario.UDP_FLOOD_MULTI, rate_pps=1e7, n_attack_ips=64,
        n_benign_ips=400, attack_fraction=0.8, seed=31)).next_records(
            12 * B)
    path = d / "flood.bin"
    path.write_bytes(rec.tobytes())
    conf = d / "fsx.json"
    conf.write_text(json.dumps({
        "batch": {"max_batch": B}, "table": {"capacity": CAP, "salt": SALT},
        "limiter": {"pps_threshold": 200.0, "bps_threshold": 1e9}}))
    return {"rec": rec, "path": str(path), "conf": str(conf)}


def _serve(capsys, *argv):
    rc = cli.main(["serve", "--device", "cpu", "--no-sink-thread", "--json",
                   *argv])
    out = capsys.readouterr()
    return rc, out.out.strip().splitlines(), out.err


@pytest.mark.parametrize("k", [0, 8])
def test_verdict_k_matches_reference(flood, capsys, k):
    rc, out, _ = _serve(capsys, "--records", flood["path"], "--config",
                        flood["conf"], "--artifact", INT8, "--verdict-k",
                        str(k))
    assert rc == 0
    rep = json.loads(out[-1])
    jcfg = jconfig.FsxConfig(
        limiter=jconfig.LimiterConfig(pps_threshold=200.0, bps_threshold=1e9),
        table=jconfig.TableConfig(capacity=CAP, salt=SALT),
        batch=jconfig.BatchConfig(max_batch=B, verdict_k=k))
    jr = JEngine(jcfg, JArraySource(flood["rec"].copy()), JCollectSink(),
                 params=jlogreg.load_params(INT8), sink_thread=False).run()
    assert rep["stats"] == jr.stats
    assert rep["blocked_sources"] == jr.blocked_sources > 8
    assert rep["table"] == jr.table
    rb = rep["readback"]
    assert rb["k_max"] == k and rb["fallback_sinks"] == jr.readback[
        "fallback_sinks"]
    if k == 0:
        # the full block arrays of every batch, no compact wire
        assert rb["mode"] == "full" and rb["wire_bytes"] is None
        assert rb["fallback_sinks"] == rep["batches"]
        assert rb["compact_sinks"] == 0
    else:
        assert rb["mode"] == "compact" and rb["fallback_sinks"] > 0
        assert rb["compact_sinks"] + rb["fallback_sinks"] == rep["batches"]


@pytest.mark.parametrize("k,msg", [
    ("-1", "--verdict-k must be >= 0"),
    (str(B + 1), "must be <= max_batch"),
])
def test_verdict_k_refused_before_boot(flood, capsys, k, msg):
    rc, out, err = _serve(capsys, "--records", flood["path"], "--config",
                          flood["conf"], "--verdict-k", k)
    assert rc == 1 and not out and msg in err


def test_profile_writes_a_trace(flood, tmp_path, capsys):
    prof = tmp_path / "prof"
    rc, out, err = _serve(capsys, "--records", flood["path"], "--config",
                          flood["conf"], "--batches", "4", "--profile",
                          str(prof))
    assert rc == 0 and json.loads(out[-1])["batches"] == 4
    assert "profiler trace written" in err
    traces = sorted(prof.glob("*.pt.trace.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert len(events) > 10
    names = {e.get("name", "") for e in events}
    # the step's host ops are in it (the plain scorer's sort, say)
    assert any(n.startswith("aten::") for n in names)


def test_new_refusals_are_pre_boot(capsys):
    """Each new refusal happens before the engine (and torch's work) is
    built: no report is printed."""
    for argv, msg in (
            (["--verdict-k", "-3"], "--verdict-k must be >= 0"),
            (["--artifact-reload"], "--artifact-reload requires --artifact"),
            (["--sim-kernel-tier", "p.npz", "--feature-ring", "r",
              "--ingest-workers", "2"],
             "--sim-kernel-tier needs the inline record path")):
        rc, out, err = _serve(capsys, *argv)
        assert rc == 1 and not out and msg in err, argv

