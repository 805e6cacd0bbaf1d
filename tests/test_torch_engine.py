"""The port's serving engine and CLI against the JAX engine, and the
port's import boundary (it never imports jax or the reference package)."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from flowsentryx_tpu.core import config as jconfig
from flowsentryx_tpu.engine import CollectSink as JCollectSink
from flowsentryx_tpu.engine import Engine as JEngine
from flowsentryx_tpu.engine import TrafficSource as JTrafficSource
from flowsentryx_tpu.engine.traffic import Scenario as JScenario
from flowsentryx_tpu.engine.traffic import TrafficSpec as JTrafficSpec
from flowsentryx_tpu.models import logreg as jlogreg
from flowsentryx_tpu_torch import cli
from flowsentryx_tpu_torch.core import config
from flowsentryx_tpu_torch.engine import (
    CollectSink, Engine, Scenario, TrafficSource, TrafficSpec,
)
from flowsentryx_tpu_torch.models import logreg

REPO = Path(__file__).resolve().parents[1]
ARTIFACT = str(REPO / "artifacts" / "logreg_int8.npz")
B, CAP = 512, 1 << 12


def _cfgs(verdict_k=64):
    t = dict(capacity=CAP, salt=0x1234)
    bt = dict(max_batch=B, verdict_k=verdict_k)
    return (jconfig.FsxConfig(table=jconfig.TableConfig(**t),
                              batch=jconfig.BatchConfig(**bt)),
            config.FsxConfig(table=config.TableConfig(**t),
                             batch=config.BatchConfig(**bt)))


@pytest.mark.parametrize("scenario,artifact,verdict_k", [
    ("syn_benign_mix", False, 64), ("syn_benign_mix", True, 64),
    ("mixed_l34_1m", True, 64),
    ("syn_benign_mix", True, 4),    # wire overflow -> full-array fetch
    ("syn_benign_mix", True, 0),    # no compact wire at all
])
def test_cpu_engine_matches_reference_engine(scenario, artifact, verdict_k):
    jcfg, tcfg = _cfgs(verdict_k)
    total = 24 * B + 77            # a ragged last batch
    spec = dict(rate_pps=1e5, seed=7)
    jsink, tsink = JCollectSink(), CollectSink()
    je = JEngine(jcfg, JTrafficSource(JTrafficSpec(
        scenario=JScenario(scenario), **spec), total=total), jsink,
        params=jlogreg.load_params(ARTIFACT) if artifact else None,
        sink_thread=False)
    te = Engine(tcfg, TrafficSource(TrafficSpec(
        scenario=Scenario(scenario), **spec), total=total), tsink,
        params=logreg.load_params(ARTIFACT) if artifact else None,
        device="cpu")
    jr, tr = je.run(), te.run()
    assert tr.batches == jr.batches == 25
    assert tr.records == jr.records == total
    assert tr.stats == jr.stats
    assert tsink.blocked == jsink.blocked
    assert tr.blocked_sources == jr.blocked_sources
    assert tr.table == jr.table
    assert tr.readback["compact_sinks"] + tr.readback["fallback_sinks"] \
        == tr.batches
    assert tr.readback["fallback_sinks"] == jr.readback["fallback_sinks"]
    if artifact and scenario == "syn_benign_mix":
        assert tr.blocked_sources > 0   # the blacklist path was exercised
    if verdict_k == 4:
        assert tr.readback["fallback_sinks"] > 0


def test_warm_changes_nothing():
    _, tcfg = _cfgs()
    e = Engine(tcfg, TrafficSource(TrafficSpec(), total=B), CollectSink(),
               device="cpu")
    e.warm()
    assert e.stats.to_dict()["batches"] == 0
    assert not e.table.key.any()
    assert e.run().stats["allowed"] == B


def test_engine_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tcfg = _cfgs()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(tcfg, TrafficSource(TrafficSpec(), total=B), CollectSink())


def test_params_from_numpy_round_trip():
    jp = jlogreg.load_params(ARTIFACT)
    as_np = {k: np.asarray(v) for k, v in jp._asdict().items()}
    tp = logreg.params_from_numpy(as_np)
    back = logreg.params_to_numpy(tp)
    assert back.keys() == as_np.keys()
    for k in as_np:
        np.testing.assert_array_equal(back[k], as_np[k])
        assert back[k].dtype == as_np[k].dtype
    v1 = {k: v for k, v in as_np.items() if k != "log1p"}
    assert int(logreg.params_from_numpy(v1).log1p) == 0


def test_cli_serve_cpu(capsys):
    rc = cli.main(["serve", "--device", "cpu", "--table-capacity", "4096",
                   "--batches", "3", "--json"])
    assert rc == 0
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rep["batches"] == 3 and rep["records"] == 3 * 2048
    assert rep["stats"]["allowed"] + rep["stats"]["dropped"] == rep["records"]
    assert rep["device"]["type"] == "cpu"


def _port_sources():
    return sorted((REPO / "flowsentryx_tpu_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py"] + sorted((REPO / "scripts").glob("torch_*.py"))


def test_port_never_imports_jax_or_reference_ast():
    banned = {"jax", "jaxlib", "flowsentryx_tpu"}
    for path in _port_sources():
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                roots = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom) and not node.level:
                roots = [(node.module or "").split(".")[0]]
            else:
                continue
            assert not banned & set(roots), f"{path}:{node.lineno}"


def test_port_never_imports_jax_or_reference_at_runtime():
    mods = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts)
        for p in (REPO / "flowsentryx_tpu_torch").rglob("*.py")
        if p.name != "__init__.py")
    code = (
        "import importlib, sys, runpy\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "runpy.run_path('chip_smoke.py', run_name='not_main')\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flowsentryx_tpu')]\n"
        "assert not bad, bad\n"
        "print('clean', len(sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("clean")
