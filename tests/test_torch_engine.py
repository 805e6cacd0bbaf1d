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
    # "bench": the reference's root bench.py (it imports the JAX package)
    banned = {"jax", "jaxlib", "flowsentryx_tpu", "optax", "pandas", "bench"}
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
        "('jax', 'jaxlib', 'flowsentryx_tpu', 'optax', 'pandas')]\n"
        "assert not bad, bad\n"
        "print('clean', len(sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("clean")


def test_new_host_modules_are_checked():
    """The import-boundary checks above walk every module of the port:
    the shared-memory transport, the ingest fleet and worker, the arena,
    the checkpoint, table and durable-write modules, the latency plane,
    the sink channel and its timing table, the watchdog, the health
    ladder, the governor, the methodology module, the threefry, the
    distill plan compiler and loader, the served-lane parity check, the
    simulated kernel tier, the pcap reader, the training plane
    (fixture, data, optimizers, QAT, evaluation, stress), the drain ring,
    the staged-shape signature, the compile cache, the cluster (its
    mailboxes, gossip plane, engine runner and supervisor), the cluster
    layout and the partition rules, the mesh, the sharded step, the
    process mesh (its collectives, the leader and followers, the
    launcher), the
    headline benchmark, the static legs (the audit's graph recorder
    and runner, the range prover's interval algebra, seeds, prover,
    registry and runner) and the eBPF plane (the ISA, assembler, loader,
    programs, images, verifier, contracts, blacklist and rule maps, the
    XDP drive, the header generator, the scorer emulator, the
    containment bridge and the kernel-map verbs), the host-ingest stress
    harness, the port's lint gate (``scripts/torch_lint.py``), the link
    rule and its probe (``core/linkhealth.py``,
    ``scripts/torch_link_probe.py``) and the paced scale-out comparison
    (``scripts/torch_cluster_bench.py``) and the training phases' full
    recipes (``scripts/torch_train_stress_phase.py``) are among them."""
    names = {".".join(p.relative_to(REPO).with_suffix("").parts)
             for p in _port_sources()}
    for m in ("core.wire", "core.durable", "engine.shm", "engine.arena",
              "engine.checkpoint", "engine.table", "ingest.sharded",
              "ingest.worker", "ingest.__init__", "core.prng",
              "engine.metrics", "engine.watchdog", "engine.health",
              "engine.predict", "sync.__init__", "sync.channel",
              "sync.tuning", "benchmarks", "distill.__init__",
              "distill.plan", "distill.sim", "engine.pcap",
              "distill.parity", "train.__init__", "train.fixture",
              "train.data", "train.optim", "train.qat", "train.evaluate",
              "train.stress", "fused.__init__", "fused.device_loop",
              "core.signature", "engine.compile_cache",
              "cluster.__init__", "cluster.mailbox", "cluster.gossip",
              "cluster.runner", "cluster.supervisor", "parallel.__init__",
              "parallel.layout", "parallel.mesh", "parallel.step",
              "parallel.exchange", "parallel.follower", "parallel.launch",
              "bench", "audit.__init__", "audit.graph", "audit.runner",
              "ranges.__init__", "ranges.interval", "ranges.seeds",
              "ranges.prover", "ranges.registry", "ranges.runner",
              "bpf.__init__", "bpf.isa", "bpf.asm", "bpf.loader",
              "bpf.progs", "bpf.image", "bpf.verifier", "bpf.contracts",
              "bpf.blacklist", "bpf.rules", "bpf.xdp", "core.codegen",
              "distill.emulate", "ranges.bridge", "kernel_verbs",
              "shm_stress"):
        assert f"flowsentryx_tpu_torch.{m}" in names, m
    assert "scripts.torch_lint" in names
    assert "flowsentryx_tpu_torch.core.linkhealth" in names
    for script in ("torch_link_probe", "torch_cluster_bench",
                   "torch_cluster_bench_phase", "torch_train_stress_phase"):
        assert f"scripts.{script}" in names, script


def test_ebpf_plane_imports_no_torch():
    """The eBPF plane, the header generator, the emulator and the
    kernel-map verbs read the schema's numpy half: ``fsx check``,
    ``codegen`` and the pinned-map reads of ``status``/``monitor`` run
    without torch, and importing them makes no ``bpf(2)`` call."""
    mods = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts)
        for p in (REPO / "flowsentryx_tpu_torch" / "bpf").glob("*.py")
        if p.name != "__init__.py") + [
        "flowsentryx_tpu_torch.core.codegen",
        "flowsentryx_tpu_torch.distill.emulate",
        "flowsentryx_tpu_torch.kernel_verbs"]
    code = (
        "import importlib, sys\n"
        "from flowsentryx_tpu_torch.bpf import loader\n"
        "calls = []\n"
        "loader._bpf = lambda *a: calls.append(a)\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] == 'torch']\n"
        "assert not bad, bad[:5]\n"
        "assert not calls, calls\n"
        "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("clean")


def test_engine_over_fsxd_sim_blocks_attackers(tmp_path):
    """The port's CPU engine in the daemon loop: ``fsxd --sim`` floods a
    48-byte feature ring for 4 s at a paced 2e5 records/s (unpaced it
    would spin a core for nothing), the engine serves it and writes
    blocks to the verdict ring, and the daemon suppresses the blocked
    sources.
    Bounded on its own: the daemon's ``--duration``, the engine's
    ``max_seconds`` and a 30 s cap on the daemon's exit."""
    from flowsentryx_tpu_torch.engine.shm import ShmRingSource, ShmVerdictSink

    # the Makefile's build into a directory of this test's own (a
    # concurrent test may be building daemon/build/ at the same time)
    r = subprocess.run(["make", "-C", str(REPO / "daemon"),
                        f"BUILD={tmp_path / 'build'}"],
                       capture_output=True, text=True, timeout=300)
    fsxd = tmp_path / "build" / "fsxd"
    assert r.returncode == 0 and fsxd.exists(), r.stderr
    fring, vring = str(tmp_path / "fring"), str(tmp_path / "vring")
    proc = subprocess.Popen(
        [str(fsxd), "--sim", "--pace", "--duration", "4", "--rate", "2e5",
         "--attack-ips", "16", "--attack-fraction", "0.8",
         "--feature-ring", fring, "--verdict-ring", vring, "--seed", "7"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        cfg = config.FsxConfig(
            table=config.TableConfig(capacity=1 << 12),
            batch=config.BatchConfig(max_batch=512, deadline_us=2000,
                                     readback_depth=2),
            limiter=config.LimiterConfig(pps_threshold=300.0,
                                         bps_threshold=1e12, block_s=1e6))
        sink = ShmVerdictSink(vring)
        eng = Engine(cfg, ShmRingSource(fring), sink, device="cpu")
        rep = eng.run(max_seconds=5)
    finally:
        out, _ = proc.communicate(timeout=30)
    stats = json.loads(out.strip().splitlines()[-1])
    assert rep.stats["dropped"] > 0
    assert stats["verdicts"] > 0 and stats["blacklisted"] > 0
    assert stats["suppressed"] > 0
    assert sink.dropped == 0
    assert 0 < rep.records < stats["produced"]
    assert sink.t0_ns == eng.batcher.t0_ns > 0
