"""``fsx audit`` of the port against the reference's.

The port's audit stages each step variant as the aten graph of one
all-masked call (and, on the card, its captured CUDA graph); the
reference stages jaxprs and HLO.  Held equal on what both report: the
variant set and names, the verdict, the steady-state D2H of the wire,
the step's outputs (the wire is int32 bit patterns in the port, uint32
in the reference), the sharded step's exchange census, and the skip
notes without a mesh.  Planted negatives (a float64 leak, a fresh table,
an ``.item()`` mid-step, a carry whose dtype changes, an extra
``all_to_all``, a stale allowlist entry) must each be refused with a
finding that names its op or leaf, also at engine boot, through
``FSX_AUDIT=1`` and through the CLI.
"""

import json

import pytest
import torch

from flowsentryx_tpu.audit import runner as jrunner
from flowsentryx_tpu.core.config import BatchConfig as JBatchConfig
from flowsentryx_tpu.core.config import FsxConfig as JFsxConfig
from flowsentryx_tpu.core.config import TableConfig as JTableConfig
from flowsentryx_tpu.parallel import make_mesh as jmake_mesh
from flowsentryx_tpu_torch import cli
from flowsentryx_tpu_torch.audit import AuditError, graph, runner
from flowsentryx_tpu_torch.core import schema
from flowsentryx_tpu_torch.core.config import BatchConfig, FsxConfig, TableConfig
from flowsentryx_tpu_torch.engine import Engine, NullSink, TrafficSource, TrafficSpec
from flowsentryx_tpu_torch.models import logreg, registry
from flowsentryx_tpu_torch.ops import fused, graph as cgraph
from flowsentryx_tpu_torch.parallel import make_mesh
from flowsentryx_tpu_torch.parallel import step as pstep

CAP, B, K = 1 << 12, 256, 64
CFG = FsxConfig(table=TableConfig(capacity=CAP),
                batch=BatchConfig(max_batch=B, verdict_k=K))
JCFG = JFsxConfig(table=JTableConfig(capacity=CAP),
                  batch=JBatchConfig(max_batch=B, verdict_k=K))


@pytest.fixture(scope="module", autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def reports():
    """One audit of each package over all seven variants at a 4-shard
    mesh, mega_n=2 and a 2-deep ring (staging is the expensive part)."""
    ref = jrunner.run_audit(JCFG, mesh=jmake_mesh(4), mega_n=2,
                            device_loop=2)
    port = runner.run_audit(CFG, mesh=make_mesh(4, devices=["cpu"] * 4),
                            mega_n=2, device_loop=2, device="cpu")
    return ref, port


# -- against the reference ---------------------------------------------------


def test_variant_names_and_verdicts_match(reports):
    ref, port = reports
    assert [v.name for v in port.variants] == [v.name for v in ref.variants]
    assert [v.name for v in port.variants] == [
        "raw", "compact", "sharded", "megastep", "sharded_megastep",
        "device_loop@2x2", "sharded_device_loop@2x2"]
    assert ref.ok
    assert port.ok, [str(f) for v in port.variants for f in v.findings]
    assert [v.ok for v in port.variants] == [v.ok for v in ref.variants]


def test_steady_state_d2h_is_the_wire(reports):
    ref, port = reports
    for j, t in zip(ref.variants, port.variants):
        assert t.wire_words == j.wire_words == 2 * K + 4, t.name
        assert t.steady_state_d2h_bytes == j.steady_state_d2h_bytes == 528


#: The reference's u32 outputs as the port holds them: the wire and the
#: block keys as int32 bit patterns, the route-drop count in int64.
PORT_DTYPE = {("out.wire", "uint32"): "int32",
              ("out.block_key", "uint32"): "int32",
              ("out.route_drop", "uint32"): "int64"}


def _out_leaves(v, single: bool):
    out = {}
    for o in v.outputs:
        if not o["name"].startswith("out."):
            continue
        if single and o["name"] == "out.route_drop":
            continue    # the port's constant 0 on one shard
        dt = PORT_DTYPE.get((o["name"], o["dtype"]), o["dtype"])
        out[o["name"]] = (o["shape"], dt)
    return out


def test_outputs_match_reference(reports):
    ref, port = reports
    for j, t in zip(ref.variants, port.variants):
        single = not t.name.startswith("sharded")
        assert _out_leaves(t, single) == _out_leaves(j, single), t.name
    # the port's wire is int32 bit patterns where the reference's is u32
    wire = [o for o in port.variants[1].outputs if o["name"] == "out.wire"]
    assert wire[0]["dtype"] == "int32"
    assert runner.WIRE_NOTE in port.notes


def test_sharded_exchange_census_matches_reference(reports):
    ref, port = reports
    for j, t in zip(ref.variants, port.variants):
        assert t.collectives == j.collectives, t.name
    assert port.variants[2].collectives == {
        "all_to_all": 2, "psum": 2, "pmax": 1, "all_gather": 2,
        "axis_index": 1}


def test_skip_notes_without_a_mesh():
    ref = jrunner.run_audit(JCFG, mega_n=0)
    port = runner.run_audit(CFG, mega_n=0, device="cpu")
    assert [v.name for v in port.variants] == [v.name for v in ref.variants]
    assert [v.name for v in port.variants] == ["raw", "compact"]

    def skips(notes):
        return [n.split(" (")[0] for n in notes if "skipped:" in n
                and "census" not in n]
    assert skips(port.notes) == skips(ref.notes) == [
        "sharded variants skipped: need a >1-device mesh",
        "megastep variants skipped: mega_n < 1"]


# -- the port's own contracts ------------------------------------------------


def test_every_variant_updates_its_carry_in_place(reports):
    _, port = reports
    for v in port.variants:
        assert v.donation["in_place"] == runner.CARRY_NAMES, v.name
        assert v.inplace["copies"] == 0, v.name


def test_float64_only_in_the_allowlisted_emulation(reports):
    _, port = reports
    assert not port.registry_findings
    for v in port.variants:
        assert "complex64" not in v.dtypes, v.name
    # the float32 rounding emulation does compute in float64
    assert port.variants[1].dtypes.get("float64", 0) > 0


def test_ladder_rungs_read_the_smallest_rungs_trace():
    rep = runner.run_audit(CFG, mega_n=8, mega_sizes=(8, 4, 2),
                           variants=("megastep",), device="cpu")
    assert rep.ok, [str(f) for v in rep.variants for f in v.findings]
    assert [v.name for v in rep.variants] == [
        "megastep@8", "megastep@4", "megastep@2"]
    assert [v.traced_as for v in rep.variants] == [
        "megastep@2", "megastep@2", ""]
    assert rep.variants[2].trace_s > 0
    assert len({v.trace_s for v in rep.variants}) == 1   # one trace
    assert [v.steady_state_d2h_bytes for v in rep.variants] == [528] * 3
    assert rep.variants[0].outputs[-2]["shape"] == [8]    # out.now
    assert runner.TRACE_RULE in rep.notes


def test_boot_audit_caches_per_shape():
    kw = dict(wire=schema.WIRE_COMPACT16, mesh=None, mega_n=0,
              device="cpu")
    cfg = FsxConfig(table=TableConfig(capacity=CAP, salt=0x5151),
                    batch=BatchConfig(max_batch=B, verdict_k=K))
    first = runner.boot_audit(cfg, **kw)
    assert first is not None and first.ok
    caps = cgraph.CAPTURES
    assert runner.boot_audit(cfg, **kw) is None
    assert cgraph.CAPTURES == caps


# -- planted negatives -------------------------------------------------------


def _staged(fn, sharded=False, name="planted"):
    mesh = make_mesh(4, devices=["cpu"] * 4) if sharded else None

    def mk():
        table = (pstep.make_sharded_table(CFG, mesh) if sharded
                 else schema.make_table(CAP))
        return (table, schema.make_stats(), logreg.golden_params(),
                torch.zeros(B + 1, schema.COMPACT_RECORD_WORDS,
                            dtype=torch.int32))
    return runner.StagedVariant(name, fn, mk, verdict_k=K,
                                expect_sharded=sharded, quantized=False,
                                n_shards=4 if sharded else 1,
                                trace_key=name), mesh


def _base(sharded=False):
    quant = runner._quant_for(logreg.golden_params())
    if sharded:
        return pstep.make_sharded_compact_step(
            CFG, logreg.classify_batch_int8_matmul,
            make_mesh(4, devices=["cpu"] * 4), **quant)
    return fused.make_compact_step(CFG, logreg.classify_batch_int8_matmul,
                                   **quant)


def _refused(rep, contract):
    hits = [f for f in rep.findings if f.contract == contract]
    assert not rep.ok and hits, [str(f) for f in rep.findings]
    return hits


def test_planted_float64_leak():
    base = _base()

    def leaky(table, stats, params, raw):
        t, s, out = base(table, stats, params, raw)
        return t, s, out._replace(now=(out.now.double() * 2.0).float())
    sv, _ = _staged(leaky)
    hits = _refused(runner.audit_variant(sv, CFG), "dtype")
    assert "aten._to_copy.default" in hits[0].where
    assert "test_torch_audit.py:leaky" in hits[0].where


def test_planted_fresh_table():
    base = _base()

    def fresh(table, stats, params, raw):
        t, s, out = base(table, stats, params, raw)
        return t._replace(key_rows=t.key_rows.clone()), s, out
    sv, _ = _staged(fresh)
    rep = runner.audit_variant(sv, CFG)
    assert [f.where for f in _refused(rep, "donation")] == ["table.key_rows"]
    assert "aten.clone.default" in _refused(rep, "inplace")[0].where


def test_planted_item_mid_step():
    base = _base()

    def syncing(table, stats, params, raw):
        t, s, out = base(table, stats, params, raw)
        if out.now.item() > 1e30:
            raise AssertionError
        return t, s, out
    sv, _ = _staged(syncing)
    hits = _refused(runner.audit_variant(sv, CFG), "transfer")
    assert "aten._local_scalar_dense.default" in hits[0].where


def test_planted_carry_dtype_change():
    base = _base()

    def drifting(table, stats, params, raw):
        t, s, out = base(table, stats, params, raw)
        return t, s._replace(allowed=s.allowed.to(torch.int32)), out
    sv, _ = _staged(drifting)
    hits = _refused(runner.audit_variant(sv, CFG), "retrace")
    assert hits[0].where == "stats.allowed"


def test_planted_extra_all_to_all():
    base = _base(sharded=True)

    def rerouting(table, stats, params, raw):
        pstep._all_to_all([raw[:2, None]] * 4)
        return base(table, stats, params, raw)
    sv, _ = _staged(rerouting, sharded=True)
    rep = runner.audit_variant(sv, CFG)
    hits = _refused(rep, "collectives")
    assert hits[0].where == "parallel/step.py:_all_to_all"
    assert rep.collectives["all_to_all"] == 3


def test_kernel_launch_is_a_node_over_its_operands():
    """A launch hands its operands to the recorder through the launch
    counter: a ``kernel:<name>`` node in op order, framed at its wrapper,
    whose output the next op reads; counted into the trace, never into
    ``LAUNCHES``."""
    from flowsentryx_tpu_torch.ops import kernels

    def wrapper(x):
        y = x + 1
        out = torch.empty(3)
        kernels._count("score_int8", out, y)
        return out * 2
    before = dict(kernels.LAUNCHES)
    tr, _ = graph.trace_call(wrapper, (torch.zeros(3),), ("x",))
    assert kernels.LAUNCHES == before
    assert tr.launches["score_int8"] == 1
    ops = [n.op for n in tr.nodes]
    k = tr.nodes[ops.index("kernel:score_int8")]
    add = tr.nodes[ops.index("aten.add.Tensor")]
    mul = tr.nodes[ops.index("aten.mul.Tensor")]
    assert add.idx < k.idx < mul.idx
    assert [a.vid for a in k.args] == add.outs
    assert k.outs[0] in mul.ins
    assert k.frames[0] == ("tests/test_torch_audit.py", "wrapper")


def test_exchange_sites_report_their_calls():
    """Each exchange helper reports its call and per-shard operand sizes
    to this thread's record only."""
    import threading

    calls = []
    with pstep.recording_exchanges(calls):
        pstep._psum([torch.zeros(6)] * 4)
        list(pstep._axis_index(4))
        pstep._all_to_all([torch.zeros(2, 3)] * 4,
                          [torch.zeros(2, 3, 4)] * 4)
        t = threading.Thread(target=pstep._pmax, args=([torch.zeros(())],))
        t.start()
        t.join()
    pstep._all_gather([torch.zeros(64)] * 4)   # no record open
    assert calls == [("psum", [6] * 4), ("axis_index", []),
                     ("all_to_all", [6] * 4 + [24] * 4)]


def test_planted_stale_allowlist_entries():
    gone = graph.F64Ok("gone", "flowsentryx_tpu_torch/core/device.py",
                       "deleted_function_xyz", "planted")
    unused = graph.F64Ok("unused", "flowsentryx_tpu_torch/core/device.py",
                         "xla_erf_inv", "planted")
    f = graph.audit_f64_allowlist((gone, unused), {"gone": 3})
    assert [x.where for x in f] == ["gone", "unused"]
    assert all("stale F64_OK" in x.reason for x in f)


def test_planted_step_fails_the_audit_report():
    """A float-only scorer for an int8 config is a quantized finding."""
    cfg = FsxConfig(table=TableConfig(capacity=CAP),
                    batch=BatchConfig(max_batch=B, verdict_k=K))
    rep = runner.run_audit(cfg, variants=("compact",), device="cpu",
                           classify=logreg.classify_float)
    assert not rep.ok
    assert [f.contract for f in rep.variants[0].findings] == ["quantized"]


# -- engine boot, FSX_AUDIT=1, the CLI ------------------------------------------

PLANT = "planted_f64_leak"


def _leaky_score(params, x):
    return logreg.classify_float(params, x) + (x.double().sum(1) * 0).float()


@pytest.fixture
def planted_model(monkeypatch):
    monkeypatch.setitem(registry._REGISTRY, PLANT, registry.ModelSpec(
        name=PLANT, init=logreg.golden_params, classify_batch=_leaky_score))
    return PLANT


def _engine(model, **kw):
    cfg = FsxConfig(table=TableConfig(capacity=CAP, salt=0x77),
                    batch=BatchConfig(max_batch=B, verdict_k=K))
    import dataclasses
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, name=model))
    return Engine(cfg, TrafficSource(TrafficSpec(rate_pps=1e5, seed=3),
                                     total=4 * B), NullSink(),
                  device="cpu", sink_thread=False, **kw)


def test_engine_refuses_the_planted_step(planted_model):
    with pytest.raises(AuditError) as e:
        _engine(planted_model, audit=True)
    assert any("aten._to_copy.default" in f.where
               and "_leaky_score" in f.where for f in e.value.findings)


def test_fsx_audit_env_refuses_the_planted_step(planted_model, monkeypatch):
    monkeypatch.setenv("FSX_AUDIT", "1")
    with pytest.raises(AuditError):
        _engine(planted_model)
    monkeypatch.setenv("FSX_AUDIT", "0")
    _engine(planted_model)      # off: boots


def test_engine_boots_with_audit_and_reports_it():
    eng = _engine("logreg_int8", audit=True, mega_n=2)
    eng.warm()
    assert "audit_s" in eng._boot and "audit_cache_hit" in eng._boot
    rep = eng.run()
    assert rep.batches == 4 and rep.boot["audit_s"] >= 0


def test_cli_audit_and_serve_exit_codes(planted_model, tmp_path, capsys):
    assert cli.main(["audit", "--quick", "--mega", "0",
                     "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "fsx audit: compact: OK" in out and "= [132]-word wire)" in out
    assert out.rstrip().endswith("fsx audit: PASS")
    conf = tmp_path / "plant.json"
    conf.write_text(json.dumps({"model": {"name": planted_model}}))
    assert cli.main(["audit", "--quick", "--mega", "0", "--device", "cpu",
                     "--config", str(conf)]) == 1
    err = capsys.readouterr()
    assert "FAIL" in err.out and "_leaky_score" in err.err
    assert cli.main(["serve", "--audit", "--device", "cpu", "--config",
                     str(conf), "--table-capacity", str(CAP),
                     "--packets", "100"]) == 1
    assert "refusing to serve" in capsys.readouterr().err
    assert cli.main(["audit", "--quick", "--device-loop", "2", "--mega",
                     "0", "--device", "cpu"]) == 1
