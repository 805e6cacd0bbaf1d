"""The distilled kernel tier's host side in the port against the JAX
package's: the plan compiler and loader, the integer scorer, the
packing, the served-lane band check, the simulated tier in front of the
engine, ``serve --sim-kernel-tier`` and ``fsx distill``.

The plan is the reference's ``compile_plan`` of
``artifacts/logreg_int8.npz``; both packages load it, band ≥ 10k feature
rows (every quantization boundary and its neighbours included) to the
same codes, and write the same bytes (``pack_blob``, every ``.npz``
entry of ``save_plan``).  The committed
``artifacts/logreg_int8_plan.npz`` is recompiled here and must equal
that.  The port's own ``compile_plan`` (on the CPU: the plain versions of
the scorer's stages) must give the reference's plan: the same blob and
every ``meta`` key but ``backend``.  All comparisons are exact.
Capacity 2^12, B = 256.
"""

import json
import zipfile
from pathlib import Path

import numpy as np
import pytest
import torch

from flowsentryx_tpu.core import config as jconfig
from flowsentryx_tpu.core import schema as jschema
from flowsentryx_tpu.distill import SimKernelTier as JSimKernelTier
from flowsentryx_tpu.distill import plan as jplan
from flowsentryx_tpu.engine import ArraySource as JArraySource
from flowsentryx_tpu.engine import CollectSink as JCollectSink
from flowsentryx_tpu.engine import Engine as JEngine
from flowsentryx_tpu.models import logreg as jlogreg
from flowsentryx_tpu_torch import cli
from flowsentryx_tpu_torch.core import config, schema, wire
from flowsentryx_tpu_torch.distill import SimKernelTier, plan
from flowsentryx_tpu_torch.engine import ArraySource, CollectSink, Engine
from flowsentryx_tpu_torch.engine.shm import ShmRing
from flowsentryx_tpu_torch.engine.traffic import (
    Scenario, TrafficGen, TrafficSpec,
)
from flowsentryx_tpu_torch.models import logreg

REPO = Path(__file__).resolve().parents[1]
INT8 = str(REPO / "artifacts" / "logreg_int8.npz")
COMMITTED_PLAN = str(REPO / "artifacts" / "logreg_int8_plan.npz")
B, CAP = 256, 1 << 12


@pytest.fixture(autouse=True, scope="module")
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def plans(tmp_path_factory):
    """The reference's plan of the shipped artifact, saved by the
    reference and loaded by both packages."""
    ref = jplan.compile_plan(jlogreg.load_params(INT8), t_lo=0.1, t_hi=0.9)
    path = jplan.save_plan(ref, str(tmp_path_factory.mktemp("plan")
                                    / "plan.npz"))
    return {"ref": ref, "path": path, "jload": jplan.load_plan(path),
            "port": plan.load_plan(path)}


def _corpus(p, n_random=12_000, seed=11) -> np.ndarray:
    """``[N, 8]`` u32 feature rows: random rows over the whole u32 range
    and over small values, then for every feature each of its
    quantization boundaries, one below and one above, in that column
    (the other columns random), and the saturation corners."""
    rng = np.random.default_rng(seed)
    rows = [rng.integers(0, 1 << 32, (n_random // 2, 8), dtype=np.uint64),
            rng.integers(0, 1 << 12, (n_random // 2, 8), dtype=np.uint64)]
    for i in range(wire.NUM_FEATURES):
        b = p.bounds_m1[i].astype(np.int64)
        b = b[b != plan.U32_MAX]
        edges = np.unique(np.clip(np.concatenate([b - 1, b, b + 1, b + 2]),
                                  0, plan.U32_MAX))
        r = rng.integers(0, 1 << 32, (len(edges), 8), dtype=np.uint64)
        r[:, i] = edges
        rows.append(r)
    rows.append(np.array([[0] * 8, [plan.U32_MAX] * 8], np.uint64))
    return np.concatenate(rows).astype(np.uint32)


def test_bands_equal_reference_on_boundaries(plans):
    feat = _corpus(plans["ref"])
    assert len(feat) >= 10_000
    want = plans["ref"].bands(feat)
    got = plans["port"].bands(feat)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(plans["port"].ranks(feat),
                                  plans["ref"].ranks(feat))
    np.testing.assert_array_equal(plans["port"].acc(feat),
                                  plans["ref"].acc(feat))
    # every band occurs, so the comparison covers each split
    assert set(np.unique(want)) == {wire.ML_BAND_PASS, wire.ML_BAND_ESCALATE,
                                    wire.ML_BAND_DROP}


def test_band_and_model_map_constants_equal_reference():
    for name in ("ML_BAND_PASS", "ML_BAND_ESCALATE", "ML_BAND_DROP",
                 "ML_BAND_DISABLED", "ML_BOUNDS_PER_FEATURE",
                 "ML_MODEL_VALID_OFFSET", "ML_MODEL_FLAGS_OFFSET",
                 "ML_MODEL_ACC_DROP_OFFSET", "ML_MODEL_ACC_PASS_OFFSET",
                 "ML_MODEL_W_OFFSET", "ML_MODEL_QBASE_OFFSET",
                 "ML_MODEL_BOUNDS_OFFSET", "ML_MODEL_SIZE"):
        assert getattr(wire, name) == getattr(jschema, name), name
        assert getattr(schema, name) == getattr(wire, name), name


def _entries(path) -> dict:
    with zipfile.ZipFile(path) as z:
        return {n: z.read(n) for n in z.namelist()}


def test_pack_blob_and_save_plan_byte_equal(plans, tmp_path):
    assert plan.pack_blob(plans["port"]) == jplan.pack_blob(plans["ref"])
    path = plan.save_plan(plans["port"], str(tmp_path / "port_plan"))
    assert path.endswith(".npz")
    # every entry's bytes (a zip member's timestamp is not content)
    assert _entries(path) == _entries(plans["path"])
    blob = plan.pack_blob(plans["port"])
    back, jback = plan.unpack_blob(blob), jplan.unpack_blob(blob)
    for f in ("w", "qbase", "bounds_m1"):
        np.testing.assert_array_equal(getattr(back, f), getattr(jback, f))
    assert (back.acc_drop, back.acc_pass, back.w_sum) == (
        jback.acc_drop, jback.acc_pass, jback.w_sum)
    assert back.to_json() == jback.to_json() | {"thresholds": {
        "t_lo": back.t_lo, "t_hi": back.t_hi}}


def test_loader_refusals_match_reference(plans, tmp_path):
    for blob in (b"\0" * 10, b"\0" * wire.ML_MODEL_SIZE):
        with pytest.raises(plan.DistillError) as e:
            plan.unpack_blob(blob)
        with pytest.raises(jplan.DistillError) as je:
            jplan.unpack_blob(blob)
        assert str(e.value) == str(je.value)
    old = tmp_path / "v0.npz"
    z = dict(np.load(plans["path"]))
    z.pop("plan_schema_version")
    np.savez(old, **z)
    with pytest.raises(plan.DistillError) as e:
        plan.load_plan(str(old))
    with pytest.raises(jplan.DistillError) as je:
        jplan.load_plan(str(old))
    assert str(e.value) == str(je.value)


def test_committed_plan_is_the_reference_compile(tmp_path):
    """``artifacts/logreg_int8_plan.npz`` (read on the card, which has no
    JAX) is the reference's ``fsx distill`` of ``logreg_int8.npz``:
    recompiled here, every entry equal."""
    ref = jplan.compile_plan(jlogreg.load_params(INT8), t_lo=0.1, t_hi=0.9)
    fresh = jplan.save_plan(ref, str(tmp_path / "plan.npz"))
    assert _entries(fresh) == _entries(COMMITTED_PLAN)
    p = plan.load_plan(COMMITTED_PLAN)
    assert plan.pack_blob(p) == jplan.pack_blob(ref)


def _cfgs():
    t = dict(capacity=CAP, salt=0x5EED)
    bt = dict(max_batch=B)
    return (jconfig.FsxConfig(table=jconfig.TableConfig(**t),
                              batch=jconfig.BatchConfig(**bt)),
            config.FsxConfig(table=config.TableConfig(**t),
                             batch=config.BatchConfig(**bt)))


def _stream(n=24 * B + 31):
    return TrafficGen(TrafficSpec(
        scenario=Scenario.UDP_FLOOD_MULTI, rate_pps=1e6, n_attack_ips=16,
        n_benign_ips=400, attack_fraction=0.7, seed=21)).next_records(n)


def _no_hz(esc):
    return {k: v for k, v in esc.items() if k != "kernel_drop_hz"}


@pytest.mark.parametrize("block_s", [10.0, None])
def test_engine_kernel_tier_matches_reference(plans, block_s):
    """The tier in front of each engine over the same records: the
    escalation block (``kernel_drop_hz`` is a rate over the wall),
    stats, blacklist and table equal."""
    jcfg, tcfg = _cfgs()
    rec = _stream()
    te = Engine(tcfg, ArraySource(rec.copy()), CollectSink(),
                params=logreg.load_params(INT8), device="cpu",
                sink_thread=False,
                kernel_tier=SimKernelTier(plans["port"], block_s=block_s))
    je = JEngine(jcfg, JArraySource(rec.copy()), JCollectSink(),
                 params=jlogreg.load_params(INT8), sink_thread=False,
                 kernel_tier=JSimKernelTier(plans["jload"], block_s=block_s))
    # the tier thins each poll, so a batch takes several polls to fill:
    # no deadline flush on the host's clock, which would make the batch
    # partition a matter of timing (batches seal full, the last at the
    # end of the stream)
    for e in (te, je):
        e.batcher.flush_due = lambda: False
    tr, jr = te.run(), je.run()
    assert _no_hz(tr.escalation) == _no_hz(jr.escalation)
    esc = tr.escalation
    assert esc["mode"] == "sim" and esc["records_in"] == len(rec)
    assert esc["escalated"] == tr.records < len(rec)
    assert esc["kernel_drops"] > 0 and esc["kernel_passes"] > 0
    assert "kernel_drop_hz" in esc
    if block_s:
        assert esc["blacklist_hits"] > 0
    assert tr.stats == jr.stats and tr.batches == jr.batches
    assert te.sink.blocked == je.sink.blocked
    tk, ts = schema.table_to_numpy(te.table)
    np.testing.assert_array_equal(tk.view(np.uint32),
                                  np.asarray(je.table.key).view(np.uint32))
    np.testing.assert_array_equal(ts.view(np.uint32),
                                  np.asarray(je.table.state).view(np.uint32))


def test_engine_without_tier_has_no_escalation_block():
    _, tcfg = _cfgs()
    e = Engine(tcfg, ArraySource(_stream(B)), CollectSink(), device="cpu")
    assert e.run().escalation is None


def test_engine_refuses_sealed_and_precompact_sources(plans):
    class _Sealed:
        provides_sealed = True

    class _Precompact:
        precompact = True

    jcfg, tcfg = _cfgs()
    for src, match in ((_Sealed, "record path"), (_Precompact,
                                                   "compact-emit")):
        with pytest.raises(ValueError, match=match) as e:
            Engine(tcfg, src(), CollectSink(), device="cpu",
                   kernel_tier=SimKernelTier(plans["port"]))
        with pytest.raises(ValueError) as je:
            JEngine(jcfg, src(), JCollectSink(),
                    kernel_tier=JSimKernelTier(plans["jload"]))
        assert str(e.value) == str(je.value)


def _serve(capsys, *argv):
    rc = cli.main(["serve", "--device", "cpu", "--no-sink-thread", "--json",
                   *argv])
    out = capsys.readouterr()
    return rc, out.out.strip().splitlines(), out.err


def test_cli_sim_kernel_tier_matches_reference_engine(plans, tmp_path,
                                                      capsys):
    """``serve --sim-kernel-tier PLAN --records FILE`` serves what the
    tier escalates.  Its drains follow the deadline flush, which is the
    host's timing, and a source dropped in one drain is a blacklist hit
    only in later drains, so the band counters are compared where they
    do not depend on the drains (the exact block is
    :func:`test_engine_kernel_tier_matches_reference`'s)."""
    rec = _stream()
    path = tmp_path / "flows.bin"
    path.write_bytes(rec.tobytes())
    conf = tmp_path / "fsx.json"
    conf.write_text(json.dumps({"batch": {"max_batch": B},
                                "table": {"capacity": CAP,
                                          "salt": 0x5EED}}))
    rc, out, _ = _serve(capsys, "--records", str(path), "--config",
                        str(conf), "--artifact", INT8, "--sim-kernel-tier",
                        COMMITTED_PLAN)
    assert rc == 0
    rep = json.loads(out[-1])
    jcfg, _ = _cfgs()
    je = JEngine(jcfg, JArraySource(rec.copy()), JCollectSink(),
                 params=jlogreg.load_params(INT8), sink_thread=False,
                 kernel_tier=JSimKernelTier(plans["jload"],
                                            block_s=jcfg.model.ml_block_s))
    want = je.run().escalation
    esc = rep["escalation"]
    for k in ("mode", "records_in", "blocked_sources"):
        assert esc[k] == want[k], k
    assert esc["thresholds"] == json.loads(json.dumps(want["thresholds"]))
    assert esc["records_in"] == len(rec) == (
        esc["kernel_drops"] + esc["blacklist_hits"] + esc["kernel_passes"]
        + esc["escalated"])
    assert rep["records"] == esc["escalated"] > 0
    assert (rep["stats"]["allowed"] + rep["stats"]["dropped"]
            == rep["records"])


def test_cli_sim_kernel_tier_refusals(tmp_path, capsys):
    rc, out, err = _serve(capsys, "--sim-kernel-tier", COMMITTED_PLAN,
                          "--feature-ring", str(tmp_path / "ring"),
                          "--ingest-workers", "1")
    assert rc == 1 and not out
    assert "--sim-kernel-tier needs the inline record path" in err
    bad = tmp_path / "bad.npz"
    bad.write_bytes(b"not a plan")
    rc, out, err = _serve(capsys, "--sim-kernel-tier", str(bad),
                          "--batches", "1")
    assert rc == 1 and not out
    assert "cannot load the distill plan" in err
    # a compact-emit ring: its records arrive kernel-quantized
    ring = tmp_path / "compact.ring"
    ShmRing.create(ring, 1024, wire.COMPACT_RECORD_DTYPE)
    rc, out, err = _serve(capsys, "--sim-kernel-tier", COMMITTED_PLAN,
                          "--feature-ring", str(ring), "--seconds", "0.1")
    assert rc == 1 and not out
    assert "cannot rescore a compact-emit" in err


# ---------------------------------------------------------------------------
# The compiler and fsx distill
# ---------------------------------------------------------------------------


def _same_plan(port, ref):
    """Trap-free plan equality: the blob, every array and scalar entry,
    and every ``meta`` key except ``backend`` (the device that ran the
    chain)."""
    assert plan.pack_blob(port) == jplan.pack_blob(ref)
    for f in ("w", "qbase", "bounds_m1"):
        a, b = getattr(port, f), getattr(ref, f)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for f in ("acc_drop", "acc_pass", "t_lo", "t_hi", "in_zp", "w_sum"):
        assert getattr(port, f) == getattr(ref, f), f
    strip = lambda m: {k: v for k, v in m.items() if k != "backend"}  # noqa
    assert strip(port.meta) == strip(ref.meta)
    assert port.meta["backend"] == "cpu"


@pytest.fixture(scope="module")
def trained_artifact(tmp_path_factory):
    """An artifact the port's trainer just produced (CPU, 40 epochs on a
    6,000-row fixture)."""
    from flowsentryx_tpu_torch.train import fixture, qat

    X, y = fixture.cicids_fixture(n=6000, seed=4)
    res = qat.train_logreg_qat(X, y, epochs=40, device="cpu")
    return logreg.save_params(res.params, str(
        tmp_path_factory.mktemp("trained") / "trained.npz"))


@pytest.mark.parametrize("thresholds", [(0.1, 0.9), (0.05, 0.95),
                                        (0.3, 0.7)])
@pytest.mark.parametrize("which", ["golden", "int8", "trained"])
def test_compile_plan_equals_reference(which, thresholds, trained_artifact):
    if which == "golden":
        jp, tp = jlogreg.golden_params(), logreg.golden_params()
    else:
        path = INT8 if which == "int8" else trained_artifact
        jp, tp = jlogreg.load_params(path), logreg.load_params(path)
    ref = jplan.compile_plan(jp, *thresholds)
    _same_plan(plan.compile_plan(tp, *thresholds), ref)


def test_compile_plan_errors_match_reference():
    jp, tp = jlogreg.load_params(INT8), logreg.load_params(INT8)
    for th in ((0.9, 0.1), (0.5, 0.5), (-0.1, 0.5), (0.2, 1.5)):
        with pytest.raises(plan.DistillError) as e:
            plan.compile_plan(tp, *th)
        with pytest.raises(jplan.DistillError) as je:
            jplan.compile_plan(jp, *th)
        assert str(e.value) == str(je.value)
    # a negative weight scale makes the tail decreasing in acc
    neg = dict(logreg.params_to_numpy(tp), w_scale=np.float32(-0.01))
    with pytest.raises(plan.DistillError) as e:
        plan.compile_plan(logreg.params_from_numpy(neg))
    with pytest.raises(jplan.DistillError) as je:
        jplan.compile_plan(jlogreg.make_params(**{
            k: v for k, v in neg.items()}))
    assert "not monotone" in str(e.value)
    assert str(e.value) == str(je.value)


@pytest.mark.parametrize("name", ["mlp", "multiclass", "logreg_float",
                                  "wrong_pytree"])
def test_require_distillable_matches_reference(name):
    from flowsentryx_tpu.models import mlp as jmlp
    from flowsentryx_tpu.models import registry as jregistry
    from flowsentryx_tpu_torch.core import prng
    from flowsentryx_tpu_torch.models import mlp, registry

    model = "logreg_int8" if name == "wrong_pytree" else name
    tparams = (mlp.init_params(prng.prng_key(0))
               if name == "wrong_pytree" else object())
    jparams = (jmlp.init_params(jax_key(0))
               if name == "wrong_pytree" else object())
    with pytest.raises(ValueError) as e:
        registry.require_distillable(model, tparams)
    with pytest.raises(ValueError) as je:
        jregistry.require_distillable(model, jparams)
    assert str(e.value) == str(je.value)
    assert registry.distillable_models() == jregistry.distillable_models()
    assert registry.registered_models() == jregistry.registered_models()


def jax_key(seed):
    import jax

    return jax.random.PRNGKey(seed)


def _distill(main, argv, capsys):
    rc = main(["distill", *argv])
    cap = capsys.readouterr()
    return rc, cap.out, cap.err


def test_cli_distill_json_matches_reference(tmp_path, capsys):
    from flowsentryx_tpu import cli as jcli

    argv = [INT8, "--thresholds", "0.2,0.8", "--json"]
    rc_j, out_j, _ = _distill(jcli.main, argv + [
        "--out", str(tmp_path / "j"), "--blob", str(tmp_path / "j.bin"),
        "--report", str(tmp_path / "j.json")], capsys)
    rc_t, out_t, _ = _distill(cli.main, argv + [
        "--device", "cpu", "--out", str(tmp_path / "t"),
        "--blob", str(tmp_path / "t.bin"),
        "--report", str(tmp_path / "t.json")], capsys)
    assert rc_j == rc_t == 0
    j, t = json.loads(out_j), json.loads(out_t)
    for d in (j, t):
        d.pop("compile_s")
        d["plan"]["meta"].pop("backend")
        for k in ("plan_file", "blob_file"):
            d[k] = Path(d[k]).name[1:]
    assert t == j
    assert (tmp_path / "t.bin").read_bytes() == \
        (tmp_path / "j.bin").read_bytes()
    tj = json.loads((tmp_path / "t.json").read_text())
    assert tj["plan"] == json.loads(out_t)["plan"]
    _same_plan(plan.load_plan(str(tmp_path / "t.npz")),
               jplan.load_plan(str(tmp_path / "j.npz")))


@pytest.mark.parametrize("argv", [
    ["--thresholds", "0.9,0.1"], ["--thresholds", "x"],
    ["--model", "mlp"], ["--model", "nope"]])
def test_cli_distill_refusals_match_reference(argv, capsys):
    from flowsentryx_tpu import cli as jcli

    rc_j, _, err_j = _distill(jcli.main, [INT8, *argv], capsys)
    rc_t, _, err_t = _distill(cli.main, [INT8, *argv, "--device", "cpu"],
                              capsys)
    assert rc_j == rc_t == 1
    assert err_t == err_j


def test_cli_distill_without_card_fails(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc, out, err = _distill(cli.main, [INT8], capsys)
    assert rc == 1 and not out and "no CUDA device" in err


@pytest.mark.parametrize("which", ["golden", "int8"])
def test_served_band_check_matches_reference_emulate(which):
    """The reference's ``_distill_emulate`` corpus, rebuilt by the port:
    the served int8 lane bands every row as the plan does (0
    mismatches, the reference's acceptance), and the split equals the
    reference's emulator run over its own corpus."""
    from flowsentryx_tpu import cli as jcli
    from flowsentryx_tpu_torch.distill import parity

    if which == "golden":
        jp, tp = jlogreg.golden_params(), logreg.golden_params()
    else:
        jp, tp = jlogreg.load_params(INT8), logreg.load_params(INT8)
    ref_plan = jplan.compile_plan(jp)
    ref = jcli._distill_emulate(jp, ref_plan, jplan.pack_blob(ref_plan),
                                n=4000)
    p = plan.compile_plan(tp)
    got = parity.served_band_check(tp, p, parity.corpus(p, n=4000))
    assert got["ok"] and got["served_mismatches"] == 0
    assert got["vectors"] == ref["vectors"] and got["split"] == ref["split"]

