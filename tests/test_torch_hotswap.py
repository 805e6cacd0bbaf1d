"""The live model swap of the port against the JAX package's.

``Engine.hot_swap`` at a batch index: serve N batches, swap, serve M
more, on the port's CPU engine and on the reference engine, for the int8
logistic regression over the compact16 wire (a second artifact derived
from ``artifacts/logreg_int8.npz`` with the same input observer, other
weights and bias) and for the MLP over raw48 (``mlp_robust.npz``, then
the family's default ``PRNGKey(0)`` params): stats, blacklist with
untils and the whole table equal, byte for byte, and differ from the
same stream without the swap.  The reference's refusals (another
family, a leaf's shape or dtype, observer drift on the compact16 model
wire) with its wording; ``watch_artifact`` on an atomic replace (one
swap, equal to the reference's swap at the same index) and on a
truncated or foreign file (fail-open: no swap, serving continues); and
``serve --artifact-reload``.  A swap lands where the test puts it, at a
batch index, never after a sleep.  Capacity 2^12, B = 256.
"""

import json
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowsentryx_tpu.core import config as jconfig
from flowsentryx_tpu.engine import ArraySource as JArraySource
from flowsentryx_tpu.engine import CollectSink as JCollectSink
from flowsentryx_tpu.engine import Engine as JEngine
from flowsentryx_tpu.models import logreg as jlogreg
from flowsentryx_tpu.models import mlp as jmlp
from flowsentryx_tpu_torch import cli
from flowsentryx_tpu_torch.core import config, schema
from flowsentryx_tpu_torch.engine import ArraySource, CollectSink, Engine
from flowsentryx_tpu_torch.engine.traffic import (
    Scenario, TrafficGen, TrafficSpec,
)
from flowsentryx_tpu_torch.models import logreg, mlp, registry

REPO = Path(__file__).resolve().parents[1]
ART = REPO / "artifacts"
INT8 = str(ART / "logreg_int8.npz")
MLP = str(ART / "mlp_robust.npz")
B, CAP = 256, 1 << 12
N_BEFORE, N_TOTAL = 6, 16


@pytest.fixture(autouse=True, scope="module")
def _threads():
    # the plain CPU step runs ~10x slower with a thread per core
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _cfgs(model):
    t = dict(capacity=CAP, salt=0x5EED)
    bt = dict(max_batch=B)
    lim = dict(pps_threshold=200.0, bps_threshold=1e9)
    return (jconfig.FsxConfig(limiter=jconfig.LimiterConfig(**lim),
                              model=jconfig.ModelConfig(name=model),
                              table=jconfig.TableConfig(**t),
                              batch=jconfig.BatchConfig(**bt)),
            config.FsxConfig(limiter=config.LimiterConfig(**lim),
                             model=config.ModelConfig(name=model),
                             table=config.TableConfig(**t),
                             batch=config.BatchConfig(**bt)))


def _records(seed=3):
    return TrafficGen(TrafficSpec(
        scenario=Scenario.UDP_FLOOD_MULTI, rate_pps=1e6, n_attack_ips=16,
        n_benign_ips=400, attack_fraction=0.7, seed=seed)).next_records(
            N_TOTAL * B)


def derived_int8(seed=5) -> dict:
    """A second int8 artifact: ``logreg_int8.npz``'s input observer
    (``in_scale``, ``in_zp``, ``log1p``) with other weights and bias,
    made from a seed with numpy."""
    h = dict(np.load(INT8))
    rng = np.random.default_rng(seed)
    h["w_int8"] = rng.integers(-127, 128, 8).astype(np.int8)
    h["bias"] = np.float32(h["bias"] + rng.normal())
    return h


def _jlogreg(h):
    return jlogreg.LogRegParams(**{k: jnp.asarray(h[k])
                                   for k in jlogreg.LogRegParams._fields})


def _pair(case):
    """``(model, reference boot params, port boot params, reference
    swap params, port swap params)``."""
    if case == "compact16_int8":
        h = derived_int8()
        return ("logreg_int8", jlogreg.load_params(INT8),
                logreg.load_params(INT8), _jlogreg(h),
                logreg.params_from_numpy(h))
    return ("mlp", jmlp.load_params(MLP), mlp.load_params(MLP),
            jmlp.init_params(jax.random.PRNGKey(0)),
            registry.get_model("mlp").init("cpu"))


def _port_engine(tcfg, rec, params, **kw):
    return Engine(tcfg, ArraySource(rec.copy()), CollectSink(),
                  params=params, device="cpu", sink_thread=False, **kw)


def _ref_engine(jcfg, rec, params):
    return JEngine(jcfg, JArraySource(rec.copy()), JCollectSink(),
                   params=params, sink_thread=False)


def _state(e, port=True):
    if port:
        k, st = schema.table_to_numpy(e.table)
    else:
        k, st = np.asarray(e.table.key), np.asarray(e.table.state)
    return k.view(np.uint32), st.view(np.uint32)


def _assert_same(te, tr, je, jr):
    assert tr.stats == jr.stats
    assert tr.batches == jr.batches == N_TOTAL
    assert te.sink.blocked == je.sink.blocked
    tk, ts = _state(te)
    jk, js = _state(je, port=False)
    np.testing.assert_array_equal(tk, jk)
    np.testing.assert_array_equal(ts, js)


@pytest.fixture(scope="module", params=["compact16_int8", "raw48_mlp"])
def swapped(request):
    """Both engines over one stream, swapped after ``N_BEFORE`` batches;
    and the port's run of the same stream without the swap."""
    model, jboot, tboot, jnew, tnew = _pair(request.param)
    jcfg, tcfg = _cfgs(model)
    rec = _records()
    te = _port_engine(tcfg, rec, tboot)
    te.run(max_batches=N_BEFORE)
    te.hot_swap(tnew)
    tr = te.run()
    je = _ref_engine(jcfg, rec, jboot)
    je.run(max_batches=N_BEFORE)
    je.hot_swap(jnew)
    jr = je.run()
    plain = _port_engine(tcfg, rec, tboot)
    return {"case": request.param, "port": (te, tr), "ref": (je, jr),
            "unswapped": (plain, plain.run())}


def test_hot_swap_at_batch_index_matches_reference(swapped):
    te, tr = swapped["port"]
    je, jr = swapped["ref"]
    _assert_same(te, tr, je, jr)
    assert te._hot_swaps == je._hot_swaps == 1
    assert te._swap_at == [N_BEFORE]
    assert te.wire == ("compact16" if swapped["case"] == "compact16_int8"
                       else "raw48")


def test_hot_swap_changes_the_verdicts(swapped):
    """The swapped-in model decided the second part of the stream: the
    state differs from the same stream served without the swap."""
    te, tr = swapped["port"]
    pe, pr = swapped["unswapped"]
    assert tr.records == pr.records
    differs = tr.stats != pr.stats or any(
        not np.array_equal(a, b) for a, b in zip(_state(te), _state(pe)))
    assert differs


def test_hot_swap_repacks_the_scorer_in_place():
    """The int8 scorer's pack keeps its buffer (its address is what a
    captured graph holds) and takes the new model's contents."""
    _, tcfg = _cfgs("logreg_int8")
    e = _port_engine(tcfg, _records()[:B], logreg.load_params(INT8))
    pack = e.score_params
    ptr = pack.args_ptr
    h = derived_int8()
    e.hot_swap(logreg.params_from_numpy(h))
    assert e.score_params is pack and pack.args_ptr == ptr
    assert pack.buf.data_ptr() == ptr
    want = logreg.score_from_code(logreg.params_from_numpy(h),
                                  torch.arange(256, dtype=torch.float32))
    assert torch.equal(pack.table, want)
    w = np.frombuffer(np.array([pack.args.w_lo, pack.args.w_hi],
                               "<u4").tobytes(), np.int8)
    np.testing.assert_array_equal(w, h["w_int8"])


def _refusal(je, te, jparams, tparams):
    with pytest.raises(ValueError) as jexc:
        je.hot_swap(jparams)
    with pytest.raises(ValueError) as texc:
        te.hot_swap(tparams)
    assert str(texc.value) == str(jexc.value)
    return str(texc.value)


@pytest.fixture(scope="module")
def int8_engines():
    jcfg, tcfg = _cfgs("logreg_int8")
    rec = _records()[:B]
    return (_ref_engine(jcfg, rec, jlogreg.load_params(INT8)),
            _port_engine(tcfg, rec, logreg.load_params(INT8)))


def test_refuses_another_family(int8_engines):
    je, te = int8_engines
    msg = _refusal(je, te, jmlp.init_params(jax.random.PRNGKey(0)),
                   registry.get_model("mlp").init("cpu"))
    assert "different family" in msg


def test_refuses_a_shape_change(int8_engines):
    je, te = int8_engines
    jp = jlogreg.load_params(INT8)
    tp = logreg.load_params(INT8)
    msg = _refusal(je, te, jp._replace(w_int8=jnp.zeros((4,), jnp.int8)),
                   tp._replace(w_int8=torch.zeros(4, dtype=torch.int8)))
    assert "shape/dtype" in msg and "leaf 0" in msg


def test_refuses_a_dtype_change(int8_engines):
    je, te = int8_engines
    jp = jlogreg.load_params(INT8)
    tp = logreg.load_params(INT8)
    msg = _refusal(je, te, jp._replace(w_int8=jp.w_int8.astype(jnp.int16)),
                   tp._replace(w_int8=tp.w_int8.to(torch.int16)))
    assert "int16[8]" in msg and "int8[8]" in msg


@pytest.mark.parametrize("field", ["in_scale", "in_zp", "log1p"])
def test_refuses_observer_drift_on_the_compact16_model_wire(int8_engines,
                                                            field):
    je, te = int8_engines
    h = dict(np.load(INT8))
    h[field] = {"in_scale": np.float32(h["in_scale"] * 2),
                "in_zp": np.int32(3), "log1p": np.int32(0)}[field]
    msg = _refusal(je, te, _jlogreg(h), logreg.params_from_numpy(h))
    assert "observer" in msg and field in msg
    assert te._hot_swaps == je._hot_swaps == 0


def test_observer_change_is_accepted_over_raw48():
    """Over raw48 the wire carries the records verbatim: a new observer
    is only new scorer arguments, and the swap equals the reference's."""
    jcfg, tcfg = _cfgs("logreg_int8")
    rec = _records()
    h = derived_int8()
    h["in_scale"] = np.float32(h["in_scale"] * 2)
    te = Engine(tcfg, ArraySource(rec.copy()), CollectSink(),
                params=logreg.load_params(INT8), device="cpu",
                sink_thread=False, wire="raw48")
    je = JEngine(jcfg, JArraySource(rec.copy()), JCollectSink(),
                 params=jlogreg.load_params(INT8), sink_thread=False,
                 wire="raw48")
    for e, p in ((te, logreg.params_from_numpy(h)), (je, _jlogreg(h))):
        e.run(max_batches=N_BEFORE)
        e.hot_swap(p)
    _assert_same(te, te.run(), je, je.run())


def _atomic_write(path, params):
    tmp = logreg.save_params(params, str(path) + ".tmp.npz")
    os.replace(tmp, path)


def test_watch_artifact_atomic_replace_matches_reference(tmp_path,
                                                         capsys):
    """A push that replaces the watched file atomically is swapped in by
    the serving loop's check, exactly once; served on, the engine equals
    the reference swapped at the same batch index."""
    jcfg, tcfg = _cfgs("logreg_int8")
    rec = _records()
    path = tmp_path / "live.npz"
    _atomic_write(path, logreg.load_params(INT8))
    te = _port_engine(tcfg, rec, logreg.load_params(INT8))
    te.watch_artifact(str(path))
    te.run(max_batches=N_BEFORE)
    assert te._hot_swaps == 0               # unchanged file: no swap
    h = derived_int8()
    _atomic_write(path, logreg.params_from_numpy(h))
    os.utime(path, ns=(1, 1))               # a new mtime, whatever the clock
    te._watch_next = 0.0                    # skip the 0.5 s throttle
    te._maybe_reload_artifact()
    te._watch_next = 0.0
    te._maybe_reload_artifact()             # same mtime: not again
    assert te._hot_swaps == 1 and te._swap_at == [N_BEFORE]
    assert "hot-swapped artifact" in capsys.readouterr().err
    tr = te.run()
    je = _ref_engine(jcfg, rec, jlogreg.load_params(INT8))
    je.run(max_batches=N_BEFORE)
    je.hot_swap(_jlogreg(h))
    _assert_same(te, tr, je, je.run())


@pytest.mark.parametrize("bad", ["truncated", "not_npz", "other_family"])
def test_watch_artifact_fails_open(tmp_path, capsys, bad):
    """A half-written push (a truncated zip), a file that is no npz, or
    another family's artifact is announced and skipped: no swap, and the
    engine serves the whole stream on the incumbent model, equal to an
    engine that never watched."""
    _, tcfg = _cfgs("logreg_int8")
    rec = _records()
    path = tmp_path / "live.npz"
    _atomic_write(path, logreg.load_params(INT8))
    good = path.read_bytes()
    te = _port_engine(tcfg, rec, logreg.load_params(INT8))
    te.watch_artifact(str(path))
    te.run(max_batches=N_BEFORE)
    if bad == "truncated":
        path.write_bytes(good[:len(good) // 2])
    elif bad == "not_npz":
        path.write_bytes(b"not an npz")
    else:
        # the MLP's npz, under the watched name
        np.savez(path, **mlp.params_to_numpy(
            registry.get_model("mlp").init("cpu")), dtype="bfloat16",
            schema_version=1)
    os.utime(path, ns=(2, 2))
    te._watch_next = 0.0
    te._maybe_reload_artifact()
    assert "artifact reload failed" in capsys.readouterr().err
    tr = te.run()
    assert te._hot_swaps == 0 and tr.records == N_TOTAL * B
    plain = _port_engine(tcfg, rec, logreg.load_params(INT8))
    pr = plain.run()
    assert tr.stats == pr.stats and te.sink.blocked == plain.sink.blocked


def test_cli_artifact_reload_requires_artifact(capsys):
    rc = cli.main(["serve", "--device", "cpu", "--artifact-reload",
                   "--batches", "1"])
    assert rc == 1
    assert "--artifact-reload requires --artifact" in capsys.readouterr().err


def test_cli_artifact_reload_serves(tmp_path, capsys):
    """``serve --artifact-reload`` boots watching the artifact and serves
    (the file is unchanged, so nothing is swapped)."""
    path = tmp_path / "live.npz"
    _atomic_write(path, logreg.load_params(INT8))
    rc = cli.main(["serve", "--device", "cpu", "--table-capacity", "4096",
                   "--artifact", str(path), "--artifact-reload",
                   "--batches", "2", "--no-sink-thread", "--json"])
    assert rc == 0
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rep["batches"] == 2
    assert rep["dispatch"]["wire"] == "compact16"
