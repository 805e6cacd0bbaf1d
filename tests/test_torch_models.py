"""The port's model families against the JAX reference, byte for byte.

``mlp``, ``multiclass`` and ``logreg_float`` scores (and the MLP logits,
the multiclass probabilities and ``attack_class``) on both shipped
artifacts, on the reference's own seeded init carried across, and on
seeded bf16 params with a wide exponent spread (where XLA's summation
order shows), over heavy-tailed, zero and negative features; each scorer
alone at B = 2048 (the serving batch) and at B = 256 (the tests' size),
since XLA's dot order may depend on the shape; the ``logreg_float`` lane
inside the compact16 step; the artifacts loaded by both packages; and
the registry.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from flowsentryx_tpu.core import config as jconfig
from flowsentryx_tpu.core import schema as jschema
from flowsentryx_tpu.engine.traffic import Scenario as JScenario
from flowsentryx_tpu.engine.traffic import TrafficGen as JTrafficGen
from flowsentryx_tpu.engine.traffic import TrafficSpec as JTrafficSpec
from flowsentryx_tpu.models import get_model as jget_model
from flowsentryx_tpu.models import logreg as jlogreg
from flowsentryx_tpu.models import mlp as jmlp
from flowsentryx_tpu.models import multiclass as jmulticlass
from flowsentryx_tpu.ops import fused as jfused
from flowsentryx_tpu_torch.core import config, schema
from flowsentryx_tpu_torch.models import logreg, mlp, multiclass, registry
from flowsentryx_tpu_torch.ops import fused

ART = Path(__file__).resolve().parents[1] / "artifacts"
F32 = np.float32


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype in (np.float32, np.int32) else a


def features(n, seed):
    """Heavy-tailed flow features (1 .. e^20), a fifth zero, a tenth
    negative (the transform's sign branch), plus small fractions."""
    rng = np.random.default_rng(seed)
    x = np.exp(rng.uniform(0, 20, (n, 8))).astype(F32)
    x[rng.random((n, 8)) < 0.2] = 0
    x[rng.random((n, 8)) < 0.1] *= -1
    x[rng.random((n, 8)) < 0.05] = rng.uniform(0, 1, 1)[0]
    return x


def wide_params(seed, classes):
    """Seeded bf16 params with a wide exponent spread and nonzero biases
    (as numpy f32 arrays holding bf16 values)."""
    rng = np.random.default_rng(seed)

    def bf(shape):
        v = rng.standard_normal(shape) * 2.0 ** rng.integers(-6, 4, shape)
        return np.asarray(jnp.asarray(v, jnp.bfloat16).astype(jnp.float32))

    h = 32
    return dict(w1=bf((8, h)), b1=bf((h,)), w2=bf((h, h)), b2=bf((h,)),
                w3=bf((h, classes)), b3=bf((classes,)))


def trunk_params(family, source):
    """``(reference params, port params)`` of an MLP-trunk family from
    ``source``: the shipped artifact, the reference's seeded init, or
    wide seeded params."""
    jmod, tmod = ((jmlp, mlp) if family == "mlp"
                  else (jmulticlass, multiclass))
    classes = 1 if family == "mlp" else 4
    if source == "artifact":
        path = str(ART / ("mlp_robust.npz" if family == "mlp"
                          else "multiclass.npz"))
        return jmod.load_params(path), tmod.load_params(path)
    if source == "init":
        jp = jmod.init_params(jax.random.PRNGKey(7))
        return jp, tmod.params_from_numpy(
            {k: np.asarray(v, F32) for k, v in jp._asdict().items()})
    d = wide_params(11, classes)
    cls = jmod.MlpParams if family == "mlp" else jmod.MulticlassParams
    jp = cls(**{k: jnp.asarray(v, jnp.bfloat16) for k, v in d.items()})
    return jp, tmod.params_from_numpy(d)


def _check(jfn, tfn, jp, tp, b, seed, n=1 << 14):
    x = features(n, seed)
    j = jax.jit(jfn)
    want = np.concatenate([np.asarray(j(jp, x[i:i + b]))
                           for i in range(0, n, b)])
    got = tfn(tp, torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("b", [256, 2048])
@pytest.mark.parametrize("source", ["artifact", "init", "wide"])
def test_mlp_logits_and_scores(source, b):
    jp, tp = trunk_params("mlp", source)
    _check(jmlp.logits, mlp.logits, jp, tp, b, seed=1)
    _check(jmlp.classify_batch, mlp.classify_batch, jp, tp, b, seed=2)


@pytest.mark.parametrize("b", [256, 2048])
@pytest.mark.parametrize("source", ["artifact", "init", "wide"])
def test_multiclass_probs_scores_and_attack_class(source, b):
    jp, tp = trunk_params("multiclass", source)
    _check(jmulticlass.class_probs, multiclass.class_probs, jp, tp, b, 3)
    _check(jmulticlass.classify_batch, multiclass.classify_batch, jp, tp, b,
           4)
    _check(jmulticlass.attack_class, multiclass.attack_class, jp, tp, b, 5)


@pytest.mark.parametrize("b", [256, 2048])
@pytest.mark.parametrize("source", ["golden", "artifact", "seeded"])
def test_logreg_float_scores(source, b):
    """The float lane (``logreg_float``): ``log1p`` when the artifact
    says so, an eight-term f32 dot, XLA's sigmoid."""
    if source == "golden":
        jp = jlogreg.golden_params()
    elif source == "artifact":
        jp = jlogreg.load_params(str(ART / "logreg_int8.npz"))
    else:
        rng = np.random.default_rng(9)
        jp = jlogreg.make_params(rng.integers(-128, 128, 8), bias=0.37,
                                 w_scale=0.0123, in_scale=1.0, log1p=True)
    tp = logreg.params_from_numpy({k: np.asarray(v)
                                   for k, v in jp._asdict().items()})
    jfn = jget_model("logreg_float").classify_batch
    _check(jfn, logreg.classify_float, jp, tp, b, seed=6)


@pytest.mark.parametrize("artifact", [False, True])
@pytest.mark.parametrize("scenario", ["syn_benign_mix", "udp_flood_multi"])
def test_logreg_float_compact_step_stream(scenario, artifact):
    """``logreg_float`` over the compact16 wire, the reference's default
    for it: the step's outputs, table and stats byte-equal over a
    generator stream, with the golden params (8 batches) and with the
    log1p artifact ``logreg_int8.npz`` (16 batches: the float lane takes
    ``log1p`` of the decode's ``expm1`` without re-quantizing, so every
    decoded feature must be XLA:CPU's)."""
    if artifact:
        jp = jlogreg.load_params(str(ART / "logreg_int8.npz"))
        tp = logreg.load_params(str(ART / "logreg_int8.npz"))
    else:
        jp = jlogreg.golden_params()
        tp = logreg.golden_params()
    quant = jschema.model_quant_args(jp)
    kw = dict(table=dict(capacity=1 << 12, salt=7), batch=dict(max_batch=256),
              model=dict(name="logreg_float", threshold=0.3),
              limiter=dict(pps_threshold=300.0))
    jcfg = jconfig.FsxConfig(**{k: getattr(jconfig, c)(**v) for (k, v), c in
                                zip(kw.items(), ("TableConfig", "BatchConfig",
                                                 "ModelConfig",
                                                 "LimiterConfig"))})
    tcfg = config.FsxConfig(**{k: getattr(config, c)(**v) for (k, v), c in
                               zip(kw.items(), ("TableConfig", "BatchConfig",
                                                "ModelConfig",
                                                "LimiterConfig"))})
    jstep = jax.jit(jfused.make_compact_step(
        jcfg, jget_model("logreg_float").classify_batch, emit_score=True,
        **quant))
    tstep = fused.make_compact_step(
        tcfg, registry.get_model("logreg_float").classify_batch,
        emit_score=True, **quant)
    jt, js = jschema.make_table(1 << 12), jschema.make_stats()
    tt, ts = schema.make_table(1 << 12), schema.make_stats()
    gen = JTrafficGen(JTrafficSpec(scenario=JScenario(scenario), seed=8,
                                   rate_pps=4e4, n_attack_ips=64))
    t0 = None
    for i in range(16 if artifact else 8):
        rec = gen.next_records(256 - 31 * (i % 3))
        t0 = int(rec["ts_ns"][0]) if t0 is None else t0
        raw = jschema.encode_compact(rec, 256, t0, **quant)
        jt, js, jo = jstep(jt, js, jp, raw)
        tt, ts, to = tstep(tt, ts, tp, schema.wire_to_tensor(raw))
        for f in ("verdict", "score", "block_until", "wire"):
            np.testing.assert_array_equal(_bits(getattr(to, f).numpy()),
                                          _bits(getattr(jo, f)), f)
        key, state = schema.table_to_numpy(tt)
        np.testing.assert_array_equal(key, np.asarray(jt.key))
        np.testing.assert_array_equal(state.view(np.uint32),
                                      _bits(jt.state))
    assert ts.to_dict()["batches"] == (16 if artifact else 8)


# -- artifacts and the registry -----------------------------------------------


@pytest.mark.parametrize("name,path", [("mlp", "mlp_robust.npz"),
                                       ("multiclass", "multiclass.npz"),
                                       ("logreg_float", "logreg_int8.npz")])
def test_artifact_loads_equal_in_both_packages(name, path):
    jp = jget_model(name) and __import__(
        "flowsentryx_tpu.models.registry", fromlist=["load_artifact"]
    ).load_artifact(name, str(ART / path))
    tp = registry.load_artifact(name, str(ART / path), "cpu")
    assert type(tp).__name__ == type(jp).__name__
    for f in jp._fields:
        want = np.asarray(jnp.asarray(getattr(jp, f)).astype(
            jnp.float32 if name != "logreg_float" else getattr(jp, f).dtype))
        got = getattr(tp, f).numpy()
        np.testing.assert_array_equal(got, want, f)
        assert got.dtype == want.dtype, f


def test_params_carried_across_round_trip():
    jp = jmlp.init_params(jax.random.PRNGKey(3))
    as_np = {k: np.asarray(v, F32) for k, v in jp._asdict().items()}
    back = mlp.params_to_numpy(mlp.params_from_numpy(as_np))
    for k in as_np:
        np.testing.assert_array_equal(back[k], as_np[k])


def test_registry_serves_every_reference_family():
    from flowsentryx_tpu.models.registry import registered_models

    assert registry.NOT_PORTED == ()
    assert sorted(registry._REGISTRY) == registered_models()
    assert registry.get_model("mlp").classify_batch is mlp.classify_batch
    # the reference's default init_params(PRNGKey(0)), byte for byte
    for name in ("mlp", "multiclass"):
        jp = jget_model(name).init()
        tp = registry.get_model(name).init("cpu")
        for k in jp._fields:
            np.testing.assert_array_equal(
                getattr(tp, k).numpy(), np.asarray(getattr(jp, k), F32), k)
    with pytest.raises(ValueError, match="not a multiclass artifact"):
        registry.load_artifact("multiclass", str(ART / "mlp_robust.npz"),
                               "cpu")
    # the reference's mlp loader refuses a logreg npz by its version
    with pytest.raises(ValueError, match="mlp artifact schema version 2"):
        registry.load_artifact("mlp", str(ART / "logreg_int8.npz"), "cpu")


def test_mesh_config_refused_by_name():
    cfg = config.FsxConfig.from_json('{"mesh": {"ip_axis": 4}}')
    assert config.unsupported(cfg)
    from flowsentryx_tpu_torch.engine import (
        CollectSink, Engine, TrafficSource, TrafficSpec,
    )
    with pytest.raises(ValueError, match="mesh.ip_axis=4"):
        Engine(cfg, TrafficSource(TrafficSpec(), total=8), CollectSink(),
               device="cpu")


def test_every_reference_config_parses():
    """Every config the reference writes parses here to the same dict;
    unknown keys are refused."""
    j = jconfig.FsxConfig(
        rules=(jconfig.RuleConfig(proto="tcp", dport=22),
               jconfig.RuleConfig(proto=17)),
        table=jconfig.TableConfig(evict_ttl_s=0.25, evict_every=32),
        limiter=jconfig.LimiterConfig(kind=jconfig.LimiterKind.TOKEN_BUCKET),
        interface="ens5")
    for c in (j, jconfig.DEFAULT_CONFIG):
        t = config.FsxConfig.from_json(c.to_json())
        assert t.to_dict() == c.to_dict()
    assert config.DEFAULT_CONFIG == config.FsxConfig()
    with pytest.raises(KeyError, match="unknown config key"):
        config.FsxConfig.from_dict({"table": {"nope": 1}})
    with pytest.raises(ValueError, match="evict_every"):
        config.TableConfig(evict_every=0)
    with pytest.raises(ValueError, match="evict_ttl_s"):
        config.TableConfig(evict_ttl_s=-1.0)
