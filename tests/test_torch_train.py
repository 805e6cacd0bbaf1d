"""The port's training plane against the JAX package's: data, fixture,
metrics, the optax optimizers, the QAT pieces and trainers, the MLP
families' trainers and ``fsx train``.

The reference runs under ``JAX_PLATFORMS=cpu``, the port with
``device="cpu"``; inputs come from numpy seeds.  Exact where the port
rebuilds the reference's rounding (data, observers, fake-quant, Adam,
``convert``); elsewhere the tolerance is stated beside the assert:
torch sums a loss or a gradient over the batch in another order than
XLA, and XLA:CPU's ``rsqrt`` is a host-specific estimate plus two Newton
steps (ROADMAP queue 3), so trained weights are held to the reference's
own cross-trainer tolerances (``tests/test_train.py``).  Sizes are
small: 30,000 fixture rows at most.
"""

import io
import json
import zipfile
from contextlib import redirect_stdout
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from flowsentryx_tpu import cli as jcli
from flowsentryx_tpu.models import logreg as jlogreg
from flowsentryx_tpu.models import mlp as jmlp
from flowsentryx_tpu.models import multiclass as jmulticlass
from flowsentryx_tpu.train import data as jdata
from flowsentryx_tpu.train import evaluate as jevaluate
from flowsentryx_tpu.train import fixture as jfixture
from flowsentryx_tpu.train import qat as jqat
from flowsentryx_tpu.train import stress as jstress
from flowsentryx_tpu_torch import cli
from flowsentryx_tpu_torch.core import prng
from flowsentryx_tpu_torch.models import logreg, mlp, multiclass
from flowsentryx_tpu_torch.train import (
    data, evaluate, fixture, optim, qat, stress,
)


@pytest.fixture(autouse=True, scope="module")
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _np(x):
    return np.asarray(x)


# ---------------------------------------------------------------------------
# Data, fixture, metrics
# ---------------------------------------------------------------------------


def test_cicids_fixture_byte_equal():
    a = fixture.cicids_fixture(n=20_000, seed=2, return_classes=True)
    b = jfixture.cicids_fixture(n=20_000, seed=2, return_classes=True)
    for u, v in zip(a, b):
        assert u.dtype == v.dtype and u.tobytes() == v.tobytes()
    assert fixture.provenance() == jfixture.provenance()


@pytest.mark.parametrize("variant", ["v1", "v2"])
def test_fixture_variant_byte_equal(variant):
    a = stress.fixture_variant(variant, 5000, seed=9)
    b = jstress.fixture_variant(variant, 5000, seed=9)
    for u, v in zip(a, b):
        assert u.dtype == v.dtype and u.tobytes() == v.tobytes()


def test_synthetic_split_and_shift_augment_byte_equal():
    X, y = data.synthetic_dataset(3000, seed=4)
    jX, jy = jdata.synthetic_dataset(3000, seed=4)
    assert X.tobytes() == jX.tobytes() and y.tobytes() == jy.tobytes()
    for u, v in zip(data.train_test_split(X, y),
                    jdata.train_test_split(jX, jy)):
        assert u.tobytes() == v.tobytes()
    Xf, _ = fixture.cicids_fixture(n=4000, seed=1)
    a = stress.shift_augment(Xf, np.random.default_rng(0))
    b = jstress.shift_augment(Xf, np.random.default_rng(0))
    assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def _crafted_csv(path):
    cols = [" " + c if i else c for i, c in enumerate(data.CSV_COLUMNS)]
    rows = [",".join(cols) + ", Label",
            "80, -5, 1, 1000, 1, 1, 1, 1, BENIGN",       # negative -> 0
            "80, 1, Infinity, 1, 1, 1, 1, 1, DDoS",       # inf row dropped
            "80, 1, -Infinity, 1, 1, 1, 1, 1, DDoS",      # -inf -> 0, kept
            "80, 1, NaN, 1, 1, 1, 1, 1, DDoS",            # NaN row dropped
            "80, 1, , 1, 1, 1, 1, 1, DDoS",               # empty -> NaN
            "53, 2.5, 0.125, 1500.5, 3e5, 7, 8, 9,  BENIGN  ",
            "53, 2.5, 0.125, 1500.5, 3e5, 7, 8, 9, BENIGN",  # duplicate
            "53, 2.5, 0.125, 1500.5, 3e5, 7, 8, 9, PortScan",  # new label
            "443, 123456.789, 0.1, 99999999, 0.001, 1e-3, 2, 3, DoS Hulk",
            "",
            "8080, 1, 1, 1, 1, 1, 1, 1e38, Bot"]
    path.write_text("\n".join(rows) + "\n")


def test_load_csvs_equals_reference(tmp_path):
    """The csv-module loader against the reference's pandas loader, bit
    for bit after the f32 cast: generated files (two, globbed) and the
    crafted quirks corpus."""
    data.write_fixture_csv(tmp_path / "a_day1.csv", n=300, seed=5)
    data.write_fixture_csv(tmp_path / "a_day2.csv", n=200, seed=6)
    _crafted_csv(tmp_path / "b_crafted.csv")
    for pattern in ("a_*.csv", "b_*.csv", "*.csv"):
        X, y = data.load_csvs(str(tmp_path / pattern))
        jX, jy = jdata.load_csvs(str(tmp_path / pattern))
        assert X.dtype == jX.dtype == np.float32
        assert X.tobytes() == jX.tobytes() and y.tobytes() == jy.tobytes()
    X, y = data.load_csvs(str(tmp_path / "b_*.csv"))
    assert len(X) == 6 and (X >= 0).all()
    assert y.tolist() == [0, 1, 0, 1, 1, 1]
    with pytest.raises(FileNotFoundError):
        data.load_csvs(str(tmp_path / "none*.csv"))


def test_confusion_and_multiclass_report_equal():
    rng = np.random.default_rng(0)
    s, lab = rng.random(5000).astype(np.float32), rng.random(5000) < 0.3
    assert evaluate.confusion(s, lab) == jevaluate.confusion(s, lab)
    assert evaluate.confusion(s, lab, 0.7) == jevaluate.confusion(s, lab, 0.7)
    X, _, yc = fixture.cicids_fixture(n=3000, seed=7, return_classes=True)
    jp = jmulticlass.init_params(jax.random.PRNGKey(3))
    tp = multiclass.init_params(prng.prng_key(3))
    assert (evaluate.multiclass_report(tp, X, yc)
            == jevaluate.multiclass_report(jp, X, yc))


# ---------------------------------------------------------------------------
# Optimizers (optax 0.2.6 under jit, the trainers' form)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("steps", [1, 10])
@pytest.mark.parametrize("name,dtype", [("adam", "float32"),
                                        ("adam", "bfloat16"),
                                        ("adagrad", "float32")])
def test_optimizer_matches_optax(name, dtype, steps):
    rng = np.random.default_rng(steps)
    n = 20_000
    p0 = rng.standard_normal(n).astype(np.float32)
    grads = [(rng.standard_normal(n) * 10.0 ** rng.uniform(-4, 2, n)
              ).astype(np.float32) for _ in range(steps)]
    jdt = jnp.dtype(dtype)
    tdt = getattr(torch, dtype)
    ref_opt = optax.adam(1e-3) if name == "adam" else optax.adagrad(0.05)
    P = jnp.asarray(p0).astype(jdt)
    st = ref_opt.init(P)

    @jax.jit
    def step(P, G, st):
        u, st = ref_opt.update(G, st)
        return optax.apply_updates(P, u), st

    tp = torch.nn.Parameter(torch.from_numpy(p0).to(tdt))
    opt = (optim.Adam([tp], 1e-3) if name == "adam"
           else optim.Adagrad([tp], 0.05))
    for g in grads:
        G = jnp.asarray(g).astype(jdt)
        P, st = step(P, G, st)
        tp.grad = torch.from_numpy(_np(G.astype(jnp.float32))).to(tdt)
        opt.step()
    ref = _np(P.astype(jnp.float32))
    got = tp.detach().float().numpy()
    assert tp.dtype == tdt
    if name == "adam":
        # Adam is rebuilt op for op: bit-equal in both dtypes, moments too
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(
            opt.state[tp]["mu"].float().numpy(),
            _np(st[0].mu.astype(jnp.float32)))
        np.testing.assert_array_equal(
            opt.state[tp]["nu"].float().numpy(),
            _np(st[0].nu.astype(jnp.float32)))
        assert opt.state[tp]["mu"].dtype == tdt
    else:
        # the accumulator is exact (starts at 0.1, one FMA per step); the
        # update differs only through XLA's estimated rsqrt: most entries
        # equal, the rest within 1e-6 of each update's magnitude per step
        np.testing.assert_array_equal(
            opt.state[tp]["sum_of_squares"].numpy(),
            _np(st[0].sum_of_squares))
        assert (got == ref).mean() > 0.9
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=steps * 0.05 * 1e-6
                                   + 2 * np.spacing(np.abs(ref)).max())


# ---------------------------------------------------------------------------
# QAT pieces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [0, 1, 1000, 4096, 50_000])
def test_gemv_seq_plain_equals_reference_dot(n):
    """The weight gradient's order: ``gemv_seq``'s plain version equals
    the reference's compiled ``[N] x [N, 8]`` dot (one FMA chain per
    output in row order), exactly."""
    from flowsentryx_tpu_torch.ops import kernels

    rng = np.random.default_rng(n)
    g = (rng.standard_normal(n) * 10.0 ** rng.uniform(-3, 3, n)
         ).astype(np.float32)
    m = (rng.standard_normal((n, 8)) * 3).astype(np.float32)
    ref = jax.jit(lambda g, m: jax.lax.dot_general(
        g, m, (((0,), (0,)), ((), ()))))(g, m)
    got = kernels.gemv_seq(torch.from_numpy(g), torch.from_numpy(m))
    np.testing.assert_array_equal(got.numpy(), _np(ref))


def _ref_dot(g, m):
    return np.asarray(jax.jit(lambda g, m: jax.lax.dot_general(
        g, m, (((0,), (0,)), ((), ()))))(g, m))


def _flush_case(name):
    """Inputs of ROADMAP queue 3, item 40: XLA:CPU flushes denormal
    inputs (DAZ) and results whose rounding, at an unbounded exponent, is
    below 2^-126 (FTZ, tininess after rounding)."""
    f = np.float32
    a = f(2.0 ** -63 * (1 + 2.0 ** -13))
    c = f(2.0 ** -125 * (1 + 2.0 ** -13))
    if name == "denormal_g":
        g, m = [1e-39, 3.0], [[1e10] * 8, [0.0] * 8]
    elif name == "denormal_m":
        g, m = [1e10, 3.0], [[1e-39] * 8, [0.0] * 8]
    elif name == "rounds_up_to_2^-126":
        # exact 2^-126 (1 - 2^-26): rounds to 2^-126, kept
        g, m = [1.0, -a], [[c] * 8, [a] * 8]
    elif name == "tiny_at_unbounded_exponent":
        # exact 2^-126 - 1.5 x 2^-151: 2^-126 on the denormal grid, but
        # 2^-126 - 2^-150 at 24 bits: flushed
        g, m = [1.0, -1.5 * 2.0 ** -75], [[2.0 ** -126] * 8,
                                          [2.0 ** -76] * 8]
    else:
        rng = np.random.default_rng(40)
        n = 4096
        g = rng.standard_normal(n) * 10.0 ** rng.uniform(-3, 3, n)
        den = rng.random(n) < 0.46
        g[den] = rng.uniform(-1, 1, int(den.sum())) * 2.0 ** -126
        m = rng.standard_normal((n, 8)) * 3
    return np.asarray(g, f), np.asarray(m, f)


@pytest.mark.parametrize("name", [
    "denormal_g", "denormal_m", "rounds_up_to_2^-126",
    "tiny_at_unbounded_exponent", "random_4096_denormal_g"])
def test_gemv_seq_plain_flushes_denormals_as_reference_dot(name):
    """The weight gradient's flushes: a denormal ``g[n]`` or ``m[n, k]``
    is zero in its product, a step whose 24-bit rounding is below 2^-126
    is zero, one that rounds to 2^-126 is kept; by bits, as the
    reference's jitted dot (ROADMAP queue 3, item 40)."""
    from flowsentryx_tpu_torch.ops import kernels

    g, m = _flush_case(name)
    if name.startswith("random"):
        assert 1800 < int(((g != 0) & (np.abs(g) < 2.0 ** -126)).sum())
    got = kernels.gemv_seq(torch.from_numpy(g), torch.from_numpy(m))
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  _ref_dot(g, m).view(np.uint32))


@pytest.mark.parametrize("shards", [1, 2, 8])
def test_gemv_seq_shards_plain_equals_per_shard_chains(shards):
    """The data-parallel epoch's one-launch entry: ``[S, R]`` x ``[S, R,
    8]`` -> ``[S, 8]``, shard i by bits ``gemv_seq`` of shard i alone
    and the reference's dot of its rows."""
    from flowsentryx_tpu_torch.ops import kernels

    rng = np.random.default_rng(shards)
    r = 2500
    g = (rng.standard_normal((shards, r)) * 10.0 ** rng.uniform(
        -3, 3, (shards, r))).astype(np.float32)
    g[rng.random((shards, r)) < 0.05] = np.float32(3e-39)
    m = (rng.standard_normal((shards, r, 8)) * 3).astype(np.float32)
    got = kernels.gemv_seq_shards(torch.from_numpy(g), torch.from_numpy(m))
    assert got.shape == (shards, 8) and got.dtype == torch.float32
    for i in range(shards):
        one = kernels.gemv_seq_plain(torch.from_numpy(g[i]),
                                     torch.from_numpy(m[i]))
        np.testing.assert_array_equal(got[i].numpy().view(np.uint32),
                                      one.numpy().view(np.uint32))
        np.testing.assert_array_equal(got[i].numpy().view(np.uint32),
                                      _ref_dot(g[i], m[i]).view(np.uint32))


def test_observer_and_fake_quant_exact():
    rng = np.random.default_rng(3)
    n = 20_000
    lo = -np.abs(rng.standard_normal(n).astype(np.float32)) * \
        10.0 ** rng.uniform(-3, 3, n).astype(np.float32)
    hi = np.abs(rng.standard_normal(n).astype(np.float32)) * \
        10.0 ** rng.uniform(-3, 3, n).astype(np.float32)
    blo, bhi = lo * np.float32(1.3), hi * np.float32(0.7)
    # momentum update (fresh and not) and the jitted qparams, vectorized;
    # the momentum is traced, as it is inside the trainer's epoch (a leaf
    # of its state)
    ref = jax.jit(jax.vmap(lambda o, c, d: o.update_minmax(c, d),
                           in_axes=(jqat.Observer(0, 0, None), 0, 0)))(
        jqat.Observer(jnp.asarray(lo), jnp.asarray(hi), jnp.float32(0.9)),
        blo, bhi)
    got = qat.Observer(torch.from_numpy(lo), torch.from_numpy(hi)
                       ).update_minmax(torch.from_numpy(blo),
                                       torch.from_numpy(bhi))
    np.testing.assert_array_equal(got.lo.numpy(), _np(ref.lo))
    np.testing.assert_array_equal(got.hi.numpy(), _np(ref.hi))
    fresh = qat.fresh_observer().update_minmax(torch.tensor(blo[0]),
                                               torch.tensor(bhi[0]))
    assert fresh.lo.item() == blo[0] and fresh.hi.item() == bhi[0]
    qj = jax.jit(jax.vmap(lambda a, b: jqat.Observer(a, b).quint8_qparams()))(
        lo, hi)
    qt = qat.Observer(torch.from_numpy(lo),
                      torch.from_numpy(hi)).quint8_qparams()
    for u, v in zip(qt, qj):
        np.testing.assert_array_equal(u.numpy(), _np(v))
    # eager qparams (convert's) divide truly
    for i in range(64):
        ej = jqat.Observer(jnp.float32(lo[i]), jnp.float32(hi[i])
                           ).quint8_qparams()
        et = qat.Observer(torch.tensor(lo[i]), torch.tensor(hi[i])
                          ).quint8_qparams(eager=True)
        assert [float(v) for v in et] == [float(v) for v in ej]
    # fake-quant of a heavy-tailed vector against one range
    x = rng.lognormal(2, 2, 50_000).astype(np.float32)
    s, z = jax.jit(lambda o: o.quint8_qparams())(
        jqat.Observer(jnp.float32(-0.3), jnp.float32(17.7)))
    fq = jax.jit(lambda x, s, z: jqat.fake_quant(x, s, z, 0, 255))(x, s, z)
    tx = torch.from_numpy(x).requires_grad_(True)
    out = qat.fake_quant(tx, torch.tensor(_np(s)), torch.tensor(_np(z)),
                         0.0, 255.0)
    np.testing.assert_array_equal(out.detach().numpy(), _np(fq))
    out.sum().backward()                    # straight-through: identity
    assert torch.equal(tx.grad, torch.ones_like(tx))


def _ref_epoch_fn(X, y):
    """The reference's jitted epoch body (``train_logreg_qat``'s
    ``epoch``), built from its public pieces, returning the gradients.
    ``X`` and ``y`` are arguments of the jit, as in the reference (closed
    over, XLA would fold them into constants and lay the graph out
    otherwise)."""
    opt = optax.adagrad(0.05)

    def loss_fn(wb, obs_in, obs_out, X, y, quantize):
        w, b = wb
        p, obs_in, obs_out = jqat.qat_forward(w, b, obs_in, obs_out, X,
                                              quantize)
        eps = 1e-7
        losses = -(y * jnp.log(p + eps) + (1 - y) * jnp.log(1 - p + eps))
        return losses.sum(), (obs_in, obs_out)

    @partial(jax.jit, static_argnames=("quantize",))
    def epoch(state, X, y, quantize):
        (loss, (oi, oo)), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            (state.w, state.b), state.obs_in, state.obs_out, X, y, quantize)
        updates, opt_state = opt.update(grads, state.opt_state)
        w, b = optax.apply_updates((state.w, state.b), updates)
        return jqat.QatState(w, b, oi, oo, opt_state), loss, grads

    return lambda state, quantize: epoch(state, X, y, quantize)


def _carried(jstate):
    acc = jstate.opt_state[0].sum_of_squares
    return {"w": _np(jstate.w), "b": _np(jstate.b),
            "obs_in_lo": _np(jstate.obs_in.lo),
            "obs_in_hi": _np(jstate.obs_in.hi),
            "obs_out_lo": _np(jstate.obs_out.lo),
            "obs_out_hi": _np(jstate.obs_out.hi),
            "acc_w": _np(acc[0]), "acc_b": _np(acc[1])}


@pytest.fixture(scope="module")
def mid_training():
    """A reference state 30 epochs into QAT (15 warmup, 15 quantized) on
    a 4,000-row fixture, and its log1p'd training set."""
    X, y = fixture.cicids_fixture(n=4000, seed=12)
    res = jqat.train_logreg_qat(X, y, epochs=30)
    return X, y, res.state


def test_epochs_from_carried_state(mid_training):
    """One warmup epoch and one quantize epoch from the carried-over
    reference state: observers and gradients exact (the backward is
    written out in the compiled reference's order, the weight gradient a
    row-order FMA chain); the loss within rtol 1e-5 (its per-row ``log``
    is torch's, not XLA's); the state round-trips."""
    X, y, jstate = mid_training
    d = _carried(jstate)
    st = qat.state_from_numpy(d)
    back = qat.state_to_numpy(st)
    for k in d:
        np.testing.assert_array_equal(back[k], d[k])
    Xj = jnp.log1p(jnp.asarray(X))
    epoch = _ref_epoch_fn(Xj, jnp.asarray(y))
    Xt = torch.from_numpy(_np(Xj))
    yt = torch.from_numpy(y)
    np.testing.assert_array_equal(
        Xt.numpy(), qat.xla_log1p(torch.from_numpy(X)).numpy())
    for quantize in (False, True):
        # each epoch from the reference's state before it (the port's own
        # previous epoch differs in the last bit of Adagrad's rsqrt)
        st = qat.state_from_numpy(_carried(jstate))
        jstate, jloss, jgrads = epoch(jstate, quantize)
        st, loss = qat.qat_epoch(st, Xt, yt, quantize)
        # the update: exact but for the rsqrt's last bit
        np.testing.assert_allclose(st.w.numpy(), _np(jstate.w), rtol=1e-6)
        for ours, ref in ((st.obs_in, jstate.obs_in),
                          (st.obs_out, jstate.obs_out)):
            assert ours.lo.item() == float(ref.lo)
            assert ours.hi.item() == float(ref.hi)
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
        np.testing.assert_array_equal(st.w.grad.numpy(), _np(jgrads[0]))
        assert st.b.grad.item() == float(jgrads[1])


def _members(path):
    with zipfile.ZipFile(path) as z:
        return {n: z.read(n) for n in z.namelist()}


def test_convert_byte_identical_artifact(mid_training, tmp_path):
    """``convert`` of the same carried-over state writes the same npz:
    every member's bytes (zip timestamps aside), through ``save_params``
    in both packages."""
    _, _, jstate = mid_training
    st = qat.state_from_numpy(_carried(jstate))
    a = logreg.save_params(qat.convert(st), str(tmp_path / "port"))
    b = jlogreg.save_params(jqat.convert(jstate), str(tmp_path / "ref"))
    assert _members(a) == _members(b)


def test_train_logreg_qat_against_reference():
    """120 epochs on a 30,000-row fixture (``test_train.py``'s size),
    held to the reference's own cross-trainer tolerances: ``w_int8``
    within 1 code, ``in_scale`` rtol 1e-6, ``out_scale`` rtol 1e-2,
    losses rtol 1e-2; test F1 within 0.01, and the artifact equal to the
    reference on everything decided by the input observer."""
    X, y = fixture.cicids_fixture(n=30_000, seed=2)
    Xtr, Xte, ytr, yte = data.train_test_split(X, y)
    rj = jqat.train_logreg_qat(Xtr, ytr, epochs=120)
    rt = qat.train_logreg_qat(Xtr, ytr, epochs=120, device="cpu")
    pj, pt = rj.params, logreg.params_to_numpy(rt.params)
    assert np.abs(pt["w_int8"].astype(int)
                  - _np(pj.w_int8).astype(int)).max() <= 1
    np.testing.assert_allclose(pt["in_scale"], _np(pj.in_scale), rtol=1e-6)
    np.testing.assert_allclose(pt["out_scale"], _np(pj.out_scale), rtol=1e-2)
    assert int(pt["in_zp"]) == int(pj.in_zp) and int(pt["log1p"]) == 1
    np.testing.assert_allclose(rt.losses, rj.losses, rtol=1e-2)
    mj = jevaluate.evaluate_model(jlogreg.classify_batch_int8_matmul, pj,
                                  Xte, yte)
    mt = evaluate.evaluate_model(evaluate.int8_classify(rt.params),
                                 rt.params, Xte, yte)
    assert abs(mt["f1"] - mj["f1"]) <= 0.01 and 0.7 < mt["f1"] < 0.999


# ---------------------------------------------------------------------------
# Data-parallel QAT (test_train.py::TestQatDataParallel's inputs)
# ---------------------------------------------------------------------------


class _OptaxAdagrad:
    """The reference's Adagrad step, ``optax.adagrad(lr)`` jitted, over
    the port's ``[w, b]``: the port's optimizer factory interface with
    XLA:CPU's host ``rsqrt`` inside (ROADMAP queue 3, item 19), so a run
    through it isolates every other bit of the trainer."""

    def __init__(self, params, lr=0.05):
        self.params = params
        opt = optax.adagrad(lr)
        self.state = opt.init(tuple(jnp.asarray(_np(p.detach()))
                                    for p in params))

        def step(P, G, st):
            u, st = opt.update(G, st)
            return optax.apply_updates(P, u), st

        self._step = jax.jit(step)

    def step(self):
        P = tuple(jnp.asarray(_np(p.detach())) for p in self.params)
        G = tuple(jnp.asarray(_np(p.grad)) for p in self.params)
        new, self.state = self._step(P, G, self.state)
        with torch.no_grad():
            for p, v in zip(self.params, new):
                p.copy_(torch.from_numpy(np.array(v)))


@pytest.fixture(scope="module")
def dp_inputs():
    rng = np.random.default_rng(0)
    n = 203  # deliberately ragged: exercises the pad+mask path
    X = rng.lognormal(3, 2, (n, 8)).astype(np.float32)
    w_true = np.array([1.0, -1.0, 0.5, 0, 0, 2.0, -0.5, 0.0])
    y = ((np.log1p(X) @ w_true) > 2.0).astype(np.float32)
    from flowsentryx_tpu.parallel import make_mesh as jmake_mesh

    return X, y, jqat.train_logreg_qat_dp(X, y, jmake_mesh(8), epochs=30)


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


def _dp_mesh():
    from flowsentryx_tpu_torch.parallel import make_mesh

    return make_mesh(8, devices=["cpu"] * 8)


def test_train_logreg_qat_dp_byte_equal_reference(dp_inputs):
    """8 shards of the CPU against the reference's 8 virtual devices, 30
    epochs on 203 rows, the reference's own Adagrad step substituted
    (its host ``rsqrt`` is queue 3 item 19): weights, bias, both
    observers, every epoch's loss and the converted artifact, byte for
    byte.  What it holds: the observers merged from the global masked
    range, each shard's ``[26, 8]`` dot with its tail rows (item 29),
    the shards' gradients at the mesh size's cotangent (item 30), their
    in-order ``psum``, and the loss's fused sums."""
    X, y, ref = dp_inputs
    got = qat.train_logreg_qat_dp(X, y, _dp_mesh(), epochs=30,
                                  optimizer=_OptaxAdagrad)
    assert np.array_equal(_bits(got.state.w.detach()), _bits(ref.state.w))
    assert _bits(got.state.b.detach()) == _bits(ref.state.b)
    for o in ("obs_in", "obs_out"):
        for k in ("lo", "hi"):
            assert _bits(getattr(getattr(got.state, o), k)) == _bits(
                getattr(getattr(ref.state, o), k)), (o, k)
    assert np.array_equal(_bits(got.losses), _bits(ref.losses))
    p = logreg.params_to_numpy(got.params)
    for k, v in p.items():
        assert np.array_equal(v, _np(getattr(ref.params, k))), k


def test_train_logreg_qat_dp_own_adagrad_holds_reference_relations(
        dp_inputs):
    """With the port's own Adagrad (a correctly rounded ``rsqrt``) the
    8-shard run holds the reference's DP-against-single-device relations
    (``tests/test_train.py:144-190``) against the reference's DP run and
    against the port's single-device trainer: input observers
    bit-identical, ``w_int8`` within 1 code, ``in_scale`` rtol 1e-6,
    ``out_scale`` and the losses rtol 1e-2."""
    X, y, ref = dp_inputs
    got = qat.train_logreg_qat_dp(X, y, _dp_mesh(), epochs=30)
    single = qat.train_logreg_qat(X, y, epochs=30, device="cpu")
    p = logreg.params_to_numpy(got.params)
    for other, name in ((ref, "reference dp"), (single, "port single")):
        op = (logreg.params_to_numpy(other.params)
              if name == "port single" else
              {k: _np(getattr(other.params, k)) for k in p})
        assert _bits(got.state.obs_in.lo) == _bits(other.state.obs_in.lo)
        assert _bits(got.state.obs_in.hi) == _bits(other.state.obs_in.hi)
        assert np.abs(p["w_int8"].astype(int)
                      - op["w_int8"].astype(int)).max() <= 1, name
        np.testing.assert_allclose(p["in_scale"], op["in_scale"], rtol=1e-6)
        np.testing.assert_allclose(p["out_scale"], op["out_scale"],
                                   rtol=1e-2)
        np.testing.assert_allclose(got.losses, other.losses, rtol=1e-2)
    assert np.isfinite(got.losses).all()


@pytest.mark.parametrize("n", [5, 27, 203, 4003])
def test_dot8_tail_rows_equal_reference_dot(n):
    """XLA:CPU's ``[N, 8] @ [8]``: whole 8-row tiles add their products
    as adjacent pairs, the ``N mod 8`` tail rows as halves (queue 3 item
    29): the port's ``_dot8`` equals the jitted dot on every row."""
    rng = np.random.default_rng(n)
    x = rng.lognormal(0, 1, (n, 8)).astype(np.float32)
    w = rng.standard_normal(8).astype(np.float32)
    ref = jax.jit(lambda x, w: x @ w)(x, w)
    got = qat._dot8(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_array_equal(_bits(got), _bits(ref))


def test_dp_mesh_of_one_equals_single_device_epoch():
    """A one-shard mesh runs the single-device epoch's arithmetic (no
    padding, cotangent 1): one epoch of each phase from one state gives
    the same bits as :func:`qat.qat_epoch`."""
    X, y = fixture.cicids_fixture(n=2003, seed=4)
    Xt = qat.xla_log1p(torch.from_numpy(X))
    yt = torch.from_numpy(y)
    mask = torch.ones(len(X), dtype=torch.bool)
    a, b = qat.new_state("cpu"), qat.new_state("cpu")
    for quantize in (False, True):
        a, la = qat.qat_epoch(a, Xt, yt, quantize)
        b, lb = qat.qat_dp_epoch(b, Xt, yt, mask, 1, quantize)
        assert torch.equal(a.w.grad, b.w.grad)
        assert torch.equal(a.b.grad, b.b.grad)
        assert torch.equal(a.w, b.w) and torch.equal(la, lb)


# ---------------------------------------------------------------------------
# MLP families
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("family", ["mlp", "multiclass"])
@pytest.mark.parametrize("steps", [1, 10])
def test_minibatch_trainers_track_reference(family, steps):
    """Bit-equal init, the reference's batches (``default_rng(seed)``
    permutation), bf16 Adam: after 1 and 10 steps of 256 rows the last
    loss within rtol 1e-2 and at least 99 % of the bf16 weights equal."""
    X, y, yc = fixture.cicids_fixture(n=4000, seed=5, return_classes=True)
    n = 256 * steps
    if family == "mlp":
        pj, lj = jqat.train_mlp(X[:n], y[:n], epochs=1, batch_size=256)
        pt, lt = qat.train_mlp(X[:n], y[:n], epochs=1, batch_size=256,
                               device="cpu")
        init_j = jmlp.init_params(jax.random.PRNGKey(0))
        init_t = mlp.init_params(prng.prng_key(0))
    else:
        pj, lj = jqat.train_multiclass(X[:n], yc[:n], epochs=1,
                                       batch_size=256)
        pt, lt = qat.train_multiclass(X[:n], yc[:n], epochs=1,
                                      batch_size=256, device="cpu")
        init_j = jmulticlass.init_params(jax.random.PRNGKey(0))
        init_t = multiclass.init_params(prng.prng_key(0))
    for a, b in zip(init_t, init_j):
        np.testing.assert_array_equal(a.numpy(), _np(b).astype(np.float32))
    np.testing.assert_allclose(lt, lj, rtol=1e-2)
    eq = tot = 0
    for a, b in zip(pt, pj):
        b = _np(b).astype(np.float32)
        eq += int((a.numpy() == b).sum())
        tot += b.size
    assert eq / tot >= 0.99, eq / tot


@pytest.mark.parametrize("family", ["mlp", "multiclass"])
def test_minibatch_trainers_bit_equal_after_10_steps(family):
    """Every bf16 weight equal to the reference's after 10 steps of 256
    rows (the multiclass family through its written-out backward,
    ``multiclass.train_grads``: autograd left 99.86 % equal)."""
    X, y, yc = fixture.cicids_fixture(n=4000, seed=5, return_classes=True)
    n = 2560
    if family == "mlp":
        pj, _ = jqat.train_mlp(X[:n], y[:n], epochs=1, batch_size=256)
        pt, _ = qat.train_mlp(X[:n], y[:n], epochs=1, batch_size=256,
                              device="cpu")
    else:
        pj, _ = jqat.train_multiclass(X[:n], yc[:n], epochs=1,
                                      batch_size=256)
        pt, _ = qat.train_multiclass(X[:n], yc[:n], epochs=1,
                                     batch_size=256, device="cpu")
    for a, b in zip(pt, pj):
        np.testing.assert_array_equal(a.numpy(),
                                      _np(b).astype(np.float32))


def test_multiclass_train_grads_match_reference():
    """``multiclass.train_grads`` against ``jax.value_and_grad`` of the
    reference's loss at its init on one 256-row batch: every gradient
    bit-equal, the loss within rtol 1e-6."""
    X, _, yc = fixture.cicids_fixture(n=2048, seed=3, return_classes=True)
    x, lab = X[:256], yc[:256]
    jp = jmulticlass.init_params(jax.random.PRNGKey(1))
    lj, gj = jax.jit(jax.value_and_grad(jmulticlass.loss_fn))(
        jp, jnp.asarray(x, jnp.float32), jnp.asarray(lab, jnp.int32))
    tp = multiclass.MulticlassParams(*(
        t.to(torch.bfloat16) for t in multiclass.init_params(
            prng.prng_key(1))))
    xt = mlp.transform(torch.from_numpy(x.astype(np.float32))).to(
        torch.bfloat16)
    lt, gt = multiclass.train_grads(tp, xt, torch.from_numpy(
        lab.astype(np.int32)))
    for a, b in zip(gt, gj):
        np.testing.assert_array_equal(a.float().numpy(),
                                      _np(b).astype(np.float32))
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-6)


@pytest.mark.parametrize("family", ["mlp", "multiclass"])
def test_loss_fn_matches_reference(family):
    """The families' training losses on the reference's init: the
    forward's logits bit-equal, the mean loss within rtol 1e-6 (its
    ``exp``/``log`` are torch's, not XLA's)."""
    X, y, yc = fixture.cicids_fixture(n=2048, seed=3, return_classes=True)
    jfam, tfam = ((jmlp, mlp) if family == "mlp"
                  else (jmulticlass, multiclass))
    lab = y if family == "mlp" else yc
    jp = jfam.init_params(jax.random.PRNGKey(1))
    tp = type(tfam.init_params(prng.prng_key(1)))(*(
        t.to(torch.bfloat16) for t in tfam.init_params(prng.prng_key(1))))
    xt = mlp.transform(torch.from_numpy(X)).to(torch.bfloat16)
    lg, _ = mlp.train_forward(tp, xt)
    jlg = _np(jfam.logits(jp, jnp.asarray(X)))
    np.testing.assert_array_equal(
        lg[:, 0].numpy() if family == "mlp" else lg.numpy(), jlg)
    np.testing.assert_allclose(
        tfam.loss_fn(tp, xt, torch.from_numpy(lab)).item(),
        float(jfam.loss_fn(jp, jnp.asarray(X), jnp.asarray(lab))),
        rtol=1e-6)


def test_mlp_trains_to_reference_quality():
    """The reference's ``test_mlp_trains``: 20 epochs of 1,024-row
    batches on 5,000 synthetic rows reach F1 > 0.9; the artifact loads
    back bit-equal."""
    X, y = data.synthetic_dataset(20_000, seed=11)
    Xtr, Xte, ytr, yte = data.train_test_split(X, y)
    params, losses = qat.train_mlp(Xtr[:5000], ytr[:5000], epochs=20,
                                   batch_size=1024, device="cpu")
    m = evaluate.evaluate_model(mlp.classify_batch, params, Xte, yte)
    assert m["f1"] > 0.9, m
    assert losses.shape == (20,) and np.isfinite(losses).all()


def test_save_params_layouts_equal_reference(tmp_path):
    jp = jmlp.init_params(jax.random.PRNGKey(4))
    tp = mlp.init_params(prng.prng_key(4))
    a = mlp.save_params(tp, str(tmp_path / "m"))
    b = jmlp.save_params(jp, str(tmp_path / "jm"))
    assert _members(a) == _members(b)
    jp = jmulticlass.init_params(jax.random.PRNGKey(4))
    tp = multiclass.init_params(prng.prng_key(4))
    a = multiclass.save_params(tp, str(tmp_path / "c"))
    b = jmulticlass.save_params(jp, str(tmp_path / "jc"))
    assert _members(a) == _members(b)
    back = multiclass.load_params(a)
    for u, v in zip(back, tp):
        assert torch.equal(u, v)


# ---------------------------------------------------------------------------
# fsx train
# ---------------------------------------------------------------------------


def _run(main, argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = main(argv)
    return rc, json.loads(buf.getvalue())


def _flat(d, prefix=""):
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        elif isinstance(v, (int, float)) and not isinstance(v, bool):
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("model", ["logreg_int8", "mlp", "multiclass"])
def test_cli_train_matches_reference(model, tmp_path):
    """``fsx train --synthetic 4000 --epochs 20`` in both packages: the
    same keys, rates within 0.01 (counts within 1 % of the test split),
    and an artifact the reference's loader reads."""
    args = ["train", "--model", model, "--synthetic", "4000", "--epochs",
            "20"]
    rc_j, rj = _run(jcli.main, args + ["--out", str(tmp_path / "j.npz")])
    rc_t, rt = _run(cli.main, args + ["--device", "cpu", "--out",
                                      str(tmp_path / "t.npz")])
    assert rc_j == rc_t == 0
    assert rj.keys() == rt.keys()
    fj, ft = _flat(rj), _flat(rt)
    assert fj.keys() == ft.keys()
    for k in fj:
        if k in ("final_loss",):
            np.testing.assert_allclose(ft[k], fj[k], rtol=5e-2)
        elif isinstance(fj[k], float):
            assert abs(ft[k] - fj[k]) <= 0.01, (k, ft[k], fj[k])
        else:
            assert abs(ft[k] - fj[k]) <= max(1, 0.01 * rt["test_n"]), k
    loader = {"logreg_int8": jlogreg.load_params, "mlp": jmlp.load_params,
              "multiclass": jmulticlass.load_params}[model]
    loader(rt["artifact"])


@pytest.mark.parametrize("argv", [
    ["--epochs", "0"],
    ["--model", "mlp", "--slow-weight", "4"],
    ["--model", "logreg_int8", "--augment-shift", "2"],
    ["--model", "multiclass", "--data", "x*.csv"],
    ["--slow-weight", "4", "--synthetic", "500"],
])
def test_cli_train_refusals_match_reference(argv):
    with pytest.raises(SystemExit) as ej:
        with redirect_stdout(io.StringIO()):
            jcli.main(["train", *argv])
    with pytest.raises(SystemExit) as et:
        with redirect_stdout(io.StringIO()):
            cli.main(["train", *argv, "--device", "cpu"])
    assert str(et.value) == str(ej.value)


def test_cli_train_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        cli.main(["train", "--synthetic", "500", "--epochs", "1"])
