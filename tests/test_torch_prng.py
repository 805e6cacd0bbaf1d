"""The port's threefry (``core/prng.py``) against ``jax.random``, the
default ``mlp`` and ``multiclass`` params against the reference's
``init_params(PRNGKey(0))``, and ``serve --model mlp`` without an
artifact.

The reference draws with jax's default generator, threefry2x32 with
``jax_threefry_partitionable`` as this repository's jax sets it; the
port rebuilds it in numpy ``uint32`` and ``normal`` through XLA:CPU's
``erf_inv`` (``core/device.py::xla_erf_inv``)."""

import json

import numpy as np
import pytest
import torch

import jax

from flowsentryx_tpu.models import get_model as jget_model
from flowsentryx_tpu_torch import cli
from flowsentryx_tpu_torch.core import prng
from flowsentryx_tpu_torch.models import registry

SHAPES = [(8, 32), (32, 32), (32, 1), (32, 4), (1 << 16,)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The float64 emulation of XLA:CPU's rounding is many small
    elementwise ops: one torch thread runs them ~10x faster than a
    thread per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _keys():
    """``PRNGKey(0)``, its three split keys, and two other seeds."""
    out = [(jax.random.PRNGKey(0), prng.prng_key(0))]
    for jk, tk in zip(jax.random.split(jax.random.PRNGKey(0), 3),
                      prng.split(prng.prng_key(0), 3)):
        out.append((jk, tk))
    for seed in (7, 123456789):
        out.append((jax.random.PRNGKey(seed), prng.prng_key(seed)))
    return out


def test_prng_key_and_split_equal_jax():
    assert jax.config.jax_threefry_partitionable
    for jk, tk in _keys():
        np.testing.assert_array_equal(np.asarray(jk), tk)
        for n in (2, 3, 5):
            np.testing.assert_array_equal(np.asarray(jax.random.split(jk, n)),
                                          prng.split(tk, n))


@pytest.mark.parametrize("shape", SHAPES)
def test_bits_uniform_normal_equal_jax(shape):
    keys = _keys() if np.prod(shape) < 1 << 12 else _keys()[:2]
    for jk, tk in keys:
        np.testing.assert_array_equal(np.asarray(jax.random.bits(jk, shape)),
                                      prng.bits(tk, shape))
        np.testing.assert_array_equal(
            np.asarray(jax.random.uniform(jk, shape)).view(np.uint32),
            prng.uniform(tk, shape).view(np.uint32))
        np.testing.assert_array_equal(
            np.asarray(jax.random.normal(jk, shape)).view(np.uint32),
            prng.normal(tk, shape).view(np.uint32))


def test_normal_tail_equal_jax():
    """2^17 draws under each of the three keys split from
    ``PRNGKey(0)`` hold several hundred values in the
    ``w = -log1p(-u^2) >= 5`` tail of ``erf_inv`` (``|u| > 0.9966``,
    ``|z| > 2.9``); every one equals ``jax.random.normal``'s bits."""
    tail = 0
    for jk, tk in _keys()[1:4]:
        want = np.asarray(jax.random.normal(jk, (1 << 17,)))
        got = prng.normal(tk, (1 << 17,))
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))
        tail += int((np.abs(got) > 2.9).sum())
    assert tail > 300


@pytest.mark.parametrize("name", ["mlp", "multiclass"])
def test_default_params_equal_reference_init(name):
    """``get_model(name).init()`` is the reference's bf16
    ``init_params(PRNGKey(0))`` byte for byte, and ``init_params`` under
    another key too."""
    jp = jget_model(name).init()
    tp = registry.get_model(name).init("cpu")
    assert tp._fields == jp._fields
    for k in jp._fields:
        want = np.asarray(getattr(jp, k)).astype(np.float32)
        got = getattr(tp, k).numpy()
        assert got.shape == want.shape, k
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32), k)
    if name == "mlp":
        from flowsentryx_tpu.models import mlp as jmlp

        from flowsentryx_tpu_torch.models import mlp

        jp = jmlp.init_params(jax.random.PRNGKey(42), hidden=16)
        tp = mlp.init_params(prng.prng_key(42), hidden=16)
        for k in jp._fields:
            np.testing.assert_array_equal(
                getattr(tp, k).numpy(),
                np.asarray(getattr(jp, k)).astype(np.float32), k)


def test_cli_serves_mlp_without_artifact(capsys):
    """``serve --model mlp`` with no ``--artifact`` serves the default
    params over raw48 on the CPU, as the reference's serve does."""
    rc = cli.main(["serve", "--device", "cpu", "--table-capacity", "4096",
                   "--model", "mlp", "--batches", "2", "--json"])
    assert rc == 0
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rep["dispatch"]["wire"] == "raw48"
    assert rep["batches"] == 2 and rep["records"] == 2 * 2048
    assert rep["stats"]["allowed"] + rep["stats"]["dropped"] == rep["records"]
