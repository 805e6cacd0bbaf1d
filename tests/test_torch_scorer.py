"""The port's int8 scorer (``score_int8`` and its plain version) against
the JAX reference, bit for bit.

The Pallas kernel runs in interpret mode here, as the reference's own
tests run it on the CPU.  The CUDA kernel itself is held to the plain
version on the card (``tests/test_torch_cuda.py`` and ``chip_smoke.py``)."""

import ctypes
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from flowsentryx_tpu.core import schema as jschema
from flowsentryx_tpu.models import logreg as jlogreg
from flowsentryx_tpu.ops import pallas_kernels as pk
from flowsentryx_tpu_torch.core import schema
from flowsentryx_tpu_torch.core.device import fma32
from flowsentryx_tpu_torch.models import logreg, registry
from flowsentryx_tpu_torch.ops import kernels

ARTIFACT = str(Path(__file__).resolve().parents[1] / "artifacts" / "logreg_int8.npz")


def _pair(name):
    jp = (jlogreg.golden_params() if name == "golden"
          else jlogreg.load_params(ARTIFACT))
    return jp, logreg.params_from_numpy(
        {k: np.asarray(v) for k, v in jp._asdict().items()})


@pytest.mark.parametrize("name", ["golden", "log1p"])
@pytest.mark.parametrize("b", [1, 7, 512, 1000])
def test_plain_score_matches_pallas_and_xla(rng, name, b):
    jp, tp = _pair(name)
    hi = 2e6 if name == "golden" else 1e6
    x = rng.uniform(0, hi, (b, jschema.NUM_FEATURES)).astype(np.float32)
    want_pallas = np.asarray(pk.score_int8(jp, jnp.asarray(x)))
    want_xla = np.asarray(jlogreg.classify_batch_int8_matmul(
        jp, jnp.asarray(x)))
    before = dict(kernels.LAUNCHES)
    got = kernels.score_int8(tp, torch.from_numpy(x)).numpy()
    assert kernels.LAUNCHES == before   # CPU tensor: the plain version
    np.testing.assert_array_equal(got, want_pallas)
    np.testing.assert_array_equal(got, want_xla)


@pytest.mark.parametrize("name", ["golden", "log1p"])
def test_score_from_acc_exhaustive(name):
    """Every reachable accumulator, |acc| <= 255 * 127 * 8."""
    jp, tp = _pair(name)
    lim = 255 * 127 * 8
    acc = np.arange(-lim, lim + 1, dtype=np.int32)
    want = np.asarray(jlogreg.score_from_acc(jp, jnp.asarray(acc)))
    got = logreg.score_from_acc(tp, torch.from_numpy(acc)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["golden", "log1p"])
def test_model_mode_wire_grid_scores(name):
    """The serving input domain: every u8 code of each feature, decoded
    from the compact wire and scored, equals the reference's chain."""
    jp, tp = _pair(name)
    quant = jschema.model_quant_args(jp)
    q = np.random.default_rng(1).integers(0, 256, (8 * 256, 8),
                                          dtype=np.uint32)
    for f in range(8):
        q[f * 256:(f + 1) * 256, f] = np.arange(256, dtype=np.uint32)
    raw = np.zeros((q.shape[0] + 1, 4), np.uint32)
    raw[:-1, 1] = q[:, 0] | q[:, 1] << 8 | q[:, 2] << 16 | q[:, 3] << 24
    raw[:-1, 2] = q[:, 4] | q[:, 5] << 8 | q[:, 6] << 16 | q[:, 7] << 24
    raw[-1, 0] = q.shape[0]
    jx = jschema.decode_compact(jnp.asarray(raw), **quant).feat
    want = np.asarray(jlogreg.classify_batch_int8_matmul(jp, jx))
    tx = schema.decode_compact(schema.wire_to_tensor(raw), **quant).feat
    got = kernels.score_int8(tp, tx).numpy()
    np.testing.assert_array_equal(got, want)


def test_params_round_trip_and_artifact():
    jp = jlogreg.load_params(ARTIFACT)
    tp = logreg.load_params(ARTIFACT)
    back = logreg.params_to_numpy(tp)
    for k, v in jp._asdict().items():
        np.testing.assert_array_equal(back[k], np.asarray(v))
        assert back[k].dtype == np.asarray(v).dtype
    g = logreg.golden_params()
    for k, v in jlogreg.golden_params()._asdict().items():
        np.testing.assert_array_equal(logreg.params_to_numpy(g)[k],
                                      np.asarray(v))


def test_registry_lanes():
    for name in ("logreg_int8", "logreg_int8_pallas"):
        assert registry.get_model(name).classify_batch is kernels.score_int8
    for name in registry.NOT_PORTED:
        with pytest.raises(KeyError, match="not ported"):
            registry.get_model(name)
    with pytest.raises(KeyError, match="unknown model"):
        registry.get_model("nope")



@pytest.mark.parametrize("name", ["golden", "log1p"])
def test_kernel_arithmetic_from_packed_params_matches_plain(name):
    """The CUDA kernel's arithmetic, written out in numpy from the packed
    argument struct (per-lane quantize, the integer dot, one fma, one
    division, rint, then the output table), equals the plain scorer."""
    _, tp = _pair(name)
    a = kernels.pack_score_params(tp)
    assert ctypes.sizeof(a.args) == 1060
    rng = np.random.default_rng(17)
    x = np.concatenate([rng.uniform(0, 2e6, (1 << 14, 8)),
                        rng.uniform(0, 10, (1 << 12, 8))]).astype(np.float32)
    f = np.float32
    w = np.frombuffer(np.array([a.args.w_lo, a.args.w_hi], "<u4").tobytes(),
                      np.int8).astype(np.int64)
    v = torch.log1p(torch.from_numpy(x)).numpy() if a.args.log1p else x
    q = np.clip(np.rint(v / f(a.args.in_scale)) + f(a.args.in_zp), 0, 255)
    acc = ((q.astype(np.int64) - int(a.args.in_zp)) * w).sum(axis=1)
    y = fma32(torch.from_numpy(acc.astype(f)), a.args.s, a.args.bias).numpy()
    q_y = np.clip(np.rint(y / f(a.args.out_scale)) + f(a.args.out_zp), 0,
                  255).astype(np.int64)
    got = np.array(a.args.table, f)[q_y]
    want = kernels.score_int8_plain(tp, torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
