"""Int8-quantized logistic regression (the serving classifier).

Counterpart of ``flowsentryx_tpu/models/logreg.py``: the same params,
the same npz artifact format, the plain PyTorch versions of the int8
scoring pipeline, and the float lane :func:`classify_float`
(``logreg_float``).  The CUDA kernel that serves the int8 lane on the
card is :func:`flowsentryx_tpu_torch.ops.kernels.score_int8`; the int8
functions here are its plain versions (CPU tests, and the on-card
comparison).  The optional ``log1p`` and the sigmoid are XLA's
(``core/device.py``): on the raw48 wire the scorer sees any float32, not
only the 256 values a compact16 code decodes to.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from flowsentryx_tpu_torch.core.device import fma32, xla_log1p, xla_sigmoid


class LogRegParams(NamedTuple):
    """Quantized logistic-regression parameters (torch-artifact
    semantics): qint8 weights with zero point 0, quint8 input and
    output activations, quantized sigmoid at scale 1/256.  Each leaf is
    a 0-d tensor (``w_int8`` is ``[8]`` int8) on the serving device."""

    w_int8: torch.Tensor
    bias: torch.Tensor
    w_scale: torch.Tensor
    in_scale: torch.Tensor
    in_zp: torch.Tensor
    out_scale: torch.Tensor
    out_zp: torch.Tensor
    log1p: torch.Tensor


_DTYPES = dict(
    w_int8=np.int8, bias=np.float32, w_scale=np.float32,
    in_scale=np.float32, in_zp=np.int32, out_scale=np.float32,
    out_zp=np.int32, log1p=np.int32,
)


def params_from_numpy(d, device: str | torch.device = "cpu"
                      ) -> LogRegParams:
    """A reference ``LogRegParams`` given as numpy arrays — a dict such
    as ``{k: np.asarray(v) for k, v in p._asdict().items()}``, an open
    npz, or any object with those attributes — -> the port's params.
    ``log1p`` defaults to 0 (v1 artifacts predate it)."""
    if not hasattr(d, "keys") or not callable(d.keys):
        d = {k: getattr(d, k) for k in LogRegParams._fields if hasattr(d, k)}
    vals = {}
    for k, dt in _DTYPES.items():
        v = np.asarray(d[k] if k in d else 0).astype(dt)
        vals[k] = torch.from_numpy(np.array(v)).to(device)
    return LogRegParams(**vals)


def params_to_numpy(p: LogRegParams) -> dict:
    """The port's params -> ``{field: numpy array}`` (reference dtypes)."""
    return {k: getattr(p, k).cpu().numpy() for k in LogRegParams._fields}


def make_params(w_int8, bias: float, w_scale: float, in_scale: float,
                in_zp: int = 0, out_scale: float = 1.0, out_zp: int = 0,
                log1p: bool = False,
                device: str | torch.device = "cpu") -> LogRegParams:
    return params_from_numpy(dict(
        w_int8=np.asarray(w_int8), bias=bias, w_scale=w_scale,
        in_scale=in_scale, in_zp=in_zp, out_scale=out_scale, out_zp=out_zp,
        log1p=int(bool(log1p))), device)


#: The reference's converted int8 artifact (the reference embeds the
#: same values as ``GOLDEN``).
GOLDEN = dict(
    w_int8=[0, -80, 106, -9, -85, -52, 106, -45],
    bias=0.0278,
    w_scale=0.002657087752595544,
    in_scale=944881.875,
    in_zp=0,
    out_scale=398330.9688,
    out_zp=84,
)


def golden_params(device: str | torch.device = "cpu") -> LogRegParams:
    return make_params(**GOLDEN, device=device)


_READABLE_SCHEMA_VERSIONS = (1, 2)


def load_params(path: str, device: str | torch.device = "cpu"
                ) -> LogRegParams:
    """Load a reference ``.npz`` artifact (schema v1 or v2)."""
    path = path if path.endswith(".npz") else path + ".npz"
    with np.load(path) as z:
        version = int(z["schema_version"]) if "schema_version" in z else 0
        if version not in _READABLE_SCHEMA_VERSIONS:
            raise ValueError(f"artifact schema version {version} not in "
                             f"{_READABLE_SCHEMA_VERSIONS}")
        return params_from_numpy({k: z[k] for k in z.files}, device)


#: The artifact schema :func:`save_params` writes (the reference's).
ARTIFACT_SCHEMA_VERSION = 2


def save_params(params: LogRegParams, path: str) -> str:
    """Write ``params`` as a reference ``.npz`` artifact (schema v2, the
    reference's ``save_params`` layout); returns the path written
    (``.npz`` appended if missing)."""
    path = path if path.endswith(".npz") else path + ".npz"
    np.savez(path, **params_to_numpy(params),
             schema_version=ARTIFACT_SCHEMA_VERSION)
    return path


# ---------------------------------------------------------------------------
# Scoring (plain PyTorch)
# ---------------------------------------------------------------------------


def _quantize_u8(x: torch.Tensor, scale: torch.Tensor,
                 zp: torch.Tensor) -> torch.Tensor:
    """quint8 affine quantization.  True division (a reciprocal multiply
    is one ULP off at round-half boundaries) and ``torch.round``, which
    rounds half to even like the reference."""
    q = torch.round(x / scale) + zp.float()
    return torch.clamp(q, 0.0, 255.0)


def requant_acc(params: LogRegParams, acc: torch.Tensor) -> torch.Tensor:
    """Integer accumulator ``sum((q_x - in_zp) * w_int8)`` -> the quint8
    output code ``q_y`` (f32 in 0..255).  ``acc * s + bias`` is one fused
    multiply-add, as the reference's compiled graph rounds it
    (:func:`~flowsentryx_tpu_torch.core.device.fma32`)."""
    s = params.in_scale * params.w_scale
    y = fma32(acc.float(), s, params.bias)
    return _quantize_u8(y, params.out_scale, params.out_zp)


def score_from_code(params: LogRegParams, q_y: torch.Tensor) -> torch.Tensor:
    """Output code ``q_y`` -> quantized probability: dequant -> sigmoid
    -> output quant on the 1/256 grid.  Only 256 inputs exist, so the
    CUDA kernel reads this function's values from a table
    (:func:`flowsentryx_tpu_torch.ops.kernels.pack_score_params`)."""
    y_dq = (q_y - params.out_zp.float()) * params.out_scale
    p = xla_sigmoid(y_dq)
    return torch.clamp(torch.round(p * 256.0), 0.0, 255.0) * (1.0 / 256.0)


def score_from_acc(params: LogRegParams, acc: torch.Tensor) -> torch.Tensor:
    """Integer accumulator -> quantized probability: requant -> sigmoid
    -> output quant."""
    return score_from_code(params, requant_acc(params, acc))


def _maybe_log1p(params: LogRegParams, x: torch.Tensor) -> torch.Tensor:
    """The artifact's feature-domain transform (XLA's ``log1p``)."""
    return torch.where(params.log1p > 0, xla_log1p(x), x)


def int8_acc(params: LogRegParams, x: torch.Tensor) -> torch.Tensor:
    """``[B, 8]`` f32 features -> ``[B]`` int32 accumulators (optional
    log1p, input quantization, the K=8 int8 dot)."""
    x = _maybe_log1p(params, x.float())
    q_x = _quantize_u8(x, params.in_scale, params.in_zp).to(torch.int32)
    return ((q_x - params.in_zp) * params.w_int8.to(torch.int32)).sum(
        dim=1, dtype=torch.int32)


def classify_batch_int8_matmul(params: LogRegParams,
                               x: torch.Tensor) -> torch.Tensor:
    """Plain ``[B, 8] -> [B]`` int8 scoring, bit-identical to the
    reference lane of the same name (all intermediates are exact small
    integers up to the requant)."""
    return score_from_acc(params, int8_acc(params, x))


def classify_float(params: LogRegParams, x: torch.Tensor) -> torch.Tensor:
    """The float lane ``sigmoid(x @ w_dequant + bias)``, ``[B, 8] -> [B]``,
    rounded as the reference's compiled graph rounds it: ``w_dequant =
    f32(w_int8 * w_scale)``, the dot one rounded product then seven
    fused multiply-adds in feature order, the bias a separate add, and
    XLA's sigmoid."""
    x = _maybe_log1p(params, x.float())
    w = params.w_int8.float() * params.w_scale
    acc = x[:, 0] * w[0]
    for k in range(1, x.shape[1]):
        acc = fma32(x[:, k], w[k], acc)
    return xla_sigmoid(acc + params.bias)
