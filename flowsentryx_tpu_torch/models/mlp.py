"""Small MLP detector head (8 -> hidden -> hidden -> 1, bfloat16).

Counterpart of ``flowsentryx_tpu/models/mlp.py``: the same params, the
same npz artifact format, and the forward pass rounded as the
reference's compiled XLA:CPU graph rounds it:

* the input transform ``sign(x) * log1p(|x|)`` with XLA's ``log1p``
  (:func:`~flowsentryx_tpu_torch.core.device.xla_log1p`), then bf16;
* each layer's matmul is an f32 accumulation of exact bf16 x bf16
  products in XLA:CPU's order for that shape (:func:`fixed_order_dot`),
  rounded to bf16; the bias add is an f32 add of the two bf16 values,
  rounded to bf16 again; then relu;
* the final sigmoid is XLA's (:func:`~..core.device.xla_sigmoid`).

``torch.matmul`` fixes no summation order (a sequential CPU sum differs
on up to 1 % of layer outputs), so the layers are written as explicit
accumulations.  The default params are the reference's
``init_params(PRNGKey(0))``, drawn by the port's own threefry
(:func:`init_params`, :mod:`~flowsentryx_tpu_torch.core.prng`).

Training (``train/qat.py``) does not run that scorer: its fixed-order
sums have no useful gradient and cost ~1,000 ops.  :func:`train_forward`
is the differentiable forward over bfloat16 parameters (``torch``'s own
bf16 matmuls, f32 accumulation), on inputs already passed through
:func:`transform`; :func:`loss_fn` is the reference's mean stable BCE,
:func:`xla_batch_sum` the reference's bf16 reduction over the batch (the
bias gradients), and :func:`save_params` writes the reference's
``.npz`` layout.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from flowsentryx_tpu_torch.core import prng
from flowsentryx_tpu_torch.core.device import xla_log1p, xla_sigmoid


class MlpParams(NamedTuple):
    """Weights as float32 tensors holding bfloat16 values (the
    reference's dtype), on the serving device."""

    w1: torch.Tensor  # [8, H]
    b1: torch.Tensor  # [H]
    w2: torch.Tensor  # [H, H]
    b2: torch.Tensor  # [H]
    w3: torch.Tensor  # [H, C]
    b3: torch.Tensor  # [C]


#: XLA:CPU's summation order per layer, ``(accumulators, combine)``:
#: ``n`` interleaved accumulators (lane ``k`` adds into ``k mod n``, in
#: order of ``k``), combined as adjacent pairs (``"adjacent"``:
#: ``(a0+a1)+(a2+a3)``) or as halves (``"halves"``: ``a_i + a_{i+n/2}``
#: first).  Found against the jitted reference step at B = 256 and
#: 2048 (``tests/test_torch_models.py``): the ``[B, K] @ [K, H]``
#: hidden layers use two accumulators, the ``[B, 32] @ [32, 1]`` head
#: eight combined as halves, the ``[B, 32] @ [32, 4]`` head four
#: combined adjacently.
HIDDEN_ORDER = (2, "adjacent")
HEAD_ORDER = {1: (8, "halves"), 4: (4, "adjacent")}


def fixed_order_dot(x: torch.Tensor, w: torch.Tensor, n_acc: int,
                    combine: str) -> torch.Tensor:
    """``[B, K] @ [K, N]`` in f32, each product exact (bf16 operands), the
    sum in a fixed order (:data:`HIDDEN_ORDER`)."""
    prods = x[:, :, None] * w[None, :, :]          # [B, K, N], exact
    k = prods.shape[1]
    accs = []
    for j in range(min(n_acc, k)):
        a = prods[:, j]
        for i in range(j + n_acc, k, n_acc):
            a = a + prods[:, i]
        accs.append(a)
    while len(accs) > 1:
        if combine == "adjacent":
            accs = [accs[i] + accs[i + 1] for i in range(0, len(accs), 2)]
        else:
            h = len(accs) // 2
            accs = [accs[i] + accs[i + h] for i in range(h)]
    return accs[0]


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """Round f32 to bfloat16 (nearest even) and back to f32."""
    return t.to(torch.bfloat16).float()


def _layer(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
           order: tuple[int, str], round_out: bool = True) -> torch.Tensor:
    """bf16 ``x @ w + b`` as the compiled graph rounds it: the dot
    rounded to bf16, then the bias added in f32 and (``round_out``)
    rounded again.  XLA drops a bf16 -> f32 round trip where the result
    is converted to f32 anyway (its excess-precision rule): the
    multiclass head's sum stays f32, the MLP head's is rounded."""
    y = _bf16(fixed_order_dot(x, w, *order)) + b
    return _bf16(y) if round_out else y


def transform(x: torch.Tensor) -> torch.Tensor:
    """The family's feature contract: ``sign(x) * log1p(|x|)``, bf16."""
    x = x.float()
    return _bf16(torch.sign(x) * xla_log1p(x.abs()))


def trunk(params, x: torch.Tensor) -> torch.Tensor:
    """``[B, 8]`` features -> ``[B, H]`` bf16 hidden activations (shared
    with the multiclass family)."""
    h = torch.relu(_layer(transform(x), params.w1, params.b1, HIDDEN_ORDER))
    return torch.relu(_layer(h, params.w2, params.b2, HIDDEN_ORDER))


def head(params, h: torch.Tensor, round_out: bool = True) -> torch.Tensor:
    """``[B, H]`` -> ``[B, C]`` f32 logits."""
    order = HEAD_ORDER[params.w3.shape[1]]
    return _layer(h, params.w3, params.b3, order, round_out)


def logits(params: MlpParams, x: torch.Tensor) -> torch.Tensor:
    """``[B, 8] -> [B]`` pre-sigmoid logits."""
    return head(params, trunk(params, x))[:, 0]


def classify_batch(params: MlpParams, x: torch.Tensor) -> torch.Tensor:
    """Batched scoring -> ``[B]`` probabilities."""
    return xla_sigmoid(logits(params, x))


# ---------------------------------------------------------------------------
# Training forward and loss
# ---------------------------------------------------------------------------


def xla_batch_sum(g: torch.Tensor) -> torch.Tensor:
    """``g.sum(0)`` in ``g``'s dtype, ordered as XLA:CPU orders a
    reduction over a long axis: while more than 32 rows remain, zero-pad
    to a multiple of 32 (half the padding in front, the odd row at the
    end) and sum each block of 32 rows left to right; then sum the rest
    left to right.  Every add is rounded to the dtype (the reference's
    bf16 reducer converts after each add), so in bfloat16 this is not
    torch's f32-accumulated ``sum``."""
    while g.shape[0] > 32:
        pad = (-g.shape[0]) % 32
        if pad:
            z = g.new_zeros((pad // 2, *g.shape[1:]))
            g = torch.cat([z, g, g.new_zeros((pad - pad // 2,
                                              *g.shape[1:]))])
        blk = g.reshape(-1, 32, *g.shape[1:])
        acc = torch.zeros_like(blk[:, 0])
        for i in range(32):
            acc = acc + blk[:, i]
        g = acc
    acc = torch.zeros_like(g[0])
    for i in range(g.shape[0]):
        acc = acc + g[i]
    return acc


def train_forward(params, xt: torch.Tensor):
    """``[B, 8]`` bf16 :func:`transform` output -> ``([B, C]`` f32 logits,
    the three bf16 pre-activations ``(a1, a2, a3))`` over bfloat16
    ``params``, differentiable.  The trainer takes the bias gradients
    from the pre-activations' gradients (:func:`xla_batch_sum`): torch's
    own bias gradient is an f32-accumulated sum, the reference's a bf16
    one."""
    a1 = xt @ params.w1 + params.b1
    a2 = torch.relu(a1) @ params.w2 + params.b2
    a3 = torch.relu(a2) @ params.w3 + params.b3
    return a3.float(), (a1, a2, a3)


def bce_mean(lg: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean binary cross-entropy of ``[B]`` logits (stable form)."""
    losses = (torch.clamp(lg, min=0) - lg * labels
              + torch.log1p(torch.exp(-lg.abs())))
    return losses.mean()


def loss_fn(params, xt: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean binary cross-entropy (numerically stable logit form) on
    :func:`transform`-ed inputs."""
    return bce_mean(train_forward(params, xt)[0][:, 0], labels)


# ---------------------------------------------------------------------------
# Init, artifact I/O and weights carried across
# ---------------------------------------------------------------------------

ARTIFACT_SCHEMA_VERSION = 1
NUM_FEATURES = 8


def init_params(key=None, hidden: int = 32,
                device: str | torch.device = "cpu", cls=MlpParams,
                n_out: int = 1):
    """The reference's ``init_params(key, hidden)``: ``key`` (a
    :func:`~..core.prng.prng_key`; None = ``PRNGKey(0)``) split in three,
    each weight ``normal(k, shape) * sqrt(2 / fan_in)`` in float32 (the
    scale a power of two for fan-ins 8 and 32, so the product is exact)
    rounded to bfloat16, every bias zero.  ``n_out`` is the head's
    width (``multiclass`` passes its class count)."""
    k1, k2, k3 = prng.split(prng.prng_key(0) if key is None else key, 3)

    def he(k, fan_in, shape):
        scale = np.float32(np.sqrt(np.float32(2.0) / np.float32(fan_in)))
        return prng.normal(k, shape) * scale

    z = np.zeros
    return params_from_numpy(dict(
        w1=he(k1, NUM_FEATURES, (NUM_FEATURES, hidden)), b1=z(hidden),
        w2=he(k2, hidden, (hidden, hidden)), b2=z(hidden),
        w3=he(k3, hidden, (hidden, n_out)), b3=z(n_out)), device, cls=cls)


def _npz_path(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def params_from_numpy(d, device: str | torch.device = "cpu",
                      cls=MlpParams):
    """Reference params as numpy arrays (a dict, an open npz, or any
    object with the fields, bf16 or f32) -> the port's params on
    ``device``, every value rounded to bfloat16."""
    if not hasattr(d, "keys") or not callable(d.keys):
        d = {k: getattr(d, k) for k in cls._fields}
    out = {}
    for k in cls._fields:
        v = np.asarray(d[k]).astype(np.float32)
        out[k] = _bf16(torch.from_numpy(np.array(v))).to(device)
    return cls(**out)


def params_to_numpy(p) -> dict:
    """The port's params -> ``{field: float32 array}`` (the npz layout;
    the values are bf16)."""
    return {k: getattr(p, k).detach().float().cpu().numpy()
            for k in p._fields}


def save_params(params, path: str, family: str | None = None) -> str:
    """Write ``params`` as the reference's ``.npz`` artifact: each field
    as float32 (the bf16 values), ``dtype="bfloat16"``, ``family`` where
    the family records one (``multiclass``), then the schema version.
    Returns the path written (``.npz`` appended if missing)."""
    path = _npz_path(path)
    extra = {} if family is None else {"family": family}
    np.savez(path, **params_to_numpy(params), dtype="bfloat16", **extra,
             schema_version=ARTIFACT_SCHEMA_VERSION)
    return path


def load_params(path: str, device: str | torch.device = "cpu") -> MlpParams:
    """Load a reference ``mlp`` ``.npz`` artifact."""
    with np.load(_npz_path(path)) as z:
        version = int(z["schema_version"]) if "schema_version" in z else 0
        if version != ARTIFACT_SCHEMA_VERSION:
            raise ValueError(f"mlp artifact schema version {version} != "
                             f"{ARTIFACT_SCHEMA_VERSION}")
        if str(z["dtype"]) != "bfloat16":
            raise ValueError(f"{path}: weights stored as {z['dtype']}; the "
                             "port serves the bfloat16 family only")
        return params_from_numpy({k: z[k] for k in MlpParams._fields},
                                 device)
