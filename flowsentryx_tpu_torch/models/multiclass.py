"""Per-attack-class expert heads (the MLP trunk, a ``[H, 4]`` head).

Counterpart of ``flowsentryx_tpu/models/multiclass.py``: the binary
serving contract ``1 - P(benign)``, and :func:`attack_class` for
attribution.  The trunk is :func:`~.mlp.trunk`, rounded as the
reference's compiled graph rounds it; the softmax is XLA:CPU's
(:func:`class_probs`).  Training takes the reference's compiled gradient
of its mean softmax cross-entropy, written out (:func:`train_grads`),
over bfloat16 params; :func:`save_params` writes the reference's layout
with ``family="multiclass"``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from flowsentryx_tpu_torch.core.device import fma32, xla_exp
from flowsentryx_tpu_torch.models import mlp

#: Class 0 MUST be benign (classify_batch's binary contract relies on it).
ATTACK_CLASSES: tuple[str, ...] = (
    "benign", "volumetric_flood", "syn_flood", "slow_attack")
NUM_CLASSES = len(ATTACK_CLASSES)


class MulticlassParams(NamedTuple):
    w1: torch.Tensor  # [8, H]
    b1: torch.Tensor  # [H]
    w2: torch.Tensor  # [H, H]
    b2: torch.Tensor  # [H]
    w3: torch.Tensor  # [H, C] - the per-class expert heads
    b3: torch.Tensor  # [C]


def logits(params: MulticlassParams, x: torch.Tensor) -> torch.Tensor:
    """``[B, 8] -> [B, C]`` f32 logits: the bias add is not rounded back
    to bf16 (:func:`~.mlp.head`)."""
    return mlp.head(params, mlp.trunk(params, x), round_out=False)


def class_probs(params: MulticlassParams, x: torch.Tensor) -> torch.Tensor:
    """``[B, C]`` softmax as XLA:CPU computes it: subtract the row max,
    its ``exp``, the four terms summed ``((e0 + e1) + e2) + e3``, and a
    true division."""
    lg = logits(params, x)
    e = xla_exp(lg - lg.max(dim=1, keepdim=True).values)
    total = e[:, 0]
    for c in range(1, e.shape[1]):
        total = total + e[:, c]
    return e / total[:, None]


def classify_batch(params: MulticlassParams, x: torch.Tensor
                   ) -> torch.Tensor:
    """Binary serving contract: ``P(any attack) = 1 - P(benign)``."""
    return 1.0 - class_probs(params, x)[:, 0]


def attack_class(params: MulticlassParams, x: torch.Tensor) -> torch.Tensor:
    """``[B]`` int32 argmax class ids (0 = benign; first maximum wins)."""
    return torch.argmax(logits(params, x), dim=1).to(torch.int32)


ARTIFACT_SCHEMA_VERSION = 1


def init_params(key=None, hidden: int = 32,
                device: str | torch.device = "cpu") -> MulticlassParams:
    """The reference's ``init_params(key, hidden)`` (``key`` None =
    ``PRNGKey(0)``): :func:`~.mlp.init_params` with a ``[H, 4]`` head."""
    return mlp.init_params(key, hidden, device, cls=MulticlassParams,
                           n_out=NUM_CLASSES)


def params_from_numpy(d, device: str | torch.device = "cpu"
                      ) -> MulticlassParams:
    return mlp.params_from_numpy(d, device, cls=MulticlassParams)


params_to_numpy = mlp.params_to_numpy


def loss_fn(params, xt: torch.Tensor, y_class: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy over integer class labels, on
    :func:`~.mlp.transform`-ed inputs."""
    return softmax_ce_mean(mlp.train_forward(params, xt)[0], y_class)


def softmax_ce_mean(lg: torch.Tensor, y_class: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy of ``[B, C]`` logits."""
    logp = torch.log_softmax(lg, dim=-1)
    return -logp.gather(1, y_class.long()[:, None]).mean()


def train_grads(params, xt: torch.Tensor, y_class: torch.Tensor):
    """``(loss, grads)`` of the mean softmax cross-entropy over bfloat16
    ``params`` and :func:`~.mlp.transform`-ed ``xt``, as the reference's
    jitted ``value_and_grad`` computes them on XLA:CPU (its optimized
    HLO, read op by op), the grads in the params' order, bfloat16:

    * the forward rounds as the served model does (:func:`logits`): the
      head's bias add stays f32, the logits are NOT rounded to bf16;
    * the logits' cotangent is ``fma(f32(1/B) / sum(e), e, t)`` with
      ``e = exp(lg - max)`` (XLA's ``exp``, the four terms summed left to
      right) and ``t`` the one-hot of ``-f32(1/B)``, rounded to bf16;
    * the back-propagated dots over the hidden width (``[B, C] @ [C,
      H]``) sum in :data:`~.mlp.HIDDEN_ORDER`, rounded to bf16, then
      masked by ``a > 0``;
    * the weight gradients sum exact bf16 products over the batch (in
      float64, rounded to f32, then bf16); the bias gradients are XLA's
      blocked bf16 sums (:func:`~.mlp.xla_batch_sum`).

    Autograd differs in two places, each enough to move a bf16 weight
    after a few steps: it takes the cotangent from bf16-rounded logits
    through torch's ``log_softmax`` backward, and it sums the hidden
    dots in another order."""
    w1, b1, w2, b2, w3, b3 = (t.float() for t in params)
    xf = xt.float()
    a1 = mlp._layer(xf, w1, b1, mlp.HIDDEN_ORDER)
    h1 = torch.relu(a1)
    a2 = mlp._layer(h1, w2, b2, mlp.HIDDEN_ORDER)
    h2 = torch.relu(a2)
    lg = mlp._layer(h2, w3, b3, mlp.HEAD_ORDER[w3.shape[1]],
                    round_out=False)
    n = lg.shape[0]
    e = xla_exp(lg - lg.max(dim=1, keepdim=True).values)
    total = e[:, 0]
    for c in range(1, e.shape[1]):
        total = total + e[:, c]
    inv_n = torch.tensor(1.0 / n, dtype=torch.float32, device=lg.device)
    t = torch.zeros_like(lg)
    t[torch.arange(n, device=lg.device), y_class.long()] = -inv_n
    g3 = mlp._bf16(fma32((inv_n / total)[:, None].expand_as(e), e, t))
    g2 = torch.where(a2 > 0, mlp._bf16(mlp.fixed_order_dot(
        g3, w3.T, *mlp.HIDDEN_ORDER)), 0.0)
    g1 = torch.where(a1 > 0, mlp._bf16(mlp.fixed_order_dot(
        g2, w2.T, *mlp.HIDDEN_ORDER)), 0.0)

    def wgrad(h, g):
        return (h.double().T @ g.double()).float().to(torch.bfloat16)

    gb = mlp.xla_batch_sum(torch.cat([g1, g2, g3], dim=1).to(
        torch.bfloat16)).split([b1.numel(), b2.numel(), b3.numel()])
    return softmax_ce_mean(lg, y_class), (
        wgrad(xf, g1), gb[0], wgrad(h1, g2), gb[1], wgrad(h2, g3), gb[2])


def save_params(params, path: str) -> str:
    """Persist as the reference's ``.npz`` (bf16 stored as f32 with the
    dtype recorded, ``family="multiclass"``)."""
    return mlp.save_params(params, path, family="multiclass")


def load_params(path: str, device: str | torch.device = "cpu"
                ) -> MulticlassParams:
    """Load a reference ``multiclass`` ``.npz`` artifact (its ``family``
    must say so)."""
    with np.load(mlp._npz_path(path), allow_pickle=False) as z:
        fam = str(z["family"]) if "family" in z else ""
        if fam != "multiclass":
            raise ValueError(f"{path}: not a multiclass artifact")
        version = int(z["schema_version"]) if "schema_version" in z else 0
        if version != ARTIFACT_SCHEMA_VERSION:
            raise ValueError(f"multiclass artifact schema version {version}"
                             f" != {ARTIFACT_SCHEMA_VERSION}")
        if str(z["dtype"]) != "bfloat16":
            raise ValueError(f"{path}: weights stored as {z['dtype']}; the "
                             "port serves the bfloat16 family only")
        return params_from_numpy({k: z[k] for k in MulticlassParams._fields},
                                 device)
