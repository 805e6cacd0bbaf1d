"""Per-attack-class expert heads (the MLP trunk, a ``[H, 4]`` head).

Counterpart of ``flowsentryx_tpu/models/multiclass.py``: the binary
serving contract ``1 - P(benign)``, and :func:`attack_class` for
attribution.  The trunk is :func:`~.mlp.trunk`, rounded as the
reference's compiled graph rounds it; the softmax is XLA:CPU's
(:func:`class_probs`).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from flowsentryx_tpu_torch.core.device import xla_exp
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


def params_from_numpy(d, device: str | torch.device = "cpu"
                      ) -> MulticlassParams:
    return mlp.params_from_numpy(d, device, cls=MulticlassParams)


params_to_numpy = mlp.params_to_numpy


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
