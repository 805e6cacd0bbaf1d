"""Model registry: name -> (init, batch scorer).

Counterpart of ``flowsentryx_tpu/models/registry.py``, every family of
it registered.  Both int8 logistic-regression lanes are served by the
CUDA ``score_int8`` kernel: the reference's ``logreg_int8`` (XLA dot
form) and ``logreg_int8_pallas`` (its Pallas kernel) are bit-identical by
test, so one kernel serves the pair.  ``logreg_float``, ``mlp`` and
``multiclass`` are plain torch ops rounded as the reference's XLA:CPU
graph rounds them (``models/logreg.py::classify_float``,
``models/mlp.py``, ``models/multiclass.py``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from flowsentryx_tpu_torch.models import logreg, mlp, multiclass
from flowsentryx_tpu_torch.ops import kernels


@dataclass(frozen=True)
class ModelSpec:
    name: str
    init: Callable[..., Any]      # (device) -> params
    # (params, x) -> [B]; kernels.score_int8 also takes packed=, its
    # kernels.pack_score_params
    classify_batch: Callable[..., torch.Tensor]
    #: The family's npz loader ``(path, device) -> params``.
    load: Callable[..., Any] = logreg.load_params


_REGISTRY: dict[str, ModelSpec] = {}

#: Reference families this port does not serve yet.
NOT_PORTED: tuple[str, ...] = ()


def register_model(spec: ModelSpec) -> ModelSpec:
    if spec.name in _REGISTRY:
        raise ValueError(f"model {spec.name!r} already registered")
    _REGISTRY[spec.name] = spec
    return spec


def get_model(name: str) -> ModelSpec:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown model {name!r}; registered: {sorted(_REGISTRY)}"
        ) from None


def load_artifact(name: str, path: str, device="cpu"):
    """Load a trained ``.npz`` artifact as the params for ``name``,
    through its family's loader (as the reference dispatches)."""
    spec = get_model(name)
    try:
        return spec.load(path, device)
    except (TypeError, KeyError) as e:
        raise ValueError(
            f"{path!r} is not a {name!r} artifact (fields don't match the "
            f"family's schema: {e}); set model.name in the config to the "
            "family the artifact was trained as") from e


def _no_default_init(name: str):
    def init(device=None):
        raise ValueError(
            f"model {name!r} has no default params in this port: the "
            "reference draws them from jax.random.PRNGKey(0), which needs "
            "JAX. Serve an artifact (--artifact PATH, "
            f"registry.load_artifact({name!r}, path)) or carry the "
            f"reference's params across ({name}.params_from_numpy)")
    return init


for _name in ("logreg_int8", "logreg_int8_pallas"):
    register_model(ModelSpec(name=_name, init=logreg.golden_params,
                             classify_batch=kernels.score_int8))
register_model(ModelSpec(name="logreg_float", init=logreg.golden_params,
                         classify_batch=logreg.classify_float))
register_model(ModelSpec(name="mlp", init=_no_default_init("mlp"),
                         classify_batch=mlp.classify_batch,
                         load=mlp.load_params))
register_model(ModelSpec(name="multiclass",
                         init=_no_default_init("multiclass"),
                         classify_batch=multiclass.classify_batch,
                         load=multiclass.load_params))
