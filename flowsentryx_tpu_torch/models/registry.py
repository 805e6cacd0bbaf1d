"""Model registry: name -> (init, batch scorer).

Counterpart of ``flowsentryx_tpu/models/registry.py``, every family of
it registered.  Both int8 logistic-regression lanes are served by the
CUDA ``score_int8`` kernel: the reference's ``logreg_int8`` (XLA dot
form) and ``logreg_int8_pallas`` (its Pallas kernel) are bit-identical by
test, so one kernel serves the pair.  ``logreg_float``, ``mlp`` and
``multiclass`` are plain torch ops rounded as the reference's XLA:CPU
graph rounds them (``models/logreg.py::classify_float``,
``models/mlp.py``, ``models/multiclass.py``).  :func:`validate_swap`
holds a live model swap to the reference's refusals.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from flowsentryx_tpu_torch.core import wire
from flowsentryx_tpu_torch.core.device import resolve_device
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
    #: ``fsx distill`` can compile this family's artifacts into the
    #: kernel tier: only the int8 logreg lane (monotone accumulator ->
    #: score tail) has bands the distiller inverts exactly.
    distillable: bool = False


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


def registered_models() -> list[str]:
    return sorted(_REGISTRY)


def distillable_models() -> list[str]:
    return sorted(n for n, s in _REGISTRY.items() if s.distillable)


def require_distillable(name: str, params: Any) -> None:
    """Refuse a (model, artifact) pair the distiller cannot compile,
    before any work, with the reference's messages: the family must
    serve the int8 logreg lane, and the artifact must carry that
    family's quantization fields."""
    spec = get_model(name)
    if not spec.distillable:
        raise ValueError(
            f"model {name!r} is not distillable: fsx distill compiles "
            "the int8 logistic-regression lane (quantize -> int8 dot -> "
            "requant -> sigmoid) into eBPF, and this family serves a "
            "different function. Supported families: "
            f"{distillable_models()}")
    missing = [f for f in ("w_int8", "bias", "w_scale", "in_scale",
                           "in_zp", "out_scale", "out_zp")
               if not hasattr(params, f)]
    if missing:
        raise ValueError(
            f"artifact is not a {name!r} params pytree: missing "
            f"quantization fields {missing} (is this an artifact from "
            "another model family?)")


def load_artifact(name: str, path: str, device=None):
    """Load a trained ``.npz`` artifact as the params for ``name`` on
    ``device`` (None: the card, raising without one), through its
    family's loader (as the reference dispatches; an unregistered name
    has no loader, in the reference's words)."""
    if name not in _REGISTRY:
        raise KeyError(f"no artifact loader for model family {name!r}")
    spec = _REGISTRY[name]
    device = resolve_device(device)
    try:
        return spec.load(path, device)
    except (TypeError, KeyError) as e:
        raise ValueError(
            f"{path!r} is not a {name!r} artifact (fields don't match the "
            f"family's schema: {e}); set model.name in the config to the "
            "family the artifact was trained as") from e


def _leaf_dtype(leaf) -> str:
    """A leaf's dtype by its numpy name (``int8``, ``float32``, ...)."""
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).removeprefix("torch.")
    return np.dtype(getattr(leaf, "dtype", type(leaf))).name


def validate_swap(served, params, quant: dict | None) -> None:
    """The reference's ``Engine.hot_swap`` refusals
    (``flowsentryx_tpu/engine/engine.py:2323-2353``), in its words:
    ``params`` may replace the ``served`` model only as a
    re-parameterization of what the engine has built.  Raises
    ``ValueError`` on a different family (params type), on a leaf whose
    shape or dtype differs, and — when ``quant`` is a ``model``-mode
    compact16 quantizer, which the batcher, the ingest workers and the
    step's decode table were built from — on any drift of the input
    observer (``in_scale``, ``in_zp``, ``log1p``)."""
    if type(params) is not type(served):
        raise ValueError(
            "hot_swap: artifact tree structure differs from the "
            "served model (different family?); boot a fresh engine")
    for i, (a, b) in enumerate(zip(served, params)):
        sa, sb = tuple(np.shape(a)), tuple(np.shape(b))
        da, db = _leaf_dtype(a), _leaf_dtype(b)
        if sa != sb or da != db:
            raise ValueError(
                f"hot_swap: params leaf {i} is {db}{list(sb)}, "
                f"served model has {da}{list(sa)} — a shape/dtype "
                "change would retrace the step mid-serve")
    if quant and quant.get("feat_mode") == "model":
        nq = wire.model_quant_args(type(params)(*(
            t.cpu() if isinstance(t, torch.Tensor) else t for t in params)))
        drift = {k: (quant.get(k), nq[k])
                 for k in ("in_scale", "in_zp", "log1p")
                 if nq[k] != quant.get(k)}
        if drift:
            raise ValueError(
                "hot_swap: the compact16 wire quantizes with the "
                "boot artifact's input observer, but the new "
                f"artifact's differs: {drift}; serve raw48 or "
                "reboot with the new artifact")


for _name in ("logreg_int8", "logreg_int8_pallas"):
    register_model(ModelSpec(name=_name, init=logreg.golden_params,
                             classify_batch=kernels.score_int8,
                             distillable=True))
register_model(ModelSpec(name="logreg_float", init=logreg.golden_params,
                         classify_batch=logreg.classify_float))
# the reference's defaults: init_params(jax.random.PRNGKey(0)), drawn by
# the port's threefry (core/prng.py)
register_model(ModelSpec(
    name="mlp",
    init=lambda device=None: mlp.init_params(device=resolve_device(device)),
    classify_batch=mlp.classify_batch, load=mlp.load_params))
register_model(ModelSpec(
    name="multiclass",
    init=lambda device=None: multiclass.init_params(
        device=resolve_device(device)),
    classify_batch=multiclass.classify_batch, load=multiclass.load_params))
