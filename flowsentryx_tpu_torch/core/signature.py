"""The staged-shape signature: what keys a boot's cached artifacts.

Counterpart of ``flowsentryx_tpu/core/signature.py`` (numpy only).  A
staged serving shape is keyed by everything that changes what a boot
builds and captures: the full config JSON, the wire format, the mesh
device count, the coalescing ladder's sizes, the drain ring's depth,
donation, and the params leaves' dtypes and shapes.  Toolchain versions
are not part of it: the compile cache (:mod:`..engine.compile_cache`)
layers them on top, in each entry's header.

The digest equals the reference's for the same config, wire, ladder,
ring depth, donation and params leaves (the port's params are
NamedTuples of torch tensors, read in field order, as
``jax.tree_util.tree_leaves`` reads the reference's).
"""

from __future__ import annotations

import hashlib
import json
from typing import Any

import numpy as np


def _leaf_dtype(leaf: Any) -> str:
    """numpy's name for a leaf's dtype (``float32``, ``int8``,
    ``bfloat16``), torch tensors included."""
    dt = getattr(leaf, "dtype", type(leaf))
    if type(dt).__module__ == "torch":
        return str(dt).removeprefix("torch.")
    return str(np.dtype(dt))


def params_signature(params: Any | None, model_name: str) -> list:
    """Dtype/shape signature of a params tuple (or dict, in key order, as
    ``tree_leaves`` orders one), the part of the staged shape the config
    cannot describe.  ``None`` params key on the model's name, which
    makes two default-booted engines shape-equal."""
    if params is None:
        return ["default", model_name]
    leaves = ([params[k] for k in sorted(params)]
              if isinstance(params, dict) else params)
    return [[_leaf_dtype(leaf),
             [int(d) for d in getattr(leaf, "shape", ())]]
            for leaf in leaves]


def staging_signature(cfg: Any, *, wire: str, mesh_devices: int = 1,
                      mega_sizes: tuple[int, ...] | list[int] | None = None,
                      device_loop: int = 0, params: Any | None = None,
                      donate: bool | None = None) -> dict:
    """The canonical signature dict of one staged serving shape (pure
    data: hash it with :func:`signature_digest`).  ``donate=None`` means
    "backend default" and stays distinct from an explicit bool."""
    return {
        "cfg": cfg.to_json(),
        "wire": wire,
        "mesh_devices": int(mesh_devices or 1),
        "mega_sizes": [int(s) for s in (mega_sizes or ())],
        "device_loop": int(device_loop),
        "donate": None if donate is None else bool(donate),
        "params": params_signature(params, cfg.model.name),
    }


def signature_digest(sig: dict) -> str:
    """Stable hex digest of a signature dict (sorted-key canonical JSON,
    sha256): the compile cache's filename key."""
    blob = json.dumps(sig, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()
