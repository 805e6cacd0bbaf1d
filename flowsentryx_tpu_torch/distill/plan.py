"""The kernel-tier scoring plan: its integer scorer, its packing, and
its ``.npz`` file.

Counterpart of the loader half of ``flowsentryx_tpu/distill/plan.py``:
:class:`DistillPlan` (:meth:`~DistillPlan.ranks`,
:meth:`~DistillPlan.acc`, :meth:`~DistillPlan.bands`: pure u32-vs-u32
compares, the numpy twin of the XDP scorer), :class:`DistillError`,
:func:`pack_blob` / :func:`unpack_blob` (the ``ml_model_map`` value,
``wire.ML_MODEL_*``) and :func:`save_plan` / :func:`load_plan`.  A plan
is compiled from a ``LogRegParams`` artifact by the reference's
``compile_plan`` (``fsx distill``), which bisects the serving chain for
every quantization boundary; that half is not ported yet.

numpy only.
"""

from __future__ import annotations

import json
import struct
from dataclasses import dataclass, field

import numpy as np

from flowsentryx_tpu_torch.core import wire as schema

U32_MAX = (1 << 32) - 1
#: bounds_m1 padding: compares as "never below x" for every u32 x.
_PAD = U32_MAX


@dataclass(frozen=True)
class DistillPlan:
    """The integer scoring tables one artifact compiles to."""

    w: np.ndarray           # [8] int32 (int8-valued weights, widened)
    qbase: np.ndarray       # [8] uint32: q_i(0)
    bounds_m1: np.ndarray   # [8, 255] uint32: sorted (b_q - 1), PAD-filled
    acc_drop: int           # s >= acc_drop -> DROP   (s = sum w*q, zp folded)
    acc_pass: int           # s <= acc_pass -> PASS
    t_lo: float             # operator band thresholds, probability space
    t_hi: float
    in_zp: int
    w_sum: int              # sum of weights (the folded-zp bookkeeping)
    meta: dict = field(default_factory=dict)

    # -- the pure-integer scorer (numpy twin of fn_ml_score) ------------

    def ranks(self, feat: np.ndarray) -> np.ndarray:
        """``[N, 8]`` u32 features → ``[N, 8]`` int64 quant values.

        Pure u32-vs-u32 compares — no float touches this path, which is
        why it agrees with the eBPF scorer by construction."""
        feat = np.asarray(feat)
        if feat.dtype != np.uint32:
            feat = feat.astype(np.uint32)
        q = np.empty(feat.shape, np.int64)
        for i in range(schema.NUM_FEATURES):
            # count of boundaries strictly below x == count of (x > b_m1)
            q[..., i] = self.qbase[i] + np.searchsorted(
                self.bounds_m1[i], feat[..., i], side="left")
        return q

    def acc(self, feat: np.ndarray) -> np.ndarray:
        """``[N, 8]`` u32 features → ``[N]`` int64 raw weighted rank sum
        (the quantity the kernel thresholds)."""
        return (self.ranks(feat) * self.w.astype(np.int64)).sum(axis=-1)

    def bands(self, feat: np.ndarray) -> np.ndarray:
        """``[N, 8]`` u32 features → ``[N]`` uint8 ``schema.ML_BAND_*``."""
        s = self.acc(feat)
        band = (np.full(s.shape, schema.ML_BAND_ESCALATE, np.int64)
                + (s >= self.acc_drop) - (s <= self.acc_pass))
        return band.astype(np.uint8)

    def to_json(self) -> dict:
        return {
            "w": self.w.tolist(),
            "qbase": self.qbase.tolist(),
            "n_bounds": [int((self.bounds_m1[i] != _PAD).sum())
                         for i in range(schema.NUM_FEATURES)],
            "acc_drop": self.acc_drop,
            "acc_pass": self.acc_pass,
            "thresholds": {"t_lo": self.t_lo, "t_hi": self.t_hi},
            "in_zp": self.in_zp,
            "w_sum": self.w_sum,
            "blob_bytes": schema.ML_MODEL_SIZE,
            "meta": self.meta,
        }


class DistillError(ValueError):
    """A plan that failed compilation or self-validation."""


# ---------------------------------------------------------------------------
# Packing: the ml_model_map value (hot-swap payload) and the .npz plan
# ---------------------------------------------------------------------------


def pack_blob(plan: DistillPlan) -> bytes:
    """Serialize into the ``struct fsx_ml_model`` map value
    (``schema.ML_MODEL_*`` layout; diffed by ``fsx check``)."""
    out = struct.pack("<II", 1, 0)  # valid, _reserved
    out += struct.pack("<qq", plan.acc_drop, plan.acc_pass)
    out += plan.w.astype("<i4").tobytes()
    out += plan.qbase.astype("<u4").tobytes()
    out += np.ascontiguousarray(plan.bounds_m1, "<u4").tobytes()
    if len(out) != schema.ML_MODEL_SIZE:
        raise DistillError(
            f"packed blob is {len(out)} B, schema says "
            f"{schema.ML_MODEL_SIZE} B — schema drift (run fsx check)")
    return out


def unpack_blob(blob: bytes) -> DistillPlan:
    """Inverse of :func:`pack_blob` (thresholds in probability space
    are not carried on the wire; they come back as NaN markers)."""
    if len(blob) != schema.ML_MODEL_SIZE:
        raise DistillError(f"blob is {len(blob)} B, want "
                           f"{schema.ML_MODEL_SIZE}")
    valid, _ = struct.unpack_from("<II", blob, 0)
    if not valid:
        raise DistillError("blob has valid=0 (no model)")
    acc_drop, acc_pass = struct.unpack_from(
        "<qq", blob, schema.ML_MODEL_ACC_DROP_OFFSET)
    nf = schema.NUM_FEATURES
    w = np.frombuffer(blob, "<i4", nf, schema.ML_MODEL_W_OFFSET)
    qbase = np.frombuffer(blob, "<u4", nf, schema.ML_MODEL_QBASE_OFFSET)
    bounds = np.frombuffer(
        blob, "<u4", nf * schema.ML_BOUNDS_PER_FEATURE,
        schema.ML_MODEL_BOUNDS_OFFSET,
    ).reshape(nf, schema.ML_BOUNDS_PER_FEATURE)
    return DistillPlan(
        w=w.astype(np.int32), qbase=qbase.copy(), bounds_m1=bounds.copy(),
        acc_drop=int(acc_drop), acc_pass=int(acc_pass),
        t_lo=float("nan"), t_hi=float("nan"),
        in_zp=0, w_sum=int(w.sum()), meta={"from": "blob"},
    )


PLAN_SCHEMA_VERSION = 1


def save_plan(plan: DistillPlan, path: str) -> str:
    """Persist as .npz (the ``fsx distill --out`` artifact; consumed by
    ``fsx serve --sim-kernel-tier`` and ``fsx distill --pin``)."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    np.savez(
        path,
        w=plan.w, qbase=plan.qbase, bounds_m1=plan.bounds_m1,
        acc_drop=np.int64(plan.acc_drop), acc_pass=np.int64(plan.acc_pass),
        t_lo=np.float64(plan.t_lo), t_hi=np.float64(plan.t_hi),
        in_zp=np.int64(plan.in_zp), w_sum=np.int64(plan.w_sum),
        meta=json.dumps(plan.meta),
        plan_schema_version=PLAN_SCHEMA_VERSION,
    )
    return path


def load_plan(path: str) -> DistillPlan:
    if not path.endswith(".npz"):
        path = path + ".npz"
    with np.load(path) as z:
        version = int(z["plan_schema_version"]) \
            if "plan_schema_version" in z else 0
        if version != PLAN_SCHEMA_VERSION:
            raise DistillError(
                f"plan schema version {version} != {PLAN_SCHEMA_VERSION} "
                f"(re-run fsx distill to regenerate {path})")
        return DistillPlan(
            w=z["w"].astype(np.int32),
            qbase=z["qbase"].astype(np.uint32),
            bounds_m1=z["bounds_m1"].astype(np.uint32),
            acc_drop=int(z["acc_drop"]), acc_pass=int(z["acc_pass"]),
            t_lo=float(z["t_lo"]), t_hi=float(z["t_hi"]),
            in_zp=int(z["in_zp"]), w_sum=int(z["w_sum"]),
            meta=json.loads(str(z["meta"])),
        )
