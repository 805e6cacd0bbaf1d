"""The kernel-tier scoring plan: its integer scorer, its packing, and
its ``.npz`` file.

Counterpart of the loader half of ``flowsentryx_tpu/distill/plan.py``:
:class:`DistillPlan` (:meth:`~DistillPlan.ranks`,
:meth:`~DistillPlan.acc`, :meth:`~DistillPlan.bands`: pure u32-vs-u32
compares, the numpy twin of the XDP scorer), :class:`DistillError`,
:func:`pack_blob` / :func:`unpack_blob` (the ``ml_model_map`` value,
``wire.ML_MODEL_*``) and :func:`save_plan` / :func:`load_plan`, and the
compiler, :func:`compile_plan` (``fsx distill``).

The compiler inverts an int8 artifact's float observer and score tail
into exact integer tables.  Each quantization boundary ``b_q = min{x :
q(x) >= q}`` of the u32 feature domain is found by bisecting the serving
chain itself (u32 -> f32, the optional XLA ``log1p``, true division,
rint, ``+ zp``, clip), and the two band thresholds are read off a sweep
of the score tail over every reachable accumulator value.  On the card
both run through the ``score_int8`` kernel's own stage functions
(:func:`~flowsentryx_tpu_torch.ops.kernels.score_quant_u8`,
:func:`~flowsentryx_tpu_torch.ops.kernels.score_tail`); on the CPU
through their plain versions, which equal the reference's jitted chain.
The params are arguments of every launch, never baked into a closure
(ROADMAP queue 3, item 6).  ``validate`` replays every boundary ±1, the
saturation corners and a uniform u32 sample through the table and the
chain; a plan that fails never leaves this module.

The loader half is numpy only; :func:`compile_plan` imports torch when
it is called.
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


def _bisect_bounds(qchain, targets: np.ndarray) -> np.ndarray:
    """min u32 x with ``qchain(x) >= t`` per target (int64; targets
    with no preimage — above the chain's max — come back as 2^32)."""
    nt = len(targets)
    lo = np.full(nt, -1, np.int64)          # q(lo) < t (q(-1) := -inf)
    hi = np.full(nt, U32_MAX, np.int64)     # candidate answer
    q_top = np.asarray(qchain(np.full(nt, U32_MAX, np.uint32)), np.int64)
    reachable = q_top >= targets
    for _ in range(33):  # ceil(log2(2^32)) + slack
        span = hi - lo > 1
        if not span.any():
            break
        mid = np.where(span, (lo + hi) // 2, hi)
        qm = np.asarray(qchain(mid.astype(np.uint32)), np.int64)
        ge = qm >= targets
        hi = np.where(span & ge, mid, hi)
        lo = np.where(span & ~ge, mid, lo)
    return np.where(reachable, hi, np.int64(1) << 32)


def compile_plan(
    params,
    t_lo: float = 0.1,
    t_hi: float = 0.9,
    validate: bool = True,
    sample: int = 65536,
    seed: int = 0,
) -> DistillPlan:
    """Compile ``params`` (the port's ``LogRegParams``, on the device
    the chain runs on) into a :class:`DistillPlan` with bands ``(t_lo,
    t_hi)``.  Raises :class:`DistillError` on invalid thresholds, a
    non-monotone score tail, degenerate bands or a failed validation
    replay, with the reference's messages."""
    import torch

    from flowsentryx_tpu_torch.ops import kernels

    if not 0.0 <= t_lo < t_hi <= 1.0:
        raise DistillError(
            f"band thresholds need 0 <= t_lo < t_hi <= 1, got "
            f"({t_lo}, {t_hi})")
    w = params.w_int8.cpu().numpy().astype(np.int32)
    if w.shape != (schema.NUM_FEATURES,):
        raise DistillError(f"expected [{schema.NUM_FEATURES}] weights, "
                           f"got shape {w.shape}")
    in_zp = int(params.in_zp)
    w_sum = int(w.sum())
    dev = params.in_scale.device
    packed = kernels.pack_score_params(params)

    def qchain(x_u32: np.ndarray) -> np.ndarray:
        # u32 -> f32 on the device (round to nearest), then the scorer's
        # input stage with the params as launch arguments
        x = torch.from_numpy(np.asarray(x_u32, np.int64)).to(dev).float()
        return kernels.score_quant_u8(params, x, packed).cpu().numpy(
            ).astype(np.int64)

    qbase_scalar = int(qchain(np.zeros(1, np.uint32))[0])
    # per-tensor observer: one boundary table, tiled per feature
    targets = np.arange(qbase_scalar + 1, 256, dtype=np.int64)
    b = _bisect_bounds(qchain, targets) if len(targets) else \
        np.empty(0, np.int64)
    n_real = int((b <= U32_MAX).sum())
    bounds_row = np.full(schema.ML_BOUNDS_PER_FEATURE, _PAD, np.uint32)
    if n_real:
        # q(0) = qbase < target, so every reachable boundary is >= 1
        bounds_row[:n_real] = (b[:n_real] - 1).astype(np.uint32)
    bounds_m1 = np.tile(bounds_row, (schema.NUM_FEATURES, 1))
    qbase = np.full(schema.NUM_FEATURES, qbase_scalar, np.uint32)

    # exact band thresholds: every reachable accumulator through the tail
    contrib = (np.arange(256)[None, :] - in_zp) * w[:, None]  # [8, 256]
    amin = int(contrib.min(axis=1).sum())
    amax = int(contrib.max(axis=1).sum())
    accs = torch.arange(amin, amax + 1, dtype=torch.int32, device=dev)
    g = kernels.score_tail(params, accs, packed).cpu().numpy().astype(
        np.float64)
    if not (np.diff(g) >= 0).all():
        i = int(np.argmin(np.diff(g)))
        raise DistillError(
            f"score_from_acc is not monotone at acc={amin + i} "
            f"({g[i]} -> {g[i + 1]}); the threshold inversion is unsound "
            "for this artifact")
    above = np.nonzero(g > t_hi)[0]
    below = np.nonzero(g < t_lo)[0]
    acc_drop_dev = amin + int(above[0]) if len(above) else amax + 1
    acc_pass_dev = amin + int(below[-1]) if len(below) else amin - 1
    # fold the zero-point: the kernel tier sums raw w*q, the scorer
    # w*(q - zp)
    acc_drop = acc_drop_dev + in_zp * w_sum
    acc_pass = acc_pass_dev + in_zp * w_sum
    if acc_drop <= acc_pass:
        raise DistillError(
            f"degenerate bands: acc_drop ({acc_drop}) <= acc_pass "
            f"({acc_pass}) — every packet would be both confident-attack "
            "and confident-benign; widen (t_lo, t_hi)")

    plan = DistillPlan(
        w=w, qbase=qbase, bounds_m1=bounds_m1,
        acc_drop=acc_drop, acc_pass=acc_pass,
        t_lo=float(t_lo), t_hi=float(t_hi),
        in_zp=in_zp, w_sum=w_sum,
        meta={
            "log1p": bool(int(params.log1p)),
            "in_scale": float(params.in_scale),
            "n_bounds": n_real,
            "qbase": qbase_scalar,
            "score_min": float(g[0]), "score_max": float(g[-1]),
            "acc_range": [amin, amax],
            "backend": str(dev),
        },
    )

    if validate:
        # boundary-local exactness and a broad replay: the table rank
        # must reproduce the chain at every boundary neighbourhood, the
        # saturation corners and a uniform u32 sample
        rng = np.random.default_rng(seed)
        xs = np.concatenate([
            validation_edges(plan), rng.integers(0, 1 << 32, size=sample, dtype=np.uint64
                                ).astype(np.uint32)])
        want = qchain(xs)
        got = qbase_scalar + np.searchsorted(bounds_row, xs, side="left")
        bad = np.nonzero(want != got)[0]
        if len(bad):
            x = int(xs[bad[0]])
            raise DistillError(
                f"boundary table diverges from the device observer at "
                f"x={x}: table rank {int(got[bad[0]])} != device "
                f"q {int(want[bad[0]])} ({len(bad)}/{len(xs)} points)")
    return plan


def validation_edges(plan: DistillPlan) -> np.ndarray:
    """The u32 points ``compile_plan``'s replay checks before its random
    sample: every boundary and its two neighbours, and the saturation
    corners."""
    row = plan.bounds_m1[0]
    b = row[row != _PAD].astype(np.int64) + 1
    edges = np.unique(np.concatenate([
        b, b - 1, b + 1,
        np.array([0, 1, 7, 8, 9, 255, 1 << 16, (1 << 24) - 1, 1 << 24,
                  (1 << 24) + 1, 1 << 31, U32_MAX, U32_MAX - 1], np.int64)]))
    return edges[(edges >= 0) & (edges <= U32_MAX)].astype(np.uint32)


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
