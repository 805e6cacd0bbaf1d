"""The kernel tier's three-way parity: the emitted eBPF scorer, the
plan's integer twin and the served int8 lane, over the reference's
parity corpus.

The reference's ``fsx distill --emulate`` (``flowsentryx_tpu/cli.py``
``_distill_emulate``) runs the emitted scorer bytecode over a corpus of
CICIDS fixture rows, uniform u32 noise, saturation edges and boundary
neighbourhoods (:func:`corpus`), and requires 0 band mismatches between
it (:func:`~.emulate.emulate_scorer`), the plan's integer twin
(:meth:`~.plan.DistillPlan.bands`) and the served int8 lane.  Here the
served lane is the port's: the ``score_int8`` kernel on the card, its
plain version on the CPU (:func:`served_bands`).  :func:`emulate_check`
is the full check behind ``fsx distill --emulate``;
:func:`served_band_check` holds the served lane alone against a plan.
"""

from __future__ import annotations

import numpy as np

from flowsentryx_tpu_torch.distill.plan import U32_MAX, DistillPlan


def corpus(plan: DistillPlan, n: int = 10000) -> np.ndarray:
    """``[max(n, 512), 8]`` u32 feature rows, built as the reference's
    ``_distill_emulate`` builds them (``default_rng(7)``): fixture rows
    (seed 3) clipped into u32, uniform u32 noise, the saturation and
    zero-point edges, and rows drawn from every boundary and its two
    upper neighbours."""
    from flowsentryx_tpu_torch.train import fixture

    rng = np.random.default_rng(7)
    corpora = []
    X, _ = fixture.cicids_fixture(n=max(n // 2, 256), seed=3)
    corpora.append(np.clip(X, 0, U32_MAX).astype(np.uint32))
    corpora.append(rng.integers(0, 1 << 32, size=(max(n // 4, 256), 8),
                                dtype=np.uint64).astype(np.uint32))
    edges = np.array([0, 1, 8, 255, (1 << 16) - 1, (1 << 24) - 1,
                      1 << 24, (1 << 24) + 1, 1 << 31, U32_MAX], np.uint32)
    corpora.append(np.tile(edges[:, None], (1, 8)))
    b = plan.bounds_m1[0]
    real = b[b != 0xFFFFFFFF].astype(np.uint64)
    near = np.unique(np.concatenate([real, real + 1, real + 2]))
    near = near[near <= U32_MAX].astype(np.uint32)
    if len(near):
        corpora.append(
            near[rng.integers(0, len(near), size=(max(n // 4, 256), 8))])
    return np.concatenate(corpora)[:max(n, 512)]


def served_bands(params, plan: DistillPlan, feats: np.ndarray
                 ) -> np.ndarray:
    """The served int8 lane's bands of ``feats`` (u32 rows, cast to f32
    as the wire decodes them) on the params' device, through
    ``score_int8`` (``> t_hi`` drop, ``< t_lo`` pass, else escalate)."""
    import torch

    from flowsentryx_tpu_torch.ops import kernels

    dev = params.in_scale.device
    x = torch.from_numpy(feats.astype(np.int64)).to(dev).float()
    scores = kernels.score_int8(params, x.contiguous()).cpu().numpy()
    return np.where(scores > plan.t_hi, 2,
                    np.where(scores < plan.t_lo, 0, 1)).astype(np.uint8)


def _split(bands: np.ndarray) -> dict:
    return {name: int((bands == code).sum())
            for name, code in (("pass", 0), ("escalate", 1), ("drop", 2))}


def served_band_check(params, plan: DistillPlan, feats: np.ndarray) -> dict:
    """Compare the served lane's bands (:func:`served_bands`) with
    ``plan.bands``.  ``ok`` is 0 mismatches."""
    served = served_bands(params, plan, feats)
    sim = plan.bands(feats)
    split = _split(sim)
    mism = int((served != sim).sum())
    return {"ok": mism == 0, "vectors": int(len(feats)),
            "served_mismatches": mism, "split": split,
            "escalation_ratio": round(split["escalate"] / len(feats), 6)}


def emulate_check(params, plan: DistillPlan, blob: bytes,
                  n: int = 10000) -> dict:
    """``fsx distill --emulate``: the emitted scorer bytecode run by the
    lane emulator over :func:`corpus`, against the served lane and the
    plan's twin.  The record has the reference's keys
    (``jax_mismatches`` keeps its name for parity of the JSON: it counts
    the served lane's mismatches against the bytecode) plus
    ``served_device``; ``ok`` is 0 mismatches in both."""
    import time

    from flowsentryx_tpu_torch.distill.emulate import emulate_scorer

    feats = corpus(plan, n)
    served = served_bands(params, plan, feats)
    t0 = time.perf_counter()
    em_bands = emulate_scorer(blob, feats)
    em_s = time.perf_counter() - t0
    sim_bands = plan.bands(feats)
    split = _split(em_bands)
    return {
        "ok": bool((em_bands == served).all()
                   and (sim_bands == em_bands).all()),
        "vectors": int(len(feats)),
        "jax_mismatches": int((em_bands != served).sum()),
        "sim_mismatches": int((sim_bands != em_bands).sum()),
        "split": split,
        "escalation_ratio": round(split["escalate"] / len(feats), 6),
        "emulator_wall_s": round(em_s, 3),
        "emulator_vectors_per_s": round(len(feats) / max(em_s, 1e-9)),
        "thresholds": {"t_lo": plan.t_lo, "t_hi": plan.t_hi,
                       "acc_pass": plan.acc_pass,
                       "acc_drop": plan.acc_drop},
        "served_device": str(params.in_scale.device),
    }
