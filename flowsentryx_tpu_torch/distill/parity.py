"""The served int8 lane's bands against a plan's, over the reference's
parity corpus.

The reference's ``fsx distill --emulate`` (``flowsentryx_tpu/cli.py``
``_distill_emulate``) runs the emitted eBPF scorer over a corpus of
CICIDS fixture rows, uniform u32 noise, saturation edges and boundary
neighbourhoods, and requires 0 band mismatches between it, the plan's
integer twin (:meth:`~.plan.DistillPlan.bands`) and the served int8
lane.  The eBPF emulator is not ported (it needs ``bpf/``); what the
port can hold is the served lane — the ``score_int8`` kernel on the
card — against the plan's bands, over the same corpus
(:func:`corpus`, :func:`served_band_check`).
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


def served_band_check(params, plan: DistillPlan, feats: np.ndarray) -> dict:
    """Score ``feats`` (u32 rows, cast to f32 as the wire decodes them)
    through the served int8 lane on the params' device (``score_int8``)
    and compare its bands (``> t_hi`` drop, ``< t_lo`` pass, else
    escalate) with ``plan.bands``.  ``ok`` is 0 mismatches."""
    import torch

    from flowsentryx_tpu_torch.ops import kernels

    dev = params.in_scale.device
    x = torch.from_numpy(feats.astype(np.int64)).to(dev).float()
    scores = kernels.score_int8(params, x.contiguous()).cpu().numpy()
    served = np.where(scores > plan.t_hi, 2,
                      np.where(scores < plan.t_lo, 0, 1)).astype(np.uint8)
    sim = plan.bands(feats)
    split = {name: int((sim == code).sum())
             for name, code in (("pass", 0), ("escalate", 1), ("drop", 2))}
    mism = int((served != sim).sum())
    return {"ok": mism == 0, "vectors": int(len(feats)),
            "served_mismatches": mism, "split": split,
            "escalation_ratio": round(split["escalate"] / len(feats), 6)}
