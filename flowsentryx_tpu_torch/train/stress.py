"""Off-assumption generalization stress for fixture-trained models.

Counterpart of ``flowsentryx_tpu/train/stress.py``: how much quality
survives when the evaluation distribution is not the training one.

1. :func:`cross_fixture_table` — train on one attack regime (``v1``:
   volumetric and slow only; ``v2``: the current fixture, with SYN
   floods), evaluate in- and cross-regime, per-subtype recall.
2. :func:`perturbation_sweep` — single-feature marginals scaled x0.5 /
   x2 or shifted by ±2 eval-set std.
3. :func:`multiclass_cross` — the expert heads per regime, per class.

:func:`robust_mlp` and :func:`expert_heads` are the recipes behind the
reference's ``MODEL_METRICS_r05.json`` (``robust_detector_mlp`` and
``slow_recall_headline.models.expert_heads``).  Scoring runs on the
params' device: the int8 logreg through the ``score_int8`` kernel, the
MLP families through their exact scorers.

``python -m flowsentryx_tpu_torch.train.stress [N] [--out FILE]
[--device cpu]`` prints the report, or writes it to ``--out``; it never
writes the reference's ``MODEL_METRICS_r05.json``.
"""

from __future__ import annotations

import numpy as np

from flowsentryx_tpu_torch.core.schema import NUM_FEATURES, Feature
from flowsentryx_tpu_torch.train import evaluate
from flowsentryx_tpu_torch.train.fixture import (
    CLASS_BENIGN,
    CLASS_SLOW,
    CLASS_SYN,
    CLASS_VOLUMETRIC,
    LABEL_RATE,
    _benign,
    _dport,
    _lognormal,
)

#: Feature columns perturbed by the sweep (all 8 model inputs).
SWEEP_FEATURES = tuple(Feature)


def _attack_v1(rng: np.random.Generator, n: int
               ) -> tuple[np.ndarray, np.ndarray]:
    """The fixture's attack generator before the SYN subtype: 85 %
    volumetric floods / 15 % slow attacks (v2 class ids)."""
    X = np.zeros((n, NUM_FEATURES), np.float32)
    slow = rng.random(n) < 0.15
    fast = ~slow
    nf, ns = int(fast.sum()), int(slow.sum())
    cls = np.where(slow, CLASS_SLOW, CLASS_VOLUMETRIC).astype(np.int32)

    X[:, Feature.DST_PORT] = np.where(
        rng.random(n) < 0.85,
        rng.choice([80.0, 443.0, 53.0], n),
        _dport(rng, n),
    )
    mean_len = np.where(fast, rng.uniform(54.0, 120.0, n),
                        rng.uniform(60.0, 400.0, n))
    std_len = np.where(fast, rng.uniform(0.0, 4.0, n),
                       rng.uniform(0.0, 60.0, n))
    X[:, Feature.PKT_LEN_MEAN] = mean_len
    X[:, Feature.PKT_LEN_STD] = std_len
    iat_mean = np.empty(n)
    iat_max = np.empty(n)
    npkts = np.empty(n)
    if nf:
        iat_mean[fast] = _lognormal(rng, nf, 50.0, 1.5, 1e6)
        iat_max[fast] = iat_mean[fast] * rng.uniform(1.0, 20.0, nf)
        npkts[fast] = _lognormal(rng, nf, 3000.0, 1.0, 1e7)
    if ns:
        iat_mean[slow] = _lognormal(rng, ns, 5.0e6, 1.0, 1.2e8)
        iat_max[slow] = np.minimum(
            iat_mean[slow] * rng.uniform(2.0, 10.0, ns), 1.2e8
        )
        npkts[slow] = rng.uniform(10.0, 200.0, ns)
    X[:, Feature.FWD_IAT_MEAN] = iat_mean
    X[:, Feature.FWD_IAT_STD] = np.minimum(
        iat_mean * rng.lognormal(-0.5, 0.6, n), 1.2e8
    )
    X[:, Feature.FWD_IAT_MAX] = iat_max
    dur_us = np.clip(iat_mean * (npkts - 1.0), 1.0, 1.2e8)
    X[:, Feature.FLOW_DUR_MS] = dur_us / 1e3
    X[:, Feature.FLOW_PPS_X1000] = np.minimum(npkts * 1e9 / dur_us, 4.0e9)
    return X, cls


def fixture_variant(variant: str, n: int, seed: int = 42
                    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``(X, y, y_class)`` under the named regime: ``"v1"`` (no SYN
    subtype) or ``"v2"`` (``train/fixture.py``); benign rows shared."""
    if variant == "v2":
        from flowsentryx_tpu_torch.train.fixture import cicids_fixture

        return cicids_fixture(n, seed=seed, return_classes=True)
    if variant != "v1":
        raise ValueError(f"unknown fixture variant {variant!r}")
    rng = np.random.default_rng(seed)
    n_attack = int(round(n * LABEL_RATE))
    Xa, cls_a = _attack_v1(rng, n_attack)
    X = np.concatenate([_benign(rng, n - n_attack), Xa])
    y = np.concatenate([
        np.zeros(n - n_attack, np.float32), np.ones(n_attack, np.float32)
    ])
    y_class = np.concatenate([
        np.full(n - n_attack, CLASS_BENIGN, np.int32), cls_a
    ])
    order = rng.permutation(n)
    return X[order], y[order], y_class[order]


def perturb(X: np.ndarray, feature: int, scale: float = 1.0,
            shift: float = 0.0) -> np.ndarray:
    """Copy of ``X`` with one feature column affinely transformed and
    re-clamped to non-negative."""
    Xp = X.copy()
    Xp[:, feature] = np.maximum(Xp[:, feature] * scale + shift, 0.0)
    return Xp


def subtype_recall(scores: np.ndarray, y_class: np.ndarray,
                   threshold: float = 0.5) -> dict:
    """Binary attack recall restricted to each attack subtype."""
    out = {}
    for cid, name in ((CLASS_VOLUMETRIC, "volumetric"),
                      (CLASS_SYN, "syn"), (CLASS_SLOW, "slow")):
        m = y_class == cid
        if not m.any():
            continue
        out[name] = {
            "recall": round(float((scores[m] > threshold).mean()), 4),
            "support": int(m.sum()),
        }
    return out


def train_binary(X: np.ndarray, y: np.ndarray, epochs: int = 200,
                 y_class: np.ndarray | None = None,
                 slow_weight: float = 1.0, device=None):
    """QAT-train + convert the deployable int8 logreg on (X, y);
    ``slow_weight`` > 1 upweights slow-attack rows (needs ``y_class``)."""
    from flowsentryx_tpu_torch.train import qat

    sw = None
    if slow_weight != 1.0:
        if y_class is None:
            raise ValueError("slow_weight needs y_class")
        sw = 1.0 + (y_class == CLASS_SLOW) * (slow_weight - 1.0)
    return qat.train_logreg_qat(X, y, epochs=epochs, sample_weight=sw,
                                device=device).params


def _int8_scores(params, X: np.ndarray) -> np.ndarray:
    return evaluate.score_chunks(evaluate.int8_classify(params), params, X)


def cross_fixture_table(n_train: int = 300_000, n_eval: int = 300_000,
                        epochs: int = 200, seed: int = 7,
                        device=None) -> dict:
    """Train per regime, evaluate in- and cross-regime, with
    per-subtype recall and the in->cross F1 gap."""
    sets = {
        v: {
            "train": fixture_variant(v, n_train, seed=seed),
            "eval": fixture_variant(v, n_eval, seed=seed + 1),
        }
        for v in ("v1", "v2")
    }
    params = {v: train_binary(sets[v]["train"][0], sets[v]["train"][1],
                              epochs=epochs, device=device) for v in sets}
    table = {}
    for train_v in sets:
        row = {}
        for eval_v in sets:
            Xe, ye, ce = sets[eval_v]["eval"]
            scores = _int8_scores(params[train_v], Xe)
            cell = evaluate.confusion(scores, ye)
            cell["subtype_recall"] = subtype_recall(scores, ce)
            row[f"eval_{eval_v}"] = cell
        row["f1_gap_in_minus_cross"] = round(
            row[f"eval_{train_v}"]["f1"]
            - row[f"eval_{'v1' if train_v == 'v2' else 'v2'}"]["f1"], 6)
        table[f"train_{train_v}"] = row
    return table


def shift_augment(X: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """One augmented copy of ``X``: per row, one random feature shifted
    by U(-2σ, +2σ) of its column (clamped non-negative)."""
    Xp = X.copy()
    stds = X.std(axis=0)
    j = rng.integers(0, X.shape[1], len(X))
    delta = rng.uniform(-2.0, 2.0, len(X)) * stds[j]
    rows = np.arange(len(X))
    Xp[rows, j] = np.maximum(Xp[rows, j] + delta, 0.0)
    return Xp


def perturbation_sweep(params, X: np.ndarray, y: np.ndarray,
                       sigma_mult: float = 2.0, classify=None) -> dict:
    """F1 under single-feature scale x0.5 / x2 and shift ±2 std.
    ``classify`` defaults to the int8 logreg lane (``score_int8``)."""
    if classify is None:
        classify = evaluate.int8_classify(params)

    def f(Xs):
        return evaluate.confusion(
            evaluate.score_chunks(classify, params, Xs), y)

    base = f(X)
    out = {"baseline_f1": base["f1"], "features": {}}
    for feat in SWEEP_FEATURES:
        std = float(X[:, feat].std())
        cases = {
            "scale_0.5": dict(scale=0.5),
            "scale_2.0": dict(scale=2.0),
            "shift_-2std": dict(shift=-sigma_mult * std),
            "shift_+2std": dict(shift=+sigma_mult * std),
        }
        row = {}
        for name, kw in cases.items():
            c = f(perturb(X, int(feat), **kw))
            row[name] = {"f1": c["f1"], "recall": c["recall"],
                         "precision": c["precision"]}
        row["std"] = round(std, 2)
        out["features"][feat.name.lower()] = row
    worst = min(
        (row[c]["f1"], f"{f}:{c}")
        for f, row in out["features"].items()
        for c in row if c != "std"
    )
    out["worst_case"] = {"f1": worst[0], "case": worst[1]}
    return out


def multiclass_cross(n_train: int = 200_000, n_eval: int = 200_000,
                     epochs: int = 60, seed: int = 11, device=None) -> dict:
    """Expert heads trained per regime; per-class P/R in- and
    cross-regime, plus where subtypes absent from training land."""
    from flowsentryx_tpu_torch.models import multiclass
    from flowsentryx_tpu_torch.train import qat

    out = {}
    sets = {
        v: {
            "train": fixture_variant(v, n_train, seed=seed),
            "eval": fixture_variant(v, n_eval, seed=seed + 1),
        }
        for v in ("v1", "v2")
    }
    for train_v in sets:
        Xt, _, ct = sets[train_v]["train"]
        params, _losses = qat.train_multiclass(Xt, ct, epochs=epochs,
                                               device=device)
        row = {}
        for eval_v in sets:
            Xe, _, ce = sets[eval_v]["eval"]
            row[f"eval_{eval_v}"] = evaluate.multiclass_report(params, Xe, ce)
        out[f"train_{train_v}"] = row
    syn_row = out["train_v1"]["eval_v2"]["confusion"][CLASS_SYN]
    names = list(multiclass.ATTACK_CLASSES)
    total = sum(syn_row) or 1
    out["syn_attribution_under_v1_training"] = {
        "note": ("v2 SYN-flood flows scored by the v1-trained heads "
                 "(which have no syn training mass): fraction routed to "
                 "each output class; anything not 'benign' still blocks"),
        "fractions": {names[i]: round(syn_row[i] / total, 4)
                      for i in range(len(names))},
        "detected_as_attack": round(1.0 - syn_row[CLASS_BENIGN] / total, 4),
    }
    return out


def robust_mlp(Xt, yt, Xe, ye, ce, epochs: int = 80, device=None,
               step_log=None):
    """The robust detector recipe: the MLP trained on ``Xt`` plus two
    ``shift_augment`` copies (``default_rng(0)``), seed 0.  Returns
    ``(params, clean confusion with subtype recall)``."""
    from flowsentryx_tpu_torch.models import mlp
    from flowsentryx_tpu_torch.train import qat

    aug_rng = np.random.default_rng(0)
    Xaug = np.concatenate([Xt, shift_augment(Xt, aug_rng),
                           shift_augment(Xt, aug_rng)])
    yaug = np.concatenate([yt, yt, yt])
    params, _ = qat.train_mlp(Xaug, yaug, epochs=epochs, seed=0,
                              device=device, step_log=step_log)
    sc = evaluate.score_chunks(mlp.classify_batch, params, Xe)
    cell = evaluate.confusion(sc, ye)
    cell["subtype_recall"] = subtype_recall(sc, ce)
    return params, cell


def expert_heads(Xt, ct, Xe, ce, epochs: int = 60, device=None,
                 step_log=None):
    """The expert heads of the slow-recall headline: ``(params,
    multiclass_report)``."""
    from flowsentryx_tpu_torch.train import qat

    params, _ = qat.train_multiclass(Xt, ct, epochs=epochs, device=device,
                                     step_log=step_log)
    return params, evaluate.multiclass_report(params, Xe, ce)


def report(n: int = 300_000, device=None) -> dict:
    """The reference's stress report (``stress.main``'s content)."""
    from flowsentryx_tpu_torch.models import mlp
    from flowsentryx_tpu_torch.train.fixture import provenance

    out = {
        "dataset": provenance(),
        "sizes": {"n_train": n, "n_eval": n},
        "cross_fixture": cross_fixture_table(n_train=n, n_eval=n,
                                             device=device),
        "multiclass": multiclass_cross(n_train=min(n, 200_000),
                                       n_eval=min(n, 200_000),
                                       device=device),
    }
    Xt, yt, ct = fixture_variant("v2", n, seed=9)
    Xe, ye, ce = fixture_variant("v2", n, seed=8)
    slow_rows = {}
    deployed = None
    for name, kw in (("binary_uniform", {}),
                     ("binary_slow_weighted_x4",
                      dict(y_class=ct, slow_weight=4.0))):
        p = train_binary(Xt, yt, device=device, **kw)
        scores = _int8_scores(p, Xe)
        cell = evaluate.confusion(scores, ye)
        cell["subtype_recall"] = subtype_recall(scores, ce)
        slow_rows[name] = cell
        deployed = p
    slow_rows["expert_heads"] = expert_heads(Xt, ct, Xe, ce,
                                             device=device)[1]
    out["slow_recall_headline"] = {
        "criterion": "slow recall >= 0.7 on fixture v2, no precision collapse",
        "models": slow_rows,
    }
    out["perturbation_sweep_v2_model_on_v2"] = perturbation_sweep(
        deployed, Xe, ye)
    mlp_params, mlp_cell = robust_mlp(Xt, yt, Xe, ye, ce, device=device)
    out["robust_detector_mlp"] = {
        "train": "v2 fixture + 2x shift_augment copies (stress.shift_augment)",
        "clean": mlp_cell,
        "sweep": perturbation_sweep(mlp_params, Xe, ye,
                                    classify=mlp.classify_batch),
    }
    return out


def main(argv: list[str] | None = None) -> int:
    import argparse
    import json
    import time

    ap = argparse.ArgumentParser(prog="python -m flowsentryx_tpu_torch."
                                 "train.stress")
    ap.add_argument("n", nargs="?", type=int, default=300_000,
                    help="fixture rows per set (default 300000)")
    ap.add_argument("--out", help="write the JSON report here (default: "
                    "print it)")
    ap.add_argument("--device", default=None,
                    help="torch device; default the card (raises without "
                         "one)")
    args = ap.parse_args(argv)
    t0 = time.time()
    out = report(args.n, args.device)
    out["wall_s"] = round(time.time() - t0, 1)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=2)
            f.write("\n")
        print(json.dumps({"wrote": args.out, "wall_s": out["wall_s"]}))
    else:
        print(json.dumps(out, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
