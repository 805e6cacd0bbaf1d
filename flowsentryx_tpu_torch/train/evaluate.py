"""Classifier quality metrics.

Counterpart of ``flowsentryx_tpu/train/evaluate.py``: :func:`confusion`
(accuracy, precision, recall, F1 and the counts at a threshold),
:func:`evaluate_model` and :func:`multiclass_report`.  Scoring runs in
65,536-row chunks, each moved to the params' device and scored there
(:func:`score_chunks`); :func:`int8_classify` is the int8 lane through
the ``score_int8`` kernel with its parameters packed once.
"""

from __future__ import annotations

import functools
from typing import Any, Callable

import numpy as np
import torch


def confusion(scores: np.ndarray, labels: np.ndarray,
              threshold: float = 0.5) -> dict:
    """All quality numbers from scores + ground truth at a threshold."""
    scores = np.asarray(scores)
    labels = np.asarray(labels).astype(bool)
    pred = scores > threshold
    tp = int((pred & labels).sum())
    tn = int((~pred & ~labels).sum())
    fp = int((pred & ~labels).sum())
    fn = int((~pred & labels).sum())
    n = max(len(labels), 1)
    precision = tp / (tp + fp) if tp + fp else 0.0
    recall = tp / (tp + fn) if tp + fn else 0.0
    f1 = (2 * precision * recall / (precision + recall)
          if precision + recall else 0.0)
    return {
        "n": len(labels),
        "accuracy": round((tp + tn) / n, 6),
        "precision": round(precision, 6),
        "recall": round(recall, 6),
        "f1": round(f1, 6),
        "tp": tp, "tn": tn, "fp": fp, "fn": fn,
    }


def params_device(params: Any) -> torch.device:
    """The device a params tuple lives on (its first leaf's)."""
    return params[0].device


def score_chunks(classify_batch: Callable[[Any, torch.Tensor], torch.Tensor],
                 params: Any, X: np.ndarray, batch: int = 65536
                 ) -> np.ndarray:
    """``classify_batch(params, chunk)`` over ``batch``-row chunks of
    ``X``, each moved to the params' device -> ``[N]`` numpy scores."""
    dev = params_device(params)
    X = np.ascontiguousarray(X, np.float32)
    return np.concatenate([
        classify_batch(params, torch.from_numpy(X[s:s + batch]).to(dev))
        .cpu().numpy() for s in range(0, len(X), batch)])


def int8_classify(params) -> Callable[[Any, torch.Tensor], torch.Tensor]:
    """The int8 logreg lane as ``(params, x) -> [B]``: ``score_int8``
    with ``params`` packed once (the kernel on the card, its plain
    version on the CPU)."""
    from flowsentryx_tpu_torch.ops import kernels

    return functools.partial(kernels.score_int8,
                             packed=kernels.pack_score_params(params))


def evaluate_model(
    classify_batch: Callable[[Any, torch.Tensor], torch.Tensor],
    params: Any,
    X: np.ndarray,
    y: np.ndarray,
    threshold: float = 0.5,
    batch: int = 65536,
) -> dict:
    """Batched scoring + confusion (keeps peak memory flat on big sets)."""
    return confusion(score_chunks(classify_batch, params, X, batch), y,
                     threshold)


def multiclass_report(params, X: np.ndarray, y_class: np.ndarray,
                      batch: int = 65536) -> dict:
    """Per-class precision/recall/F1 + confusion matrix + the binary
    view (1 - P(benign) vs attack/benign) for the expert-heads family."""
    from flowsentryx_tpu_torch.models import multiclass

    dev = params_device(params)
    X = np.ascontiguousarray(X, np.float32)
    probs = np.concatenate([
        multiclass.class_probs(params, torch.from_numpy(
            X[s:s + batch]).to(dev)).cpu().numpy()
        for s in range(0, len(X), batch)])
    preds = probs.argmax(axis=1)  # argmax(probs) == argmax(logits)
    C = multiclass.NUM_CLASSES
    conf = np.zeros((C, C), np.int64)  # [true, pred]
    np.add.at(conf, (y_class.astype(np.int64), preds.astype(np.int64)), 1)
    per_class = {}
    f1s = []
    for c, name in enumerate(multiclass.ATTACK_CLASSES):
        tp = int(conf[c, c])
        fp = int(conf[:, c].sum() - tp)
        fn = int(conf[c].sum() - tp)
        p = tp / (tp + fp) if tp + fp else 0.0
        r = tp / (tp + fn) if tp + fn else 0.0
        f1 = 2 * p * r / (p + r) if p + r else 0.0
        per_class[name] = {"precision": round(p, 4), "recall": round(r, 4),
                           "f1": round(f1, 4), "support": int(conf[c].sum())}
        f1s.append(f1)
    binary = confusion(1.0 - probs[:, 0],
                       (y_class != 0).astype(np.float32))
    return {
        "per_class": per_class,
        "macro_f1": round(float(np.mean(f1s)), 4),
        "confusion": conf.tolist(),
        "binary": binary,
    }
