"""Classification metrics of validation (a copy of vsn_tpu/train/metrics.py;
numpy).

The training-time metric set matches reference train/train_transformer.py:
457-547 (compute_metrics): accuracy, balanced accuracy, one-vs-rest ROC-AUC
and PR-AUC (macro, with NaN per-class AUCs of absent classes left out of the
average), macro and per-class F1, and MCC; ``is_improvement`` gives each
metric's direction (loss lower, every other higher).
"""

from __future__ import annotations

import numpy as np


def _one_hot(y: np.ndarray, k: int) -> np.ndarray:
    out = np.zeros((len(y), k), np.float64)
    out[np.arange(len(y)), y] = 1.0
    return out


def accuracy(gt: np.ndarray, pred: np.ndarray) -> float:
    return float((gt == pred).mean()) if len(gt) else float("nan")


def balanced_accuracy(gt: np.ndarray, pred: np.ndarray, num_classes: int) -> float:
    """Mean recall over classes *present in gt* (sklearn semantics)."""
    recalls = []
    for c in range(num_classes):
        m = gt == c
        if m.any():
            recalls.append((pred[m] == c).mean())
    return float(np.mean(recalls)) if recalls else float("nan")


def confusion_matrix(gt: np.ndarray, pred: np.ndarray, num_classes: int):
    cm = np.zeros((num_classes, num_classes), np.int64)
    np.add.at(cm, (gt, pred), 1)
    return cm


def f1_scores(gt: np.ndarray, pred: np.ndarray, num_classes: int):
    """Per-class F1 (0 where undefined, sklearn zero_division=0) and macro F1
    (mean over all classes, like sklearn's default)."""
    cm = confusion_matrix(gt, pred, num_classes)
    tp = np.diag(cm).astype(np.float64)
    fp = cm.sum(0) - tp
    fn = cm.sum(1) - tp
    denom = 2 * tp + fp + fn
    f1 = np.divide(2 * tp, denom, out=np.zeros_like(tp), where=denom > 0)
    return f1, float(f1.mean())


def mcc(gt: np.ndarray, pred: np.ndarray, num_classes: int) -> float:
    """Multiclass Matthews correlation (sklearn formulation)."""
    cm = confusion_matrix(gt, pred, num_classes).astype(np.float64)
    t = cm.sum(1)  # true per class
    p = cm.sum(0)  # predicted per class
    c = np.trace(cm)
    s = cm.sum()
    cov_ytyp = c * s - t @ p
    cov_ypyp = s * s - p @ p
    cov_ytyt = s * s - t @ t
    denom = np.sqrt(cov_ypyp * cov_ytyt)
    return float(cov_ytyp / denom) if denom > 0 else 0.0


def binary_roc_auc(y_true: np.ndarray, score: np.ndarray) -> float:
    """Rank-statistic AUROC (Mann-Whitney U with tie correction)."""
    pos = y_true.astype(bool)
    n_pos = int(pos.sum())
    n_neg = len(y_true) - n_pos
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    order = np.argsort(score, kind="mergesort")
    ranks = np.empty(len(score), np.float64)
    sorted_scores = score[order]
    # average ranks for ties
    rank_vals = np.arange(1, len(score) + 1, dtype=np.float64)
    boundaries = np.flatnonzero(np.diff(sorted_scores)) + 1
    starts = np.concatenate([[0], boundaries])
    ends = np.concatenate([boundaries, [len(score)]])
    for s, e in zip(starts, ends):
        rank_vals[s:e] = 0.5 * (s + 1 + e)
    ranks[order] = rank_vals
    auc = (ranks[pos].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg)
    return float(auc)


def binary_pr_auc(y_true: np.ndarray, score: np.ndarray) -> float:
    """Average precision (sklearn average_precision_score semantics:
    sum over recall steps of precision)."""
    pos = y_true.astype(bool)
    n_pos = int(pos.sum())
    if n_pos == 0:
        return float("nan")
    order = np.argsort(-score, kind="mergesort")
    y_sorted = pos[order]
    scores_sorted = score[order]
    tp = np.cumsum(y_sorted)
    fp = np.cumsum(~y_sorted)
    precision = tp / (tp + fp)
    recall = tp / n_pos
    # only evaluate at distinct-threshold boundaries (last index of each run)
    distinct = np.flatnonzero(np.diff(scores_sorted))
    idx = np.concatenate([distinct, [len(scores_sorted) - 1]])
    precision = precision[idx]
    recall = recall[idx]
    recall_prev = np.concatenate([[0.0], recall[:-1]])
    return float(np.sum((recall - recall_prev) * precision))


def ovr_auc(
    gt: np.ndarray, probs: np.ndarray, kind: str = "roc", average: str = "macro"
) -> float:
    """One-vs-rest AUC averaged over classes.

    NaN per-class AUCs (absent class) are excluded from the average; if every
    class is degenerate the reference falls back to uniform probabilities —
    callers handle that upstream (train_transformer.py:511-520).
    """
    k = probs.shape[1]
    fn = binary_roc_auc if kind == "roc" else binary_pr_auc
    aucs, weights = [], []
    for c in range(k):
        a = fn((gt == c).astype(np.float64), probs[:, c])
        if not np.isnan(a):
            aucs.append(a)
            weights.append((gt == c).sum())
    if not aucs:
        return float("nan")
    if average == "weighted":
        w = np.asarray(weights, np.float64)
        return float(np.average(aucs, weights=w)) if w.sum() else float("nan")
    return float(np.mean(aucs))


def compute_metrics(gt: np.ndarray, probs: np.ndarray, num_classes: int) -> dict:
    """The reference's validation metric dict (train_transformer.py:457-547).

    Degenerate probabilities (NaN rows) fall back to uniform, as the
    reference does before metric computation (511-520).
    """
    probs = np.asarray(probs, np.float64)
    bad = ~np.isfinite(probs).all(axis=1)
    if bad.any():
        probs = probs.copy()
        probs[bad] = 1.0 / num_classes
    gt = np.asarray(gt)
    pred = probs.argmax(1)
    f1_per_class, macro_f1 = f1_scores(gt, pred, num_classes)
    out = {
        "acc": accuracy(gt, pred),
        "bacc": balanced_accuracy(gt, pred, num_classes),
        "roc_auc": ovr_auc(gt, probs, "roc", "macro"),
        "pr_auc": ovr_auc(gt, probs, "pr", "macro"),
        "macro_f1": macro_f1,
        "mcc": mcc(gt, pred, num_classes),
    }
    for c in range(num_classes):
        out[f"f1_class{c}"] = float(f1_per_class[c])
    return out


# Direction of improvement per metric name (reference train_transformer.py:
# 1366-1378: 'loss' lower is better, everything else higher).
LOWER_IS_BETTER = {"loss"}


def is_improvement(metric_name: str, new: float, best: float, min_delta: float = 0.0):
    if metric_name in LOWER_IS_BETTER:
        return new < best - min_delta
    return new > best + min_delta
