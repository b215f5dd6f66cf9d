"""Bootstrap confidence intervals for classification + calibration metrics:
a copy of vsn_tpu/eval/bootstrap.py, which the port may not import.

Protocol parity with reference utils/bootstrap_metric.py:291-849
(compute_bootstrap_metrics): ``n_bootstrap`` seeded resamples with
class-presence retry (100 attempts) and a stratified fallback (362-406);
per-iteration metrics {accuracy, balanced_accuracy, weighted OVR ROC/PR-AUC
via label binarization, MCC, per-class precision/recall/F1, macro_f1/prec/
sens, ECE, MCE, Brier overall+per-class, softmax entropy, Gini, Rényi-2,
optional top-k family (480-552)}; aggregation to {mean, lower, upper,
samples} percentile CIs (714-849).

Performance: the reference pays joblib + sklearn per resample — minutes of
CPU per checkpoint. Here the whole 10k-resample bundle is vectorized across
resamples: every "mean over resampled rows" metric (acc/bacc/F1/MCC/ECE/MCE/
Brier/entropies/top-k family, via the confusion matrix and calibration bins)
reduces to one counts-matrix x feature-matrix matmul per chunk, and the
rank-based ROC/PR AUCs use weighted group statistics over a single presorted
score order per class (a resample is just a weighting of the fixed dataset).
The port's tests hold this engine against the JAX package's function on
the same ``random_state``.

Known deviation: the stratified fallback draws
``len(pool)`` per class (full-size proportional resample) rather than the
reference's proportional-with-retry blend (bootstrap_metric.py:362-406) —
distributionally close, and it only triggers after 100 failed presence
retries.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Union

import numpy as np


# ---------------------------------------------------------------------------
# Calibration / uncertainty kernels (reference bootstrap_metric.py:24-288)
# ---------------------------------------------------------------------------

def compute_ece(y_true, probs, correct_mask=None, n_bins: int = 15) -> float:
    """Expected calibration error over equal-width confidence bins
    ((lower, upper] binning like the reference)."""
    if correct_mask is None:
        correct_mask = probs.argmax(1) == y_true
    conf = probs.max(1)
    edges = np.linspace(0, 1, n_bins + 1)
    ece = 0.0
    n = len(conf)
    for lo, hi in zip(edges[:-1], edges[1:]):
        in_bin = (conf > lo) & (conf <= hi)
        cnt = in_bin.sum()
        if cnt:
            acc = correct_mask[in_bin].mean()
            avg_conf = conf[in_bin].mean()
            ece += abs(avg_conf - acc) * cnt / n
    return float(ece)


def compute_mce(y_true, probs, correct_mask=None, n_bins: int = 15) -> float:
    if correct_mask is None:
        correct_mask = probs.argmax(1) == y_true
    conf = probs.max(1)
    edges = np.linspace(0, 1, n_bins + 1)
    mce = 0.0
    for lo, hi in zip(edges[:-1], edges[1:]):
        in_bin = (conf > lo) & (conf <= hi)
        if in_bin.sum():
            mce = max(mce, abs(conf[in_bin].mean() - correct_mask[in_bin].mean()))
    return float(mce)


def compute_brier(y_true, probs, n_classes, sample_mask=None):
    """(overall MSE, per-class dict); masked variant for top-k."""
    if sample_mask is not None:
        y_true, probs = y_true[sample_mask], probs[sample_mask]
    if len(y_true) == 0:
        return np.nan, {c: np.nan for c in range(n_classes)}
    onehot = np.zeros((len(y_true), n_classes))
    onehot[np.arange(len(y_true)), y_true] = 1.0
    per_class = ((probs - onehot) ** 2).mean(0)
    return float(per_class.mean()), {c: float(per_class[c]) for c in range(n_classes)}


def softmax_entropy(probs, sample_mask=None) -> float:
    if sample_mask is not None:
        probs = probs[sample_mask]
    if len(probs) == 0:
        return np.nan
    return float((-(probs * np.log(probs + 1e-10)).sum(1)).mean())


def gini_index(probs, sample_mask=None) -> float:
    if sample_mask is not None:
        probs = probs[sample_mask]
    if len(probs) == 0:
        return np.nan
    return float((1.0 - (probs**2).sum(1)).mean())


def renyi_entropy(probs, alpha: float = 2.0, sample_mask=None) -> float:
    if alpha <= 0 or alpha == 1:
        raise ValueError("alpha must be positive and != 1")
    if sample_mask is not None:
        probs = probs[sample_mask]
    if len(probs) == 0:
        return np.nan
    s = (probs**alpha).sum(1)
    return float(((1.0 / (1.0 - alpha)) * np.log(s + 1e-10)).mean())


# ---------------------------------------------------------------------------
# Resampling (reference 362-406)
# ---------------------------------------------------------------------------

def _resample_indices(rng, y_true, classes, n_samples, max_attempts=100):
    """Resample with class-presence retry + stratified fallback
    (reference 362-406)."""
    for _ in range(max_attempts):
        idx = rng.integers(0, n_samples, n_samples)
        if len(np.unique(y_true[idx])) == len(classes):
            return idx
    # stratified fallback: proportional per-class draws, pad/trim to n
    parts = []
    for c in classes:
        pool = np.flatnonzero(y_true == c)
        k = max(1, int(len(pool)))
        parts.append(rng.choice(pool, k, replace=True))
    idx = np.concatenate(parts)
    rng.shuffle(idx)
    if len(idx) > n_samples:
        return idx[:n_samples]
    extra = rng.integers(0, n_samples, n_samples - len(idx))
    return np.concatenate([idx, extra])


# ---------------------------------------------------------------------------
# Vectorized engine: all resamples at once
# ---------------------------------------------------------------------------
#
# A bootstrap resample of a fixed dataset is fully described by its count
# vector w[i] = multiplicity of sample i (sum w = N). Every metric in the
# bundle is then either
#   (a) linear in w — any "mean over resampled rows" of a per-sample feature,
#       including the confusion matrix (one-hot (gt,pred) features) and the
#       ECE/MCE calibration bins (one-hot bin features x {1, conf, correct}) —
#       computed for a whole chunk of resamples as ONE matmul W @ V, or
#   (b) a rank statistic (ROC/PR AUC) — computed from weighted per-score-group
#       counts over a single presorted order per class (ties = score groups),
#       the Mann-Whitney / step-sum arithmetic of the JAX package's
#       train/metrics.py binary_roc_auc / binary_pr_auc applied to the
#       resampled array.

_N_BINS = 15


def _feature_matrix(y_true, probs, n_classes, top_ns):
    """Per-sample feature matrix V [N, F] + named column slices."""
    n = len(y_true)
    pred = probs.argmax(1)
    conf = probs.max(1)
    correct = (pred == y_true).astype(np.float64)
    onehot = np.zeros((n, n_classes))
    onehot[np.arange(n), y_true] = 1.0
    brier_sc = (probs - onehot) ** 2  # [N, K]
    entropy = -(probs * np.log(probs + 1e-10)).sum(1)
    gini = 1.0 - (probs**2).sum(1)
    renyi = -np.log((probs**2).sum(1) + 1e-10)  # alpha = 2
    # (lower, upper] equal-width bins; conf <= 0 belongs to no bin (weight 0).
    edges = np.linspace(0, 1, _N_BINS + 1)
    bin_idx = np.searchsorted(edges, conf, side="left") - 1
    in_range = (bin_idx >= 0) & (bin_idx < _N_BINS)
    bin_oh = np.zeros((n, _N_BINS))
    bin_oh[np.flatnonzero(in_range), bin_idx[in_range]] = 1.0

    cols, layout = [], {}

    def add(name, block):
        block = block if block.ndim == 2 else block[:, None]
        start = sum(c.shape[1] for c in cols)
        layout[name] = slice(start, start + block.shape[1])
        cols.append(block.astype(np.float64))

    cm_oh = np.zeros((n, n_classes * n_classes))
    cm_oh[np.arange(n), y_true * n_classes + pred] = 1.0
    add("cm", cm_oh)
    add("unc", np.stack([entropy, gini, renyi], 1))
    add("brier", brier_sc)
    add("bin_cnt", bin_oh)
    add("bin_conf", bin_oh * conf[:, None])
    add("bin_corr", bin_oh * correct[:, None])

    for k in top_ns:
        topk = np.argsort(probs, axis=1)[:, -k:]
        corr_k = (topk == y_true[:, None]).any(1).astype(np.float64)
        appears = np.stack(
            [(topk == c).any(1).astype(np.float64) for c in range(n_classes)],
            1,
        )  # [N, K]
        add(f"corr_{k}", corr_k)
        add(f"unc_{k}", np.stack([entropy, gini, renyi], 1) * corr_k[:, None])
        add(f"brier_{k}", brier_sc * corr_k[:, None])
        add(f"bin_corr_{k}", bin_oh * corr_k[:, None])
        add(f"recnum_{k}", onehot * corr_k[:, None])
        add(f"appears_{k}", appears)
        add(f"appears_hit_{k}", appears * onehot)
    return np.concatenate(cols, 1), layout


def _class_sort_tables(y_true, probs, n_classes):
    """Per class: ascending stable score order, score-group starts, pos mask
    in sorted order — the fixed scaffolding for weighted rank AUCs."""
    tables = []
    for c in range(n_classes):
        score = probs[:, c]
        order = np.argsort(score, kind="mergesort")
        s = score[order]
        starts = np.concatenate([[0], np.flatnonzero(np.diff(s)) + 1])
        tables.append((order, starts, y_true[order] == c))
    return tables


def _chunk_metrics(idx, feats, layout, sort_tables, n_classes, top_ns):
    """Metric arrays for one chunk of resamples. idx: [C, N] int."""
    c_sz, n = idx.shape
    k_cls = n_classes
    w = np.bincount(
        (np.arange(c_sz, dtype=np.int64)[:, None] * n + idx).ravel(),
        minlength=c_sz * n,
    ).reshape(c_sz, n).astype(np.float64)
    S = w @ feats  # [C, F]

    def blk(name):
        return S[:, layout[name]]

    out = {}
    cm = blk("cm").reshape(c_sz, k_cls, k_cls)
    tp = np.einsum("rkk->rk", cm)
    t_cnt = cm.sum(2)  # true count per class
    p_cnt = cm.sum(1)  # predicted count per class
    out["accuracy"] = tp.sum(1) / n
    rec = np.divide(tp, t_cnt, out=np.zeros_like(tp), where=t_cnt > 0)
    present = t_cnt > 0
    out["balanced_accuracy"] = np.where(
        present.any(1), (rec * present).sum(1) / np.maximum(present.sum(1), 1),
        np.nan,
    )
    prec = np.divide(tp, p_cnt, out=np.zeros_like(tp), where=p_cnt > 0)
    denom_f = prec + rec
    f1 = np.divide(
        2 * prec * rec, denom_f, out=np.zeros_like(tp), where=denom_f > 0
    )
    out["macro_f1"] = f1.mean(1)
    out["macro_prec"] = prec.mean(1)
    out["macro_sens"] = rec.mean(1)
    ctr = tp.sum(1)
    cov_ytyp = ctr * n - np.einsum("rk,rk->r", t_cnt, p_cnt)
    cov_ypyp = float(n) * n - np.einsum("rk,rk->r", p_cnt, p_cnt)
    cov_ytyt = float(n) * n - np.einsum("rk,rk->r", t_cnt, t_cnt)
    mcc_den = np.sqrt(cov_ypyp * cov_ytyt)
    out["mcc"] = np.where(
        mcc_den > 0, cov_ytyp / np.maximum(mcc_den, 1e-300), 0.0
    )
    out["precision"], out["recall"], out["f1"] = prec, rec, f1  # [C, K]

    unc = blk("unc")
    out["softmax_entropy"] = unc[:, 0] / n
    out["gini"] = unc[:, 1] / n
    out["renyi"] = unc[:, 2] / n
    brier = blk("brier") / n  # [C, K]
    out["brier_class"] = brier
    out["brier_score"] = brier.mean(1)

    def ece_mce(cnt, sc, scc):
        gap = np.abs(sc - scc)
        ece = gap.sum(1) / n
        per_bin = np.where(cnt > 0, gap / np.maximum(cnt, 1e-300), 0.0)
        return ece, per_bin.max(1)

    out["ece"], out["mce"] = ece_mce(
        blk("bin_cnt"), blk("bin_conf"), blk("bin_corr")
    )

    # Rank AUCs: weighted Mann-Whitney (ROC) and weighted step-sum AP (PR).
    # AP uses the algebraic form AP = sum_t (wp_t/P) * (tp_t / tot_t): only
    # groups with positive weight contribute (delta-recall = 0 elsewhere), so
    # the explicit recall-step differencing of a step-sum AP cancels.
    roc = np.full((c_sz, k_cls), np.nan)
    ap = np.full((c_sz, k_cls), np.nan)
    for c, (order, starts, pos_sorted) in enumerate(sort_tables):
        w_s = w[:, order]
        if len(starts) == n:  # no score ties: every group is a singleton
            wt = w_s
            wp = w_s * pos_sorted
        else:
            wt = np.add.reduceat(w_s, starts, axis=1)
            wp = np.add.reduceat(w_s * pos_sorted, starts, axis=1)
        wn = wt - wp
        pos_tot = wp.sum(1)
        neg_tot = n - pos_tot
        cum_n = np.cumsum(wn, 1)
        u = (wp * (cum_n - 0.5 * wn)).sum(1)
        ok = (pos_tot > 0) & (neg_tot > 0)
        roc[:, c] = np.where(
            ok, u / np.maximum(pos_tot * neg_tot, 1e-300), np.nan
        )
        # PR: descending score order
        wp_d = wp[:, ::-1]
        tp_d = np.cumsum(wp_d, 1)
        tot_d = np.cumsum(wt[:, ::-1], 1)
        frac = np.divide(tp_d, tot_d, out=tp_d, where=tot_d > 0)
        ap_c = (wp_d * frac).sum(1) / np.maximum(pos_tot, 1e-300)
        ap[:, c] = np.where(pos_tot > 0, ap_c, np.nan)

    def weighted_avg(auc):
        valid = ~np.isnan(auc)
        wsum = (t_cnt * valid).sum(1)
        num = np.where(valid, np.where(valid, auc, 0.0) * t_cnt, 0.0).sum(1)
        return np.where(wsum > 0, num / np.maximum(wsum, 1e-300), np.nan)

    out["roc_auc"] = weighted_avg(roc)
    out["pr_auc"] = weighted_avg(ap)

    for k in top_ns:
        corr_tot = blk(f"corr_{k}")[:, 0]
        out[f"top_{k}_accuracy"] = corr_tot / n
        out[f"top_{k}_ece"], out[f"top_{k}_mce"] = ece_mce(
            blk("bin_cnt"), blk("bin_conf"), blk(f"bin_corr_{k}")
        )
        denom = np.where(corr_tot > 0, corr_tot, np.nan)
        bk = blk(f"brier_{k}") / denom[:, None]
        out[f"top_{k}_brier_class"] = bk
        out[f"top_{k}_brier_score"] = bk.mean(1)
        unck = blk(f"unc_{k}") / denom[:, None]
        out[f"top_{k}_softmax_entropy"] = unck[:, 0]
        out[f"top_{k}_gini"] = unck[:, 1]
        out[f"top_{k}_renyi"] = unck[:, 2]
        rk = np.where(
            present, blk(f"recnum_{k}") / np.maximum(t_cnt, 1e-300), 0.0
        )
        pp = blk(f"appears_{k}")
        pk = np.where(
            present & (pp > 0),
            blk(f"appears_hit_{k}") / np.maximum(pp, 1e-300),
            0.0,
        )
        denom_fk = pk + rk
        fk = np.divide(
            2 * pk * rk, denom_fk, out=np.zeros_like(pk), where=denom_fk > 0
        )
        out[f"top_{k}_balanced_accuracy"] = np.where(
            present.any(1),
            (rk * present).sum(1) / np.maximum(present.sum(1), 1),
            np.nan,
        )
        out[f"top_{k}_precision"] = pk
        out[f"top_{k}_recall"] = rk
        out[f"top_{k}_f1"] = fk
        out[f"top_{k}_macro_f1"] = fk.mean(1)
        out[f"top_{k}_macro_prec"] = pk.mean(1)
        out[f"top_{k}_macro_sens"] = rk.mean(1)
    return out


def _draw_all_indices(y_true, classes, n_samples, n_bootstrap, random_state):
    """The reference's per-iteration seeded draw protocol, batched.

    Fast path: every row's first attempt is drawn with its own per-iteration
    rng (identical streams to ``_resample_indices``), then class presence is
    checked for ALL rows with one vectorized bincount; only the rare failing
    rows re-enter the retry/stratified-fallback protocol.
    """
    idx = np.empty((n_bootstrap, n_samples), np.int32)
    for i in range(n_bootstrap):
        rng = np.random.default_rng((random_state + i) % (2**32))
        idx[i] = rng.integers(0, n_samples, n_samples)
    k_max = int(y_true.max()) + 1
    y32 = y_true.astype(np.int32)
    step = 1024  # bound temporaries: [step, n] gathers, not [n_bootstrap, n]
    for s in range(0, n_bootstrap, step):
        rows = idx[s:s + step]
        codes = (
            np.arange(len(rows), dtype=np.int64)[:, None] * k_max + y32[rows]
        )
        cnt = np.bincount(codes.ravel(), minlength=len(rows) * k_max)
        cnt = cnt.reshape(len(rows), k_max)[:, classes]
        for i in np.flatnonzero(~(cnt > 0).all(1)) + s:
            rng = np.random.default_rng((random_state + i) % (2**32))
            idx[i] = _resample_indices(rng, y_true, classes, n_samples)
    return idx


def compute_bootstrap_metrics(
    y_true: np.ndarray,
    y_pred_probs: np.ndarray,
    n_bootstrap: int = 10000,
    confidence: float = 0.95,
    random_state: int = 42,
    top_n: Union[int, Iterable[int], None] = None,
    keep_samples: bool = True,
    chunk_size: int = 128,  # cache-resident [C, N] arrays beat larger chunks
) -> Dict:
    """Percentile-CI bootstrap over the full metric bundle.

    Returns {metric: {mean, lower, upper, samples}} with per-class metrics as
    {metric: {class_idx: {...}}} — the reference's output schema.

    All resamples are computed in chunks of ``chunk_size`` at once (the
    vectorized engine above).
    """
    y_true = np.asarray(y_true).astype(int)
    y_pred_probs = np.asarray(y_pred_probs, np.float64)
    n_samples = len(y_true)
    n_classes = y_pred_probs.shape[1]
    classes = np.unique(y_true)

    top_ns: List[int] = []
    if top_n is not None:
        top_ns = sorted({int(top_n)} if isinstance(top_n, int) else
                        {int(k) for k in top_n})
        for k in top_ns:
            if k < 1 or k > n_classes:
                raise ValueError(f"top-n {k} must be in [1, {n_classes}]")

    idx_all = _draw_all_indices(
        y_true, classes, n_samples, n_bootstrap, random_state
    )

    feats, layout = _feature_matrix(y_true, y_pred_probs, n_classes, top_ns)
    sort_tables = _class_sort_tables(y_true, y_pred_probs, n_classes)
    chunks = [
        _chunk_metrics(idx_all[s:s + chunk_size], feats, layout, sort_tables,
                       n_classes, top_ns)
        for s in range(0, n_bootstrap, chunk_size)
    ]
    merged = {k: np.concatenate([c[k] for c in chunks]) for k in chunks[0]}
    scalar = {k: v for k, v in merged.items() if v.ndim == 1}
    per_class = {k: v for k, v in merged.items() if v.ndim == 2}

    alpha = (1 - confidence) / 2

    def ci(values):
        values = np.asarray(values, np.float64)
        valid = values[~np.isnan(values)]
        if len(valid) == 0:
            return dict(mean=np.nan, lower=np.nan, upper=np.nan,
                        samples=values if keep_samples else None)
        return dict(
            mean=float(valid.mean()),
            lower=float(np.percentile(valid, 100 * alpha)),
            upper=float(np.percentile(valid, 100 * (1 - alpha))),
            samples=values if keep_samples else None,
        )

    out = {}
    for k, v in scalar.items():
        out[k] = ci(v)
    for k, v in per_class.items():
        out[k] = {c: ci(v[:, c]) for c in range(n_classes)}
    return out
