"""The port's copies of the JAX package's numpy eval modules against the
originals, in one process on the same inputs:

* ``eval/bootstrap.py``: compute_bootstrap_metrics with the same
  ``random_state`` (top-n off and on), equal to 1e-12; ECE, MCE,
  Brier and the entropies;
* ``eval/calibration.py``: temperature, Platt and isotonic scaling within
  1e-8 (the port fits the last two without scikit-learn, which the JAX
  package uses);
* ``eval/calibrate_predictions.py`` on prediction CSVs (pandas there, the
  ``csv`` module here): single-fold and leave-one-fold-out calibration with
  the ensemble, every CSV written equal within 1e-8.
"""

import csv

import numpy as np
import pytest

from vsn_tpu.eval import bootstrap as jb
from vsn_tpu.eval import calibrate_predictions as jcp
from vsn_tpu.eval import calibration as jc
from vsn_tpu_torch.eval import bootstrap as tb
from vsn_tpu_torch.eval import calibrate_predictions as tcp
from vsn_tpu_torch.eval import calibration as tc


def _data(n=60, k=4, seed=0, missing=False):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((n, k)) * 2
    probs = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    gt = rng.integers(0, k - 1 if missing else k, n)
    return gt, probs


def _close(a, b, tol, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for key in a:
            _close(a[key], b[key], tol, f"{path}/{key}")
    elif isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, tol, f"{path}/{i}")
    elif isinstance(a, (list, np.ndarray)):
        np.testing.assert_allclose(np.asarray(b, float), np.asarray(a, float),
                                   rtol=tol, atol=tol, err_msg=path)
    elif a is None or isinstance(a, str):
        assert a == b, path
    else:
        np.testing.assert_allclose(b, a, rtol=tol, atol=tol, err_msg=path)


@pytest.mark.parametrize("top_n", [None, [1, 2]])
def test_bootstrap_equal_with_the_same_random_state(top_n):
    gt, probs = _data(n=40, seed=1)
    kw = dict(n_bootstrap=2000, random_state=7, top_n=top_n)
    want = jb.compute_bootstrap_metrics(gt, probs, **kw)
    got = tb.compute_bootstrap_metrics(gt, probs, **kw)
    _close(want, got, 1e-12)
    assert "ece" in got and "brier_score" in got


def test_calibration_metrics_and_entropies_equal():
    gt, probs = _data(n=80, seed=2)
    correct = probs.argmax(1) == gt
    for fn in ("compute_ece", "compute_mce"):
        for bins in (5, 15):
            assert getattr(tb, fn)(gt, probs, correct, bins) == \
                getattr(jb, fn)(gt, probs, correct, bins)
    _close(jb.compute_brier(gt, probs, 4), tb.compute_brier(gt, probs, 4), 0.0)
    mask = np.arange(80) % 3 == 0
    for fn in ("softmax_entropy", "gini_index"):
        assert getattr(tb, fn)(probs, mask) == getattr(jb, fn)(probs, mask)
    assert tb.renyi_entropy(probs, 3.0) == jb.renyi_entropy(probs, 3.0)


@pytest.mark.parametrize("method", ["temperature", "platt", "isotonic"])
def test_calibrators_match_within_1e8(method):
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((120, 5)) * 2.5
    labels = rng.integers(0, 5, 120)
    test = rng.standard_normal((40, 5)) * 3

    def prepared(x):
        if method != "isotonic":
            return x
        e = np.exp(x)
        return e / e.sum(1, keepdims=True)

    want = jc.make_calibrator(method).fit(prepared(logits), labels)
    got = tc.make_calibrator(method).fit(prepared(logits), labels)
    np.testing.assert_allclose(got.transform(prepared(test)),
                               want.transform(prepared(test)),
                               rtol=1e-8, atol=1e-8)
    if method == "temperature":
        assert abs(got.temperature - want.temperature) < 1e-8
        assert got.temperature != 1.0


def _write_predictions(root, folds=3, seed=4):
    """prediction_model_run_{fold}_best0_{id,od}.csv as the evaluator
    writes them (float32 probabilities)."""
    rng = np.random.default_rng(seed)
    diseases = ["CN", "AD", "FTD"]
    for fold in range(folds):
        for dom, n in (("id", 30), ("od", 12)):
            logits = rng.standard_normal((n, 3)) * 2
            probs = (np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
                     ).astype(np.float32)
            with open(root / f"prediction_model_run_{fold}_best0_{dom}.csv",
                      "w", newline="") as f:
                w = csv.writer(f)
                w.writerow(["Subject", "Diagnosis", "Dataset"]
                           + [f"pred_{d}" for d in diseases])
                for i in range(n):
                    w.writerow([f"s{fold}-{dom}-{i:03d}",
                                diseases[rng.integers(0, 3)], "SYNTH",
                                *[str(v) for v in probs[i]]])


def _read(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def _same_csv(a, b, tol=1e-8):
    ra, rb = _read(a), _read(b)
    assert len(ra) == len(rb) and (not ra or list(ra[0]) == list(rb[0])), a
    for x, y in zip(ra, rb):
        for key in x:
            try:
                fx = float(x[key]) if x[key] != "" else np.nan
                fy = float(y[key]) if y[key] != "" else np.nan
            except ValueError:
                assert x[key] == y[key], (a, key)
                continue
            np.testing.assert_allclose(fy, fx, rtol=tol, atol=tol,
                                       err_msg=f"{a}: {key}")


@pytest.mark.parametrize("method", ["temperature", "platt", "isotonic"])
@pytest.mark.parametrize("val_fold", ["1", "all"])
def test_calibrate_predictions_csvs_match(method, val_fold, tmp_path):
    preds = tmp_path / "preds"
    preds.mkdir()
    _write_predictions(preds)
    args = ["--model-dir", str(preds), "--val-fold", val_fold,
            "--method", method]
    jcp.main(args + ["--output-dir", str(tmp_path / "jax")])
    tcp.main(args + ["--output-dir", str(tmp_path / "port")])
    want = sorted(p.relative_to(tmp_path / "jax")
                  for p in (tmp_path / "jax").rglob("*.csv"))
    got = sorted(p.relative_to(tmp_path / "port")
                 for p in (tmp_path / "port").rglob("*.csv"))
    assert want == got and len(want) >= 5
    for rel in want:
        _same_csv(tmp_path / "jax" / rel, tmp_path / "port" / rel)
