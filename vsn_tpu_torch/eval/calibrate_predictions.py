"""Post-hoc calibration pipeline over prediction CSVs (a copy of
vsn_tpu/eval/calibrate_predictions.py on the ``csv`` module: tables are
lists of row dicts, ``data/folds.py``).

Workflow parity with reference utils/calibrate_predictions.py:84-672:

  * discovers ``prediction_*_{fold}_best*_{id,od}.csv`` files, grouping by the
    fold number embedded in the filename (extract_fold_from_filename:19-26);
  * ``--val-fold k``: fit the calibrator on fold k's ID predictions, apply to
    every other fold (ID and OD), report ECE before/after, write calibrated
    CSVs (157-417);
  * ``--val-fold all``: leave-one-fold-out over all folds — each fold takes a
    turn as validation (per-val-fold subdirectories), then the final ensemble
    averages the calibrated copies of each test fold across validation folds
    (420-661) and writes ``ensemble/`` CSVs + a results table
    (all_folds_calibration_results.csv).

Faithful quirk: the reference loads the stored ``pred_*`` columns as
"logits" and softmaxes them to get "probabilities" (load_predictions:29-48),
even though the evaluator stored softmax probabilities. We reproduce that
exact transformation so ECE numbers are protocol-comparable.
"""

from __future__ import annotations

import argparse
import re
from pathlib import Path

import numpy as np
from scipy.special import softmax

from vsn_tpu_torch.data.folds import columns, read_csv, write_csv
from vsn_tpu_torch.eval.bootstrap import compute_ece
from vsn_tpu_torch.eval.calibration import make_calibrator

def find_prediction_files(model_dir: Path, pattern: str = "*_best0_*.csv"):
    return sorted(Path(model_dir).glob(pattern))


def extract_fold_from_filename(path: Path) -> int:
    """'prediction_model_<runid>_<fold>_best0_id.csv' -> fold."""
    m = re.search(r"_(\d+)_best\d+_", Path(path).name)
    return int(m.group(1)) if m else -1


def _labels(rows, classes) -> np.ndarray:
    """Diagnosis -> class index; NaN where the diagnosis is not a class
    (pandas' ``map`` of a missing key)."""
    index = {d: i for i, d in enumerate(classes)}
    return np.array([index.get(row["Diagnosis"], np.nan) for row in rows])


def load_predictions(csv_path):
    """Returns (rows, classes, pred_cols, values-as-logits, labels)."""
    rows = read_csv(csv_path)
    pred_cols = [c for c in columns(rows) if c.startswith("pred_")]
    if not pred_cols:
        raise ValueError(f"no pred_* columns in {csv_path}")
    classes = [c.replace("pred_", "").replace("_ensemble", "") for c in pred_cols]
    logits = np.array([[float(row[c]) for c in pred_cols] for row in rows],
                      np.float64).reshape(len(rows), len(pred_cols))
    labels = _labels(rows, classes)
    if not np.isnan(labels).any():
        labels = labels.astype(np.int64)
    return rows, classes, pred_cols, logits, labels


def fit_calibrator(method: str, val_logits, val_labels):
    cal = make_calibrator(method)
    if method == "isotonic":
        cal.fit(softmax(val_logits, axis=1), val_labels)
    else:
        cal.fit(val_logits, val_labels)
    return cal


def calibrate_fold(calibrator, test_logits, test_labels, method: str):
    """(calibrated probs, ece_before, ece_after, temperature|None)."""
    probs_before = softmax(test_logits, axis=1)
    ece_before = compute_ece(test_labels, probs_before)
    if method == "isotonic":
        probs_after = calibrator.transform(probs_before)
    else:
        probs_after = calibrator.transform(test_logits)
    ece_after = compute_ece(test_labels, probs_after)
    return probs_after, ece_before, ece_after, getattr(
        calibrator, "temperature", None
    )


def _with_preds(rows, pred_cols, probs):
    return [{**row, **{c: float(probs[r, j]) for j, c in enumerate(pred_cols)}}
            for r, row in enumerate(rows)]


def _by_fold(files):
    id_by_fold = {
        extract_fold_from_filename(f): f for f in files if "_id.csv" in f.name
    }
    od_by_fold = {
        extract_fold_from_filename(f): f for f in files if "_od.csv" in f.name
    }
    return id_by_fold, od_by_fold


def process_single_fold(model_dir, output_dir, val_fold: int, method: str,
                        pattern: str = "*_best0_*.csv") -> list:
    id_by_fold, od_by_fold = _by_fold(find_prediction_files(model_dir, pattern))
    if val_fold not in id_by_fold:
        raise FileNotFoundError(
            f"validation fold {val_fold} not among {sorted(id_by_fold)}"
        )

    _, _, _, val_logits, val_labels = load_predictions(id_by_fold[val_fold])
    calibrator = fit_calibrator(method, val_logits, val_labels)

    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    results = []
    for domain, by_fold in (("ID", id_by_fold), ("OD", od_by_fold)):
        for fold, f in sorted(by_fold.items()):
            if fold == val_fold:
                continue
            rows, _, pred_cols, logits, labels = load_predictions(f)
            probs, ece_b, ece_a, temp = calibrate_fold(
                calibrator, logits, labels, method
            )
            write_csv(_with_preds(rows, pred_cols, probs), output_dir / f.name,
                      columns(rows))
            results.append(dict(domain=domain, val_fold=val_fold,
                                test_fold=fold, n_samples=len(rows),
                                ece_before=ece_b, ece_after=ece_a,
                                temperature=temp))
    write_csv(results, output_dir / "calibration_results.csv")
    return results


def process_all_folds(model_dir, output_dir, method: str,
                      pattern: str = "*_best0_*.csv") -> list:
    """Leave-one-fold-out calibration + per-test-fold ensemble averaging
    (reference 420-661)."""
    id_by_fold, od_by_fold = _by_fold(find_prediction_files(model_dir, pattern))
    output_dir = Path(output_dir)

    calibrated_id: dict[int, list] = {}
    calibrated_od: dict[int, list] = {}
    results = []
    for val_fold in sorted(id_by_fold):
        fold_dir = output_dir / f"val_fold_{val_fold}"
        fold_dir.mkdir(parents=True, exist_ok=True)
        _, _, _, val_logits, val_labels = load_predictions(id_by_fold[val_fold])
        calibrator = fit_calibrator(method, val_logits, val_labels)

        for domain, by_fold, store in (
            ("ID", id_by_fold, calibrated_id), ("OD", od_by_fold, calibrated_od)
        ):
            for test_fold, f in sorted(by_fold.items()):
                if test_fold == val_fold:
                    continue
                rows, _, pred_cols, logits, labels = load_predictions(f)
                probs, ece_b, ece_a, temp = calibrate_fold(
                    calibrator, logits, labels, method
                )
                out = _with_preds(rows, pred_cols, probs)
                write_csv(out, fold_dir / f.name, columns(rows))
                store.setdefault(test_fold, []).append((out, pred_cols, probs))
                results.append(dict(val_fold=val_fold, test_fold=test_fold,
                                    domain=domain, n_samples=len(rows),
                                    ece_before=ece_b, ece_after=ece_a,
                                    temperature=temp))

    # final ensemble: mean of the calibrated copies per test fold
    ens_dir = output_dir / "ensemble"
    ens_dir.mkdir(parents=True, exist_ok=True)
    for store, by_fold in ((calibrated_id, id_by_fold), (calibrated_od, od_by_fold)):
        for test_fold, copies in store.items():
            rows, pred_cols, _ = copies[0]
            mean = np.stack([p for _, _, p in copies]).mean(axis=0)
            ens = _with_preds(rows, pred_cols, mean)
            labels = _labels(ens, [c.replace("pred_", "") for c in pred_cols])
            ece = compute_ece(labels, mean)
            results.append(dict(val_fold="ensemble", test_fold=test_fold,
                                domain="ID" if by_fold is id_by_fold else "OD",
                                n_samples=len(ens), ece_before=np.nan,
                                ece_after=ece, temperature=None))
            write_csv(ens, ens_dir / by_fold[test_fold].name, columns(rows))

    write_csv(results, output_dir / "all_folds_calibration_results.csv")
    return results


def main(argv=None):
    p = argparse.ArgumentParser(description="calibrate prediction CSVs")
    p.add_argument("--model-dir", type=Path, required=True)
    p.add_argument("--output-dir", type=Path, required=True)
    p.add_argument("--val-fold", type=str, required=True,
                   help="fold index, or 'all' for leave-one-out + ensemble")
    p.add_argument("--method", choices=["temperature", "platt", "isotonic"],
                   default="temperature")
    p.add_argument("--pattern", default="*_best0_*.csv")
    args = p.parse_args(argv)
    if args.val_fold.lower() == "all":
        results = process_all_folds(args.model_dir, args.output_dir, args.method,
                                    args.pattern)
    else:
        results = process_single_fold(args.model_dir, args.output_dir,
                                      int(args.val_fold), args.method,
                                      args.pattern)
    for row in results:
        print("  ".join(f"{k}={v}" for k, v in row.items()))
    return results


if __name__ == "__main__":
    main()
