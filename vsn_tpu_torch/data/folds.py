"""Rotating K-fold cross-validation split reader (port of
vsn_tpu/data/folds.py, on the standard ``csv`` module).

Protocol identical to the reference (utils/helper.py:346-414): the metadata
directory holds ``fold_0.csv .. fold_{K-1}.csv``; for configuration ``fold``,
folds ``(fold+i) % K`` for i in [0, split0) are train, the next split1 are
val, the remaining are test. CSVs carry at least ``Subject`` and ``Diagnosis``
columns (plus ``Dataset`` for cohort filtering).

The port's metadata table is a list of row dicts, column name -> the CSV's
text (``read_csv``), in file order; columns a step adds (``pred_*``) hold
numbers, which ``write_csv`` writes as pandas' ``to_csv`` does (the
shortest repr of the value's own dtype, '' for NaN and None).
"""

from __future__ import annotations

import csv
import re
from pathlib import Path

import numpy as np

Table = list  # list[dict[str, object]]: one dict per row, keyed by column


def read_csv(path) -> Table:
    """The rows of a CSV with a header line, as dicts of strings."""
    with open(path, newline="") as f:
        return [dict(row) for row in csv.DictReader(f)]


def columns(rows: Table) -> list[str]:
    """Column names in first-seen order over the rows."""
    out: dict[str, None] = {}
    for row in rows:
        out.update(dict.fromkeys(row))
    return list(out)


def _cell(value) -> str:
    if value is None or (isinstance(value, (float, np.floating))
                         and np.isnan(value)):
        return ""
    return str(value)


def write_csv(rows: Table, path, fieldnames=None) -> None:
    """Write ``rows`` with a header (``fieldnames``, default ``columns``)
    and no index column."""
    fieldnames = list(fieldnames or columns(rows))
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(fieldnames)
        for row in rows:
            w.writerow([_cell(row.get(k)) for k in fieldnames])


def get_train_val_test(
    metadata_dir: str,
    fold: int,
    kfold: int,
    split: tuple[int, int, int] = (7, 2, 1),
) -> tuple[Table, Table, Table, Table]:
    """Return (train, val, test, all) metadata tables for a fold, ``all``
    sorted by Subject.

    Invariants match reference utils/helper.py:380-392: split has 3 parts that
    sum to kfold, kfold >= 3, fold in [0, kfold), and exactly kfold files named
    ``fold_<n>.csv`` exist.
    """
    if len(split) != 3:
        raise ValueError("split must have three entries (train, val, test)")
    if kfold < 3:
        raise ValueError("kfold must be at least 3")
    if sum(split) != kfold:
        raise ValueError(f"sum(split) must equal kfold={kfold}, got {sum(split)}")
    if not 0 <= fold < kfold:
        raise ValueError(f"fold must be in [0, {kfold})")

    files = [
        p
        for p in Path(metadata_dir).glob("fold_*.csv")
        if re.fullmatch(r"fold_[0-9]+\.csv", p.name)
    ]
    if len(files) != kfold:
        raise FileNotFoundError(
            f"expected {kfold} fold CSVs in {metadata_dir}, found {len(files)}"
        )

    def read(indices):
        return [row for i in indices
                for row in read_csv(Path(metadata_dir) / f"fold_{i}.csv")]

    n_train, n_val, _ = split
    train_idx = [(fold + i) % kfold for i in range(n_train)]
    val_idx = [(fold + i) % kfold for i in range(n_train, n_train + n_val)]
    test_idx = [(fold + i) % kfold for i in range(n_train + n_val, kfold)]

    meta_train = read(train_idx)
    meta_val = read(val_idx)
    meta_test = read(test_idx)
    meta_all = sorted(meta_train + meta_val + meta_test,
                      key=lambda row: row["Subject"])
    return meta_train, meta_val, meta_test, meta_all


def load_metadata(
    metadata_paths,
    accept_datasets: list[str] | None = None,
) -> Table:
    """Load/concatenate metadata CSVs (a path, a list of paths, or a table),
    optionally filtering by Dataset column.

    Mirrors reference dataset/dataset.py:19-39.
    """
    if isinstance(metadata_paths, (str, Path)):
        metadata = read_csv(metadata_paths)
    elif isinstance(metadata_paths, (list, tuple)) and all(
            isinstance(p, (str, Path)) for p in metadata_paths):
        metadata = [row for p in metadata_paths for row in read_csv(p)]
    elif isinstance(metadata_paths, list):
        metadata = [dict(row) for row in metadata_paths]
    else:
        raise TypeError(f"unsupported metadata source: {type(metadata_paths)}")

    if accept_datasets is not None:
        metadata = [row for row in metadata
                    if row["Dataset"] in accept_datasets]
    return metadata
