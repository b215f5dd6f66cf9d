"""Synthetic NIfTI cohort generator (port of vsn_tpu/data/synthetic.py's
``generate_synthetic_dataset``, writing its fold CSVs by ``csv``).

The paper cohorts are unshareable (reference README.md:156-159), so tests and
card runs use synthetic T1-like volumes: a class-dependent smooth blob
pattern plus noise inside a brain-ish ellipsoid mask. Produces the same
on-disk layout the real pipeline expects, with the same bytes as the JAX
package's generator for the same arguments:

  raw_dir/{subject}_T1.nii.gz, {subject}_mask.nii.gz
  csv_dir/fold_0.csv .. fold_{K-1}.csv  with Subject/Diagnosis/Dataset/
      T1_path/Mask_path columns.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from vsn_tpu_torch.data.folds import write_csv


def _make_volume(rng, shape, class_idx: int, num_classes: int):
    """Class-separable smooth volume: low-frequency blob whose position and
    amplitude depend on the class, embedded in an ellipsoid mask."""
    d, h, w = shape
    zz, yy, xx = np.meshgrid(
        np.linspace(-1, 1, d), np.linspace(-1, 1, h), np.linspace(-1, 1, w),
        indexing="ij",
    )
    mask = (zz**2 / 0.9 + yy**2 / 0.95 + xx**2 / 0.9) < 1.0

    # class-dependent blob center on a circle in the (z, y) plane
    theta = 2 * np.pi * class_idx / max(num_classes, 1)
    cz, cy = 0.4 * np.cos(theta), 0.4 * np.sin(theta)
    blob = np.exp(-(((zz - cz) ** 2 + (yy - cy) ** 2 + xx**2) / 0.15))
    base = 0.6 * np.exp(-((zz**2 + yy**2 + xx**2) / 0.5))
    noise = 0.05 * rng.standard_normal(shape)
    vol = (base + (0.5 + 0.1 * class_idx) * blob + noise) * 100.0
    return vol.astype(np.float32), mask.astype(np.float32)


def generate_synthetic_dataset(
    root: str | Path,
    n_subjects: int = 40,
    shape=(32, 36, 32),
    diseases=("CN", "AD", "FTD"),
    kfold: int = 10,
    seed: int = 0,
    dataset_name: str = "SYNTH",
):
    """Write NIfTI volumes + masks + fold CSVs; returns (raw_dir, csv_dir).

    The subjects are shuffled as pandas' ``sample(frac=1.0,
    random_state=seed)`` shuffles (``RandomState(seed).permutation``), then
    split with a stride so that every fold sees every class."""
    from vsn_tpu_torch.utils import nifti

    root = Path(root)
    raw_dir = root / "raw"
    csv_dir = root / "folds"
    raw_dir.mkdir(parents=True, exist_ok=True)
    csv_dir.mkdir(parents=True, exist_ok=True)

    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n_subjects):
        subject = f"synth-{i:04d}"
        cls = i % len(diseases)
        vol, mask = _make_volume(rng, shape, cls, len(diseases))
        t1_path = raw_dir / f"{subject}_T1.nii.gz"
        mask_path = raw_dir / f"{subject}_mask.nii.gz"
        nifti.save(vol, t1_path)
        nifti.save(mask, mask_path)
        rows.append(
            dict(
                Subject=subject,
                Diagnosis=diseases[cls],
                Dataset=dataset_name,
                T1_path=str(t1_path),
                Mask_path=str(mask_path),
            )
        )

    order = np.random.RandomState(seed).permutation(len(rows))
    rows = [rows[i] for i in order]
    for k in range(kfold):
        write_csv(rows[k::kfold], csv_dir / f"fold_{k}.csv",
                  fieldnames=list(rows[0]) if rows else None)
    return raw_dir, csv_dir
