"""NIfTI -> float16 volume cache (port of vsn_tpu/data/preprocessing.py).

Per-subject preprocessing matching reference dataset/preprocessing.py:178-390
(DataPrepa): load T1 + brain mask, multiply, center-crop to IMG_SIZE, add a
channel dim, cast float16, save one ``{Subject}.npy`` file per subject laid
out channels-last ``[D, H, W, 1]``; the cache is incremental: subjects are
diffed against existing files and strays deleted. IO-bound work runs in a
thread pool.

The optional downsample is the JAX package's ``jax.image.resize(...,
"linear")`` on the host, here the port's ``data/augment.py``
``resize_batch`` on the CPU (the same antialiased weights). Metadata is a
table of row dicts (``data/folds.py``) or a CSV path.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from vsn_tpu_torch.data.folds import read_csv


def center_crop(vol: np.ndarray, crop) -> np.ndarray:
    """Centered spatial crop (MONAI CenterSpatialCrop semantics: axes smaller
    than the ROI are left untouched)."""
    slices = []
    for size, c in zip(vol.shape, crop):
        if size <= c:
            slices.append(slice(None))
        else:
            center = size // 2
            start = center - c // 2
            slices.append(slice(start, start + c))
    return vol[tuple(slices)]


def resize_volume(vol: np.ndarray, target) -> np.ndarray:
    """Linear (antialiased) resize of a [D, H, W] volume on the CPU, f32."""
    from vsn_tpu_torch.data.augment import resize_batch

    x = torch.from_numpy(np.ascontiguousarray(vol, np.float32))[None, ..., None]
    return resize_batch(x, tuple(target))[0, ..., 0].numpy()


class DataPrepa:
    """Preprocess T1 MRIs into the float16 cache.

    Expects metadata with columns Subject, T1_path, Mask_path (reference
    preprocessing.py:178-183).
    """

    def __init__(self, metadata, preprocess_data_dir: str | Path):
        self.metadata = (metadata if isinstance(metadata, list)
                         else read_csv(metadata))
        self.dir = Path(preprocess_data_dir)

    def cache_path(self, subject: str) -> Path:
        return self.dir / f"{subject}.npy"

    def _process_one(self, row, crop, downsample) -> bool:
        try:
            from vsn_tpu_torch.utils import nifti

            image = nifti.load(row["T1_path"]).get_fdata()
            mask = nifti.load(row["Mask_path"]).get_fdata()
            image = image * mask
            image = center_crop(image, crop)
            if downsample and tuple(downsample) != tuple(crop):
                image = resize_volume(image, downsample)
            image = image[..., None].astype(np.float16)  # [D, H, W, 1]
            np.save(self.cache_path(row["Subject"]), image)
            return True
        except Exception as e:  # noqa: BLE001 — per-subject skip & report
            print(f"Error processing subject {row['Subject']}: {e}")
            return False

    def _diff_cache(self):
        """Incremental-diff + stray GC (reference preprocessing.py:359-390):
        the rows whose subject has no cache file, or None."""
        df_subjects = {row["Subject"] for row in self.metadata}
        file_subjects = {f.stem for f in self.dir.glob("*.npy")}
        for stray in file_subjects - df_subjects:
            os.remove(self.dir / f"{stray}.npy")
        todo = df_subjects - file_subjects
        if not todo:
            return None
        return [row for row in self.metadata if row["Subject"] in todo]

    def preprocess_data(self, crop, downsample=None, n_jobs: int = 8) -> int:
        """Process missing subjects; returns the number processed (a subject
        that fails is reported and skipped)."""
        if len(crop) != 3:
            raise ValueError(f"crop must have length 3, got {len(crop)}")
        self.dir.mkdir(parents=True, exist_ok=True)

        rows = self._diff_cache()
        if rows is None:
            return 0
        with ThreadPoolExecutor(max_workers=max(1, n_jobs)) as ex:
            return int(sum(ex.map(
                lambda r: self._process_one(r, crop, downsample), rows)))
