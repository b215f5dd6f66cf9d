"""Host input pipeline for evaluation (port of vsn_tpu/data/pipeline.py's
``InMemoryDataset`` and ``EvalPipeline``).

The float16 cache is preloaded into one contiguous numpy array
(PRELOAD_DATA, reference dataset/dataset.py:81-101); eval batches are
gathered from it in a fixed order and padded to a full final batch. All
voxel math happens on the device. Metadata is a table of row dicts
(``data/folds.py``). The training pipeline (samplers, mix plans, prefetch)
comes with the trainer.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


class InMemoryDataset:
    """Preloaded float16 cache ``images`` [N, D, H, W, 1] + one-hot
    ``labels`` [N, K].

    One-hot rule matches reference dataset.py:64-70: diagnoses outside
    ``diseases`` get an all-zero label (they are normally filtered upstream).
    """

    def __init__(self, cache_dir, metadata, diseases):
        cache_dir = Path(cache_dir)
        self.metadata = list(metadata)
        self.subjects = [row["Subject"] for row in self.metadata]
        idx = {d: i for i, d in enumerate(diseases)}
        self.labels = np.zeros((len(self.metadata), len(idx)), np.float32)
        for i, row in enumerate(self.metadata):
            if row["Diagnosis"] in idx:
                self.labels[i, idx[row["Diagnosis"]]] = 1.0

        first = np.load(cache_dir / f"{self.subjects[0]}.npy")
        self.images = np.empty((len(self.subjects),) + first.shape,
                               np.float16)
        self.images[0] = first
        for i in range(1, len(self.subjects)):
            self.images[i] = np.load(cache_dir / f"{self.subjects[i]}.npy")

    def __len__(self):
        return len(self.subjects)


class EvalPipeline:
    """Fixed-order batches of ``batch_size`` rows of an array (a dataset's
    ``images``), the last padded to full size with copies of row 0.

    Yields (batch [B, ...], valid_mask [B]): a full batch keeps every launch
    at one shape; the mask drops pad rows on the host (the reference's
    all_gather pad/trim, train_transformer.py:550-568, on one process).
    """

    def __init__(self, images: np.ndarray, batch_size: int):
        self.images = images
        self.batch_size = int(batch_size)

    def __iter__(self):
        n, b = len(self.images), self.batch_size
        for start in range(0, n, b):
            idx = np.arange(start, min(start + b, n))
            valid = np.zeros(b, bool)
            valid[: len(idx)] = True
            pad = np.concatenate([idx, np.zeros(b - len(idx), np.int64)])
            yield self.images[pad], valid
