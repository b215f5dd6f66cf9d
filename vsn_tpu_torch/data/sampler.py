"""Class-balanced and shuffled epoch sampling (port of
vsn_tpu/data/sampler.py, one process).

Reference utils/balanced_sampler.py semantics:
  * class weights = inverse class frequency normalized so the smallest weight
    is 1.0 (compute_class_weights:23-78);
  * per-sample weight = weight of the sample's class (compute_sample_weights:
    81-123);
  * per epoch, ``total_size`` indices are drawn WITH replacement proportional
    to the sample weights (multinomial, DistributedWeightedSampler:126-364).

Host-side numpy; the counts come from numpy, not pandas.
"""

from __future__ import annotations

import numpy as np


def compute_class_weights(labels, diseases) -> dict[str, float]:
    """Inverse-frequency weights normalized to min = 1.0."""
    names, counts = np.unique(np.asarray(labels), return_counts=True)
    count = dict(zip(names.tolist(), counts.tolist()))
    missing = [d for d in diseases if d not in count]
    if missing:
        raise ValueError(f"classes with zero samples: {missing}")
    inv = {d: 1.0 / count[d] for d in diseases}
    lo = min(inv.values())
    return {d: w / lo for d, w in inv.items()}


def compute_sample_weights(labels, diseases) -> np.ndarray:
    cw = compute_class_weights(labels, diseases)
    return np.asarray([cw[label] for label in labels], np.float64)


def weighted_epoch_indices(sample_weights: np.ndarray,
                           total_size: int | None,
                           rng: np.random.Generator) -> np.ndarray:
    """Multinomial-with-replacement epoch draw of ``total_size`` indices
    (default: one per sample)."""
    n = len(sample_weights)
    if total_size is None:
        total_size = n
    p = np.asarray(sample_weights, np.float64)
    if np.any(p < 0) or p.sum() <= 0:
        raise ValueError("sample weights must be non-negative with positive "
                         "sum")
    p = p / p.sum()
    return rng.choice(n, size=total_size, replace=True, p=p)


def shuffled_epoch_indices(n: int, rng: np.random.Generator) -> np.ndarray:
    """Plain shuffled epoch order."""
    return rng.permutation(n)
