"""MixUp / CutMix (port of vsn_tpu/data/mixers.py).

Host side (numpy, copied as it is, plans bit-equal to JAX's): partner
selection, lambda and cuboid bounds per sample. Device side (torch): the
voxel math over a [B, D, H, W, C] micro-batch, on whatever device it lies.
"""

from __future__ import annotations

import numpy as np
import torch


# ---------------------------------------------------------------------------
# Device side
# ---------------------------------------------------------------------------

def apply_mixup(x1, x2, y1, y2, lam, apply):
    """x = lam*x1 + (1-lam)*x2 where apply, else x1; same for labels (f32)."""
    b = x1.shape[0]
    lam_x = lam.reshape((b,) + (1,) * (x1.ndim - 1)).float()
    app_x = apply.reshape((b,) + (1,) * (x1.ndim - 1))
    x = torch.where(app_x, lam_x * x1.float() + (1 - lam_x) * x2.float(),
                    x1.float())
    lam_y = lam.reshape(b, 1).float()
    y = torch.where(apply.reshape(b, 1), lam_y * y1 + (1 - lam_y) * y2, y1)
    return x, y


def apply_cutmix(x1, x2, y1, y2, bounds, actual_lam, apply):
    """Replace the cuboid [b0:b3, b1:b4, b2:b5] with partner voxels where
    apply; label = actual_lam*y1 + (1-actual_lam)*y2."""
    b, d, h, w, _ = x1.shape
    dev = x1.device
    zz = torch.arange(d, device=dev).reshape(1, d, 1, 1, 1)
    yy = torch.arange(h, device=dev).reshape(1, 1, h, 1, 1)
    xx = torch.arange(w, device=dev).reshape(1, 1, 1, w, 1)

    def bound(i):
        return bounds[:, i].reshape(b, 1, 1, 1, 1)

    inside = ((zz >= bound(0)) & (zz < bound(3))
              & (yy >= bound(1)) & (yy < bound(4))
              & (xx >= bound(2)) & (xx < bound(5)))
    x = torch.where(inside & apply.reshape(b, 1, 1, 1, 1), x2.float(),
                    x1.float())
    lam_y = actual_lam.reshape(b, 1).float()
    y = torch.where(apply.reshape(b, 1), lam_y * y1 + (1 - lam_y) * y2, y1)
    return x, y


def build_mix_fn(cfg):
    """fn(micro) -> (images, labels) applying the configured mix to one
    micro-batch dict (image, image2, label, label2, mix_*), or None."""
    if cfg.get("USE_MIXUP", False) and cfg.get("USE_CUTMIX", False):
        raise ValueError("USE_MIXUP and USE_CUTMIX are mutually exclusive")
    if cfg.get("USE_MIXUP", False):
        def fn(batch):
            return apply_mixup(batch["image"], batch["image2"],
                               batch["label"], batch["label2"],
                               batch["mix_lam"], batch["mix_apply"])
        return fn
    if cfg.get("USE_CUTMIX", False):
        def fn(batch):
            return apply_cutmix(batch["image"], batch["image2"],
                                batch["label"], batch["label2"],
                                batch["mix_bounds"], batch["mix_lam"],
                                batch["mix_apply"])
        return fn
    return None


# ---------------------------------------------------------------------------
# Host side
# ---------------------------------------------------------------------------

def cutmix_bounds(shape, lam, rng) -> tuple[np.ndarray, float]:
    """Cuboid bounds + actual lambda for one sample (``shape`` is D, H, W)."""
    d, h, w = shape
    cut = np.sqrt(1.0 - lam)
    cd, ch, cw = int(d * cut), int(h * cut), int(w * cut)
    zc = rng.integers(0, d + 1)
    yc = rng.integers(0, h + 1)
    xc = rng.integers(0, w + 1)
    z0, z1 = max(0, zc - cd // 2), min(d, zc + cd // 2)
    y0, y1 = max(0, yc - ch // 2), min(h, yc + ch // 2)
    x0, x1 = max(0, xc - cw // 2), min(w, xc + cw // 2)
    vol = (z1 - z0) * (y1 - y0) * (x1 - x0)
    actual_lam = 1.0 - vol / float(d * h * w)
    return np.array([z0, y0, x0, z1, y1, x1], np.int32), actual_lam


class MixPlanner:
    """Per-epoch mix planning over the full dataset: partner from a
    different class (MixUp) or any class (CutMix), deterministic per rng."""

    def __init__(self, labels_str, diseases, cfg, spatial_shape, seed=None):
        self.mode = ("mixup" if cfg.get("USE_MIXUP", False)
                     else "cutmix" if cfg.get("USE_CUTMIX", False)
                     else None)
        self.alpha = float(cfg.MIXUP_ALPHA if self.mode == "mixup"
                           else cfg.get("CUTMIX_ALPHA", 1.0))
        self.prob = float(cfg.MIXUP_PROB if self.mode == "mixup"
                          else cfg.get("CUTMIX_PROB", 0.5))
        self.spatial_shape = tuple(spatial_shape)
        self.seed = seed
        labels_str = np.asarray(labels_str)
        self.class_indices = {c: np.flatnonzero(labels_str == c)
                              for c in np.unique(labels_str)}
        self.class_list = sorted(self.class_indices)
        self.labels_str = labels_str

    def plan(self, indices: np.ndarray, epoch: int, rng: np.random.Generator):
        """Per-sample arrays for ``indices`` (1-D): mix_apply, partner,
        mix_lam, mix_bounds."""
        n = len(indices)
        apply = np.zeros(n, bool)
        partner = indices.copy()
        lam = np.ones(n, np.float32)
        bounds = np.zeros((n, 6), np.int32)
        if self.mode is None:
            return dict(mix_apply=apply, partner=partner, mix_lam=lam,
                        mix_bounds=bounds)
        for i, idx in enumerate(indices):
            if rng.random() > self.prob:
                continue
            apply[i] = True
            cls1 = self.labels_str[idx]
            choices = ([c for c in self.class_list if c != cls1]
                       if self.mode == "mixup" else self.class_list)
            cls2 = choices[rng.integers(0, len(choices))]
            pool = self.class_indices[cls2]
            partner[i] = pool[rng.integers(0, len(pool))]
            lam_i = float(rng.beta(self.alpha, self.alpha))
            if self.mode == "cutmix":
                bounds[i], lam_i = cutmix_bounds(self.spatial_shape, lam_i,
                                                 rng)
            lam[i] = lam_i
        return dict(mix_apply=apply, partner=partner, mix_lam=lam,
                    mix_bounds=bounds)
