"""Test-Time Augmentation with inverse-entropy weighted averaging (port of
vsn_tpu/eval/tta.py).

View recipe matches reference eval/test_time_augmentation.py:14-120:
identity + deterministic sagittal flip + ``num_samples`` random small affines
(rot ±3° per axis, translate ±5 voxels) + one 0.9-scale center-crop->resize
(default total 8 views); per-view softmax; final prediction is the
inverse-entropy weighted mean w_v ∝ 1/(H_v + eps) (326-354) or uniform.

All views are made on the model's device from the raw volumes and stacked
into the batch axis: one model call per input batch of shape [B*V, ...],
whose eval transform (resize + z-score) runs after the warp. The affine
views use the JAX package's gather-free warp (``data/augment.py``
``affine_warp_matmul``). Their draws come from a ``torch.Generator``, or are
injected: JAX's threefry streams (``fold_in(rng, i)``) cannot be reproduced
here, so tests pass JAX's draws in.
"""

from __future__ import annotations

import numpy as np
import torch

from vsn_tpu_torch.data.augment import affine_warp_matmul, resize_batch
from vsn_tpu_torch.train.step import make_eval_step


def _center_crop_resize(x: torch.Tensor, scale: float) -> torch.Tensor:
    b, d, h, w, c = x.shape
    roi = [max(1, int(round(s * scale))) for s in (d, h, w)]
    starts = [(s - r) // 2 for s, r in zip((d, h, w), roi)]
    crop = x[:, starts[0]:starts[0] + roi[0], starts[1]:starts[1] + roi[1],
             starts[2]:starts[2] + roi[2], :]
    return resize_batch(crop, (d, h, w))


def make_tta_views(
    num_samples: int = 5,
    use_flip: bool = True,
    use_affine: bool = True,
    use_scaled_center_crop: bool = True,
    crop_roi_scale: float = 0.9,
    affine_rotate_deg: float = 3.0,
    affine_translate_vox: float = 5.0,
):
    """Returns (fn(x [B,D,H,W,C], generator=None, draws=None) -> views
    [B, V, D, H, W, C] in x's dtype, V).

    ``draws(i)`` gives the i-th affine view's (angles [B', 3] radians,
    translation [B', 3] voxels) for B' >= B rows, of which the first B are
    taken (a padded batch's draws serve its valid rows); without it they
    are drawn uniformly from ``generator`` (a CPU generator; torch's
    default one when None)."""
    rot = float(np.deg2rad(affine_rotate_deg))

    def draw(b, generator):
        u = torch.rand((2, b, 3), generator=generator)
        return ((2.0 * u[0] - 1.0) * rot,
                (2.0 * u[1] - 1.0) * affine_translate_vox)

    def views_fn(x, generator=None, draws=None):
        views = [x]
        if use_flip:
            views.append(torch.flip(x, dims=(1,)))
        if use_affine:
            b = x.shape[0]
            vols = x.float().squeeze(-1)
            for i in range(num_samples):
                angles, trans = (draw(b, generator) if draws is None
                                 else (t[:b] for t in draws(i)))
                warped = affine_warp_matmul(vols, angles, trans)[..., None]
                views.append(warped.to(x.dtype))
        if use_scaled_center_crop:
            views.append(_center_crop_resize(x, crop_roi_scale).to(x.dtype))
        return torch.stack(views, dim=1)  # [B, V, ...]

    n_views = 1 + int(use_flip) + (num_samples if use_affine else 0) + int(
        use_scaled_center_crop
    )
    return views_fn, n_views


def entropy_weighted_average(probs: torch.Tensor,
                             use_entropy_weighting: bool = True):
    """probs [B, V, K] -> [B, K]; w_v = 1/(H_v + 1e-10), renormalized
    (reference 326-354)."""
    if not use_entropy_weighting:
        return probs.mean(dim=1)
    h = -(probs * torch.log(probs + 1e-10)).sum(-1)  # [B, V]
    w = 1.0 / (h + 1e-10)
    w = w / w.sum(dim=1, keepdim=True)
    return (probs * w[..., None]).sum(dim=1)


def make_tta_predictor(
    model,
    eval_transform=None,
    num_samples: int = 5,
    use_flip: bool = True,
    use_affine: bool = True,
    use_scaled_center_crop: bool = True,
    crop_roi_scale: float = 0.9,
    use_entropy_weighting: bool = True,
):
    """Returns (fn(images [B, ...], generator=None, draws=None,
    variables=None) -> probs [B, K] f32, number of views).

    The port of reference create_tta_predictor (test_time_augmentation.py:
    397-445). ``eval_transform`` (resize + z-score) is applied per view AFTER
    augmentation, matching the reference's eval loader ordering; the
    forward is the eval step's (``variables``, a state dict, replaces the
    model's parameters for the call)."""
    views_fn, n_views = make_tta_views(
        num_samples, use_flip, use_affine, use_scaled_center_crop,
        crop_roi_scale
    )
    eval_step = make_eval_step(model)

    def predict(images, generator=None, draws=None, variables=None):
        with torch.inference_mode():
            views = views_fn(images, generator, draws)  # [B, V, ...]
            b, v = views.shape[:2]
            flat = views.reshape(b * v, *views.shape[2:])
            if eval_transform is not None:
                flat = eval_transform(flat)
            probs = eval_step(flat, variables).reshape(b, v, -1)
            return entropy_weighted_average(probs, use_entropy_weighting)

    return predict, n_views
