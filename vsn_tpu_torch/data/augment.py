"""Eval and train transforms (port of vsn_tpu/data/augment.py, minimal
stack: resize + z-score).

Batches are [B, D, H, W, C] tensors on any device.
"""

from __future__ import annotations

from typing import Callable

import torch


def zscore(x: torch.Tensor) -> torch.Tensor:
    """Per-sample z-score over the whole volume, population std floored at
    1e-8 (MONAI NormalizeIntensity defaults); f32 out."""
    x32 = x.float()
    axes = tuple(range(1, x.ndim))
    mean = x32.mean(dim=axes, keepdim=True)
    std = x32.std(dim=axes, keepdim=True, correction=0)
    return (x32 - mean) / std.clamp_min(1e-8)


def resize_batch(x: torch.Tensor, target) -> torch.Tensor:
    """Resize of the spatial dims; the identity when they already match."""
    if tuple(x.shape[1:4]) == tuple(target):
        return x
    raise NotImplementedError(
        f"resize {tuple(x.shape[1:4])} -> {tuple(target)}: the port of "
        "jax.image.resize (antialiased linear) is a later slice (ROADMAP)")


def build_eval_transform(cfg) -> Callable[[torch.Tensor], torch.Tensor]:
    """Validation/eval: resize (if needed) + z-score."""
    target = cfg.input_size

    def fn(x):
        return zscore(resize_batch(x, target))

    return fn


def build_train_augment(cfg) -> Callable[[torch.Tensor, object], torch.Tensor]:
    """Training stack: the minimal one (resize + z-score, as validation),
    fn(x, generator). The extended and dung stacks are not ported yet."""
    if cfg.get("IS_DUNG_TRANSFORMS", False) or cfg.get(
            "USE_EXTENDED_DATA_AUGMENTATION", False):
        raise NotImplementedError(
            "the extended and dung augmentation stacks are not ported yet "
            "(ROADMAP Queue 1, item 12)")
    target = cfg.input_size

    def fn(x, generator=None):
        del generator
        return zscore(resize_batch(x, target))

    return fn
