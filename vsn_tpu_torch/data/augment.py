"""Eval and train transforms (port of vsn_tpu/data/augment.py, minimal
stack: resize + z-score).

Batches are [B, D, H, W, C] tensors on any device.
"""

from __future__ import annotations

import functools
from typing import Callable

import numpy as np
import torch


def zscore(x: torch.Tensor) -> torch.Tensor:
    """Per-sample z-score over the whole volume, population std floored at
    1e-8 (MONAI NormalizeIntensity defaults); f32 out."""
    x32 = x.float()
    axes = tuple(range(1, x.ndim))
    mean = x32.mean(dim=axes, keepdim=True)
    std = x32.std(dim=axes, keepdim=True, correction=0)
    return (x32 - mean) / std.clamp_min(1e-8)


@functools.lru_cache(maxsize=None)
def linear_resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """The [n_out, n_in] f32 matrix of jax.image.resize(..., "linear") along
    one axis (jax/_src/image/scale.py ``compute_weight_mat`` with the
    triangle kernel, scale n_out / n_in, no translation, antialias on):
    half-pixel sample positions; on a downsample the triangle widens by
    1 / scale, so each output averages every input it covers; each output's
    weights are normalized to sum to 1; outputs that sample outside the
    input get 0. Computed in f32, as JAX computes it."""
    f32 = np.float32
    inv_scale = f32(1.0 / (n_out / n_in))
    kernel_scale = max(inv_scale, f32(1.0))
    sample = (np.arange(n_out, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    dist = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None])
    w = np.maximum(f32(0.0), f32(1.0) - dist / kernel_scale)
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(f32).eps,
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.ascontiguousarray(np.where(inside[None, :], w, f32(0.0)).T,
                                dtype=f32)


def resize_batch(x: torch.Tensor, target) -> torch.Tensor:
    """Antialiased linear resize of the spatial dims of [B, D, H, W, C]
    (vsn_tpu/data/augment.py resize_batch, ``jax.image.resize(x, ...,
    "linear")``): one [out, in] weight matrix per axis whose size changes
    (``linear_resize_weights``), applied as one [rows, in] x [in, out]
    matmul in f32 on x's device.
    The identity (x as it is) when the sizes already match."""
    if tuple(x.shape[1:4]) == tuple(target):
        return x
    x = x.float()
    for axis, n_out in zip((1, 2, 3), target):
        n_in = x.shape[axis]
        if n_in == n_out:
            continue
        w = torch.from_numpy(linear_resize_weights(n_in, int(n_out))).to(
            x.device)
        x = torch.movedim(x, axis, -1)
        rows = x.shape[:-1]
        x = (x.reshape(-1, n_in) @ w.t()).reshape(*rows, int(n_out))
        x = torch.movedim(x, -1, axis)
    return x.contiguous()


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
            "(ROADMAP Queue 1, item 6)")
    target = cfg.input_size

    def fn(x, generator=None):
        del generator
        return zscore(resize_batch(x, target))

    return fn
