"""Eval and train transforms (port of vsn_tpu/data/augment.py, minimal
stack: resize + z-score), and the gather-free affine warp that TTA's views
use (``affine_warp_matmul``).

Batches are [B, D, H, W, C] tensors on any device.
"""

from __future__ import annotations

import contextlib
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
            "(ROADMAP Queue 1, item 5)")
    target = cfg.input_size

    def fn(x, generator=None):
        del generator
        return zscore(resize_batch(x, target))

    return fn


# --- matmul-based affine resampling (vsn_tpu/data/augment.py:223-385) -------
#
# The inverse affine A = L U (Doolittle, 3x3 closed form) is applied as EIGHT
# single-axis resample passes, each "resample axis t at src = scale*i +
# slope*dep + shift", an einsum against a banded trilinear weight tensor.
# Coordinate maps compose exactly; the interpolation smooths slightly
# differently from direct trilinear sampling (JAX's ``affine_warp``), so TTA
# takes this warp, as the JAX package's TTA does, not ``grid_sample``.


def _rotation_matrix(angles: torch.Tensor) -> torch.Tensor:
    """R = Rz @ Ry @ Rx for angles [3] (radians), f32 as ``angles``."""
    az, ay, ax = angles[0], angles[1], angles[2]
    cz, sz = torch.cos(az), torch.sin(az)
    cy, sy = torch.cos(ay), torch.sin(ay)
    cx, sx = torch.cos(ax), torch.sin(ax)
    one, zero = torch.ones_like(az), torch.zeros_like(az)
    rz = torch.stack([torch.stack([one, zero, zero]),
                      torch.stack([zero, cz, -sz]),
                      torch.stack([zero, sz, cz])])
    ry = torch.stack([torch.stack([cy, zero, sy]),
                      torch.stack([zero, one, zero]),
                      torch.stack([-sy, zero, cy])])
    rx = torch.stack([torch.stack([cx, -sx, zero]),
                      torch.stack([sx, cx, zero]),
                      torch.stack([zero, zero, one])])
    return rz @ ry @ rx


def _lu3(a: torch.Tensor):
    """Closed-form Doolittle LU of a [3, 3] matrix (unit lower diagonal):
    (lower, upper)."""
    u11, u12, u13 = a[0, 0], a[0, 1], a[0, 2]
    l21 = a[1, 0] / u11
    u22 = a[1, 1] - l21 * u12
    u23 = a[1, 2] - l21 * u13
    l31 = a[2, 0] / u11
    l32 = (a[2, 1] - l31 * u12) / u22
    u33 = a[2, 2] - l31 * u13 - l32 * u23
    lower = torch.eye(3, dtype=a.dtype)
    lower[1, 0], lower[2, 0], lower[2, 1] = l21, l31, l32
    upper = torch.zeros(3, 3, dtype=a.dtype)
    upper[0, 0], upper[0, 1], upper[0, 2] = u11, u12, u13
    upper[1, 1], upper[1, 2], upper[2, 2] = u22, u23, u33
    return lower, upper


@contextlib.contextmanager
def _exact_f32_matmul():
    """f32 products without TF32 on the card, whatever the caller set."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


_AXIS_NAMES = {1: "z", 2: "y", 3: "x"}


def _resample_pass(x, axis, dep_axis, scale, slope, shift):
    """out[..., i@axis, ...] = lerp of x [B, D, H, W] along ``axis`` at
    src = scale*i + slope*dep + shift (per-sample f32 scalars [B] on x's
    device): the weights W[b, dep, i, k] = max(0, 1 - |src - k|) (sources
    out of range weigh nothing: zero padding) contracted with x by
    ``torch.einsum`` in f32."""
    dev, f32 = x.device, torch.float32
    size = x.shape[axis]
    i = torch.arange(size, dtype=f32, device=dev)
    if dep_axis is None:
        src = scale[:, None] * i[None, :] + shift[:, None]       # [B, I]
    else:
        dep = torch.arange(x.shape[dep_axis], dtype=f32, device=dev)
        src = (scale[:, None, None] * i[None, None, :]
               + slope[:, None, None] * dep[None, :, None]
               + shift[:, None, None])                            # [B, DEP, I]
    k = torch.arange(size, dtype=f32, device=dev)
    w = (1.0 - (src[..., None] - k).abs()).clamp_min(0.0)
    tgt = _AXIS_NAMES[axis]
    in_sub = "b" + "".join("k" if a == axis else _AXIS_NAMES[a]
                           for a in (1, 2, 3))
    out_sub = "b" + "".join(_AXIS_NAMES[a] for a in (1, 2, 3))
    w_sub = (f"b{tgt}k" if dep_axis is None
             else f"b{_AXIS_NAMES[dep_axis]}{tgt}k")
    return torch.einsum(f"{w_sub},{in_sub}->{out_sub}", w, x.float())


def affine_params(angles, translation, shape):
    """Per-sample (lower [B,3,3], upper [B,3,3], offset o [B,3]) of the warp
    of a volume of ``shape`` (D, H, W), computed in f32 on the CPU as the
    JAX function computes them at unit scales: A = R(angles)^-1 = lower @
    upper, o = c - A (c + t) with c the volume's center."""
    d, h, w = shape
    center = torch.tensor([(d - 1) / 2, (h - 1) / 2, (w - 1) / 2],
                          dtype=torch.float32)
    cpu = lambda t: torch.as_tensor(t).detach().to("cpu", torch.float32)
    angles, translation = map(cpu, (angles, translation))
    lowers, uppers, offsets = [], [], []
    for angle, trans in zip(angles, translation):
        a = torch.linalg.inv(_rotation_matrix(angle))
        lower, upper = _lu3(a)
        lowers.append(lower)
        uppers.append(upper)
        offsets.append(center - a @ (center + trans))
    return torch.stack(lowers), torch.stack(uppers), torch.stack(offsets)


def affine_warp_matmul(vols: torch.Tensor, angles,
                       translation) -> torch.Tensor:
    """Batched rigid warp of vols [B, D, H, W] without gathers (f32 out on
    vols' device, zero padding): output voxel p samples the input at
    A (p - c - t) + c with A = R(angles)^-1; angles (radians) and
    translation (voxels) are [B, 3]. The JAX function's scales are 1 here,
    as TTA calls it. The L-pass stack runs first, then the
    U-pass stack (the last-applied pass's coordinates are evaluated first),
    each a single-axis banded resample (``_resample_pass``); TF32 off."""
    b = vols.shape[0]
    lower, upper, o = (t.to(vols.device) for t in affine_params(
        angles, translation, vols.shape[1:]))
    zero = torch.zeros(b, device=vols.device)
    one = torch.ones(b, device=vols.device)
    with _exact_f32_matmul():
        # inner map (applied to the input first): g(w) = in(L w + o)
        x = _resample_pass(vols, 1, None, one, zero, o[:, 0])
        x = _resample_pass(x, 2, 1, one, lower[:, 1, 0], o[:, 1])
        x = _resample_pass(x, 3, 1, one, lower[:, 2, 0], o[:, 2])
        x = _resample_pass(x, 3, 2, one, lower[:, 2, 1], zero)
        # outer map: out(p) = g(U p), passes in the JAX function's order
        x = _resample_pass(x, 3, None, upper[:, 2, 2], zero, zero)
        x = _resample_pass(x, 2, 3, upper[:, 1, 1], upper[:, 1, 2], zero)
        x = _resample_pass(x, 1, 3, one, upper[:, 0, 2], zero)
        x = _resample_pass(x, 1, 2, upper[:, 0, 0], upper[:, 0, 1], zero)
    return x
