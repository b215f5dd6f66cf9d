"""The port's ``resize_batch`` against ``jax.image.resize(..., "linear")``
(vsn_tpu/data/augment.py resize_batch), on the CPU.

jax.image.resize is antialiased by default: on a downsample its triangle
kernel widens by 1 / scale and each output's weights are normalized, so it
is not ``F.interpolate(mode="trilinear")``. The port builds the same [out,
in] weight matrix per axis (``linear_resize_weights``, equal to JAX's bit
for bit) and applies it as a matmul; the results differ by the order of
sums only: 1e-6 of the data's scale (f32 on both sides).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F
from jax._src.image.scale import _fill_triangle_kernel, compute_weight_mat

from vsn_tpu.data.augment import build_eval_transform as jax_eval_transform
from vsn_tpu.data.augment import resize_batch as jax_resize
from vsn_tpu_torch.config import load_config
from vsn_tpu_torch.data.augment import (
    build_eval_transform,
    linear_resize_weights,
    resize_batch,
)

CASES = {  # name -> (input spatial dims, target)
    "168 to 160 (the ViT preset's H)": ((6, 168, 5), (6, 160, 5)),
    "factor 2 down, three axes": ((16, 12, 10), (8, 6, 5)),
    "upsample": ((7, 9, 5), (13, 9, 11)),
    "identity": ((6, 8, 5), (6, 8, 5)),
}


def _x(dims, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, *dims, 1)) * 50 + 100).astype(np.float32)


@pytest.mark.parametrize("case", sorted(CASES))
def test_resize_matches_jax_image_resize(case):
    dims, target = CASES[case]
    x = _x(dims)
    want = np.asarray(jax_resize(jnp.asarray(x), target))
    got = resize_batch(torch.from_numpy(x), target)
    assert tuple(got.shape) == (2, *target, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-6 * np.abs(want).max())
    if dims == target:
        assert torch.equal(got, torch.from_numpy(x))


@pytest.mark.parametrize("n_in, n_out", [(168, 160), (16, 8), (7, 13),
                                         (144, 144)])
def test_weights_equal_jax_bit_for_bit(n_in, n_out):
    want = np.asarray(compute_weight_mat(n_in, n_out, n_out / n_in, 0.0,
                                         _fill_triangle_kernel, True)).T
    got = linear_resize_weights(n_in, n_out)
    assert got.dtype == np.float32 and got.shape == (n_out, n_in)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got.sum(1), 1.0, rtol=1e-6)


def test_downsample_is_antialiased_not_trilinear():
    """168 -> 160 averages up to 3 inputs per output (the triangle widened
    by 168 / 160); F.interpolate's trilinear mode takes 2 and gives another
    function."""
    w = linear_resize_weights(168, 160)
    assert (w > 0).sum(1).max() == 3
    x = _x((6, 168, 5))
    ours = resize_batch(torch.from_numpy(x), (6, 160, 5))
    tri = F.interpolate(torch.from_numpy(x).permute(0, 4, 1, 2, 3),
                        size=(6, 160, 5), mode="trilinear",
                        align_corners=False).permute(0, 2, 3, 4, 1)
    assert (ours - tri).abs().max() > 1.0


def test_eval_transform_resizes_then_zscores_like_jax():
    cfg = load_config(dict(RESHAPE_SIZE=[6, 160, 5]))
    from vsn_tpu.config import load_config as jax_load_config

    jcfg = jax_load_config(extra_overrides=dict(RESHAPE_SIZE=[6, 160, 5]))
    x = _x((6, 168, 5), seed=1).astype(np.float16)
    want = np.asarray(jax.jit(jax_eval_transform(jcfg))(jnp.asarray(x)))
    got = build_eval_transform(cfg)(torch.from_numpy(x))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
