"""K1 ``attn_half`` and K2 ``ln_mlp`` of the port against the JAX
``fused_attn_half`` / ``fused_ln_mlp`` Pallas kernels run in interpret mode
on the CPU, as tests/test_swin_block_kernels.py runs them.

On CPU tensors the port's wrappers run their plain PyTorch versions, which
are what the CUDA kernels are held to on the card. Inputs come from numpy
seeds, in f32. Tolerance 2e-5, as the JAX kernel tests use: both sides are
f32 with the same softmax form, differing only in the order of sums.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from vsn_tpu.models.swin3d import (
    padded_window_region_ids,
    shifted_window_region_ids,
)
from vsn_tpu.ops.swin_block_kernels import fused_attn_half, fused_ln_mlp
from vsn_tpu_torch.ops import swin_block_kernels as port

TOL = 2e-5
HEADS, HD = 2, 4
C = HEADS * HD


def _attn_inputs(n, bw, rng, bias_shift=None):
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    p = dict(
        x=f(bw, n, C),
        lng=1.0 + 0.1 * f(C), lnb=0.1 * f(C),
        wqkv=0.3 * f(C, 3 * C), bqkv=0.1 * f(3 * C),
        wproj=0.3 * f(C, C), bproj=0.1 * f(C),
        bias=0.5 * f(HEADS, n, n),
    )
    if bias_shift is not None:
        # logits far past exp's f32 range: the rowmax shift must keep the
        # softmax exact (DEVIATIONS #3)
        p["bias"] = 8.0 * f(HEADS, n, n) + bias_shift
    return p


def _run_attn(p, ids, gains, lam, use_bias=True):
    scale = HD ** -0.5
    bias = p["bias"] if use_bias else None
    want = fused_attn_half(
        jnp.asarray(p["x"]), jnp.asarray(p["lng"]), jnp.asarray(p["lnb"]),
        jnp.asarray(p["wqkv"]), jnp.asarray(p["bqkv"]),
        None if bias is None else jnp.asarray(bias),
        None if ids is None else jnp.asarray(ids),
        jnp.asarray(p["wproj"]), jnp.asarray(p["bproj"]),
        jnp.asarray(gains), jnp.asarray(gains), scale, HEADS, lam)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    got = port.attn_half(
        t(p["x"]), t(p["lng"]), t(p["lnb"]), t(p["wqkv"].T), t(p["bqkv"]),
        None if bias is None else t(bias), None if ids is None else t(ids),
        t(p["wproj"].T), t(p["bproj"]), t(gains), t(gains), scale, HEADS,
        lam)
    return got.numpy(), np.asarray(want)


# (dims, window, shift, ids kind): shifted mask on a power-of-two window,
# N = 12 (window (2,3,2)) shifted, and a padded grid whose pad slots carry -1
ATTN_CASES = {
    "shifted": ((4, 4, 4), (2, 2, 2), (1, 1, 1), "shifted"),
    "n12_shifted": ((4, 6, 4), (2, 3, 2), (1, 1, 1), "shifted"),
    "padded_ids": ((3, 5, 3), (2, 3, 2), (1, 1, 1), "padded"),
    "padded_ids_unshifted": ((3, 5, 3), (2, 3, 2), (0, 0, 0), "padded"),
}


def _ids(dims, window, shift, kind):
    if kind == "padded":
        return padded_window_region_ids(dims, window, shift)
    return shifted_window_region_ids(dims, window, shift)


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_attn_half_matches_jax(case):
    dims, window, shift, kind = ATTN_CASES[case]
    ids = _ids(dims, window, shift, kind)
    if kind == "padded":
        assert (ids == -1).any()
    nw, n = ids.shape
    rng = np.random.default_rng(len(case))
    p = _attn_inputs(n, 2 * nw, rng)
    gains = np.asarray([0.6, 1.4], np.float32)  # per-sample, B = 2
    got, want = _run_attn(p, ids, gains, lam=0.75)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("which", ["no_ids", "no_bias", "no_ids_no_bias"])
def test_attn_half_optional_mask_and_bias(which):
    dims, window, shift = (4, 6, 4), (2, 3, 2), (1, 1, 1)
    ids = shifted_window_region_ids(dims, window, shift)
    nw, n = ids.shape
    p = _attn_inputs(n, 2 * nw, np.random.default_rng(3))
    gains = np.asarray([1.25, 0.5], np.float32)
    got, want = _run_attn(p, None if "no_ids" in which else ids, gains,
                          lam=1.0, use_bias="no_bias" not in which)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("logit", [45.0, 200.0])
def test_attn_half_exact_at_saturated_logits(logit):
    dims, window, shift = (4, 4, 4), (2, 2, 2), (1, 1, 1)
    ids = shifted_window_region_ids(dims, window, shift)
    nw, n = ids.shape
    p = _attn_inputs(n, 2 * nw, np.random.default_rng(7), bias_shift=logit)
    gains = np.asarray([1.0, 0.3], np.float32)
    got, want = _run_attn(p, ids, gains, lam=1.0)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("lam,gains", [
    (1.0, (1.0, 1.0)),
    (0.5, (0.25, 1.75)),  # distinct per-sample gains over 2 tiles each
])
def test_ln_mlp_matches_jax(lam, gains):
    rows, c, hid = 96, 16, 64           # per sample, B = 2
    rng = np.random.default_rng(11)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    x = f(2 * rows, c)
    lng, lnb = 1.0 + 0.1 * f(c), 0.1 * f(c)
    w1, b1 = 0.3 * f(c, hid), 0.1 * f(hid)
    w2, b2 = 0.3 * f(hid, c), 0.1 * f(c)
    g = np.asarray(gains, np.float32)
    want = fused_ln_mlp(*map(jnp.asarray, (x, lng, lnb, w1, b1, w2, b2, g, g)),
                        48, lam)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    got = port.ln_mlp(t(x), t(lng), t(lnb), t(w1.T), t(b1), t(w2.T), t(b2),
                      t(g), t(g), lam)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def test_bf16_plain_versions_round_operands_like_the_kernel():
    """bf16 in, bf16 out; the result lies within bf16 rounding of the f32
    computation on the same inputs."""
    rng = np.random.default_rng(5)
    p = _attn_inputs(8, 8, rng)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    args = [t(p["lng"]), t(p["lnb"]), t(p["wqkv"].T), t(p["bqkv"]),
            t(p["bias"]), None, t(p["wproj"].T), t(p["bproj"]),
            torch.ones(2), torch.ones(2), HD ** -0.5, HEADS]
    x = t(p["x"])
    ref = port.attn_half(x, *args)
    out = port.attn_half(x.bfloat16(), *args)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), ref.numpy(), atol=0.1,
                               rtol=0.05)


def test_plain_window_attention_helpers_match_jax():
    from vsn_tpu.ops.window_attention import (
        _mask_from_ids,
        window_attention_reference as jax_reference,
    )
    from vsn_tpu_torch.ops.window_attention import (
        mask_from_ids,
        window_attention_reference,
    )

    ids = padded_window_region_ids((3, 5, 3), (2, 3, 2), (1, 1, 1))
    np.testing.assert_array_equal(mask_from_ids(torch.from_numpy(ids[0])),
                                  np.asarray(_mask_from_ids(jnp.asarray(ids[0]))))
    rng = np.random.default_rng(9)
    q, k, v = (rng.standard_normal((16, HEADS, 12, HD)).astype(np.float32)
               for _ in range(3))
    bias = rng.standard_normal((HEADS, 12, 12)).astype(np.float32)
    want = jax_reference(*map(jnp.asarray, (q, k, v, bias, ids)), HD ** -0.5)
    got = window_attention_reference(*map(torch.from_numpy, (q, k, v, bias, ids)),
                                      HD ** -0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
