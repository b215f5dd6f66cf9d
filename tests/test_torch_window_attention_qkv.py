"""K4, the port's ``window_attention_qkv``, against the JAX package's
``fused_window_attention_qkv`` Pallas kernel, run in interpret mode on the
CPU as tests/test_window_attention_kernel.py runs it, forward and
``jax.vjp``.

On CPU tensors the port's Function runs its plain forward and the explicit
plain backward (``window_attention_qkv_backward_reference``), which the CUDA
kernels K4f/K4b are held to on the card. Both sides read q, k, v into f32,
subtract the plain row max and mask with -1e9, so they differ only in the
order of sums.

Tolerances: f32 1e-5 (rtol and atol), the rounding of sums taken in another
order; dbias sums over every window. bf16 2e-2 of each output's own scale:
both sides compute in f32 from the same bf16 inputs and round the result to
bf16 once, and a sum taken in another order can round to the neighbouring
bf16 value (2^-8 relative). In f32 the plain backward is also held to
autograd through the plain forward, an independent derivation, at 1e-5.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vsn_tpu.models.swin3d import (
    padded_window_region_ids,
    shifted_window_region_ids,
)
from vsn_tpu.ops.window_attention import fused_window_attention_qkv
from vsn_tpu_torch.ops import window_attention as port

TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _ids(kind):
    """(region ids [W, N], windows per sample)."""
    if kind == "shifted":
        ids = shifted_window_region_ids((4, 6, 4), (2, 3, 2), (1, 1, 1))
    elif kind == "padded":  # 3x5x3 padded to 4x6x4; pad slots carry -1
        ids = padded_window_region_ids((3, 5, 3), (2, 3, 2), (1, 1, 1))
        assert (ids == -1).any()
    elif kind == "zeros":   # an unshifted block: one row of zeros, W = 1
        return np.zeros((1, 12), np.int32), 8
    else:                   # the N = 150 window of Swin-T stage 4 (5x6x5)
        return np.zeros((1, 150), np.int32), 1
    return ids, ids.shape[0]


def _case(kind, heads, seed, logit=None):
    """(qkv [BW, N, 3C], bias [H, N, N], ids, dout [BW, N, C]) at B = 2,
    head dim 4, O(1) logits (or logits near ``logit``)."""
    ids, nw = _ids(kind)
    n, c = ids.shape[1], 4 * heads
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    qkv = 1.5 * f(2 * nw, n, 3 * c)
    bias = f(heads, n, n) if logit is None else 8.0 * f(heads, n, n) + logit
    return qkv, bias, ids, f(2 * nw, n, c)


def _jax(qkv, bias, ids, dout, heads, dtype):
    scale = (qkv.shape[-1] // (3 * heads)) ** -0.5
    fn = lambda a, b: fused_window_attention_qkv(a, b, jnp.asarray(ids), scale,
                                                 heads)
    out, vjp = jax.vjp(fn, jnp.asarray(qkv).astype(dtype), jnp.asarray(bias))
    dqkv, dbias = vjp(jnp.asarray(dout).astype(dtype))
    return [np.asarray(t.astype(jnp.float32)) for t in (out, dqkv, dbias)]


def _port(fn, qkv, bias, ids, dout, heads, dtype):
    scale = (qkv.shape[-1] // (3 * heads)) ** -0.5
    a = torch.from_numpy(qkv).to(dtype).requires_grad_()
    b = torch.from_numpy(bias).requires_grad_()
    out = fn(a, b, torch.from_numpy(ids), scale, heads)
    assert out.dtype == dtype and out.shape == (*qkv.shape[:2],
                                                qkv.shape[2] // 3)
    dqkv, dbias = torch.autograd.grad(out, [a, b],
                                      torch.from_numpy(dout).to(dtype))
    assert dqkv.dtype == dtype and dbias.dtype == torch.float32
    return [t.detach().float().numpy() for t in (out, dqkv, dbias)]


def _close(got, want, dtype):
    for name, g, w in zip(("out", "dqkv", "dbias"), got, want):
        assert np.isfinite(g).all(), name
        if dtype == "float32":
            np.testing.assert_allclose(g, w, rtol=TOL[dtype], atol=TOL[dtype],
                                       err_msg=name)
        else:
            err = np.abs(g - w).max()
            assert err <= TOL[dtype] * np.abs(w).max(), (name, err)


CASES = {  # name -> (ids kind, heads, dtype)
    "shifted": ("shifted", 2, "float32"),
    "padded": ("padded", 2, "float32"),
    "no_mask": ("zeros", 3, "float32"),
    "n150": ("n150", 2, "float32"),
    "bf16_shifted": ("shifted", 2, "bfloat16"),
    "bf16_padded": ("padded", 3, "bfloat16"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_and_vjp_match_jax(case):
    kind, heads, dtype = CASES[case]
    args = _case(kind, heads, seed=len(case))
    want = _jax(*args, heads, getattr(jnp, dtype))
    got = _port(port.window_attention_qkv, *args, heads, getattr(torch, dtype))
    _close(got, want, dtype)


@pytest.mark.parametrize("logit", [45.0, 200.0])
def test_saturated_logits_match_jax(logit):
    """Logits near 45 and 200: the plain row max keeps exp exact."""
    args = _case("shifted", 2, seed=7, logit=logit)
    want = _jax(*args, 2, jnp.float32)
    got = _port(port.window_attention_qkv, *args, 2, torch.float32)
    _close(got, want, "float32")


@pytest.mark.parametrize("kind", ["shifted", "padded"])
def test_plain_backward_equals_autograd(kind):
    args = _case(kind, 2, seed=3)
    got = _port(port.window_attention_qkv_reference, *args, 2, torch.float32)
    want = _port(port.window_attention_qkv_math, *args, 2, torch.float32)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)


def test_split_head_reference_agrees():
    """The packed-qkv forward equals the split-head plain oracle
    ``window_attention_reference`` (the v1 kernel's layout)."""
    qkv, bias, ids, _ = _case("shifted", 2, seed=5)
    t = torch.from_numpy(qkv)
    bw, n, c3 = t.shape
    q, k, v = t.reshape(bw, n, 3, 2, c3 // 6).permute(2, 0, 3, 1, 4)
    scale = (c3 // 6) ** -0.5
    split = port.window_attention_reference(q, k, v, torch.from_numpy(bias),
                                            torch.from_numpy(ids), scale)
    packed = port.window_attention_qkv(t, torch.from_numpy(bias),
                                       torch.from_numpy(ids), scale, 2)
    torch.testing.assert_close(packed, split.transpose(1, 2).reshape(bw, n, -1),
                               rtol=1e-5, atol=1e-5)


def test_argument_check_rejects_what_the_kernels_do_not_take():
    qkv, bias, ids, _ = _case("padded", 2, seed=2)
    a, b = torch.from_numpy(qkv), torch.from_numpy(bias)
    assert port._check(a, b, torch.from_numpy(ids), 2) == ids.shape[0]
    with pytest.raises(ValueError):  # 3 id rows for 16 windows
        port._check(a, b, torch.from_numpy(ids[:3].copy()), 2)
    with pytest.raises(TypeError):
        port._check(a.half(), b, torch.from_numpy(ids), 2)
    bw = a.shape[0]   # head dim 48: a multiple of 16 up to 128
    assert port._check(torch.zeros(bw, 12, 3 * 96), b, torch.from_numpy(ids),
                       2) == ids.shape[0]
    # head dims 40 (above 32, not 16 k) and 129 (above 128: the slab
    # kernels): every head dim up to 8192 is taken
    for c in (80, 258):
        assert port._check(torch.zeros(bw, 12, 3 * c), b,
                           torch.from_numpy(ids), 2) == ids.shape[0]
    with pytest.raises(ValueError):  # head dim 8193
        port._check(torch.zeros(bw, 12, 3 * 2 * 8193), b,
                    torch.from_numpy(ids), 2)
