"""The VJPs of K1 ``attn_half`` and K2 ``ln_mlp`` against ``jax.vjp`` of the
JAX ``fused_attn_half`` / ``fused_ln_mlp`` Pallas kernels, run in interpret
mode on the CPU as tests/test_swin_block_kernels.py runs them.

On CPU tensors the port's Functions run their plain forward and the explicit
plain backward (``*_backward_reference``), which the CUDA backward kernels
are held to on the card. The samples get distinct forward and backward
gains (gf != gb), so a backward that used gf would fail.

Tolerances: f32 5e-4 (rtol and atol, as tests/test_swin_block_kernels.py
holds the fused VJPs); bf16 2e-2 of each gradient's own scale: both sides
round the same operands to bf16, and a sum taken in another order can
round one of them to its neighbour (2^-8 relative). In f32 the plain
backward is also held to autograd through the plain forward, an
independent derivation, at 1e-5.
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
from vsn_tpu.ops.swin_block_kernels import fused_attn_half, fused_ln_mlp
from vsn_tpu_torch.ops import swin_block_kernels as port

HEADS, HD = 2, 4
C = HEADS * HD
GF, GB = np.float32([0.7, 1.3]), np.float32([0.4, 1.1])
TOL = {"float32": 5e-4, "bfloat16": 2e-2}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _attn_case(kind, seed, logit=None):
    """Inputs of one K1 call at B = 2: (params, ids, dout)."""
    dims, window = ((3, 5, 3), (2, 3, 2)) if kind == "padded" else (
        (4, 4, 4), (2, 2, 2)) if logit is not None else ((4, 6, 4), (2, 3, 2))
    ids = (padded_window_region_ids(dims, window, (1, 1, 1)) if kind == "padded"
           else shifted_window_region_ids(dims, window, (1, 1, 1)))
    nw, n = ids.shape
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    p = dict(x=f(2 * nw, n, C), lng=1.0 + 0.1 * f(C), lnb=0.1 * f(C),
             wqkv=0.3 * f(C, 3 * C), bqkv=0.1 * f(3 * C), bias=0.5 * f(HEADS, n, n),
             wproj=0.3 * f(C, C), bproj=0.1 * f(C))
    if logit is not None:  # saturated logits (DEVIATIONS #3)
        p["bias"] = 8.0 * f(HEADS, n, n) + logit
    return p, ids, f(2 * nw, n, C)


def _attn_jax(p, ids, dout, lam, dtype, use_ids=True, use_bias=True):
    keys = ["x", "lng", "lnb", "wqkv", "bqkv", "bias", "wproj", "bproj"]
    if not use_bias:
        keys.remove("bias")

    def fn(*leaves):
        a = dict(zip(keys, leaves))
        return fused_attn_half(
            a["x"], a["lng"], a["lnb"], a["wqkv"], a["bqkv"], a.get("bias"),
            jnp.asarray(ids) if use_ids else None, a["wproj"], a["bproj"],
            jnp.asarray(GF), jnp.asarray(GB), HD ** -0.5, HEADS, lam)

    leaves = [jnp.asarray(p[k]).astype(dtype) if k == "x" else jnp.asarray(p[k])
              for k in keys]
    out, vjp = jax.vjp(fn, *leaves)
    grads = dict(zip(keys, vjp(jnp.asarray(dout).astype(dtype))))
    return {k: np.asarray(v.astype(jnp.float32)) for k, v in grads.items()}


def _attn_port(fn, p, ids, dout, lam, dtype, use_ids=True, use_bias=True):
    args = [_t(p["x"]).to(dtype), _t(p["lng"]), _t(p["lnb"]), _t(p["wqkv"].T),
            _t(p["bqkv"]), _t(p["bias"]) if use_bias else None,
            _t(ids) if use_ids else None, _t(p["wproj"].T), _t(p["bproj"]),
            _t(GF), _t(GB), HD ** -0.5, HEADS, lam]
    diff = [0, 1, 2, 3, 4, 7, 8] + ([5] if use_bias else [])
    for i in diff:
        args[i] = args[i].requires_grad_()
    out = fn(*args)
    g = torch.autograd.grad(out, [args[i] for i in diff],
                            _t(dout).to(dtype))
    got = dict(zip(["x", "lng", "lnb", "wqkv", "bqkv", "wproj", "bproj",
                    "bias"], g))
    got["wqkv"], got["wproj"] = got["wqkv"].t(), got["wproj"].t()
    return {k: v.float().numpy() for k, v in got.items()}


def _close(got, want, dtype):
    assert set(got) == set(want)
    for k in want:
        if dtype == "float32":
            np.testing.assert_allclose(got[k], want[k], rtol=TOL[dtype],
                                       atol=TOL[dtype], err_msg=k)
        else:
            err = np.abs(got[k] - want[k]).max()
            assert err <= TOL[dtype] * np.abs(want[k]).max(), (k, err)


ATTN_CASES = {  # name -> (ids kind, lam, dtype, use ids, use bias)
    "shifted_lam1": ("shifted", 1.0, "float32", True, True),
    "shifted_lam0": ("shifted", 0.0, "float32", True, True),
    "padded_ids": ("padded", 1.0, "float32", True, True),
    "no_ids": ("shifted", 1.0, "float32", False, True),
    "no_bias": ("shifted", 0.0, "float32", True, False),
    "bf16_shifted": ("shifted", 1.0, "bfloat16", True, True),
    "bf16_padded_lam0": ("padded", 0.0, "bfloat16", True, True),
}


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_attn_half_grads_match_jax(case):
    kind, lam, dtype, use_ids, use_bias = ATTN_CASES[case]
    p, ids, dout = _attn_case(kind, seed=len(case))
    if kind == "padded":
        assert (ids == -1).any()
    want = _attn_jax(p, ids, dout, lam, getattr(jnp, dtype), use_ids,
                     use_bias)
    got = _attn_port(port.attn_half, p, ids, dout, lam,
                     getattr(torch, dtype), use_ids, use_bias)
    _close(got, want, dtype)


@pytest.mark.parametrize("logit", [45.0, 200.0])
def test_attn_half_grads_at_saturated_logits(logit):
    p, ids, dout = _attn_case("shifted", seed=7, logit=logit)
    want = _attn_jax(p, ids, dout, 1.0, jnp.float32)
    got = _attn_port(port.attn_half, p, ids, dout, 1.0, torch.float32)
    assert all(np.isfinite(v).all() for v in got.values())
    _close(got, want, "float32")


@pytest.mark.parametrize("kind,lam", [("shifted", 1.0), ("padded", 0.0)])
def test_attn_half_plain_backward_equals_autograd(kind, lam):
    p, ids, dout = _attn_case(kind, seed=3)
    got = _attn_port(port.attn_half, p, ids, dout, lam, torch.float32)
    want = _attn_port(port.attn_half_math, p, ids, dout, lam, torch.float32)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5,
                                   err_msg=k)


def _mlp_case(seed):
    rows, hid = 48, 4 * C   # per sample, B = 2
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    p = dict(x=f(2 * rows, C), lng=1.0 + 0.1 * f(C), lnb=0.1 * f(C),
             w1=0.3 * f(C, hid), b1=0.1 * f(hid), w2=0.3 * f(hid, C),
             b2=0.1 * f(C))
    return p, f(2 * rows, C)


KEYS = ["x", "lng", "lnb", "w1", "b1", "w2", "b2"]


def _mlp_port(fn, p, dout, lam, dtype):
    args = [_t(p["x"]).to(dtype), _t(p["lng"]), _t(p["lnb"]), _t(p["w1"].T),
            _t(p["b1"]), _t(p["w2"].T), _t(p["b2"])]
    args = [a.requires_grad_() for a in args]
    out = fn(*args, _t(GF), _t(GB), lam)
    g = dict(zip(KEYS, torch.autograd.grad(out, args, _t(dout).to(dtype))))
    g["w1"], g["w2"] = g["w1"].t(), g["w2"].t()
    return {k: v.float().numpy() for k, v in g.items()}


@pytest.mark.parametrize("lam,dtype", [(1.0, "float32"), (0.0, "float32"),
                                       (1.0, "bfloat16")])
def test_ln_mlp_grads_match_jax(lam, dtype):
    p, dout = _mlp_case(seed=11)
    jdt = getattr(jnp, dtype)

    def fn(*leaves):
        a = dict(zip(KEYS, leaves))
        return fused_ln_mlp(a["x"], a["lng"], a["lnb"], a["w1"], a["b1"],
                            a["w2"], a["b2"], jnp.asarray(GF), jnp.asarray(GB),
                            24, lam)

    leaves = [jnp.asarray(p[k]).astype(jdt) if k == "x" else jnp.asarray(p[k])
              for k in KEYS]
    out, vjp = jax.vjp(fn, *leaves)
    want = {k: np.asarray(v.astype(jnp.float32))
            for k, v in zip(KEYS, vjp(jnp.asarray(dout).astype(jdt)))}
    got = _mlp_port(port.ln_mlp, p, dout, lam, getattr(torch, dtype))
    _close(got, want, dtype)


def test_ln_mlp_plain_backward_equals_autograd():
    p, dout = _mlp_case(seed=5)
    got = _mlp_port(port.ln_mlp, p, dout, 0.5, torch.float32)
    want = _mlp_port(port.ln_mlp_math, p, dout, 0.5, torch.float32)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5,
                                   err_msg=k)


def test_gains_and_ids_get_no_gradient():
    p, ids, dout = _attn_case("shifted", seed=2)
    gf, gb = _t(GF).requires_grad_(), _t(GB).requires_grad_()
    x = _t(p["x"]).requires_grad_()
    out = port.attn_half(x, _t(p["lng"]), _t(p["lnb"]), _t(p["wqkv"].T),
                         _t(p["bqkv"]), _t(p["bias"]), _t(ids),
                         _t(p["wproj"].T), _t(p["bproj"]), gf, gb,
                         HD ** -0.5, HEADS)
    gx, dgf, dgb = torch.autograd.grad(out, [x, gf, gb], _t(dout),
                                       allow_unused=True)
    assert dgf is None and dgb is None and gx is not None
