"""K1 ``attn_half`` and K2 ``ln_mlp`` in their residual modes (in-band
LayerScale ``gamma``, ``post_norm``, and both) against the JAX
``fused_attn_half`` / ``fused_ln_mlp`` Pallas kernels in interpret mode,
forward and VJP with dgamma.

On CPU tensors the port's wrappers run their plain versions (the plain
forward and the explicit plain backward that mirrors _attn_bwd_kernel /
_mlp_bwd_kernel), which the CUDA kernels are held to on the card. A
Swin-like K1 call (relative-position bias, shifted region ids, qkv bias,
head dim 8) and a ViT-like one (no bias, no ids, no qkv bias, head dim 64),
and K2 at C = 16; B = 2 samples with gf != gb, lam = 0.9129 (DeepScaleLM's
lambda at depth 12) and gamma = 0.5 + 0.1 z. Inputs from numpy seeds, f32;
tolerance 2e-5 of each output's scale (at least 1), as the JAX kernel tests
use. The explicit plain backward is also held to autograd of the plain
forward, an independent check of the dgamma formulas.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vsn_tpu.models.swin3d import shifted_window_region_ids
from vsn_tpu.ops.swin_block_kernels import fused_attn_half, fused_ln_mlp
from vsn_tpu_torch.ops import swin_block_kernels as port

TOL = 2e-5
LAM = 0.9129
GF = np.asarray([0.6, 1.4], np.float32)
GB = np.asarray([1.25, 0.35], np.float32)
MODES = {"ls": (True, False), "post": (False, True),
         "post_ls": (True, True)}
# (heads, head dim, N, windows per sample, Swin-like: bias, ids, qkv bias)
ATTN = {"swin": (2, 8, 8, 4, True), "vit": (2, 64, 13, 1, False)}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, what):
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert np.isfinite(got).all(), what
    assert err <= TOL * scale, f"{what}: max|d| {err} > {TOL} x {scale}"


def _attn_inputs(kind, seed):
    heads, hd, n, nw, swin = ATTN[kind]
    c = heads * hd
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    p = dict(x=f(2 * nw, n, c), lng=1.0 + 0.1 * f(c), lnb=0.1 * f(c),
             wqkv=c ** -0.5 * f(c, 3 * c),
             bqkv=0.1 * f(3 * c) if swin else np.zeros(3 * c, np.float32),
             wproj=c ** -0.5 * f(c, c), bproj=0.1 * f(c),
             gamma=0.5 + 0.1 * f(c), ct=f(2 * nw, n, c))
    bias = f(heads, n, n) if swin else None
    ids = (shifted_window_region_ids((4, 4, 4), (2, 2, 2), (1, 1, 1))[:nw]
           if swin else None)
    return p, bias, ids, heads, hd ** -0.5


ATTN_LEAVES = ("x", "lng", "lnb", "wqkv", "bqkv", "wproj", "bproj", "gamma")


def _jax_attn(p, bias, ids, heads, scale, ls, post):
    jb = None if bias is None else jnp.asarray(bias)
    jids = None if ids is None else jnp.asarray(ids)

    def fn(x, lng, lnb, wqkv, bqkv, wproj, bproj, gamma):
        return fused_attn_half(x, lng, lnb, wqkv, bqkv, jb, jids, wproj,
                               bproj, jnp.asarray(GF), jnp.asarray(GB), scale,
                               heads, LAM, gamma if ls else None, post)

    out, vjp = jax.vjp(fn, *(jnp.asarray(p[k]) for k in ATTN_LEAVES))
    grads = vjp(jnp.asarray(p["ct"]))
    return np.asarray(out), {k: np.asarray(g)
                             for k, g in zip(ATTN_LEAVES, grads)}


def _port_attn(fn, p, bias, ids, heads, scale, ls, post):
    leaves = {k: _t(p[k]).requires_grad_() for k in ATTN_LEAVES}
    bqkv = leaves["bqkv"] if bias is not None else None
    out = fn(leaves["x"], leaves["lng"], leaves["lnb"], leaves["wqkv"].t(),
             bqkv, None if bias is None else _t(bias),
             None if ids is None else _t(ids), leaves["wproj"].t(),
             leaves["bproj"], _t(GF), _t(GB), scale, heads, LAM,
             gamma=leaves["gamma"] if ls else None, post_norm=post)
    out.backward(_t(p["ct"]))
    return out.detach().numpy(), {
        k: v.grad.numpy() for k, v in leaves.items() if v.grad is not None}


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("kind", sorted(ATTN))
def test_attn_half_modes_match_jax(kind, mode):
    ls, post = MODES[mode]
    p, bias, ids, heads, scale = _attn_inputs(kind, seed=len(kind + mode))
    want, wgrads = _jax_attn(p, bias, ids, heads, scale, ls, post)
    got, grads = _port_attn(port.attn_half, p, bias, ids, heads, scale, ls,
                            post)
    _close(got, want, f"{kind} {mode} out")
    assert ("gamma" in grads) == ls
    for k, g in grads.items():
        _close(g, wgrads[k], f"{kind} {mode} d{k}")


@pytest.mark.parametrize("mode", sorted(MODES))
def test_attn_half_explicit_backward_matches_autograd(mode):
    ls, post = MODES[mode]
    p, bias, ids, heads, scale = _attn_inputs("swin", seed=7)
    _, grads = _port_attn(port.attn_half, p, bias, ids, heads, scale, ls,
                          post)
    _, auto = _port_attn(port.attn_half_math, p, bias, ids, heads, scale, ls,
                         post)
    assert grads.keys() == auto.keys()
    for k, g in grads.items():
        _close(g, auto[k], f"{mode} d{k}")


MLP_LEAVES = ("x", "lng", "lnb", "w1", "b1", "w2", "b2", "gamma")


def _mlp_inputs(seed, rows=24, c=16, hid=64):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return dict(x=f(rows, c), lng=1.0 + 0.1 * f(c), lnb=0.1 * f(c),
                w1=c ** -0.5 * f(c, hid), b1=0.1 * f(hid),
                w2=hid ** -0.5 * f(hid, c), b2=0.1 * f(c),
                gamma=0.5 + 0.1 * f(c), ct=f(rows, c))


def _port_mlp(fn, p, ls, post):
    leaves = {k: _t(p[k]).requires_grad_() for k in MLP_LEAVES}
    out = fn(leaves["x"], leaves["lng"], leaves["lnb"], leaves["w1"].t(),
             leaves["b1"], leaves["w2"].t(), leaves["b2"], _t(GF), _t(GB),
             LAM, gamma=leaves["gamma"] if ls else None, post_norm=post)
    out.backward(_t(p["ct"]))
    return out.detach().numpy(), {
        k: v.grad.numpy() for k, v in leaves.items() if v.grad is not None}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_ln_mlp_modes_match_jax(mode):
    ls, post = MODES[mode]
    p = _mlp_inputs(seed=len(mode))

    def fn(x, lng, lnb, w1, b1, w2, b2, gamma):
        return fused_ln_mlp(x, lng, lnb, w1, b1, w2, b2, jnp.asarray(GF),
                            jnp.asarray(GB), 12, LAM,
                            gamma if ls else None, post)

    want, vjp = jax.vjp(fn, *(jnp.asarray(p[k]) for k in MLP_LEAVES))
    wgrads = dict(zip(MLP_LEAVES, vjp(jnp.asarray(p["ct"]))))
    got, grads = _port_mlp(port.ln_mlp, p, ls, post)
    _close(got, np.asarray(want), f"{mode} out")
    assert ("gamma" in grads) == ls
    for k, g in grads.items():
        _close(g, np.asarray(wgrads[k]), f"{mode} d{k}")
    _, auto = _port_mlp(port.ln_mlp_math, p, ls, post)
    for k, g in grads.items():
        _close(g, auto[k], f"{mode} d{k} (autograd)")


def test_launch_keys_name_the_mode():
    g = torch.ones(4)
    assert port.mode_key("attn_half_tiled", None, False) == "attn_half_tiled"
    assert port.mode_key("attn_half_bwd", g, False) == "attn_half_bwd_ls"
    assert port.mode_key("ln_mlp", None, True) == "ln_mlp_post"
    assert port.mode_key("attn_half_tiled", g, True) == \
        "attn_half_tiled_post_ls"
