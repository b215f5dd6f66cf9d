"""The plain versions of K1's key-tiled attention launches alone
(``attention_tiled_reference``: qkv -> ao, the row statistics and f32 o;
``attention_tiled_backward_reference``: qkv, dao, o, statistics -> dqkv,
dbias, dbqkv), composed into the attention half-block, against the JAX
``fused_attn_half`` Pallas kernel in interpret mode, forward and VJP.

The CUDA launches (``csrc/attn_tiled.cuh``) are held to these plain
versions on the card (chip_smoke.py phase 3). Here the block around them is
K1's own plain arithmetic: y = LN(x), qkv = round(y Wqkv^T), the launch,
out = lam x + gf (ao Wproj^T + bproj); backward dao = round(gb dout) Wproj,
the launch's backward, dWqkv = dqkv^T y, dy = dqkv Wqkv, LN's backward,
dWproj = do^T ao. The backward takes s1 = dO . o on the forward's f32 o
(the FlashAttention identity), where the JAX kernel sums rowsum(p dp).

ViT's geometry: head dim 64, no qkv bias, no region mask, 2 windows of N
tokens (N = 13, 37, and 150, which leaves a ragged key tile of 22 past two
of 64), 2 heads. Tolerances: f32 2e-5 (the JAX kernel tests' own), bf16
1e-2 of each output's scale (a few f32 ulps flip a bf16 rounding).
Saturated logits: an additive bias 8 z + logit (45, 200, -200); at -200
every exp underflows under the max(rowmax, 0) shift and the attention
output is 0. A fully masked row: one query row's bias -1e9 on every key,
whose attention output and gradients are 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vsn_tpu.ops.swin_block_kernels import fused_attn_half
from vsn_tpu_torch.ops import swin_block_kernels as port

HEADS, HD = 2, 64
C = HEADS * HD
SCALE = HD ** -0.5
GF = np.asarray([0.6, 1.4], np.float32)
GB = np.asarray([1.25, 0.35], np.float32)
NAMES = ("x", "lng", "lnb", "wqkv", "wproj", "bproj", "bias")


def _inputs(n, seed, logit=None, masked_row=None):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    p = dict(x=f(2, n, C), lng=1.0 + 0.1 * f(C), lnb=0.1 * f(C),
             wqkv=C ** -0.5 * f(C, 3 * C), wproj=C ** -0.5 * f(C, C),
             bproj=0.1 * f(C), bias=None)
    if logit is not None:
        p["bias"] = 8.0 * f(HEADS, n, n) + logit
    if masked_row is not None:
        p["bias"] = f(HEADS, n, n)
        p["bias"][:, masked_row, :] = -1e9
    return p


def _jax(p, dtype, lam):
    args = [jnp.asarray(p["x"], dtype)] + [
        jnp.asarray(p[k]) for k in NAMES[1:6]]
    with_bias = p["bias"] is not None
    if with_bias:
        args.append(jnp.asarray(p["bias"]))

    def fn(x, lng, lnb, wqkv, wproj, bproj, bias=None):
        return fused_attn_half(x, lng, lnb, wqkv, jnp.zeros(3 * C), bias,
                               None, wproj, bproj, jnp.asarray(GF),
                               jnp.asarray(GB), SCALE, HEADS, lam)

    out, vjp = jax.vjp(fn, *args)
    ct = np.random.default_rng(99).standard_normal(out.shape)
    grads = vjp(jnp.asarray(ct, out.dtype))
    return np.asarray(out.astype(jnp.float32)), ct, {
        k: np.asarray(g.astype(jnp.float32)) for k, g in zip(NAMES, grads)}


def _port(p, dtype, lam, ct):
    """The block around the launch-level plain versions, forward and its
    backward for the cotangent ``ct``; returns (out, grads, row stats)."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    x = t(p["x"]).to(dtype)
    lng, lnb, bproj = t(p["lng"]), t(p["lnb"]), t(p["bproj"])
    wqkv, wproj = t(p["wqkv"].T), t(p["wproj"].T)    # torch [out, in]
    bias = None if p["bias"] is None else t(p["bias"])
    cdt = port._compute_dtype(x)
    b, n, c = x.shape
    gf, gb = t(GF), t(GB)
    y, xhat, rstd, qkv = port._qkv_parts(x, lng, lnb, wqkv, None)
    qkv = qkv.reshape(b, n, 3 * c).to(dtype)
    ao, stats, o = port.attention_tiled_reference(qkv, bias, None, SCALE,
                                                  HEADS)
    branch = port._mm(ao.reshape(b * n, c), wproj, cdt) + bproj
    out = port._residual(x, branch.reshape(b, n, c), gf, gb, lam)

    do_res = t(ct).to(dtype).float().reshape(b * n, c)
    do = port._row_gains(gb, b * n) * do_res
    dao = (port._r(do, cdt) @ port._r(wproj, cdt)).to(dtype).reshape(b, n, c)
    dqkv, dbias, _ = port.attention_tiled_backward_reference(
        qkv, dao, o, stats, bias, None, SCALE, HEADS)
    dqkv = port._r(dqkv.reshape(b * n, 3 * c), cdt)
    dy = dqkv @ port._r(wqkv, cdt)
    dxn, dlng, dlnb = port._ln_backward(dy, lng, xhat, rstd)
    grads = {
        "x": (lam * do_res + dxn).to(dtype).float().reshape(b, n, c),
        "lng": dlng, "lnb": dlnb,
        "wqkv": (dqkv.t() @ port._r(y, cdt)).t(),          # JAX [in, out]
        "wproj": (port._r(do, cdt).t() @ port._r(ao.reshape(b * n, c),
                                                  cdt)).t(),
        "bproj": do.sum(0)}
    if dbias is not None:
        grads["bias"] = dbias
    return (out.float().numpy(), {k: v.numpy() for k, v in grads.items()},
            stats)


def _close(got, want, tol, what):
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert np.isfinite(got).all(), what
    assert err <= tol * scale, f"{what}: max|d| {err} > {tol} x {scale}"


def _check(p, dtype, lams=(0.0, 1.0)):
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tol = 2e-5 if dtype == "float32" else 1e-2
    for lam in lams:
        want, ct, wgrads = _jax(p, jdt, lam)
        got, grads, stats = _port(p, getattr(torch, dtype), lam, ct)
        _close(got, want, tol, f"out lam={lam}")
        assert set(grads) == set(wgrads)
        for k, g in grads.items():
            _close(g, wgrads[k], tol, f"d{k} lam={lam}")
    return stats


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [13, 37, 150])
def test_launch_level_plain_versions_match_jax(n, dtype):
    stats = _check(_inputs(n, seed=n), dtype)
    assert stats.shape == (2, HEADS, n, 2)
    m, rinv = stats[..., 0], stats[..., 1]
    assert bool((m >= 0).all()) and bool((rinv > 0).all())


@pytest.mark.parametrize("logit", [45.0, 200.0, -200.0])
def test_saturated_logits_match_jax(logit):
    stats = _check(_inputs(37, seed=7, logit=logit), "float32", lams=(1.0,))
    if logit > 0:
        # the shift is the row max, exp(0) = 1 at the top: 1 / sum <= 1
        assert float(stats[..., 0].min()) > logit - 50
        assert float(stats[..., 1].max()) <= 1.0
    else:
        # the clamp at 0: every exp underflows, the sum is 0, 1 / 1e-30
        assert float(stats[..., 0].abs().max()) == 0.0
        assert float(stats[..., 1].min()) == pytest.approx(1e30)


def test_a_fully_masked_row_gives_zero():
    p = _inputs(37, seed=11, masked_row=5)
    stats = _check(p, "float32", lams=(1.0,))
    assert float(stats[:, :, 5, 1].min()) == pytest.approx(1e30)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    x = t(p["x"])
    qkv = port._qkv_parts(x, t(p["lng"]), t(p["lnb"]), t(p["wqkv"].T),
                          None)[3].reshape(2, 37, 3 * C)
    ao, stats, o = port.attention_tiled_reference(qkv, t(p["bias"]), None,
                                                  SCALE, HEADS)
    assert float(ao[:, 5].abs().max()) == 0.0
    dao = torch.randn(2, 37, C, generator=torch.Generator().manual_seed(1))
    dqkv, dbias, _ = port.attention_tiled_backward_reference(
        qkv, dao, o, stats, t(p["bias"]), None, SCALE, HEADS)
    assert float(dqkv[:, 5, :C].abs().max()) == 0.0      # dq of the row
    assert float(dbias[:, 5].abs().max()) == 0.0


def test_plain_launches_compose_to_k1s_plain_version():
    """The launch-level plain versions in the block equal K1's plain
    forward and backward (``attn_half_reference``) at a ragged N."""
    p = _inputs(70, seed=3)
    ct = np.random.default_rng(5).standard_normal((2, 70, C))
    got, grads, _ = _port(p, torch.float32, 1.0, ct)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    x = t(p["x"]).requires_grad_()
    params = {k: t(p[k]).requires_grad_() for k in ("lng", "lnb", "wqkv",
                                                    "wproj", "bproj")}
    out = port.attn_half_reference(
        x, params["lng"], params["lnb"], params["wqkv"].t(), None, None,
        None, params["wproj"].t(), params["bproj"], t(GF), t(GB), SCALE,
        HEADS, 1.0)
    out.backward(t(ct).float())
    np.testing.assert_allclose(got, out.detach().numpy(), atol=2e-6)
    np.testing.assert_allclose(grads["x"], x.grad.numpy(), atol=2e-5)
    for k, v in params.items():
        np.testing.assert_allclose(grads[k], v.grad.numpy(), atol=2e-5,
                                   err_msg=k)
