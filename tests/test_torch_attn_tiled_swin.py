"""The plain versions of K1's key-tiled attention launches alone at Swin's
geometry, composed into the attention half-block, against the JAX
``fused_attn_half`` Pallas kernel in interpret mode, forward and VJP.

Every preset's K1 calls take the key-tiled body on the card, Swin-T's
included (head dim 32, a relative-position bias, region ids, a qkv bias).
``tests/test_torch_attn_tiled_stats.py`` holds the launches' plain
versions (``attention_tiled_reference`` and its backward) to JAX at ViT's
geometry; here the same composition runs with what Swin adds: y = LN(x),
qkv = round(y Wqkv^T + bqkv), the launch with the bias [H, N, N] and the
ids rows (window bw takes row bw % W; ids that differ are masked with
-1e9), out = lam x + gf (ao Wproj^T + bproj); backward dao = round(gb
dout) Wproj, the launch's backward (dqkv, dbias summed over every window,
dbqkv the column sums of the unrounded dq, dk, dv), dWqkv = dqkv^T y, dy
= dqkv Wqkv, LN's backward, dWproj = do^T ao.

Geometry: d = 32, 3 heads, 8 windows (2 samples of 4) of N = 37 (one
ragged key tile) and 70 (a full tile and a ragged one); the ids shifted
(4 rows, one a window), padded (the last tokens of some windows -1: pad
tokens attend only to pad tokens) and absent; an O(1) bias and a nonzero
qkv bias. Tolerances, of each output's scale: f32 2e-5 (the JAX kernel
tests' own: the same f32 arithmetic summed in another order), bf16 1e-2
(a few f32 ulps flip a bf16 rounding of q, k, v, p or ds). Saturated
logits, f32 on a shifted call: bias 8 z + 45, + 200 (the shift, the row
max, keeps exp exact) and - 200 (every exp underflows under the
max(rowmax, 0) shift: the attention output and every gradient through it
are 0).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vsn_tpu.ops.swin_block_kernels import fused_attn_half
from vsn_tpu_torch.ops import swin_block_kernels as port

HEADS, HD, WINDOWS = 3, 32, 4
C = HEADS * HD
SCALE = HD ** -0.5
GF = np.asarray([0.6, 1.4], np.float32)
GB = np.asarray([1.25, 0.35], np.float32)
NAMES = ("x", "lng", "lnb", "wqkv", "bqkv", "wproj", "bproj", "bias")


def _ids(kind, n, rng):
    """[W, N] int32 region ids of the 4 windows of a sample, or None."""
    if kind is None:
        return None
    ids = rng.integers(0, 3, (WINDOWS, n)).astype(np.int32)
    if kind == "padded":   # the last tokens of windows 1 and 3 are padding
        ids[1, n - 5:] = -1
        ids[3, n - 11:] = -1
    return ids


def _inputs(n, ids_kind, seed, logit=None):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    p = dict(x=f(2 * WINDOWS, n, C), lng=1.0 + 0.1 * f(C), lnb=0.1 * f(C),
             wqkv=C ** -0.5 * f(C, 3 * C), bqkv=0.1 * f(3 * C),
             wproj=C ** -0.5 * f(C, C), bproj=0.1 * f(C),
             bias=f(HEADS, n, n))
    if logit is not None:
        p["bias"] = 8.0 * p["bias"] + logit
    p["ids"] = _ids(ids_kind, n, rng)
    return p


def _jax(p, dtype, lam):
    args = [jnp.asarray(p["x"], dtype)] + [jnp.asarray(p[k])
                                           for k in NAMES[1:]]
    ids = None if p["ids"] is None else jnp.asarray(p["ids"])

    def fn(x, lng, lnb, wqkv, bqkv, wproj, bproj, bias):
        return fused_attn_half(x, lng, lnb, wqkv, bqkv, bias, ids, wproj,
                               bproj, jnp.asarray(GF), jnp.asarray(GB),
                               SCALE, HEADS, lam)

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
    lng, lnb, bqkv, bproj = t(p["lng"]), t(p["lnb"]), t(p["bqkv"]), t(
        p["bproj"])
    wqkv, wproj = t(p["wqkv"].T), t(p["wproj"].T)    # torch [out, in]
    bias = t(p["bias"])
    ids = None if p["ids"] is None else t(p["ids"])
    cdt = port._compute_dtype(x)
    bw, n, c = x.shape
    gf, gb = t(GF), t(GB)
    y, xhat, rstd, qkv = port._qkv_parts(x, lng, lnb, wqkv, bqkv)
    qkv = qkv.reshape(bw, n, 3 * c).to(dtype)
    ao, stats, o = port.attention_tiled_reference(qkv, bias, ids, SCALE,
                                                  HEADS)
    branch = port._mm(ao.reshape(bw * n, c), wproj, cdt) + bproj
    out = port._residual(x, branch.reshape(bw, n, c), gf, gb, lam)

    do_res = t(ct).to(dtype).float().reshape(bw * n, c)
    do = port._row_gains(gb, bw * n) * do_res
    dao = (port._r(do, cdt) @ port._r(wproj, cdt)).to(dtype).reshape(bw, n,
                                                                      c)
    dqkv, dbias, dbqkv = port.attention_tiled_backward_reference(
        qkv, dao, o, stats, bias, ids, SCALE, HEADS)
    dqkv = port._r(dqkv.reshape(bw * n, 3 * c), cdt)
    dy = dqkv @ port._r(wqkv, cdt)
    dxn, dlng, dlnb = port._ln_backward(dy, lng, xhat, rstd)
    grads = {
        "x": (lam * do_res + dxn).to(dtype).float().reshape(bw, n, c),
        "lng": dlng, "lnb": dlnb,
        "wqkv": (dqkv.t() @ port._r(y, cdt)).t(),          # JAX [in, out]
        "bqkv": dbqkv, "bias": dbias,
        "wproj": (port._r(do, cdt).t() @ port._r(ao.reshape(bw * n, c),
                                                  cdt)).t(),
        "bproj": do.sum(0)}
    return (out.float().numpy(), {k: v.numpy() for k, v in grads.items()},
            stats)


def _close(got, want, tol, what):
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert np.isfinite(got).all(), what
    assert err <= tol * scale, f"{what}: max|d| {err} > {tol} x {scale}"


def _check(p, dtype, lam=1.0):
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tol = 2e-5 if dtype == "float32" else 1e-2
    want, ct, wgrads = _jax(p, jdt, lam)
    got, grads, stats = _port(p, getattr(torch, dtype), lam, ct)
    _close(got, want, tol, f"out lam={lam}")
    assert set(grads) == set(wgrads) == set(NAMES)
    for k, g in grads.items():
        _close(g, wgrads[k], tol, f"d{k} lam={lam}")
    return stats


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ids_kind", ["shifted", "padded", None])
@pytest.mark.parametrize("n", [37, 70])
def test_launch_level_plain_versions_match_jax_at_swins_geometry(
        n, ids_kind, dtype):
    p = _inputs(n, ids_kind, seed=n + 3 * len(str(ids_kind)))
    stats = _check(p, dtype, lam=0.0 if n == 37 else 1.0)
    assert stats.shape == (2 * WINDOWS, HEADS, n, 2)
    assert bool((stats[..., 0] >= 0).all()) and bool(
        (stats[..., 1] > 0).all())


@pytest.mark.parametrize("logit", [45.0, 200.0, -200.0])
def test_saturated_logits_on_a_shifted_call_match_jax(logit):
    p = _inputs(37, "shifted", seed=7, logit=logit)
    stats = _check(p, "float32")
    if logit > 0:
        # the shift is the row max: 1 / sum <= 1 at every row
        assert float(stats[..., 0].min()) > logit - 80
        assert float(stats[..., 1].max()) <= 1.0
    else:
        # the clamp at 0: every exp underflows, the sum is 0, 1 / 1e-30
        assert float(stats[..., 0].abs().max()) == 0.0
        assert float(stats[..., 1].min()) == pytest.approx(1e30)


def test_pad_tokens_attend_only_to_pad_tokens():
    """At the padded ids, a pad token's attention output is the mean of
    the pad tokens' v rows weighted by their bias alone: no real token
    enters it (its logits there are - 1e9 below)."""
    p = _inputs(37, "padded", seed=5)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    qkv = torch.randn(2 * WINDOWS, 37, 3 * C,
                      generator=torch.Generator().manual_seed(2))
    bias, ids = t(p["bias"]), t(p["ids"])
    ao, _, _ = port.attention_tiled_reference(qkv, bias, ids, SCALE, HEADS)
    moved = qkv.clone()
    moved[1, :32, 2 * C:] += 100.0    # the real tokens' v rows of window 1
    ao2, _, _ = port.attention_tiled_reference(moved, bias, ids, SCALE,
                                               HEADS)
    assert torch.equal(ao[1, 32:], ao2[1, 32:])     # its pad tokens
    assert not torch.equal(ao[1, :32], ao2[1, :32])
