"""K1 ``attn_half`` at ViT's geometry (head dim 64, one window of N tokens
per sample, no relative-position bias, no region mask, no qkv bias) against
the JAX ``fused_attn_half`` Pallas kernel in interpret mode, forward and VJP.

On CPU tensors the port's wrapper runs its plain versions, which the CUDA
kernels (the key-tiled body at d = 64) are held to on the card. N = 13 and
37 (B = 2 windows, 2 heads of 64, C = 128), inputs from numpy seeds. The
JAX side passes a zero qkv bias, as ViT's fused path does (_DenseParams
without a bias); the port passes None.

Tolerances: f32 2e-5, as the JAX kernel tests use (same softmax form, sums
in another order). bf16 activations (x, q, k, v, p and ao rounded to bf16
on both sides at the same points): 1e-2 of the output's scale, where an
f32 difference of a few ulps flips a bf16 rounding. The saturated cases
put the logits near 45 through a qkv bias that aligns q and k, and near
45, 200 and -200 through an additive bias 8 z + logit (DEVIATIONS #3: the
max(rowmax, 0) shift keeps them exact). At -200 the shift's clamp at 0
makes every exp underflow: the attention output is 0 there, not the
softmax.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vsn_tpu.ops.swin_block_kernels import fused_attn_half
from vsn_tpu_torch.ops import swin_block_kernels as port

HEADS, HD = 2, 64
C = HEADS * HD
SCALE = HD ** -0.5
GF = np.asarray([0.6, 1.4], np.float32)
GB = np.asarray([1.25, 0.35], np.float32)


def _inputs(n, seed, logit=None, via="qk"):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    p = dict(x=f(2, n, C), lng=1.0 + 0.1 * f(C), lnb=0.1 * f(C),
             wqkv=C ** -0.5 * f(C, 3 * C), bqkv=np.zeros(3 * C, np.float32),
             wproj=C ** -0.5 * f(C, C), bproj=0.1 * f(C), bias=None)
    if logit is not None and via == "qk":
        # q and k share one large channel per head: q . k * scale ~ logit,
        # spread by the projections' O(sqrt(|logit|)) cross terms
        a = np.sqrt(abs(logit) / SCALE)
        for h in range(HEADS):
            p["bqkv"][h * HD] = a
            p["bqkv"][C + h * HD] = a if logit > 0 else -a
    elif logit is not None:
        # an additive bias 8 z + logit, as tests/test_swin_block_kernels.py
        # saturates K1 (logits exact in f32: no large dot products)
        p["bias"] = 8.0 * f(HEADS, n, n) + logit
    return p


def _jax(p, dtype, lam):
    args = [jnp.asarray(p["x"], dtype)] + [
        jnp.asarray(p[k]) for k in ("lng", "lnb", "wqkv", "bqkv")]
    tail = [jnp.asarray(p["wproj"]), jnp.asarray(p["bproj"])]
    bias = None if p["bias"] is None else jnp.asarray(p["bias"])

    def fn(x, lng, lnb, wqkv, bqkv, wproj, bproj):
        return fused_attn_half(x, lng, lnb, wqkv, bqkv, bias, None, wproj,
                               bproj, jnp.asarray(GF), jnp.asarray(GB), SCALE,
                               HEADS, lam)

    out, vjp = jax.vjp(fn, *args, *tail)
    ct = np.random.default_rng(99).standard_normal(out.shape)
    grads = vjp(jnp.asarray(ct, out.dtype))
    names = ("x", "lng", "lnb", "wqkv", "bqkv", "wproj", "bproj")
    return np.asarray(out.astype(jnp.float32)), ct, {
        k: np.asarray(g.astype(jnp.float32)) for k, g in zip(names, grads)}


def _port(p, dtype, lam, ct):
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    x = t(p["x"]).to(dtype).requires_grad_()
    params = {k: t(p[k]).requires_grad_() for k in ("lng", "lnb", "wqkv",
                                                    "wproj", "bproj")}
    wqkv_t = params["wqkv"].t()
    wproj_t = params["wproj"].t()
    bqkv = t(p["bqkv"]) if p["bqkv"].any() else None
    bias = None if p["bias"] is None else t(p["bias"])
    out = port.attn_half(x, params["lng"], params["lnb"], wqkv_t, bqkv, bias,
                         None, wproj_t, params["bproj"], t(GF), t(GB), SCALE,
                         HEADS, lam)
    out.backward(t(ct).to(dtype))
    grads = {"x": x.grad.float().numpy(),
             **{k: v.grad.numpy() for k, v in params.items()}}
    return out.detach().float().numpy(), grads


def _close(got, want, tol, what):
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert np.isfinite(got).all(), what
    assert err <= tol * scale, f"{what}: max|d| {err} > {tol} x {scale}"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [13, 37])
def test_forward_and_vjp_match_jax(n, dtype):
    p = _inputs(n, seed=n)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tol = 2e-5 if dtype == "float32" else 1e-2
    for lam in (0.0, 1.0):
        want, ct, wgrads = _jax(p, jdt, lam)
        got, grads = _port(p, getattr(torch, dtype), lam, ct)
        _close(got, want, tol, f"out lam={lam}")
        for k, g in grads.items():
            _close(g, wgrads[k], tol, f"d{k} lam={lam}")


@pytest.mark.parametrize("via, logit", [("qk", 45.0), ("bias", 45.0),
                                        ("bias", 200.0), ("bias", -200.0)])
def test_saturated_logits_match_jax(via, logit):
    p = _inputs(37, seed=7, logit=logit, via=via)
    want, ct, wgrads = _jax(p, jnp.float32, 1.0)
    got, grads = _port(p, torch.float32, 1.0, ct)
    _close(got, want, 2e-5, "out")
    for k, g in grads.items():
        _close(g, wgrads[k], 2e-5, f"d{k}")
    # the logits sit where the case says
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    bias = None if p["bias"] is None else t(p["bias"])
    parts = port._attention_parts(t(p["x"]), t(p["lng"]), t(p["lnb"]),
                                  t(p["wqkv"].T), t(p["bqkv"]), bias, None,
                                  SCALE, HEADS)
    q, k = parts[3], parts[4]
    s = port._scores(q, k, bias, None, SCALE)
    mid = float(s.median())
    assert abs(mid - logit) < 0.5 * abs(logit), mid
    if logit < 0:
        # every exp underflows under the clamped shift: no attention output
        assert float(parts[-1].abs().max()) == 0.0


def test_head_dims_up_to_128_and_the_tiled_choice():
    """The plain version takes any head dim, the wrapper's check up to 8192;
    every head dim from 1 to 128 at every N takes the key-tiled body, the
    one attention body of K1 (Swin-T's calls at d = 32, N = 252 and 150,
    ViT's at d = 64, and every other), and 129 its slab kernels: K1's
    checks and its tiled launches' accept it with a bias and region ids
    (the body's head-dim rule, ``takes_head_dim``), and refuse 8193."""
    meta = lambda *s, dt=torch.float32: torch.empty(s, dtype=dt,
                                                    device="meta")
    heads = 2
    for n in (13, 37, 150, 252, 450, 811, 1000):
        ids = meta(1, n, dt=torch.int32)
        for d in (*range(1, 130), 8193):
            c = heads * d
            args = (meta(c), meta(c), meta(3 * c, c), meta(3 * c),
                    meta(heads, n, n), ids, meta(c, c), meta(c), meta(1),
                    meta(1))
            if d <= 8192:
                assert port.takes_head_dim(d)
                assert port._check_attn(meta(2, n, c), *args, heads) == (1, 1)
                assert port._check_tiled_launch(meta(2, n, 3 * c), args[4],
                                                ids, heads) == 1
                continue
            assert not port.takes_head_dim(d)
            with pytest.raises(ValueError, match="8192"):
                port._check_attn(meta(2, n, c), *args, heads)
            with pytest.raises(ValueError, match="8192"):
                port._check_tiled_launch(meta(2, n, 3 * c), args[4], ids,
                                         heads)
