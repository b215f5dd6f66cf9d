"""The plain versions of K4's launches with their kept state
(``window_attention_qkv_kept_reference``: qkv -> out, the row statistics
and f32 o; ``window_attention_qkv_kept_backward_reference``: qkv, dout, o,
statistics -> dqkv, dbias) against the JAX ``fused_window_attention_qkv``
Pallas kernel in interpret mode on the CPU, forward and ``jax.vjp``.

The CUDA launches (K4f / K4b on ``csrc/attn_tiled.cuh`` under K4's softmax
policy) are held to these plain versions on the card (chip_smoke.py phase
4). K4's softmax is the TPU kernel's: the score (q k^T scale + bias) +
mask, the plain row max and the plain row sum, kept as (max, 1 / sum); the
backward takes p = exp(s - max) / sum and s1 = dO . o on the forward's f32
o (the FlashAttention identity), where the JAX kernel recomputes the
softmax and sums rowsum(p dp). In bf16 e, p and ds are rounded to bf16
before their products, as the card's kernels round them.

Windows of N = 70 tokens (2 x 5 x 7: a ragged key tile of 6 past one of
64 on the card), 8 windows per sample, 2 samples, 2 heads of head dim 8,
16 and 32; shifted ids, padded ids (-1 pad slots) and one row of zeros.
Tolerances: f32 2e-5 of each output's scale (sums in another order, p as
e times 1 / sum), bf16 2e-2 (one bf16 rounding of an output, 2^-8, and the
kernels' rounding of e, p and ds). Saturated logits: an additive bias 8 z +
logit (45, 200, -200); at -200 the plain row max keeps the softmax where
K1's max(rowmax, 0) shift would underflow every exp.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vsn_tpu.models.swin3d import (
    padded_window_region_ids,
    shifted_window_region_ids,
)
from vsn_tpu.ops.window_attention import fused_window_attention_qkv
from vsn_tpu_torch.ops import window_attention as port

HEADS, N, NW = 2, 70, 8
WINDOW, DIMS, SHIFT = (2, 5, 7), (4, 10, 14), (1, 2, 3)
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _ids(kind):
    if kind == "shifted":
        ids = shifted_window_region_ids(DIMS, WINDOW, SHIFT)
    elif kind == "padded":  # 3x9x13 padded to 4x10x14; pad slots carry -1
        ids = padded_window_region_ids((3, 9, 13), WINDOW, SHIFT)
        assert (ids == -1).any()
    else:                   # an unshifted block: one row of zeros, W = 1
        ids = np.zeros((1, N), np.int32)
    assert ids.shape[1] == N
    return ids


def _case(kind, d, seed, logit=None, ragged=False):
    """(qkv [16, N, 3C], bias [H, N, N], ids, dout [16, N, C]): O(1)
    logits, or logits near ``logit`` (the last key tile's 12 higher with
    ``ragged``)."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    c = HEADS * d
    qkv = 1.5 * f(2 * NW, N, 3 * c) / np.sqrt(np.sqrt(d / 4))
    bias = f(HEADS, N, N) if logit is None else 8.0 * f(HEADS, N, N) + logit
    if ragged:
        bias[:, :, 64:] += 12.0
    return qkv, bias, _ids(kind), f(2 * NW, N, c)


def _jax(qkv, bias, ids, dout, dtype):
    scale = (qkv.shape[-1] // (3 * HEADS)) ** -0.5
    fn = lambda a, b: fused_window_attention_qkv(a, b, jnp.asarray(ids), scale,
                                                 HEADS)
    out, vjp = jax.vjp(fn, jnp.asarray(qkv).astype(dtype), jnp.asarray(bias))
    dqkv, dbias = vjp(jnp.asarray(dout).astype(dtype))
    return [np.asarray(t.astype(jnp.float32)) for t in (out, dqkv, dbias)]


def _port(qkv, bias, ids, dout, dtype):
    """(out, dqkv, dbias) of the kept plain launches, and the kept state
    (statistics, o)."""
    scale = (qkv.shape[-1] // (3 * HEADS)) ** -0.5
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    q, b, i = t(qkv).to(dtype), t(bias), t(ids)
    out, stats, o = port.window_attention_qkv_kept_reference(q, b, i, scale,
                                                             HEADS)
    assert out.dtype == dtype and o.dtype == stats.dtype == torch.float32
    assert stats.shape == (2 * NW, HEADS, N, 2)
    dqkv, dbias = port.window_attention_qkv_kept_backward_reference(
        q, t(dout).to(dtype), o, stats, b, i, scale, HEADS)
    assert dqkv.dtype == dtype and dbias.dtype == torch.float32
    return [x.float().numpy() for x in (out, dqkv, dbias)], (stats, o)


def _close(got, want, dtype):
    for name, g, w in zip(("out", "dqkv", "dbias"), got, want):
        assert np.isfinite(g).all(), name
        err = float(np.abs(g - w).max())
        scale = max(1.0, float(np.abs(w).max()))
        assert err <= TOL[dtype] * scale, (name, err, scale)


CASES = [(kind, 8) for kind in ("shifted", "padded", "zeros")] + [
    ("shifted", 16), ("padded", 32)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind,d", CASES)
def test_kept_launches_match_jax(kind, d, dtype):
    args = _case(kind, d, seed=d + len(kind))
    want = _jax(*args, getattr(jnp, dtype))
    got, _ = _port(*args, getattr(torch, dtype))
    _close(got, want, dtype)


@pytest.mark.parametrize("kind", ["shifted", "padded"])
def test_statistics_are_the_row_max_and_sum_of_the_jax_scores(kind):
    """The kept (max, 1 / sum) of every row are the row max of the scores
    as _fwd_qkv_kernel forms them, (q k^T scale + bias) + mask, and 1 over
    the sum of exp(s - max)."""
    qkv, bias, ids, dout = _case(kind, 16, seed=11)
    _, (stats, _) = _port(qkv, bias, ids, dout, torch.float32)
    scale = 16 ** -0.5
    c = HEADS * 16
    x = jnp.asarray(qkv).reshape(2 * NW, N, 3, HEADS, 16)
    q, k = x[:, :, 0].transpose(0, 2, 1, 3), x[:, :, 1].transpose(0, 2, 1, 3)
    idr = jnp.asarray(ids)[jnp.arange(2 * NW) % ids.shape[0]]
    mask = jnp.where(idr[:, :, None] != idr[:, None, :], -1e9, 0.0)
    s = jnp.einsum("bhid,bhjd->bhij", q, k) * scale + jnp.asarray(bias)
    s = s + mask[:, None]
    m = np.asarray(s.max(-1))
    total = np.asarray(jnp.exp(s - s.max(-1, keepdims=True)).sum(-1))
    assert qkv.shape[-1] == 3 * c
    np.testing.assert_allclose(stats[..., 0].numpy(), m, rtol=1e-6,
                               atol=1e-5)
    np.testing.assert_allclose(1.0 / stats[..., 1].numpy(), total,
                               rtol=1e-5)


@pytest.mark.parametrize("logit", [45.0, 200.0, -200.0])
def test_saturated_logits_match_jax(logit):
    args = _case("shifted", 8, seed=7, logit=logit)
    got, (stats, _) = _port(*args, torch.float32)
    _close(got, _jax(*args, jnp.float32), "float32")
    # the shift is the plain row max, near the logit at either sign, and
    # exp(0) = 1 at the top: 1 / sum <= 1
    m = stats[..., 0]
    assert float(m.min()) > logit - 60 and float(m.max()) < logit + 60
    assert float(stats[..., 1].max()) <= 1.0


def test_top_logits_in_the_ragged_key_tile_match_jax():
    """Logits near 45 with the keys past the first 64 (the card's ragged
    last key tile) 12 higher, in one region (every row sees every key)."""
    args = _case("zeros", 8, seed=9, logit=45.0, ragged=True)
    got, (stats, _) = _port(*args, torch.float32)
    _close(got, _jax(*args, jnp.float32), "float32")
    assert float(stats[..., 0].min()) > 45.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kept_launches_compose_to_the_plain_version(dtype):
    """K4f's kept plain launch gives ``window_attention_qkv_reference``'s
    output, and the kept backward from its state the plain backward's
    dqkv and dbias (``window_attention_qkv_backward_reference``, which
    recomputes the softmax)."""
    qkv, bias, ids, dout = _case("shifted", 32, seed=5)
    dt = getattr(torch, dtype)
    got, _ = _port(qkv, bias, ids, dout, dt)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    scale = 32 ** -0.5
    q = t(qkv).to(dt).requires_grad_()
    b = t(bias).requires_grad_()
    out = port.window_attention_qkv_reference(q, b, t(ids), scale, HEADS)
    dqkv, dbias = torch.autograd.grad(out, [q, b], t(dout).to(dt))
    want = [x.detach().float().numpy() for x in (out, dqkv, dbias)]
    tol = {"float32": 2e-6, "bfloat16": 2e-2}[dtype]
    for name, g, w in zip(("out", "dqkv", "dbias"), got, want):
        err = float(np.abs(g - w).max())
        assert err <= tol * max(1.0, float(np.abs(w).max())), (name, err)
