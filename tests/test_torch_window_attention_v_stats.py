"""The plain versions of V1's and V3's launches with their kept state
(``window_attention_kept_reference`` / ``window_attention_windows_kept_
reference``: the forward -> out, the row statistics and f32 o; and their
``*_kept_backward_reference`` from that state -> the input gradients and
dbias) against the JAX package's ``fused_window_attention`` and
``fused_window_attention_windows`` Pallas kernels, run in interpret mode on
the CPU as tests/test_window_attention_kernel.py runs them, forward and
``jax.vjp``.

The CUDA launches (V1f / V1b and V3f / V3b: the tiled body of
``csrc/attn_tiled.cuh`` under K4's softmax policy, on the ``Split`` and
``MapRows`` layouts) are held to these plain versions on the card
(chip_smoke.py phase 5). They are K4's kept plain versions on the heads
merged (V1) or the windows partitioned (V3): the plain row max and row sum
kept as (max, 1 / sum); the backward takes p = exp(s - max) / sum and s1 =
dO . o on the forward's f32 o, where the JAX kernels recompute the softmax;
in bf16 e, p and ds are rounded to bf16 before their products, as the
card's kernels round them.

Windows of N = 70 tokens (2 x 5 x 7: a ragged key tile of 6 past one of 64
on the card), 8 windows per sample, 2 samples, 2 heads of head dim 16, 32
and 64; shifted ids, padded ids (-1 pad slots), one row of zeros, and (V3)
3 id rows over the 8 windows of a sample, where a window's row is its index
within its sample mod 3, not the global bw % 3. Tolerances as
tests/test_torch_window_attention_qkv_stats.py: f32 2e-5 of each output's
scale (sums in another order, p as e times 1 / sum), bf16 2e-2 (one bf16
rounding of an output, 2^-8, and the kernels' rounding of e, p and ds).
Saturated logits: an additive bias 8 z + logit (45, 200, -200), and logits
near 45 with the keys of the ragged tile 12 higher.
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
from vsn_tpu.ops.window_attention import (
    fused_window_attention,
    fused_window_attention_windows,
)
from vsn_tpu_torch.ops import window_attention as port

HEADS, N, NW, B = 2, 70, 8, 2
WINDOW, DIMS, SHIFT = (2, 5, 7), (4, 10, 14), (1, 2, 3)
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _ids(kind, rng):
    if kind == "shifted":
        ids = shifted_window_region_ids(DIMS, WINDOW, SHIFT)
    elif kind == "padded":  # 3x9x13 padded to 4x10x14; pad slots carry -1
        ids = padded_window_region_ids((3, 9, 13), WINDOW, SHIFT)
        assert (ids == -1).any()
    elif kind == "3 over 8":  # 3 distinct rows over 8 windows per sample
        ids = rng.integers(0, 3, (3, N)).astype(np.int32)
        assert len({tuple(r) for r in ids}) == 3
    else:                     # an unshifted block: one row of zeros, W = 1
        ids = np.zeros((1, N), np.int32)
    assert ids.shape[1] == N
    return ids


def _case(kind, d, seed, logit=None, ragged=False):
    """(qkv map [B, D, H, W, 3C], bias [H, N, N], ids, dout map [B, D, H,
    W, C]): O(1) logits, or logits near ``logit`` (the last key tile's 12
    higher with ``ragged``)."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    c = HEADS * d
    qkv = 1.5 * f(B, *DIMS, 3 * c) / np.sqrt(np.sqrt(d / 4))
    bias = f(HEADS, N, N) if logit is None else 8.0 * f(HEADS, N, N) + logit
    if ragged:
        bias[:, :, 64:] += 12.0
    return qkv, bias, _ids(kind, rng), f(B, *DIMS, c)


def _partition(x):
    """A map [B, D, H, W, c] -> its windows [B nW, N, c] (numpy), in the
    order window_partition gives them."""
    b, d, h, w, c = x.shape
    wd, wh, ww = WINDOW
    x = x.reshape(b, d // wd, wd, h // wh, wh, w // ww, ww, c)
    return x.transpose(0, 1, 3, 5, 2, 4, 6, 7).reshape(b * NW, N, c)


def _heads(x, parts):
    """[BW, N, parts H d] -> ``parts`` arrays [BW, H, N, d]."""
    bw, n, c = x.shape
    x = x.reshape(bw, n, parts, HEADS, c // (parts * HEADS))
    return [np.ascontiguousarray(t) for t in x.transpose(2, 0, 3, 1, 4)]


def _v1_args(qkv, dout):
    """(q, k, v, dout) [B nW, H, N, d] of a V3 case's values."""
    return (*_heads(_partition(qkv), 3), _heads(_partition(dout), 1)[0])


def _jax_v1(q, k, v, bias, ids, dout, dtype):
    scale = q.shape[-1] ** -0.5
    fn = lambda a, b_, c, e: fused_window_attention(a, b_, c, e,
                                                    jnp.asarray(ids), scale)
    out, vjp = jax.vjp(fn, *(jnp.asarray(t).astype(dtype) for t in (q, k, v)),
                       jnp.asarray(bias))
    grads = vjp(jnp.asarray(dout).astype(dtype))
    return [np.asarray(t.astype(jnp.float32)) for t in (out, *grads)]


def _jax_v3(qkv, bias, ids, dout, dtype):
    scale = (qkv.shape[-1] // (3 * HEADS)) ** -0.5
    fn = lambda a, b_: fused_window_attention_windows(
        a, b_, jnp.asarray(ids), scale, HEADS, WINDOW)
    out, vjp = jax.vjp(fn, jnp.asarray(qkv).astype(dtype), jnp.asarray(bias))
    dqkv, dbias = vjp(jnp.asarray(dout).astype(dtype))
    return [np.asarray(t.astype(jnp.float32)) for t in (out, dqkv, dbias)]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _port_v1(q, k, v, bias, ids, dout, dtype):
    """(out, dq, dk, dv, dbias) of V1's kept plain launches, and the kept
    state (statistics, o)."""
    scale = q.shape[-1] ** -0.5
    q, k, v = (_t(x).to(dtype) for x in (q, k, v))
    b, i = _t(bias), _t(ids)
    out, stats, o = port.window_attention_kept_reference(q, k, v, b, i, scale)
    assert out.dtype == dtype and o.dtype == stats.dtype == torch.float32
    assert o.shape == q.shape and stats.shape == (*q.shape[:3], 2)
    grads = port.window_attention_kept_backward_reference(
        q, k, v, _t(dout).to(dtype), o, stats, b, i, scale)
    assert all(g.dtype == dtype for g in grads[:3])
    assert grads[3].dtype == torch.float32
    return [x.float().numpy() for x in (out, *grads)], (stats, o)


def _port_v3(qkv, bias, ids, dout, dtype):
    """(out, dqkv, dbias) of V3's kept plain launches, and the kept state
    (statistics, o)."""
    scale = (qkv.shape[-1] // (3 * HEADS)) ** -0.5
    q, b, i = _t(qkv).to(dtype), _t(bias), _t(ids)
    out, stats, o = port.window_attention_windows_kept_reference(
        q, b, i, scale, HEADS, WINDOW)
    assert out.dtype == dtype and o.dtype == stats.dtype == torch.float32
    assert o.shape == out.shape == (*q.shape[:4], q.shape[4] // 3)
    assert stats.shape == (B * NW, HEADS, N, 2)
    dqkv, dbias = port.window_attention_windows_kept_backward_reference(
        q, _t(dout).to(dtype), o, stats, b, i, scale, HEADS, WINDOW)
    assert dqkv.dtype == dtype and dbias.dtype == torch.float32
    return [x.float().numpy() for x in (out, dqkv, dbias)], (stats, o)


def _close(got, want, dtype):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert np.isfinite(g).all()
        err = float(np.abs(g - w).max())
        scale = max(1.0, float(np.abs(w).max()))
        assert err <= TOL[dtype] * scale, (err, scale)


def _run(entry, qkv, bias, ids, dout, dtype):
    """(port, JAX) outputs of ``entry`` ("v1" or "v3") on one case, and the
    port's kept state."""
    if entry == "v1":
        q, k, v, do = _v1_args(qkv, dout)
        got, kept = _port_v1(q, k, v, bias, ids, do, getattr(torch, dtype))
        return got, _jax_v1(q, k, v, bias, ids, do, getattr(jnp, dtype)), kept
    got, kept = _port_v3(qkv, bias, ids, dout, getattr(torch, dtype))
    return got, _jax_v3(qkv, bias, ids, dout, getattr(jnp, dtype)), kept


CASES = [("v1", "shifted", 16), ("v1", "padded", 32), ("v1", "zeros", 64),
         ("v3", "shifted", 16), ("v3", "padded", 32), ("v3", "zeros", 64),
         ("v3", "3 over 8", 16)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("entry,kind,d", CASES)
def test_kept_launches_match_jax(entry, kind, d, dtype):
    args = _case(kind, d, seed=d + len(kind))
    got, want, _ = _run(entry, *args, dtype)
    _close(got, want, dtype)


@pytest.mark.parametrize("entry", ["v1", "v3"])
@pytest.mark.parametrize("logit", [45.0, 200.0, -200.0])
def test_saturated_logits_match_jax(entry, logit):
    """At either sign the shift is the plain row max, near the logit, and
    exp(0) = 1 at the top: 1 / sum <= 1."""
    args = _case("shifted", 16, seed=7, logit=logit)
    got, want, (stats, _) = _run(entry, *args, "float32")
    _close(got, want, "float32")
    m = stats[..., 0]
    assert float(m.min()) > logit - 60 and float(m.max()) < logit + 60
    assert float(stats[..., 1].max()) <= 1.0


@pytest.mark.parametrize("entry", ["v1", "v3"])
def test_top_logits_in_the_ragged_key_tile_match_jax(entry):
    """Logits near 45 with the keys past the first 64 (the card's ragged
    last key tile) 12 higher, in one region (every row sees every key)."""
    args = _case("zeros", 16, seed=9, logit=45.0, ragged=True)
    got, want, (stats, _) = _run(entry, *args, "float32")
    _close(got, want, "float32")
    assert float(stats[..., 0].min()) > 45.0


def test_v3_rows_are_the_windows_partitioned():
    """V3's kept state is V1's on the same values: the statistics equal,
    window for window, and o as the map of V1's o."""
    qkv, bias, ids, dout = _case("shifted", 16, seed=4)
    _, (stats3, o3) = _port_v3(qkv, bias, ids, dout, torch.float32)
    _, (stats1, o1) = _port_v1(*_v1_args(qkv, dout)[:3], bias, ids,
                               _v1_args(qkv, dout)[3], torch.float32)
    torch.testing.assert_close(stats3, stats1, rtol=0, atol=0)
    merged = o1.transpose(1, 2).reshape(B * NW, N, -1).numpy()
    np.testing.assert_array_equal(_partition(o3.numpy()), merged)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("entry", ["v1", "v3"])
def test_kept_launches_compose_to_the_plain_version(entry, dtype):
    """The kept plain forward gives the entry point's plain output, and
    the kept backward from its state the plain backward's gradients
    (``window_attention_split_reference`` / ``window_attention_windows_
    reference`` through autograd, which recompute the softmax)."""
    qkv, bias, ids, dout = _case("shifted", 32, seed=5)
    dt = getattr(torch, dtype)
    b = _t(bias).requires_grad_()
    if entry == "v1":
        q, k, v, do = _v1_args(qkv, dout)
        got, _ = _port_v1(q, k, v, bias, ids, do, dt)
        leaves = [_t(x).to(dt).requires_grad_() for x in (q, k, v)]
        out = port.window_attention_split_reference(*leaves, b, _t(ids),
                                                    32 ** -0.5)
    else:
        got, _ = _port_v3(qkv, bias, ids, dout, dt)
        leaves = [_t(qkv).to(dt).requires_grad_()]
        out = port.window_attention_windows_reference(
            *leaves, b, _t(ids), 32 ** -0.5, HEADS, WINDOW)
        do = dout
    grads = torch.autograd.grad(out, [*leaves, b], _t(do).to(dt))
    want = [x.detach().float().numpy() for x in (out, *grads)]
    tol = {"float32": 2e-6, "bfloat16": 2e-2}[dtype]
    for g, w in zip(got, want):
        err = float(np.abs(g - w).max())
        assert err <= tol * max(1.0, float(np.abs(w).max())), err
