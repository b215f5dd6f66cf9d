"""K1, K4, V1 and V3 at head dims that are not multiples of 16, against
the JAX package's Pallas kernels in interpret mode, forward and VJP.

The key-tiled CUDA body takes every head dim from 1 to 128 (the channels
past d staged as zeros; bf16 rows that are not whole 16-byte chunks staged
by plain loads), and above 128 its slab kernels up to 8192
(tests/test_torch_attn_wide_heads.py), as the JAX kernels put no limit on
it. On CPU tensors the
port's wrappers run their plain versions, which the CUDA kernels are held
to on the card (chip_smoke.py phase 7, ``odd_head_dim_phase``). Inputs from
numpy seeds, f32:

- K1 ``attn_half`` against ``fused_attn_half`` at d = 8, 12, 24 and 40 (3
  heads), N = 13 and 37 (8 windows: 2 samples of 4), each head dim once
  with the relative-position bias, region ids and a qkv bias and once with
  none of them; every gradient. Tolerance 2e-5 of each output's scale, as
  tests/test_torch_attn_tiled_swin.py (the same f32 arithmetic summed in
  another order).
- K4 ``window_attention_qkv``, V1 ``window_attention`` and V3
  ``window_attention_windows`` against ``fused_window_attention_qkv``,
  ``fused_window_attention`` and ``fused_window_attention_windows`` at d =
  24 and 40 (2 heads) on a shifted map of 2 samples of 8 windows of 12
  tokens; dqkv (dq, dk, dv) and dbias. Tolerance 1e-5 (rtol and atol), as
  tests/test_torch_window_attention_split.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vsn_tpu.models.swin3d import shifted_window_region_ids
from vsn_tpu.ops.swin_block_kernels import fused_attn_half
from vsn_tpu.ops.window_attention import (
    fused_window_attention,
    fused_window_attention_qkv,
    fused_window_attention_windows,
)
from vsn_tpu_torch.models.swin3d import window_partition, window_reverse
from vsn_tpu_torch.ops import swin_block_kernels as sbk
from vsn_tpu_torch.ops import window_attention as wa

HEADS, WINDOWS = 3, 4
GF = np.asarray([0.6, 1.4], np.float32)
GB = np.asarray([1.25, 0.35], np.float32)
K1_NAMES = ("x", "lng", "lnb", "wqkv", "bqkv", "wproj", "bproj", "bias")
K1_TOL, WA_TOL = 2e-5, 1e-5
# (head dim, N, with bias, ids and a qkv bias): every head dim at both N,
# once masked and biased and once not
K1_CASES = [(8, 13, True), (8, 37, False), (12, 13, False), (12, 37, True),
            (24, 13, True), (24, 37, False), (40, 13, False), (40, 37, True)]
# the map of the window-attention calls: 2 samples of 8 windows of 12
DIMS, WINDOW, SHIFT = (4, 6, 4), (2, 3, 2), (1, 1, 1)


def _k1_inputs(d, n, masked, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    c = HEADS * d
    p = dict(x=f(2 * WINDOWS, n, c), lng=1.0 + 0.1 * f(c), lnb=0.1 * f(c),
             wqkv=c ** -0.5 * f(c, 3 * c), bqkv=np.zeros(3 * c, np.float32),
             wproj=c ** -0.5 * f(c, c), bproj=0.1 * f(c),
             bias=f(HEADS, n, n) if masked else None, ids=None)
    if masked:
        p["bqkv"] = 0.1 * f(3 * c)
        p["ids"] = rng.integers(0, 3, (WINDOWS, n)).astype(np.int32)
    return p


def _k1_jax(p, scale):
    names = K1_NAMES if p["bias"] is not None else K1_NAMES[:-1]
    ids = None if p["ids"] is None else jnp.asarray(p["ids"])

    def fn(x, lng, lnb, wqkv, bqkv, wproj, bproj, bias=None):
        return fused_attn_half(x, lng, lnb, wqkv, bqkv, bias, ids, wproj,
                               bproj, jnp.asarray(GF), jnp.asarray(GB), scale,
                               HEADS, 1.0)

    out, vjp = jax.vjp(fn, *(jnp.asarray(p[k]) for k in names))
    ct = np.random.default_rng(99).standard_normal(out.shape).astype(
        np.float32)
    grads = vjp(jnp.asarray(ct))
    return np.asarray(out), ct, {k: np.asarray(g) for k, g in zip(names,
                                                                  grads)}


def _k1_port(p, scale, ct):
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    leaves = {k: t(p[k]).requires_grad_() for k in K1_NAMES
              if p.get(k) is not None}
    bqkv = leaves["bqkv"] if p["ids"] is not None else None
    out = sbk.attn_half(leaves["x"], leaves["lng"], leaves["lnb"],
                        leaves["wqkv"].t(), bqkv, leaves.get("bias"),
                        None if p["ids"] is None else t(p["ids"]),
                        leaves["wproj"].t(), leaves["bproj"], t(GF), t(GB),
                        scale, HEADS, 1.0)
    names = [k for k in leaves if k != "bqkv" or bqkv is not None]
    grads = torch.autograd.grad(out, [leaves[k] for k in names], t(ct))
    return out.detach().numpy(), {k: g.numpy() for k, g in zip(names, grads)}


def _close(got, want, tol, what):
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert np.isfinite(got).all(), what
    assert err <= tol * scale, f"{what}: max|d| {err} > {tol} x {scale}"


@pytest.mark.parametrize("d,n,masked", K1_CASES)
def test_k1_matches_jax_at_head_dims_off_the_mma_depth(d, n, masked):
    """K1's forward and every gradient against fused_attn_half; the CPU
    entry point takes the head dim as the card's key-tiled body does."""
    p = _k1_inputs(d, n, masked, seed=d * 100 + n)
    scale = d ** -0.5
    want, ct, wgrads = _k1_jax(p, scale)
    got, grads = _k1_port(p, scale, ct)
    _close(got, want, K1_TOL, "out")
    if not masked:   # the port takes no qkv bias here; JAX's was zero
        wgrads.pop("bqkv")
    assert set(grads) == set(wgrads)
    for k, g in grads.items():
        _close(g, wgrads[k], K1_TOL, f"d{k}")


def _wa_case(d, seed):
    """(qkv [BW, N, 3C], bias, ids, dout [BW, N, C]) of 2 samples on the
    shifted map, head dim d, O(1) logits."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    ids = shifted_window_region_ids(DIMS, WINDOW, SHIFT)
    nw, n = ids.shape
    c = 2 * d
    return (1.5 * f(2 * nw, n, 3 * c), f(2, n, n), ids, f(2 * nw, n, c))


def _wa_close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=WA_TOL, atol=WA_TOL,
                               err_msg=what)


def _vjp(fn, primals, ct):
    out, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in primals))
    return [np.asarray(t) for t in (out, *vjp(jnp.asarray(ct)))]


def _grads(fn, leaves, rest, ct):
    leaves = [torch.from_numpy(a).requires_grad_() for a in leaves]
    out = fn(*leaves, *rest)
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(ct))
    return [t.detach().numpy() for t in (out, *grads)]


@pytest.mark.parametrize("d", [24, 40])
def test_k4_v1_v3_match_jax_at_head_dims_off_the_mma_depth(d):
    """K4 on packed qkv, V1 on split q, k, v and V3 on the unpartitioned
    map, forward and gradients, against their JAX kernels."""
    qkv, bias, ids, dout = _wa_case(d, seed=d)
    scale, heads = d ** -0.5, 2
    jids, tids = jnp.asarray(ids), torch.from_numpy(ids)

    want = _vjp(lambda a, b: fused_window_attention_qkv(a, b, jids, scale,
                                                        heads),
                (qkv, bias), dout)
    got = _grads(wa.window_attention_qkv, [qkv, bias],
                 (tids, scale, heads), dout)
    for what, g, w in zip(("K4 out", "K4 dqkv", "K4 dbias"), got, want):
        _wa_close(g, w, what)

    bw, n, _ = qkv.shape
    split = lambda a, k: np.ascontiguousarray(
        a.reshape(bw, n, k, heads, d).transpose(2, 0, 3, 1, 4))
    q, k, v = split(qkv, 3)
    do = split(dout, 1)[0]
    want = _vjp(lambda *a: fused_window_attention(*a, jids, scale),
                (q, k, v, bias), do)
    got = _grads(wa.window_attention, [q, k, v, bias], (tids, scale), do)
    for what, g, w in zip(("V1 out", "V1 dq", "V1 dk", "V1 dv", "V1 dbias"),
                          got, want):
        _wa_close(g, w, what)

    to_map = lambda a: window_reverse(torch.from_numpy(a), WINDOW,
                                      DIMS).contiguous().numpy()
    mqkv, mdout = to_map(qkv), to_map(dout)
    want = _vjp(lambda a, b: fused_window_attention_windows(
        a, b, jids, scale, heads, WINDOW), (mqkv, bias), mdout)
    got = _grads(wa.window_attention_windows, [mqkv, bias],
                 (tids, scale, heads, WINDOW), mdout)
    for what, g, w in zip(("V3 out", "V3 dqkv", "V3 dbias"), got, want):
        _wa_close(g, w, what)
    # V3's map holds the same windows as K4's packed rows
    assert np.array_equal(window_partition(torch.from_numpy(mqkv),
                                           WINDOW).numpy(), qkv)
