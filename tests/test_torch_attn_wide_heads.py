"""K1, K4, V1 and V3 at head dims above 128, against the JAX package's
kernels on the CPU, forward and every gradient.

On the card the key-tiled body takes a head dim above 128 in slabs of 128
channels (64 in f32; ``csrc/attn_tiled.cuh``, the slab kernels), up to
8192; on CPU tensors the port's wrappers run their plain versions, which
the slab kernels are held to on the card (tests/test_torch_cuda_kernels.py
and chip_smoke.py phase 7). The JAX functions put no limit on the head dim.
Inputs from numpy seeds, f32:

- K1 ``attn_half`` against ``fused_attn_half`` in interpret mode at d =
  129, 136, 192 and 256 (2 heads), N = 13 and 37, each head dim once with
  the relative-position bias, region ids and a qkv bias and once with none
  of them; every gradient. Tolerance 2e-5 of each output's scale, as
  tests/test_torch_attn_head_dims.py.
- K4, V1 and V3 against their JAX kernels at d = 136 and 192 on the shifted
  map of tests/test_torch_attn_head_dims.py; dqkv (dq, dk, dv) and dbias.
  Tolerance 1e-5.
- The wrappers take every head dim from 129 to 8192 and raise at 8193.

Whole tiny models at such head dims: tests/test_torch_attn_wide_heads_models.py.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import tests.test_torch_attn_head_dims as hd
from vsn_tpu.ops.swin_block_kernels import fused_attn_half
from vsn_tpu_torch.ops import swin_block_kernels as sbk
from vsn_tpu_torch.ops import window_attention as wa

HEADS = 2
# (head dim, N, with bias, ids and a qkv bias)
K1_CASES = [(129, 13, True), (129, 37, False), (136, 13, False),
            (136, 37, True), (192, 13, True), (192, 37, False),
            (256, 13, False), (256, 37, True)]


def _k1_inputs(d, n, masked, seed):
    """tests/test_torch_attn_head_dims.py's K1 inputs at HEADS heads of d."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    c = HEADS * d
    p = dict(x=f(2 * hd.WINDOWS, n, c), lng=1.0 + 0.1 * f(c), lnb=0.1 * f(c),
             wqkv=c ** -0.5 * f(c, 3 * c), bqkv=np.zeros(3 * c, np.float32),
             wproj=c ** -0.5 * f(c, c), bproj=0.1 * f(c),
             bias=f(HEADS, n, n) if masked else None, ids=None)
    if masked:
        p["bqkv"] = 0.1 * f(3 * c)
        p["ids"] = rng.integers(0, 3, (hd.WINDOWS, n)).astype(np.int32)
    return p


def _k1_jax(p, scale):
    names = hd.K1_NAMES if p["bias"] is not None else hd.K1_NAMES[:-1]
    ids = None if p["ids"] is None else jnp.asarray(p["ids"])

    def fn(x, lng, lnb, wqkv, bqkv, wproj, bproj, bias=None):
        return fused_attn_half(x, lng, lnb, wqkv, bqkv, bias, ids, wproj,
                               bproj, jnp.asarray(hd.GF), jnp.asarray(hd.GB),
                               scale, HEADS, 1.0)

    out, vjp = jax.vjp(fn, *(jnp.asarray(p[k]) for k in names))
    ct = np.random.default_rng(99).standard_normal(out.shape).astype(
        np.float32)
    grads = vjp(jnp.asarray(ct))
    return np.asarray(out), ct, {k: np.asarray(g) for k, g in zip(names,
                                                                  grads)}


def _k1_port(p, scale, ct):
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    leaves = {k: t(p[k]).requires_grad_() for k in hd.K1_NAMES
              if p.get(k) is not None}
    bqkv = leaves["bqkv"] if p["ids"] is not None else None
    out = sbk.attn_half(leaves["x"], leaves["lng"], leaves["lnb"],
                        leaves["wqkv"].t(), bqkv, leaves.get("bias"),
                        None if p["ids"] is None else t(p["ids"]),
                        leaves["wproj"].t(), leaves["bproj"], t(hd.GF),
                        t(hd.GB), scale, HEADS, 1.0)
    names = [k for k in leaves if k != "bqkv" or bqkv is not None]
    grads = torch.autograd.grad(out, [leaves[k] for k in names], t(ct))
    return out.detach().numpy(), {k: g.numpy() for k, g in zip(names, grads)}


@pytest.mark.parametrize("d,n,masked", K1_CASES)
def test_k1_matches_jax_at_head_dims_above_128(d, n, masked):
    """K1's forward and every gradient against fused_attn_half at head
    dims that the card takes in slabs."""
    p = _k1_inputs(d, n, masked, seed=d * 100 + n)
    scale = d ** -0.5
    want, ct, wgrads = _k1_jax(p, scale)
    got, grads = _k1_port(p, scale, ct)
    hd._close(got, want, hd.K1_TOL, "out")
    if not masked:   # the port takes no qkv bias here; JAX's was zero
        wgrads.pop("bqkv")
    assert set(grads) == set(wgrads)
    for k, g in grads.items():
        hd._close(g, wgrads[k], hd.K1_TOL, f"d{k}")


@pytest.mark.parametrize("d", [136, 192])
def test_k4_v1_v3_match_jax_at_head_dims_above_128(d):
    """K4, V1 and V3, forward and gradients, against their JAX kernels
    (tests/test_torch_attn_head_dims.py's check at wider heads)."""
    hd.test_k4_v1_v3_match_jax_at_head_dims_off_the_mma_depth(d)


def _check_all(d, n=5):
    """Run every wrapper's argument check (K1, its tiled launches, K4, V1,
    V3) at head dim ``d`` on 2 heads, on meta tensors."""
    meta = lambda *s, dt=torch.float32: torch.empty(s, dtype=dt,
                                                    device="meta")
    c = 2 * d
    ids = meta(1, n, dt=torch.int32)
    sbk._check_attn(meta(1, n, c), meta(c), meta(c), meta(3 * c, c), None,
                    None, ids, meta(c, c), meta(c), meta(1), meta(1), 2)
    sbk._check_tiled_launch(meta(1, n, 3 * c), meta(2, n, n), ids, 2)
    wa._check(meta(1, n, 3 * c), meta(2, n, n), ids, 2)
    z = meta(1, 2, n, d)
    wa._check_split(z, z, z, meta(2, n, n), ids)
    wa._check_windows(meta(1, 1, 1, n, 3 * c), meta(2, n, n), ids, 2,
                      (1, 1, n))


@pytest.mark.parametrize("d", [129, 130, 136, 192, 255, 256, 384, 768, 1000,
                               2048, 4097, 8191, 8192])
def test_the_wrappers_take_head_dims_above_128(d):
    """K1, its launches, K4, V1 and V3 take every head dim up to 8192 (the
    widest row of K1's LayerNorm kernels)."""
    assert wa.takes_head_dim(d) and sbk.takes_head_dim(d)
    _check_all(d)


def test_the_wrappers_raise_above_head_dim_8192():
    """At 8193 every wrapper check raises, naming the limit."""
    assert not wa.takes_head_dim(8193) and not sbk.takes_head_dim(8193)
    meta = lambda *s, dt=torch.float32: torch.empty(s, dtype=dt,
                                                    device="meta")
    d, n = 8193, 5
    c = 2 * d
    ids = meta(1, n, dt=torch.int32)
    with pytest.raises(ValueError, match="head dims up to 8192"):
        sbk._check_attn(meta(1, n, c), meta(c), meta(c), meta(3 * c, c),
                        None, None, ids, meta(c, c), meta(c), meta(1),
                        meta(1), 2)
    with pytest.raises(ValueError, match="head dims up to 8192"):
        sbk._check_tiled_launch(meta(1, n, 3 * c), None, None, 2)
    with pytest.raises(ValueError, match="head dims up to 8192"):
        wa._check(meta(1, n, 3 * c), meta(2, n, n), ids, 2)
    z = meta(1, 2, n, d)
    with pytest.raises(ValueError, match="head dim up to 8192"):
        wa._check_split(z, z, z, meta(2, n, n), ids)
    with pytest.raises(ValueError, match="head dims are up to 8192"):
        wa._check_windows(meta(1, 1, 1, n, 3 * c), meta(2, n, n), ids, 2,
                          (1, 1, n))
