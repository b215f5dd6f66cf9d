"""V1, the port's ``window_attention`` on split q, k, v, against the JAX
package's ``fused_window_attention`` Pallas kernel, run in interpret mode
on the CPU as tests/test_window_attention_kernel.py runs it, forward and
``jax.vjp`` (dq, dk, dv, dbias).

On CPU tensors the port's Function runs its plain forward
(``window_attention_math``) and the explicit plain backward
(``window_attention_backward_reference``): K4's on the heads merged, which
the CUDA kernels V1f/V1b are held to on the card. Both sides read q, k, v
into f32, subtract the plain row max and mask with -1e9, so they differ
only in the order of sums.

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

from vsn_tpu.models.swin3d import shifted_window_region_ids
from vsn_tpu.ops.window_attention import fused_window_attention
from vsn_tpu_torch.ops import window_attention as port

TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _ids(kind, rng):
    """(region ids [W, N], windows per sample)."""
    if kind == "shifted":
        ids = shifted_window_region_ids((4, 6, 4), (2, 3, 2), (1, 1, 1))
        return ids, ids.shape[0]
    if kind == "padded":   # make_inputs: random regions, the last 2 slots pad
        ids = rng.integers(0, 3, (2, 16)).astype(np.int32)
        ids[:, -2:] = -1
        return ids, 2
    if kind == "zeros":    # an unshifted block: one row of zeros, W = 1
        return np.zeros((1, 12), np.int32), 3
    return np.zeros((1, 150), np.int32), 1   # Swin-T stage 4 (5x6x5)


def _case(kind, heads, seed, logit=None):
    """(q, k, v [BW, H, N, d], bias [H, N, N], ids, dout) at B = 2, head dim
    4, O(1) logits (or logits near ``logit``)."""
    rng = np.random.default_rng(seed)
    ids, nw = _ids(kind, rng)
    n = ids.shape[1]
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    q, k, v = (1.5 * f(2 * nw, heads, n, 4) for _ in range(3))
    bias = f(heads, n, n) if logit is None else 8.0 * f(heads, n, n) + logit
    return q, k, v, bias, ids, f(2 * nw, heads, n, 4)


def _jax(q, k, v, bias, ids, dout, dtype):
    scale = q.shape[-1] ** -0.5
    fn = lambda a, b, c, d: fused_window_attention(a, b, c, d,
                                                   jnp.asarray(ids), scale)
    out, vjp = jax.vjp(fn, *(jnp.asarray(t).astype(dtype) for t in (q, k, v)),
                       jnp.asarray(bias))
    grads = vjp(jnp.asarray(dout).astype(dtype))
    return [np.asarray(t.astype(jnp.float32)) for t in (out, *grads)]


def _port(fn, q, k, v, bias, ids, dout, dtype):
    scale = q.shape[-1] ** -0.5
    leaves = [torch.from_numpy(t).to(dtype).requires_grad_() for t in (q, k, v)]
    b = torch.from_numpy(bias).requires_grad_()
    out = fn(*leaves, b, torch.from_numpy(ids), scale)
    assert out.dtype == dtype and out.shape == q.shape
    grads = torch.autograd.grad(out, [*leaves, b],
                                torch.from_numpy(dout).to(dtype))
    assert all(g.dtype == dtype for g in grads[:3])
    assert grads[3].dtype == torch.float32
    return [t.detach().float().numpy() for t in (out, *grads)]


def _close(got, want, dtype):
    for name, g, w in zip(("out", "dq", "dk", "dv", "dbias"), got, want):
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
    want = _jax(*args, getattr(jnp, dtype))
    got = _port(port.window_attention, *args, getattr(torch, dtype))
    _close(got, want, dtype)


@pytest.mark.parametrize("logit", [45.0, 200.0])
def test_saturated_logits_match_jax(logit):
    """Logits near 45 and 200: the plain row max keeps exp exact."""
    args = _case("shifted", 2, seed=7, logit=logit)
    want = _jax(*args, jnp.float32)
    got = _port(port.window_attention, *args, torch.float32)
    _close(got, want, "float32")


@pytest.mark.parametrize("kind", ["shifted", "padded"])
def test_plain_backward_equals_autograd(kind):
    args = _case(kind, 2, seed=3)
    got = _port(port.window_attention_split_reference, *args, torch.float32)
    want = _port(port.window_attention_reference, *args, torch.float32)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)


def test_equals_k4_on_the_packed_layout():
    """V1 on split heads equals K4 on the same values packed as qkv, forward
    and backward (the two entry points share one function)."""
    q, k, v, bias, ids, dout = _case("shifted", 2, seed=5)
    t = lambda a: torch.from_numpy(a)
    bw, heads, n, d = q.shape
    pack = lambda *xs: torch.cat([x.transpose(1, 2).reshape(bw, n, heads * d)
                                  for x in xs], dim=-1)
    qkv = pack(t(q), t(k), t(v))
    scale = d ** -0.5
    torch.testing.assert_close(
        port.window_attention(t(q), t(k), t(v), t(bias), t(ids), scale),
        port.window_attention_qkv(qkv, t(bias), t(ids), scale, heads)
        .reshape(bw, n, heads, d).transpose(1, 2), rtol=1e-5, atol=1e-5)
    dq, dk, dv, dbias = port.window_attention_backward(
        t(q), t(k), t(v), t(bias), t(ids), t(dout), scale)
    dqkv, dbias4 = port.window_attention_qkv_backward(
        qkv, t(bias), t(ids), pack(t(dout)), scale, heads)
    torch.testing.assert_close(pack(dq, dk, dv), dqkv, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(dbias, dbias4, rtol=1e-5, atol=1e-5)


def test_argument_check_rejects_what_the_kernels_do_not_take():
    q, k, v, bias, ids, _ = _case("padded", 2, seed=2)
    t = lambda a: torch.from_numpy(a)
    args = [t(q), t(k), t(v), t(bias), t(ids)]
    assert port._check_split(*args) == ids.shape[0]
    bad = {  # argument index -> what the kernels do not take
        "3 id rows for 8 windows": (4, t(np.zeros((3, 16), np.int32))),
        "f16 q": (0, t(q).half()),
        "k in another dtype": (1, t(k).double()),
        "v of another shape": (2, t(v)[:, :1].contiguous()),
        "int64 ids": (4, t(ids).long()),
        "bias [H, N, N - 1]": (3, t(bias)[..., :-1].contiguous()),
        "non-contiguous q": (0, t(q).transpose(2, 3).contiguous()
                             .transpose(2, 3)),
    }
    for what, (i, value) in bad.items():
        new = list(args)
        new[i] = value
        with pytest.raises((TypeError, ValueError)):
            port._check_split(*new)
            pytest.fail(what)
    with pytest.raises(ValueError):  # above 8192, the slabs' widest head
        z = torch.zeros(2, 1, 16, 8193)
        port._check_split(z, z, z, t(bias)[:1].contiguous(), t(ids))
    # 40: neither up to 32 nor 16 k; 129 and 144: above 128, on the slab
    # kernels; all taken
    for d in (40, 129, 144):
        z = torch.zeros(2, 1, 16, d)
        assert port._check_split(z, z, z, t(bias)[:1].contiguous(),
                                 t(ids)) == ids.shape[0]


@pytest.mark.parametrize("d", [48, 64])
def test_argument_check_takes_the_tiled_head_dims(d):
    """Head dims 48 and 64, multiples of 16 past 32, which the tiled body
    takes."""
    _, _, _, bias, ids, _ = _case("padded", 2, seed=2)
    z = torch.zeros(2, 1, 16, d)
    b = torch.from_numpy(bias)[:1].contiguous()
    assert port._check_split(z, z, z, b, torch.from_numpy(ids)) == 2
