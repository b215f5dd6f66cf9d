"""The port's stem conv (K5f/K5w wrappers, plain versions on the CPU) against
the JAX package's ``stem_conv_im2col`` in interpret mode and its ``_ref_conv``
oracle, on the geometries of tests/test_stem_im2col.py: the ResNet stem
7^3/(1,2,2), the MedViT stem 3^3/(2,2,2), all stride 1, and the odd-extent
case (9x11x13, kernel (3,5,3), strides (2,2,1)).

Tolerances, f32 on both sides: the forward to 2e-5 (as the JAX package holds
its kernel to lax.conv: sum-order differences only); the weight gradient, a
sum over every output token, to 5e-5 relative and 5e-5 of its largest
element; bf16 to 2e-2 of the output scale (one bf16 rounding of the output).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vsn_tpu.ops import stem_im2col as jstem
from vsn_tpu_torch.ops import stem_im2col as S
from vsn_tpu_torch.ops.conv_unfold import UnfoldedConv

GEOMS = [
    # (shape DHW, kernel, strides, name), tests/test_stem_im2col.py:22-28
    ((12, 14, 12), (7, 7, 7), (1, 2, 2), "resnet-stem"),
    ((12, 14, 12), (3, 3, 3), (2, 2, 2), "medvit-stem0"),
    ((8, 10, 8), (3, 3, 3), (1, 1, 1), "stride1"),
    ((9, 11, 13), (3, 5, 3), (2, 2, 1), "odd-extent"),
]


def _setup(shape, kernel_shape, seed=0, c_out=16):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, *shape, 1)).astype(np.float32)
    k = (rng.standard_normal((*kernel_shape, 1, c_out)) * 0.1).astype(
        np.float32)
    return x, k


@pytest.mark.parametrize("shape,ks,strides,name", GEOMS)
def test_forward_matches_jax_kernel_and_lax_conv(shape, ks, strides, name):
    pad = tuple(k // 2 for k in ks)
    x, k = _setup(shape, ks)
    got = S.stem_conv_im2col(torch.from_numpy(x), torch.from_numpy(k),
                             strides, pad).numpy()
    kernel = np.asarray(jstem.stem_conv_im2col(jnp.asarray(x),
                                               jnp.asarray(k), strides, pad))
    oracle = np.asarray(jstem._ref_conv(jnp.asarray(x), jnp.asarray(k),
                                        strides, pad, jnp.float32))
    assert got.shape == kernel.shape == oracle.shape
    assert got.shape[1:4] == S.output_shape(shape, ks, strides, pad)
    np.testing.assert_allclose(got, kernel, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, oracle, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("dw_impl", ["pallas", "xla"])
@pytest.mark.parametrize("shape,ks,strides,name", GEOMS)
def test_weight_gradient_matches_jax(shape, ks, strides, name, dw_impl,
                                     monkeypatch):
    monkeypatch.setenv("VSN_STEM_DW", dw_impl)
    pad = tuple(k // 2 for k in ks)
    x, k = _setup(shape, ks, seed=1)

    def loss(kk):
        y = jstem.stem_conv_im2col(jnp.asarray(x), kk, strides, pad)
        return jnp.sum(jnp.sin(y.astype(jnp.float32)))

    want = np.asarray(jax.grad(loss)(jnp.asarray(k)))
    kt = torch.from_numpy(k).requires_grad_()
    xt = torch.from_numpy(x)  # the stem's input takes no gradient
    torch.sin(S.stem_conv_im2col(xt, kt, strides, pad)).sum().backward()
    assert xt.grad is None
    np.testing.assert_allclose(kt.grad.numpy(), want, rtol=5e-5,
                               atol=5e-5 * np.abs(want).max())


@pytest.mark.parametrize("shape,ks,strides,name", GEOMS[::3])
def test_dx_and_plain_dw_match_the_conv_vjp(shape, ks, strides, name):
    """dx (when x asks for one) is the plain conv's input gradient, and
    stem_dw_reference is the plain conv's weight gradient, as jax.vjp of
    _ref_conv gives them."""
    pad = tuple(k // 2 for k in ks)
    x, k = _setup(shape, ks, seed=2)
    y, vjp = jax.vjp(lambda xx, kk: jstem._ref_conv(xx, kk, strides, pad,
                                                    jnp.float32),
                     jnp.asarray(x), jnp.asarray(k))
    g = np.random.default_rng(3).standard_normal(y.shape).astype(np.float32)
    want_dx, want_dw = map(np.asarray, vjp(jnp.asarray(g)))
    xt = torch.from_numpy(x).requires_grad_()
    kt = torch.from_numpy(k).requires_grad_()
    S.stem_conv_im2col(xt, kt, strides, pad).backward(torch.from_numpy(g))
    for got, want in ((xt.grad, want_dx), (kt.grad, want_dw),
                      (S.stem_dw_reference(torch.from_numpy(x),
                                           torch.from_numpy(g), ks, strides,
                                           pad), want_dw)):
        np.testing.assert_allclose(got.numpy(), want, rtol=5e-5,
                                   atol=5e-5 * np.abs(want).max())


def test_bf16_forward_and_weight_gradient():
    ks, strides, pad = (7, 7, 7), (1, 2, 2), (3, 3, 3)
    x, k = _setup((12, 14, 12), ks, seed=2)
    want = np.asarray(jstem.stem_conv_im2col(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(k), strides, pad,
        dtype=jnp.bfloat16)).astype(np.float32)
    kt = torch.from_numpy(k).requires_grad_()
    got = S.stem_conv_im2col(torch.from_numpy(x).bfloat16(), kt, strides,
                             pad, dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().detach().numpy(), want, rtol=0,
                               atol=2e-2 * np.abs(want).max())
    g = np.random.default_rng(4).standard_normal(got.shape).astype(np.float32)
    got.backward(torch.from_numpy(g).bfloat16())
    _, vjp = jax.vjp(lambda kk: jstem.stem_conv_im2col(
        jnp.asarray(x, jnp.bfloat16), kk, strides, pad, dtype=jnp.bfloat16),
        jnp.asarray(k))
    want_dw = np.asarray(vjp(jnp.asarray(g, jnp.bfloat16))[0])
    assert kt.grad.dtype == torch.float32
    np.testing.assert_allclose(kt.grad.numpy(), want_dw, rtol=0,
                               atol=2e-2 * np.abs(want_dw).max())


GATE_CASES = [  # tests/test_stem_im2col.py:125-134
    ((1, 2, 2), (7, 7, 7), (3, 3, 3), 1),
    ((1, 2, 2), (7, 7, 7), (3, 3, 3), 2),
    ((1, 3, 2), (7, 7, 7), (3, 3, 3), 1),
    ((1, 2, 2), (7, 7, 6), (3, 3, 3), 1),
    ((1, 2, 2), (7, 7, 7), (3, 3, 2), 1),
    ((2, 2, 2), (9, 9, 9), (4, 4, 4), 1),
    ((2, 2, 2), (3, 3, 3), (1, 1, 1), 1),
]


def _sweep():
    for s in ((1, 1, 1), (1, 2, 2), (2, 2, 2), (2, 1, 1), (3, 1, 1)):
        for kd in (1, 3, 5, 7, 9, 15, 17):
            for k in ((kd, 3, 3), (kd, 5, 5), (kd, 7, 7), (kd, 9, 9),
                      (kd, 4, 5)):
                for c_in in (1, 2):
                    yield s, k, tuple(v // 2 for v in k), c_in
                yield s, k, (0, 0, 0), 1


@pytest.mark.parametrize("case", GATE_CASES)
def test_gate_equals_jax_on_its_cases(case):
    assert S.should_im2col(*case) == jstem.should_im2col(*case)


def test_gate_equals_jax_over_a_sweep():
    cases = list(_sweep())
    verdicts = [S.should_im2col(*c) for c in cases]
    assert verdicts == [jstem.should_im2col(*c) for c in cases]
    assert any(verdicts) and not all(verdicts)


def test_unfolded_conv_routes_to_the_stem_and_equals_the_plain_conv(
        monkeypatch):
    """UnfoldedConv takes stem_conv_im2col on the ResNet stem geometry (and
    the plain conv elsewhere), with the same result as the plain conv of its
    weight."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((2, 10, 12, 10, 1)).astype(
        np.float32))
    stem = UnfoldedConv(1, 8, (7, 7, 7), (1, 2, 2), (3, 3, 3))
    calls = []
    real = S.stem_conv_im2col
    monkeypatch.setattr("vsn_tpu_torch.ops.conv_unfold.stem_conv_im2col",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    got = stem(x)
    assert calls == [1]
    want = torch.nn.functional.conv3d(x.permute(0, 4, 1, 2, 3), stem.weight,
                                      stride=(1, 2, 2), padding=3)
    np.testing.assert_allclose(got.detach().numpy(),
                               want.permute(0, 2, 3, 4, 1).detach().numpy(),
                               rtol=2e-5, atol=2e-5)
    small = UnfoldedConv(1, 8, (3, 3, 3), (2, 2, 2), (1, 1, 1))
    assert small(x).shape == (2, 5, 6, 5, 8) and calls == [1]


def test_direct_calls_refuse_what_the_kernel_does_not_take():
    x = torch.zeros(1, 8, 8, 8, 1)
    with pytest.raises(ValueError):
        S.stem_conv_im2col(x, torch.zeros(7, 7, 6, 1, 8), (1, 2, 2),
                           (3, 3, 3))
    with pytest.raises(ValueError):
        S.stem_conv_im2col(x, torch.zeros(3, 3, 3, 1, 8), (1, 3, 2),
                           (1, 1, 1))
    with pytest.raises(ValueError):
        S.stem_conv_im2col(torch.zeros(1, 8, 8, 8, 2),
                           torch.zeros(3, 3, 3, 1, 8), (1, 1, 1), (1, 1, 1))
