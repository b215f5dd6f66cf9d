"""The port's RMSNorm and DynamicTanh against the JAX package's
(vsn_tpu/models/layers.py:27-60), in value and gradient, f32 and bf16, and
``make_norm``'s mapping of the NORM_LAYER strings.

Inputs, parameters and cotangents are made from numpy seeds and given to
both sides. Tolerances: f32 1e-5 (rtol and atol), the rounding of the f32
statistics; bf16 outputs 2e-2 of their scale (both sides compute in f32 and
round once to bf16; a result on a rounding boundary can land on the
neighbouring bf16 value, 2^-8 relative), bf16 gradients of the f32
parameters 2e-2 of their scale for the same reason.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vsn_tpu.models import layers as jlayers
from vsn_tpu_torch.models import layers

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
C = 24


def _close(got, want, dtype, name):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert np.isfinite(got).all(), name
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5,
                                   err_msg=name)
    else:
        err = np.abs(got - want).max()
        assert err <= TOL[dtype] * np.abs(want).max(), (name, err)


def _data(seed):
    rng = np.random.default_rng(seed)
    x = (2.0 * rng.standard_normal((3, 5, C)) + 0.3).astype(np.float32)
    g = rng.standard_normal((3, 5, C)).astype(np.float32)
    return x, g, rng


def _params(name, rng):
    """JAX parameters (a tree) made non-trivial, and the port's names."""
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    if name == "RMSNorm":
        return {"scale": 1.0 + 0.3 * f(C)}, {"scale": "weight"}
    return ({"alpha": np.float32(0.7), "gamma": 1.0 + 0.3 * f(C),
             "beta": 0.3 * f(C)},
            {"alpha": "alpha", "gamma": "gamma", "beta": "beta"})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["RMSNorm", "DynamicTanh"])
def test_norm_value_and_grads_match_jax(name, dtype):
    x, g, rng = _data(seed=len(name) + len(dtype))
    params, names = _params(name, rng)
    jdt = getattr(jnp, dtype)
    jmod = getattr(jlayers, name)(dtype=jdt)

    def fn(p, xx):
        return jmod.apply({"params": p}, xx)

    jparams = jax.tree.map(jnp.asarray, params)
    out, vjp = jax.vjp(fn, jparams, jnp.asarray(x).astype(jdt))
    dp, dx = vjp(jnp.asarray(g).astype(jdt))

    mod = layers.make_norm(name, C)
    assert type(mod).__name__ == name
    with torch.no_grad():
        for k, v in params.items():
            getattr(mod, names[k]).copy_(torch.from_numpy(np.asarray(v)))
    xt = torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_()
    y = mod(xt)
    assert y.dtype == xt.dtype
    y.backward(torch.from_numpy(g).to(y.dtype))
    _close(y.detach().float(), out.astype(jnp.float32), dtype, "out")
    _close(xt.grad.float(), dx.astype(jnp.float32), dtype, "dx")
    for k in params:
        p = getattr(mod, names[k])
        assert p.dtype == torch.float32 and p.shape == np.shape(params[k])
        _close(p.grad, dp[k], dtype, k)


def test_make_norm_maps_the_config_strings():
    assert isinstance(layers.make_norm("nn.LayerNorm", C), layers.LayerNorm)
    assert isinstance(layers.make_norm(None, C), layers.LayerNorm)
    dyt = layers.make_norm("DynamicTanh", C)
    assert dyt.alpha.shape == () and dyt.alpha.item() == 0.5
    assert torch.equal(layers.make_norm("RMSNorm", C).weight, torch.ones(C))
    with pytest.raises(ValueError):
        layers.make_norm("BatchNorm", C)


def test_dropout_on_an_explicit_mask_is_flax_dropout():
    """where(mask, x / keep, 0) in x's dtype, and the identity without a
    mask; the mask comes from the generator passed in."""
    x = torch.randn(4, 6, generator=torch.Generator().manual_seed(0))
    m1 = layers.dropout_mask((4, 6), 0.25, torch.Generator().manual_seed(1),
                             "cpu")
    m2 = layers.dropout_mask((4, 6), 0.25, torch.Generator().manual_seed(1),
                             "cpu")
    assert m1.dtype == torch.bool and torch.equal(m1, m2)
    got = layers.dropout(x.bfloat16(), 0.25, m1)
    assert got.dtype == torch.bfloat16
    want = torch.where(m1, x.bfloat16() / 0.75, 0.0)
    assert torch.equal(got, want)
    assert layers.dropout(x, 0.25, None) is x
