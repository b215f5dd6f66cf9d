"""The unfused Swin-3D block path (K4 attention) against the JAX package on
the CPU: a tiny Swin with DynamicTanh and with RMSNorm norms, eval logits
and the training forward's loss and every parameter gradient; and training
with DROPOUT > 0 (LayerNorm and DynamicTanh), whose keep masks are taken
from the JAX forward and injected into the port through ``draws=``.

The tiny geometry has the three stage kinds of tests/test_torch_swin3d.py:
stage 1 divisible and shifted, stage 2 padded (pad tokens masked with id
-1), stage 3 clamped to the grid and unshifted. Weights are made once by
the JAX initializer, made non-trivial (peaked attention, O(1) logits, DyT
alpha and RMSNorm scales away from their init) and carried over by
``convert.state_dict_from_jax``.

The JAX masks are captured with ``flax.linen.intercept_methods`` on every
``nn.Dropout.__call__`` of rate > 0, in call order (patch embed, then per
block proj, fc1-GELU, fc2): mask = output != 0, which holds because no
input of a dropout is exactly 0 (asserted). That order is the port's
``draw_plan`` order when no block draws residual gains
(STOCHASTIC_DEPTH_PROB 0 here: JAX's threefry draws cannot be reproduced).

Tolerance 1e-4 (rtol and atol; gradients relative to each gradient's
scale), f32 on both sides. On the CPU the JAX model takes its XLA
attention branch, which masks with -100 (DEVIATIONS #2), while the port
runs K4's plain version, which masks with -1e9: exp(-100) ~ 4e-44 against
a row's largest term, so the gap at these logits is below 1e-6; the rest
is the order of sums.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from flax import linen as nn

from vsn_tpu.config import load_config as jax_load_config
from vsn_tpu.models import build_model as jax_build_model
from vsn_tpu_torch.config import load_config
from vsn_tpu_torch.convert import jax_params_from_state_dict, state_dict_from_jax
from vsn_tpu_torch.models import build_model

TINY = dict(IMG_SIZE=[12, 18, 12], PATCH_SHAPE=[2, 2, 2],
            WINDOW_SIZE=[2, 3, 2], EMBED_DIM=8, DEPTH=[2, 2, 2],
            HEADS=[1, 2, 4], FP16=False, STOCHASTIC_DEPTH_PROB=0.0)
TOL = 1e-4
WEIGHT_SCALE = {"qkv": 8.0, "relative_position_bias_table": 50.0,
                "head": 50.0}


def _perturb(path, leaf, rng):
    """Peaked attention and O(1) logits (as tests/test_torch_swin3d.py
    scales them); norm parameters and biases away from their init so each
    one matters (and no dropout input is exactly 0: a zero bias maps the
    zero pad tokens to 0)."""
    names = [getattr(p, "key", "") for p in path]
    leaf = np.asarray(leaf)
    for name, k in WEIGHT_SCALE.items():
        if name in names and names[-1] != "bias":
            return leaf * k
    z = rng.standard_normal(leaf.shape).astype(np.float32)
    if names[-1] == "alpha":
        return np.float32(1.5) + 0.2 * z
    if names[-1] in ("gamma", "scale") and "norm" in "".join(names):
        return leaf + 0.2 * z
    if names[-1] in ("beta", "bias"):
        return leaf + 0.1 * z
    return leaf


def _setup(norm, dropout):
    over = dict(TINY, NORM_LAYER=norm, DROPOUT=dropout)
    jmodel = jax_build_model(jax_load_config(extra_overrides=over))
    x0 = np.zeros((1, 12, 18, 12, 1), np.float32)
    variables = jax.jit(lambda k, x: jmodel.init(k, x, True))(
        jax.random.key(0), x0)
    rng = np.random.default_rng(1)
    variables = jax.tree_util.tree_map_with_path(
        lambda p, v: _perturb(p, v, rng), variables)
    model = build_model(load_config(over), device="cpu")
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    return jmodel, variables, model


def _volumes(seed=0):
    return np.random.default_rng(seed).standard_normal(
        (2, 12, 18, 12, 1)).astype(np.float32)


@pytest.mark.parametrize("norm", ["DynamicTanh", "RMSNorm"])
def test_eval_logits_match_jax(norm):
    jmodel, variables, model = _setup(norm, 0.0)
    assert not model.fused()
    x = _volumes()
    want = np.asarray(jax.jit(lambda v, xx: jmodel.apply(v, xx, True))(
        variables, x))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert np.abs(want).max() > 0.1   # O(1) logits: the tolerance bites
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def _jax_masks(jmodel, variables, x, rngs):
    """The keep masks of every dropout of rate > 0 in one JAX training
    forward, in call order."""
    masks = []

    def interceptor(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        mod = context.module
        if (isinstance(mod, nn.Dropout) and context.method_name == "__call__"
                and mod.rate > 0):
            inp, got = np.asarray(args[0]), np.asarray(out)
            assert (inp != 0).all()   # so output != 0 is the keep mask
            masks.append(got != 0)
        return out

    with nn.intercept_methods(interceptor):
        jmodel.apply(variables, x, False, rngs=rngs)
    return masks


CASES = {  # name -> (NORM_LAYER, DROPOUT)
    "dyt": ("DynamicTanh", 0.0),
    "rmsnorm": ("RMSNorm", 0.0),
    "layernorm_dropout": ("nn.LayerNorm", 0.2),
    "dyt_dropout": ("DynamicTanh", 0.2),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_training_loss_and_grads_match_jax(case):
    norm, rate = CASES[case]
    jmodel, variables, model = _setup(norm, rate)
    model.train()
    assert not model.fused()      # every block takes the unfused path
    x = _volumes(seed=2)
    ct = np.random.default_rng(3).standard_normal((2, 5)).astype(np.float32)
    rngs = {"dropout": jax.random.key(5), "shakedrop": jax.random.key(6)}

    def loss_fn(params, xx):
        logits = jmodel.apply({"params": params}, xx, False, rngs=rngs)
        return jnp.sum(logits * ct)

    want_loss, want_grads = jax.jit(jax.value_and_grad(loss_fn))(
        variables["params"], x)
    masks = _jax_masks(jmodel, variables, x, rngs) if rate > 0 else []
    assert len(masks) == model.num_draws() == (1 + 3 * 6 if rate > 0 else 0)
    draws = [torch.from_numpy(m) for m in masks]
    if rate > 0:
        assert 0.6 < float(np.mean([m.mean() for m in masks])) < 0.95

    logits = model(torch.from_numpy(x), draws=draws)
    loss = (logits * torch.from_numpy(ct)).sum()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=TOL)
    want = state_dict_from_jax({"params": want_grads})
    got = dict(model.named_parameters())
    assert set(want) == set(got)
    for name, w in want.items():
        g, w = got[name].grad.numpy(), w.numpy()
        scale = np.abs(w).max()
        assert scale > 0, name
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL * scale,
                                   err_msg=name)


def test_layernorm_eval_keeps_the_fused_path():
    """DROPOUT > 0 gates only training forwards: a LayerNorm model in eval
    runs the fused kernels, as fused_block_gate's deterministic clause."""
    model = build_model(load_config(dict(TINY, DROPOUT=0.2)), device="cpu")
    assert model.fused()
    assert not model.train().fused()
    with pytest.raises(ValueError):   # dropout draws need a generator
        model(torch.zeros(1, 12, 18, 12, 1))
    dyt = build_model(load_config(dict(TINY, NORM_LAYER="DynamicTanh")),
                      device="cpu")
    assert not dyt.fused() and dyt.num_draws() == 0


@pytest.mark.parametrize("norm", ["DynamicTanh", "RMSNorm"])
def test_converter_round_trips_the_norm_leaves(norm):
    """Every leaf of the JAX tree, DyT's 0-d alpha, gamma, beta and
    RMSNorm's scale included, maps onto a port key and back exactly."""
    _, variables, model = _setup(norm, 0.0)
    sd = state_dict_from_jax(variables)
    assert set(sd) == set(model.state_dict())
    names = {k.rsplit(".", 1)[-1] for k in sd}
    assert names >= ({"alpha", "gamma", "beta"} if norm == "DynamicTanh"
                     else {"weight"})
    back = jax_params_from_state_dict(sd)
    flat_in = jax.tree_util.tree_leaves_with_path(variables)
    flat_out = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_in) == len(flat_out)
    for path, leaf in flat_in:
        np.testing.assert_array_equal(flat_out[path], leaf)
