"""Swin-3D training with ATTENTION_DROPOUT > 0 against the JAX package on
the CPU: the unfused block's XLA attention branch (vsn_tpu/models/
swin3d.py:677-712, the port's ``WindowAttention3D.attention``), the
training loss and every parameter gradient with the JAX keep masks
injected through ``draws=``.

The tiny geometry of tests/test_torch_swin_unfused.py: stage 1 divisible
and shifted, stage 2 padded (pad tokens with id -1), stage 3 clamped to the
grid and unshifted. Weights are made by the JAX initializer, made
non-trivial (peaked attention: qkv x 8 and the bias table x 50, so the -100
region mask and the bias both move the softmax; O(1) logits) and carried
over by ``convert.state_dict_from_jax``.

The masks are captured with ``flax.linen.intercept_methods`` on every
``nn.Dropout.__call__`` of rate > 0, in call order (per block: the
attention probabilities, then proj, fc1-GELU, fc2 with DROPOUT > 0; the
patch embed's first): mask = output != 0 where the input is not 0. A
probability can underflow to exactly 0 at a -100-masked entry; there the
mask is a don't-care (the output and the gradient through it are 0 either
way), taken as kept. That order is the port's ``draw_plan`` order when no
block draws residual gains (STOCHASTIC_DEPTH_PROB 0: JAX's threefry draws
cannot be reproduced).

Tolerance 1e-4 (rtol and atol; gradients relative to each gradient's
scale), f32 on both sides: the branch masks with -100 on both sides, so
what is left is the order of sums.
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
from vsn_tpu_torch.convert import state_dict_from_jax
from vsn_tpu_torch.models import build_model
from vsn_tpu_torch.models import layers
from vsn_tpu_torch.models.swin3d import init_weights

TINY = dict(IMG_SIZE=[12, 18, 12], PATCH_SHAPE=[2, 2, 2],
            WINDOW_SIZE=[2, 3, 2], EMBED_DIM=8, DEPTH=[2, 2, 2],
            HEADS=[1, 2, 4], FP16=False, STOCHASTIC_DEPTH_PROB=0.0)
TOL = 1e-4
RATE = 0.2
WEIGHT_SCALE = {"qkv": 8.0, "relative_position_bias_table": 50.0,
                "head": 50.0}
CASES = {  # name -> (NORM_LAYER, DROPOUT, ATTENTION_DROPOUT)
    "layernorm": ("nn.LayerNorm", 0.0, RATE),
    "dyt_dropout": ("DynamicTanh", RATE, RATE),
}


def _perturb(path, leaf, rng):
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


def _setup(norm, dropout, attention_dropout):
    over = dict(TINY, NORM_LAYER=norm, DROPOUT=dropout,
                ATTENTION_DROPOUT=attention_dropout)
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


def _port_model():
    """The LayerNorm + ATTENTION_DROPOUT model with the port's own init."""
    model = build_model(load_config(dict(TINY, ATTENTION_DROPOUT=RATE)),
                        device="cpu")
    return init_weights(model, torch.Generator().manual_seed(0))


def _jax_masks(jmodel, variables, x, rngs):
    """The keep masks of every dropout of rate > 0 in one JAX training
    forward, in call order (sown by an interceptor under jit, so that the
    forward is not run op by op), and the share of zero inputs of each;
    zero inputs count as kept (a don't-care)."""
    order = []

    def interceptor(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        mod = context.module
        if (isinstance(mod, nn.Dropout) and context.method_name == "__call__"
                and mod.rate > 0):
            order.append(mod.path)
            mod.sow("intermediates", "keep", (out != 0) | (args[0] == 0))
            mod.sow("intermediates", "zeros", jnp.mean(args[0] == 0))
        return out

    def run(v, xx):
        with nn.intercept_methods(interceptor):
            return jmodel.apply(v, xx, False, rngs=rngs,
                                mutable=["intermediates"])[1]

    sown = jax.jit(run)(variables, x)["intermediates"]
    masks, zeros = [], []
    for path in order:
        node = sown
        for part in path:
            node = node[part]
        masks.append(np.array(node["keep"][0]))
        zeros.append(float(node["zeros"][0]))
    return masks, zeros


@pytest.mark.parametrize("case", sorted(CASES))
def test_training_loss_and_grads_match_jax(case):
    norm, drop, attn = CASES[case]
    jmodel, variables, model = _setup(norm, drop, attn)
    model.train()
    assert not model.fused()
    assert all(blk.attn.xla_branch() for blk in model.blocks())
    x = np.random.default_rng(2).standard_normal(
        (2, 12, 18, 12, 1)).astype(np.float32)
    ct = np.random.default_rng(3).standard_normal((2, 5)).astype(np.float32)
    rngs = {"dropout": jax.random.key(5), "shakedrop": jax.random.key(6)}

    def loss_fn(params, xx):
        logits = jmodel.apply({"params": params}, xx, False, rngs=rngs)
        return jnp.sum(logits * ct)

    want_loss, want_grads = jax.jit(jax.value_and_grad(loss_fn))(
        variables["params"], x)
    masks, zeros = _jax_masks(jmodel, variables, x, rngs)
    plan = model.draw_plan(2)
    assert len(masks) == len(plan) == (6 if drop == 0 else 1 + 4 * 6)
    for (key, shape), m in zip(plan, masks):
        assert tuple(shape) == m.shape, key
    attn_masks = [m for (key, _), m in zip(plan, masks) if key[1] == "attn"]
    # [B*nW, heads, N, N]: stage 1 (2 x 27 windows, 1 head, N = 12), stage
    # 2 padded (2 x 8 windows), stage 3 clamped (2 x 1 window of 12)
    assert [m.shape for m in attn_masks[::2]] == [
        (54, 1, 12, 12), (16, 2, 12, 12), (2, 4, 12, 12)]
    kept = float(np.mean([m.mean() for m in attn_masks]))
    assert 0.7 < kept < 0.9
    assert max(zeros) < 0.5   # underflowed probabilities: masked pairs only
    draws = [torch.from_numpy(m) for m in masks]
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


def test_masks_reach_the_probabilities_and_eval_keeps_the_fused_path():
    """The attention masks move the loss (a branch that dropped them would
    pass the gradient test only by luck); eval runs the fused kernels (the
    deterministic clause of fused_block_gate) and a training forward with
    no generator or draws raises; the drawn masks keep about 1 - rate."""
    model = _port_model()
    assert model.fused()
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, 12, 18, 12, 1)).astype(np.float32))
    model.train()
    with pytest.raises(ValueError):
        model(x)
    drawn = model.draw(2, torch.device("cpu"), torch.Generator().manual_seed(0))
    ones = [torch.ones_like(m) for m in drawn]
    with torch.no_grad():
        a, b = model(x, draws=ones), model(x, draws=drawn)
    assert (a - b).abs().max() > 1e-3
    share = torch.cat([m.reshape(-1) for m in drawn]).float().mean()
    assert abs(float(share) - (1 - RATE)) < 0.02
    assert [key[1] for key, _ in model.draw_plan(2)] == ["attn"] * 6


def test_branch_masks_at_minus_100_and_matches_k4_unmasked():
    """The branch on one padded, shifted stage-2 call: with no keep mask it
    equals K4's plain version wherever the -100 region mask and K4's -1e9
    agree to f32 (logits O(1)), and the region mask is -100, not -1e9."""
    model = _port_model()
    layer = model.backbone.layers[1]
    blk, ids = layer.blocks[1], layer.ids_shift
    assert (ids < 0).any() and any(blk.shift)
    g = torch.Generator().manual_seed(0)
    qkv = torch.randn(2 * layer.n_windows, layer.n_tokens, 3 * layer.dim,
                      generator=g)
    got = blk.attn.attention(qkv, ids)
    from vsn_tpu_torch.ops.window_attention import window_attention_qkv
    want = window_attention_qkv(qkv, blk.attn.bias(), ids, blk.attn.scale,
                                blk.num_heads)
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(),
                               rtol=1e-5, atol=1e-5)
    mask = layers.region_mask(ids)
    assert set(mask.unique().tolist()) == {0.0, -100.0}
