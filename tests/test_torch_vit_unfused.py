"""ViT-3D's unfused halves against the JAX package on the CPU (where the JAX
ViT always takes its XLA blocks, vsn_tpu/models/vit3d.py ViTAttention
:52-123 and ViTBlock :198-236): eval logits, and the training forward's
loss and every parameter gradient, for

* DynamicTanh and RMSNorm (both halves unfused; DynamicTanh with
  STOCHASTIC_DEPTH_PROB 0.2, its DropPath gains injected on both sides);
* HEADS 2 at EMBED_DIM 96 (2 x 64 != 96: an unfused attention half with a
  projection beside the fused K2 MLP half, whose plain version runs here);
* HEADS 1 at EMBED_DIM 64 (dim_head = C: no ``proj``, then K2);
* LayerNorm with DROPOUT 0.2 (embedding, MLP: both halves unfused in
  training) and with ATTENTION_DROPOUT 0.2 (probabilities and proj: the
  unfused attention half and K2), the keep masks captured from the JAX
  forward and injected through ``draws=``.

A tiny ViT (16^3 input, patch 4: 65 tokens with the CLS; depth 2), f32 on
both sides, with weights made by the JAX initializer, made non-trivial
(peaked attention: qkv x 8; O(1) logits; norm parameters and biases away
from their init) and carried over by ``convert.state_dict_from_jax``.
JAX's dropout masks are sown by an interceptor on every ``nn.Dropout`` of
rate > 0 under jit (mask = output != 0 where the input is not 0; a zero
input is a don't-care), in call order: the embedding, then per block the
probabilities, proj, fc1-GELU, fc2 (the port's ``draw_plan`` order with the
gains between them); JAX's DropPath is replaced at ``vsn_tpu.models.layers.
drop_path`` by the injected gains, in call order.

Tolerance 1e-4, relative to the largest logit, the loss, or each
gradient's largest value: the same f32 function up to the order of sums
(K2's plain version and the JAX MLP half differ only there).
"""

from unittest import mock

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from flax import linen as nn

from vsn_tpu.config import load_config as jax_load_config
from vsn_tpu.models import build_model as jax_build_model
from vsn_tpu.models import layers as jlayers
from vsn_tpu_torch.config import load_config
from vsn_tpu_torch.convert import jax_params_from_state_dict, state_dict_from_jax
from vsn_tpu_torch.models import build_model

TINY = dict(ARCHITECTURE="ViT", IMG_SIZE=[16, 16, 16], RESHAPE_SIZE=False,
            PATCH_SHAPE=[4, 4, 4], EMBED_DIM=128, DEPTH=2, HEADS=2,
            FP16=False, STOCHASTIC_DEPTH_PROB=0.0)
TOL = 1e-4
CASES = {  # name -> (overrides, attention half fused in training, MLP half)
    "dyt": (dict(NORM_LAYER="DynamicTanh", STOCHASTIC_DEPTH_PROB=0.2),
            False, False),
    "rmsnorm": (dict(NORM_LAYER="RMSNorm"), False, False),
    "heads2_c96": (dict(EMBED_DIM=96, HEADS=2), False, True),
    "heads1_no_proj": (dict(EMBED_DIM=64, HEADS=1), False, True),
    "ln_dropout": (dict(DROPOUT=0.2), False, False),
    "ln_attention_dropout": (dict(ATTENTION_DROPOUT=0.2), False, True),
}
GAINS = [np.array([1.25, 0.0], np.float32), np.array([0.0, 1.25], np.float32)]


def _perturb(path, leaf, rng):
    names = [getattr(p, "key", "") for p in path]
    leaf = np.asarray(leaf)
    if names[-1] == "kernel" and ("qkv" in names or "head" in names):
        return leaf * (8.0 if "qkv" in names else 50.0)
    z = rng.standard_normal(leaf.shape).astype(np.float32)
    if names[-1] == "alpha":
        return np.float32(1.5) + 0.2 * z
    if names[-1] in ("scale", "gamma"):
        return leaf + 0.2 * z
    if names[-1] in ("bias", "beta"):
        return leaf + 0.1 * z
    return leaf


def _setup(over):
    over = dict(TINY, **over)
    jmodel = jax_build_model(jax_load_config(extra_overrides=over))
    x0 = np.zeros((1, 16, 16, 16, 1), np.float32)
    variables = jax.jit(lambda k, x: jmodel.init(k, x, True))(
        jax.random.key(0), x0)
    rng = np.random.default_rng(1)
    variables = jax.tree_util.tree_map_with_path(
        lambda p, v: _perturb(p, v, rng), variables)
    model = build_model(load_config(over), device="cpu")
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    return jmodel, variables, model


def _injected_drop_path():
    """vsn_tpu.models.layers.drop_path replaced by the branch times the next
    of GAINS, in call order (block 1's res1, res2)."""
    it = iter(GAINS)

    def drop_path(x, rate, deterministic, rng):
        g = jnp.asarray(next(it)).reshape((x.shape[0],) + (1,) * (x.ndim - 1))
        return (x * g).astype(x.dtype)
    return drop_path


def _jax_loss_grads_masks(jmodel, variables, x, ct):
    """The JAX training loss, its gradients and the keep masks of its
    dropouts of rate > 0 in call order."""
    rngs = {"dropout": jax.random.key(5)}
    order = []

    def interceptor(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        mod = context.module
        if (isinstance(mod, nn.Dropout) and context.method_name == "__call__"
                and mod.rate > 0):
            if mod.path not in order:
                order.append(mod.path)
            mod.sow("intermediates", "keep", (out != 0) | (args[0] == 0))
        return out

    def loss_fn(params, xx):
        with nn.intercept_methods(interceptor):
            logits, sown = jmodel.apply({"params": params}, xx, False,
                                        rngs=rngs, mutable=["intermediates"])
        return jnp.sum(logits * ct), sown.get("intermediates", {})

    with mock.patch.object(jlayers, "drop_path", _injected_drop_path()):
        (loss, sown), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(variables["params"], x)
    masks = []
    for path in order:
        node = sown
        for part in path:
            node = node[part]
        masks.append(np.array(node["keep"][0]))
    return loss, grads, masks


def _draws(model, masks):
    """The port's draws in ``draw_plan`` order: JAX's masks, and GAINS as
    (gf, gb) pairs where a block draws gains."""
    masks, gains = iter(masks), iter(GAINS)
    out = []
    for key, shape in model.draw_plan(2):
        if shape is None:
            g = torch.from_numpy(next(gains))
            out.append((g, g))
        else:
            m = next(masks)
            assert m.shape == tuple(shape), key
            out.append(torch.from_numpy(m))
    assert next(masks, None) is None
    assert sum(isinstance(d, tuple) for d in out) in (0, len(GAINS))
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_eval_and_training_match_jax(case):
    over, attn_fused, mlp_fused = CASES[case]
    jmodel, variables, model = _setup(over)
    x = np.random.default_rng(0).standard_normal(
        (2, 16, 16, 16, 1)).astype(np.float32)
    want = np.asarray(jax.jit(lambda v, xx: jmodel.apply(v, xx, True))(
        variables, x))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    scale = np.abs(want).max()
    assert scale > 0.5   # O(1) logits: the tolerance bites
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * scale)

    model.train()
    blk = model.blocks()[0]
    assert (blk.fused_attn(), blk.fused_mlp()) == (attn_fused, mlp_fused)
    x = np.random.default_rng(2).standard_normal(
        (2, 16, 16, 16, 1)).astype(np.float32)
    ct = np.random.default_rng(3).standard_normal((2, 5)).astype(np.float32)
    want_loss, want_grads, masks = _jax_loss_grads_masks(jmodel, variables,
                                                         x, ct)
    if over.get("DROPOUT") or over.get("ATTENTION_DROPOUT"):
        kept = float(np.mean([m.mean() for m in masks]))
        assert masks and 0.7 < kept < 0.9
    logits = model(torch.from_numpy(x), draws=_draws(model, masks))
    loss = (logits * torch.from_numpy(ct)).sum()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=TOL)
    want = state_dict_from_jax({"params": want_grads})
    got = dict(model.named_parameters())
    assert set(want) == set(got)
    for name, w in want.items():
        g, w = got[name].grad.numpy(), w.numpy()
        w_scale = np.abs(w).max()
        assert w_scale > 0, name
        np.testing.assert_allclose(g, w, rtol=0, atol=TOL * w_scale,
                                   err_msg=name)


def test_each_half_is_gated_on_its_own():
    """The gates of vsn_tpu/models/vit3d.py:238-257 and :305-318 (less the
    platform and VMEM clauses), mode by mode."""
    expect = {  # case -> ((attn, mlp) in eval, (attn, mlp) in training)
        "dyt": ((False, False), (False, False)),
        "heads2_c96": ((False, True), (False, True)),
        "heads1_no_proj": ((False, True), (False, True)),
        "ln_dropout": ((True, True), (False, False)),
        "ln_attention_dropout": ((True, True), (False, True)),
    }
    for case, (ev, tr) in expect.items():
        model = build_model(load_config(dict(TINY, **CASES[case][0])),
                            device="cpu")
        for mode, want in ((False, ev), (True, tr)):
            model.train(mode)
            blk = model.blocks()[1]
            assert (blk.fused_attn(), blk.fused_mlp()) == want, (case, mode)


def test_heads1_has_no_projection_and_the_tree_round_trips():
    """heads = 1 with dim_head = C: no ``to_out`` in the port and no
    ``attn/proj`` in the JAX tree; the converter maps each onto the other
    and back exactly."""
    _, variables, model = _setup(CASES["heads1_no_proj"][0])
    names = set(model.state_dict())
    assert not any("to_out" in k for k in names)
    assert "proj" not in variables["params"]["block0"]["attn"]
    sd = state_dict_from_jax(variables)
    assert set(sd) == names
    back = jax_params_from_state_dict(sd)
    flat_in = jax.tree_util.tree_leaves_with_path(variables)
    flat_out = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_in) == len(flat_out)
    for path, leaf in flat_in:
        np.testing.assert_array_equal(flat_out[path], leaf)
