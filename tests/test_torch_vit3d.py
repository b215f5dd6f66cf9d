"""The port's ViT-3D against the JAX package's ``ViT3D`` on the CPU.

A tiny ViT (16^3 input, patch 4: 64 patches and the CLS token, N = 65;
embed 128, depth 2, 2 heads of 64, MLP 512), f32 on both sides, with
weights made by the JAX initializer, made non-trivial (peaked attention,
O(1) logits, norm parameters and biases away from their init) and carried
over by ``convert.state_dict_from_jax``. Two JAX references:

* its XLA path (USE_PALLAS_ATTENTION off: ViTAttention's einsum softmax and
  the ResidualBranch / Mlp modules);
* its fused path (``_fused_attn_half`` / ``_fused_mlp_half``: the Pallas
  kernels of vsn_tpu/ops/swin_block_kernels.py in interpret mode), under
  ``tests/test_swin_block_kernels.py::_ForceTpu``, as tests/test_vit3d.py
  runs it.

Eval logits, and the training forward's loss and every parameter gradient
with the DropPath gains injected on both sides (STOCHASTIC_DEPTH_PROB 0.2:
block 1 draws, block 0 has rate 0): JAX's threefry draws cannot be
reproduced, so the JAX gains are replaced at ``vsn_tpu.models.layers``
(``drop_path`` on the XLA path, ``residual_branch_gains`` on the fused
path) by the ones the port gets through ``draws=``. The port runs the plain
versions of K1 (attention at d = 64) and K2 here.

Tolerance 1e-4, relative to the largest logit, the loss, or each
gradient's largest value. The XLA path normalizes p before the PV product
and shifts by the plain row max; K1 shifts by max(rowmax, 0) and scales the
[N, d] output by 1 / sum: the same function up to f32 rounding.
"""

from unittest import mock

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tests.test_swin_block_kernels import _ForceTpu
from vsn_tpu.config import load_config as jax_load_config
from vsn_tpu.models import build_model as jax_build_model
from vsn_tpu.models import layers as jlayers
from vsn_tpu.ops import swin_block_kernels as jsbk
from vsn_tpu_torch.config import PRESETS, load_config
from vsn_tpu_torch.convert import jax_params_from_state_dict, state_dict_from_jax
from vsn_tpu_torch.models import build_model
from vsn_tpu_torch.models.vit3d import ViT3D, init_weights

TINY = dict(ARCHITECTURE="ViT", IMG_SIZE=[16, 16, 16], RESHAPE_SIZE=False,
            PATCH_SHAPE=[4, 4, 4], EMBED_DIM=128, DEPTH=2, HEADS=2,
            FP16=False, STOCHASTIC_DEPTH_PROB=0.2)
TOL = 1e-4
WEIGHT_SCALE = {"qkv": 8.0, "head": 50.0}


def _perturb(path, leaf, rng):
    names = [getattr(p, "key", "") for p in path]
    leaf = np.asarray(leaf)
    for name, k in WEIGHT_SCALE.items():
        if name in names and names[-1] == "kernel":
            return leaf * k
    z = rng.standard_normal(leaf.shape).astype(np.float32)
    if names[-1] == "scale":
        return leaf + 0.2 * z
    if names[-1] == "bias":
        return leaf + 0.1 * z
    return leaf


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_load_config(extra_overrides=dict(TINY,
                                                USE_PALLAS_ATTENTION=False))
    jmodel = jax_build_model(jcfg)
    fused = jax_build_model(jax_load_config(extra_overrides=TINY))
    assert not jmodel.use_pallas and fused.use_pallas
    x0 = np.zeros((1, 16, 16, 16, 1), np.float32)
    variables = jax.jit(lambda k, x: jmodel.init(k, x, True))(
        jax.random.key(0), x0)
    rng = np.random.default_rng(1)
    variables = jax.tree_util.tree_map_with_path(
        lambda p, v: _perturb(p, v, rng), variables)
    model = build_model(load_config(TINY), device="cpu")
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    return jmodel, fused, variables, model


def _volumes(seed):
    return np.random.default_rng(seed).standard_normal(
        (2, 16, 16, 16, 1)).astype(np.float32)


def test_model_is_the_fused_vit_with_the_reference_names(setup):
    _, _, variables, model = setup
    assert isinstance(model, ViT3D)
    assert [b.drop_path_rate for b in model.blocks()] == [0.0, 0.2]
    assert model.num_draws() == 2
    names = set(model.state_dict())
    for key in ("to_patch_embedding.1.weight", "to_patch_embedding.2.bias",
                "to_patch_embedding.3.weight", "pos_embedding", "cls_token",
                "transformer.layers.1.0.norm.bias",
                "transformer.layers.1.0.to_qkv.weight",
                "transformer.layers.1.0.to_out.0.weight",
                "transformer.layers.1.1.net.0.weight",
                "transformer.layers.1.1.net.1.bias",
                "transformer.layers.1.1.net.4.weight", "mlp_head.0.weight",
                "mlp_head.1.bias"):
        assert key in names, key
    assert "transformer.layers.0.0.to_qkv.bias" not in names
    assert model.pos_embedding.shape == (1, 65, 128)
    n_jax = sum(np.asarray(v).size for v in jax.tree.leaves(variables))
    assert sum(p.numel() for p in model.parameters()) == n_jax


def test_eval_logits_match_both_jax_paths(setup):
    jmodel, fused, variables, model = setup
    x = _volumes(0)
    want = np.asarray(jax.jit(lambda v, xx: jmodel.apply(v, xx, True))(
        variables, x))
    calls = []
    real = jsbk.fused_attn_half

    def counted(*args, **kwargs):
        calls.append(args[0].shape)
        return real(*args, **kwargs)

    with _ForceTpu(), mock.patch.object(jsbk, "fused_attn_half", counted):
        want_fused = np.asarray(fused.apply(variables, x, True))
    assert calls == [(2, 65, 128)] * 2   # one K1 call a block, N = 65
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    scale = np.abs(want).max()
    assert scale > 0.5   # O(1) logits: the tolerance bites
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * scale)
    np.testing.assert_allclose(got, want_fused, rtol=0, atol=TOL * scale)


GAINS = [np.array([1.25, 0.5], np.float32), np.array([0.75, 1.5], np.float32)]


def _injected_drop_path(gains):
    """vsn_tpu.models.layers.drop_path replaced by the branch times the next
    injected per-sample gain (the XLA path's DropPath)."""
    it = iter(gains)

    def drop_path(x, rate, deterministic, rng):
        g = jnp.asarray(next(it)).reshape((x.shape[0],) + (1,) * (x.ndim - 1))
        return (x * g).astype(x.dtype)
    return drop_path


def _injected_gains(gains):
    """vsn_tpu.models.layers.residual_branch_gains replaced by the next
    injected (gf, gb) pair where the rate draws (the fused path)."""
    it = iter(gains)
    real = jlayers.residual_branch_gains

    def residual_branch_gains(n, rate, use_shakedrop, alpha_range,
                              deterministic, rng):
        if rate == 0.0 or deterministic:
            return real(n, rate, use_shakedrop, alpha_range, deterministic,
                        rng)
        g = jnp.asarray(next(it))
        return g, g
    return residual_branch_gains


def _jax_loss_and_grads(jmodel, variables, x, ct, fused):
    rngs = {"dropout": jax.random.key(5)}

    def loss_fn(params):
        logits = jmodel.apply({"params": params}, x, False, rngs=rngs)
        return jnp.sum(logits * ct)

    if fused:
        with _ForceTpu(), mock.patch.object(jlayers, "residual_branch_gains",
                                            _injected_gains(GAINS)):
            return jax.value_and_grad(loss_fn)(variables["params"])
    with mock.patch.object(jlayers, "drop_path", _injected_drop_path(GAINS)):
        return jax.jit(jax.value_and_grad(loss_fn))(variables["params"])


@pytest.mark.parametrize("path", ["xla", "fused"])
def test_training_loss_and_grads_match_jax(setup, path):
    jmodel, fused, variables, model = setup
    x = _volumes(2)
    ct = np.random.default_rng(3).standard_normal((2, 5)).astype(np.float32)
    want_loss, want_grads = _jax_loss_and_grads(
        fused if path == "fused" else jmodel, variables, x, ct,
        path == "fused")
    model.train()
    model.zero_grad()
    draws = [(torch.from_numpy(g), torch.from_numpy(g)) for g in GAINS]
    logits = model(torch.from_numpy(x), draws=draws)
    loss = (logits * torch.from_numpy(ct)).sum()
    loss.backward()
    model.eval()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=TOL)
    want = state_dict_from_jax({"params": want_grads})
    got = dict(model.named_parameters())
    assert set(want) == set(got)
    for name, w in want.items():
        g, w = got[name].grad.numpy(), w.numpy()
        scale = np.abs(w).max()
        assert scale > 0, name
        np.testing.assert_allclose(g, w, rtol=0, atol=TOL * scale,
                                   err_msg=name)


def test_gains_reach_the_blocks(setup):
    """The injected gains move the loss (a model that dropped them would
    pass the gradient test only by luck) and a training forward without
    draws or a generator refuses to run."""
    *_, model = setup
    x = torch.from_numpy(_volumes(2))
    model.train()
    try:
        ones = [(torch.ones(2), torch.ones(2))] * 2
        draws = [(torch.from_numpy(g), torch.from_numpy(g)) for g in GAINS]
        with torch.no_grad():
            a, b = model(x, draws=ones), model(x, draws=draws)
        assert (a - b).abs().max() > 1e-2
        with pytest.raises(ValueError):
            model(x)
        got = model.draw(2, torch.device("cpu"),
                         torch.Generator().manual_seed(0))
        assert len(got) == 2 and all(len(p) == 2 for p in got)
        keep = 1 - 0.2
        for gf, gb in got:
            assert torch.equal(gf, gb)
            assert set(gf.tolist()) <= {0.0, 1 / keep}
    finally:
        model.eval()


def test_converter_round_trips_the_vit_tree(setup):
    _, _, variables, model = setup
    sd = state_dict_from_jax(variables)
    assert set(sd) == set(model.state_dict())
    back = jax_params_from_state_dict(sd)
    flat_in = jax.tree_util.tree_leaves_with_path(variables)
    flat_out = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_in) == len(flat_out)
    for path, leaf in flat_in:
        np.testing.assert_array_equal(flat_out[path], leaf)


@pytest.mark.parametrize("name", ["vit-5c-no_seed-baseline",
                                  "vit-3c-no_seed-baseline"])
def test_presets_build_vit_s(name):
    """ViT-S at the presets' full size (12 blocks of 384, 6 heads of 64,
    MLP 1536, 144x160x144 / 16^3 + CLS = 811 tokens), built on the meta
    device; the parameter count equals the JAX model's."""
    cfg = load_config(preset=name)
    assert name in PRESETS and cfg.input_size == (144, 160, 144)
    with torch.device("meta"):
        model = build_model(cfg, device="meta")
    assert len(model.blocks()) == 12
    attn = model.blocks()[0][0]
    assert (attn.heads, attn.dim_head) == (6, 64)
    assert model.blocks()[0][1].net[1].weight.shape == (1536, 384)
    assert model.pos_embedding.shape == (1, 811, 384)
    assert model.dtype == torch.bfloat16
    assert model.mlp_head[1].out_features == cfg.num_classes
    jm = jax_build_model(jax_load_config(extra_overrides=dict(
        ARCHITECTURE="ViT", RESHAPE_SIZE=[144, 160, 144],
        PATCH_SHAPE=[16, 16, 16], EMBED_DIM=384, DEPTH=12, HEADS=6,
        DISEASES=cfg.DISEASES)))
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.key(0), jnp.ones((1, 144, 160, 144, 1)), True))
    n_jax = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    assert sum(p.numel() for p in model.parameters()) == n_jax


def test_init_weights_follow_the_jax_initializers():
    model = build_model(load_config(TINY), device="cpu")
    init_weights(model, torch.Generator().manual_seed(0))
    qkv = model.blocks()[0][0].to_qkv.weight
    assert 0.015 < qkv.std() < 0.025 and qkv.abs().max() <= 0.04
    assert abs(model.pos_embedding.std() - 1.0) < 0.05
    assert model.blocks()[0][0].to_out[0].bias.abs().max() == 0
    assert torch.equal(model.mlp_head[0].weight, torch.ones(128))


@pytest.mark.parametrize("over, match", [
    (dict(NORM_LAYER="DynamicTanh"), "NORM_LAYER"),
    (dict(HEADS=3), "dim_head"),
])
def test_unported_options_raise(over, match):
    """The options the fused slice refused (``match``: a norm other than
    LayerNorm, heads * dim_head != C) now build and run the unfused
    attention half (tests/test_torch_vit_unfused.py holds them to JAX);
    FP64, the JAX package's CPU oracle mode, still raises."""
    model = build_model(load_config(dict(TINY, **over)), device="cpu")
    assert not model.blocks()[0].fused_attn()
    assert model.blocks()[0].fused_mlp() == (match != "NORM_LAYER")
    with torch.no_grad():
        out = model(torch.zeros(1, 16, 16, 16, 1))
    assert out.shape == (1, 5) and bool(torch.isfinite(out).all())
    with pytest.raises(NotImplementedError, match="FP64"):
        build_model(load_config(dict(TINY, FP64=True, **over)), device="cpu")


@pytest.mark.parametrize("key", ["POST_NORM", "LAYER_SCALE",
                                 "ENABLE_STABLE"])
def test_stabilizer_options_build_and_run(key):
    """Each stabilizer option builds and runs an eval and a training
    forward and backward on the CPU (tests/test_torch_stabilizers_vit.py
    holds them to JAX)."""
    model = build_model(load_config(dict(TINY, **{key: True})), device="cpu")
    x = torch.randn(2, 16, 16, 16, 1, generator=torch.Generator()
                    .manual_seed(0))
    with torch.no_grad():
        out = model(x)
    assert out.shape == (2, 5) and bool(torch.isfinite(out).all())
    model.train()
    model(x, generator=torch.Generator().manual_seed(1)).sum().backward()
    assert all(p.grad is not None for p in model.parameters())


@pytest.mark.parametrize("key", ["DROPOUT", "ATTENTION_DROPOUT"])
def test_training_with_dropout_raises_and_eval_runs(key):
    """Eval keeps the fused halves; a training forward takes the unfused
    attention half (and, with DROPOUT, the unfused MLP half), runs with a
    generator and raises without one or injected draws."""
    model = build_model(load_config(dict(TINY, **{key: 0.1})), device="cpu")
    x = torch.zeros(1, 16, 16, 16, 1)
    with torch.no_grad():
        assert model(x).shape == (1, 5)
    assert model.blocks()[0].fused_attn() and model.blocks()[0].fused_mlp()
    model.train()
    assert not model.blocks()[0].fused_attn()
    assert model.blocks()[0].fused_mlp() == (key == "ATTENTION_DROPOUT")
    with pytest.raises(ValueError, match="generator"):
        model(x)
    model(x, generator=torch.Generator().manual_seed(0)).sum().backward()
    assert all(p.grad is not None for p in model.parameters())
