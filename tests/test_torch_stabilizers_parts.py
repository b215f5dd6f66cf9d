"""The pieces of the stabilizer options that need no kernel: DeepScaleLM's
gains and inits (``ops/stable_init.py`` against vsn_tpu/ops/stable_init.py,
and ``init_weights`` under ENABLE_STABLE), the converter's LayerScale and
post-norm rules, and the LayerScale gamma in the train state (no weight
decay, carried by the EMA).
"""

import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vsn_tpu.config import load_config as jax_load_config
from vsn_tpu.models import build_model as jax_build_model
from vsn_tpu.ops import stable_init as jstable
from vsn_tpu_torch.config import load_config
from vsn_tpu_torch.convert import (
    jax_params_from_state_dict,
    state_dict_from_jax,
)
from vsn_tpu_torch.models import build_model
from vsn_tpu_torch.models.swin3d import init_weights as swin_init
from vsn_tpu_torch.models.vit3d import init_weights as vit_init
from vsn_tpu_torch.ops import stable_init
from vsn_tpu_torch.train.step import init_train_state

SWIN = dict(IMG_SIZE=[12, 18, 12], PATCH_SHAPE=[2, 2, 2],
            WINDOW_SIZE=[2, 3, 2], EMBED_DIM=32, DEPTH=[2, 2], HEADS=[1, 2],
            FP16=False)
VIT = dict(ARCHITECTURE="ViT", IMG_SIZE=[16, 16, 16], RESHAPE_SIZE=False,
           PATCH_SHAPE=[4, 4, 4], EMBED_DIM=128, DEPTH=2, HEADS=2, FP16=False)
ALL = dict(LAYER_SCALE=True, POST_NORM=True, ENABLE_STABLE=True)


@pytest.mark.parametrize("n, k, alpha", [(12, 2.0, 1.0), (4, 2.0, 1.0),
                                         (2, 4.0, 1.0), (24, 1.0, 0.5)])
def test_gains_and_stds_match_jax(n, k, alpha):
    assert stable_init.compute_residual_gains(n, k, alpha) == \
        jstable.compute_residual_gains(n, k, alpha)
    for d, p in ((96, 0.0), (384, 0.1)):
        assert stable_init.stable_embedding_std(d, p, 2) == \
            jstable.stable_embedding_std(d, p, 2)
        assert stable_init.stable_qk_std(d) == jstable.stable_qk_std(d)
        assert stable_init.stable_vproj_std(d, p) == \
            jstable.stable_vproj_std(d, p)


def test_flagship_depth_gives_the_paper_gains():
    lam, beta = stable_init.compute_residual_gains(12)
    assert math.isclose(beta ** 2, 2 / 12) and math.isclose(lam, 0.9128709,
                                                            rel_tol=1e-6)


def test_column_wise_qkv_init_matches_the_jax_layout():
    """q and k rows at 1/sqrt(d_in), v rows at the V std: the torch [3C, C]
    form of stable_qkv_init's column scale over [C, 3C]."""
    c, p = 64, 0.1
    w = stable_init.stable_qkv_init_(torch.empty(3 * c, c), c, p,
                                     torch.Generator().manual_seed(0))
    want = np.asarray(jstable.stable_qkv_init(c, p)(
        jax.random.key(0), (c, 3 * c))).T
    for part in range(3):
        got_std = w[part * c:(part + 1) * c].std().item()
        want_std = want[part * c:(part + 1) * c].std()
        assert abs(got_std / want_std - 1) < 0.05, part
    with pytest.raises(ValueError):
        stable_init.stable_qkv_init_(torch.empty(3 * c, c + 1), c, p,
                                     torch.Generator())


def _std_close(t, want, what):
    got = t.detach().std().item()
    assert abs(got / want - 1) < 0.1, f"{what}: std {got} vs {want}"


def test_swin_init_weights_under_enable_stable():
    model = build_model(load_config(dict(SWIN, ENABLE_STABLE=True,
                                         LAYER_SCALE=True, DROPOUT=0.1,
                                         ATTENTION_DROPOUT=0.2)),
                        device="cpu")
    swin_init(model, torch.Generator().manual_seed(0))
    sd = jstable
    _std_close(model.backbone.patch_embed.proj.weight,
               sd.stable_embedding_std(8, 0.1), "patch embed")
    for blk in model.blocks():
        c = blk.attn.proj.weight.shape[0]
        qkv = blk.attn.qkv.weight
        _std_close(qkv[:2 * c], sd.stable_qk_std(c), "q, k")
        _std_close(qkv[2 * c:], sd.stable_vproj_std(c, 0.2), "v")
        for name, layer in (("proj", blk.attn.proj), ("fc1", blk.mlp[0]),
                            ("fc2", blk.mlp[3])):
            _std_close(layer.weight, sd.stable_vproj_std(c, 0.1), name)
            assert not layer.bias.any()
        for res in (blk.res1, blk.res2):
            assert torch.equal(res.gamma, torch.full((c,), 0.1))
    assert 0.015 < model.head.weight.std() < 0.025   # trunc-normal 0.02


def test_vit_init_weights_under_enable_stable():
    model = build_model(load_config(dict(VIT, ENABLE_STABLE=True,
                                         DROPOUT=0.1,
                                         ATTENTION_DROPOUT=0.2)),
                        device="cpu")
    vit_init(model, torch.Generator().manual_seed(0))
    sd, c = jstable, 128
    _std_close(model.to_patch_embedding[2].weight,
               sd.stable_embedding_std(64, 0.1), "patch projection")
    for blk in model.blocks():
        qkv = blk[0].to_qkv.weight
        _std_close(qkv[:2 * c], sd.stable_qk_std(c), "q, k")
        _std_close(qkv[2 * c:], sd.stable_vproj_std(c, 0.2), "v")
        _std_close(blk[0].to_out[0].weight, sd.stable_vproj_std(c, 0.2),
                   "proj")
        for layer in (blk[1].net[1], blk[1].net[4]):
            _std_close(layer.weight, sd.stable_vproj_std(c, 0.1), "mlp")
    assert model.lam == pytest.approx(0.0) and model.beta == 1.0  # depth 2


def _round_trip(over, x_shape):
    jmodel = jax_build_model(jax_load_config(extra_overrides=over))
    variables = jax.jit(lambda k, x: jmodel.init(k, x, True))(
        jax.random.key(0), jnp.zeros(x_shape))
    variables = jax.tree.map(np.asarray, variables)
    sd = state_dict_from_jax(variables)
    model = build_model(load_config(over), device="cpu")
    model.load_state_dict(sd, strict=True)
    back = jax_params_from_state_dict(model.state_dict())
    flat_in = jax.tree_util.tree_leaves_with_path(variables)
    flat_out = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_in) == len(flat_out)
    for path, leaf in flat_in:
        np.testing.assert_array_equal(flat_out[path], leaf)
    return sd


def test_converter_round_trips_swin_gamma():
    sd = _round_trip(dict(SWIN, **ALL), (1, 12, 18, 12, 1))
    assert "backbone.layers.1.blocks.1.res2.gamma" in sd
    assert "backbone.layers.0.blocks.0.norm1.weight" in sd


def test_converter_round_trips_vit_gamma_and_post_norms():
    sd = _round_trip(dict(VIT, **ALL), (1, 16, 16, 16, 1))
    for key in ("transformer.layers.1.res1.gamma",
                "transformer.layers.0.attn_norm.weight",
                "transformer.layers.0.ff_norm.bias"):
        assert key in sd, key
    assert not any(k.startswith("transformer.layers.0.0.norm")
                   or k.startswith("transformer.layers.0.1.net.0")
                   for k in sd)


def test_gamma_takes_no_weight_decay_and_rides_the_ema():
    cfg = load_config(dict(SWIN, LAYER_SCALE=True, USE_EMA=True))
    model = build_model(cfg, device="cpu")
    state = init_train_state(cfg, model)
    names = state.params.names
    gammas = [i for i, n in enumerate(names) if n.endswith(".gamma")]
    assert len(gammas) == 2 * len(model.blocks())
    masks = state.params.views(state.params.decay_mask)
    for i in gammas:
        assert not masks[i].any(), names[i]
    qkv = names.index("backbone.layers.0.blocks.0.attn.qkv.weight")
    assert masks[qkv].all()
    # the EMA vector covers the flat parameters, gammas included
    p = state.params.flat.numel()
    assert state.ema.ema.numel() >= p
    ema_gammas = state.params.views(state.ema.ema[:p])
    for i in gammas:
        assert torch.equal(ema_gammas[i], torch.full_like(ema_gammas[i],
                                                          0.1))
