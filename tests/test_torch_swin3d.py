"""Whole-model parity: the port's Swin-3D against JAX ``build_model`` on CPU.

JAX's CPU forward is its unfused XLA path (the fused gate needs a TPU);
the port's CPU forward is the plain version of every kernel. Weights are
made once by the JAX initializer and carried over by
``convert.state_dict_from_jax``.

Tiny geometry that still has all three stage kinds of the flagship: stage
1 is 6x9x6 (divisible, shifted, window-resident), stage 2 is 3x5x3 (padded
to 4x6x4, shifted, pad tokens masked), stage 3 is 2x3x2 (window clamped to
the grid, unshifted).
"""

import numpy as np
import jax
import pytest
import torch

from vsn_tpu.config import load_config as jax_load_config
from vsn_tpu.models import build_model as jax_build_model
from vsn_tpu_torch.config import load_config
from vsn_tpu_torch.convert import state_dict_from_jax
from vsn_tpu_torch.models import build_model
from vsn_tpu_torch.models.swin3d import (
    clamp_window,
    padded_window_region_ids,
    shifted_window_region_ids,
    stage_dims,
)

TINY = dict(IMG_SIZE=[12, 18, 12], PATCH_SHAPE=[2, 2, 2],
            WINDOW_SIZE=[2, 3, 2], EMBED_DIM=8, DEPTH=[2, 2, 2],
            HEADS=[1, 2, 4], FP16=False)
# f32 on both sides; the paths differ in the order of sums, in the softmax
# shift (max(rowmax, 0) vs rowmax) and in the mask value (-1e9 vs -100:
# exp(-100) ~ 4e-44 is 0 against any real row), none above ~1e-6 here.
TOL = 1e-4


# Init-scale weights give near-uniform attention and logits of ~0.02, which
# would let a 1e-4 tolerance hide a wrong mask. These leaves are scaled so
# the attention is peaked, the bias matters and the logits are O(1).
WEIGHT_SCALE = {"qkv": 8.0, "relative_position_bias_table": 50.0,
                "head": 50.0}


def _scale(path, leaf):
    names = [getattr(p, "key", "") for p in path]
    for name, k in WEIGHT_SCALE.items():
        if name in names and names[-1] != "bias":
            return leaf * k
    return leaf


@pytest.fixture(scope="module")
def jax_variables():
    model = jax_build_model(jax_load_config(extra_overrides=TINY))
    x0 = np.zeros((1, 12, 18, 12, 1), np.float32)
    variables = jax.jit(lambda k, x: model.init(k, x, True))(
        jax.random.key(0), x0)
    return jax.tree_util.tree_map_with_path(
        lambda p, v: np.asarray(_scale(p, v)), variables)


def _volumes(n=2, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (n, 12, 18, 12, 1)).astype(np.float32)


def test_tiny_geometry_has_all_three_stage_kinds():
    grids = stage_dims(TINY["IMG_SIZE"], TINY["PATCH_SHAPE"], 3)
    assert grids == [(6, 9, 6), (3, 5, 3), (2, 3, 2)]
    win = tuple(TINY["WINDOW_SIZE"])
    half = tuple(w // 2 for w in win)
    assert clamp_window(grids[0], win, half) == (win, (1, 1, 1))
    assert clamp_window(grids[1], win, half) == (win, (1, 1, 1))
    assert clamp_window(grids[2], win, half) == ((2, 3, 2), (0, 0, 0))
    assert (padded_window_region_ids(grids[1], win, (1, 1, 1)) == -1).any()
    assert shifted_window_region_ids(grids[0], win, (1, 1, 1)).max() > 0


@pytest.mark.parametrize("shakedrop", [False, True])
def test_logits_match_jax(jax_variables, shakedrop):
    over = dict(TINY, USE_SHAKEDROP=shakedrop)
    jmodel = jax_build_model(jax_load_config(extra_overrides=over))
    x = _volumes()
    want = np.asarray(jax.jit(lambda v, xx: jmodel.apply(v, xx, True))(
        jax_variables, x))

    model = build_model(load_config(over), device="cpu")
    model.load_state_dict(state_dict_from_jax(jax_variables), strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 5)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_shakedrop_changes_eval_gains(jax_variables):
    """ShakeDrop's eval gain is 1 - p, not 1: the two recipes differ."""
    x = torch.from_numpy(_volumes(seed=1))
    outs = []
    for shakedrop in (False, True):
        model = build_model(load_config(dict(TINY, USE_SHAKEDROP=shakedrop)),
                            device="cpu")
        model.load_state_dict(state_dict_from_jax(jax_variables))
        with torch.no_grad():
            outs.append(model(x))
    assert not torch.allclose(outs[0], outs[1], atol=1e-6)


def test_converter_maps_every_leaf_and_key(jax_variables):
    sd = state_dict_from_jax(jax_variables)
    model = build_model(load_config(TINY), device="cpu")
    assert set(sd) == set(model.state_dict())
    bogus = {"params": dict(jax_variables["params"], extra={"kernel": 0})}
    with pytest.raises(KeyError):
        state_dict_from_jax(bogus)
    missing = dict(sd)
    missing.pop("head.bias")
    with pytest.raises(RuntimeError):
        model.load_state_dict(missing, strict=True)
    with pytest.raises(KeyError):
        state_dict_from_jax(dict(jax_variables, intermediates={}))


def test_training_forward_and_unported_options_raise():
    """Training runs the kernels' VJPs, with dropout the unfused blocks'
    (K4), with attention dropout the unfused blocks' XLA branch (no kernel;
    tests/test_torch_swin_attn_dropout.py holds it to JAX); the unported
    options raise; the stabilizer options build and train."""
    x = torch.zeros(1, 12, 18, 12, 1)
    model = build_model(load_config(TINY), device="cpu").train()
    model(x, generator=torch.Generator().manual_seed(0)).sum().backward()
    with pytest.raises(ValueError):
        model(x)   # stochastic depth draws need a generator or draws
    model = build_model(load_config(dict(TINY, DROPOUT=0.1)),
                        device="cpu").train()
    model(x, generator=torch.Generator().manual_seed(0)).sum().backward()
    model = build_model(load_config(dict(TINY, ATTENTION_DROPOUT=0.1)),
                        device="cpu").train()
    assert not model.fused()
    model(x, generator=torch.Generator().manual_seed(0)).sum().backward()
    for key in ("POST_NORM", "LAYER_SCALE", "ENABLE_STABLE"):
        model = build_model(load_config(dict(TINY, **{key: True})),
                            device="cpu").train()
        out = model(x, generator=torch.Generator().manual_seed(0))
        assert out.shape == (1, 5) and bool(torch.isfinite(out).all())
        out.sum().backward()
    with pytest.raises(ValueError):
        build_model(load_config(dict(TINY, NORM_LAYER="GroupNorm")),
                    device="cpu")
    with pytest.raises(NotImplementedError):   # a stub in the JAX package
        build_model(load_config(dict(TINY, ARCHITECTURE="SwinDPL")),
                    device="cpu")
    with pytest.raises(NotImplementedError):   # the JAX CPU oracle mode
        build_model(load_config(dict(TINY, FP64=True)), device="cpu")


GEOMETRY = [  # (dims, window, shift): divisible, padded, clamped-like
    ((6, 9, 6), (2, 3, 2), (1, 1, 1)),
    ((9, 11, 9), (6, 7, 6), (3, 3, 3)),
    ((3, 5, 3), (2, 3, 2), (0, 0, 0)),
]


@pytest.mark.parametrize("dims,window,shift", GEOMETRY)
def test_region_ids_and_bias_table_match_jax(dims, window, shift):
    from vsn_tpu.models import swin3d as jswin
    from vsn_tpu_torch.models import swin3d

    np.testing.assert_array_equal(
        swin3d.padded_window_region_ids(dims, window, shift),
        jswin.padded_window_region_ids(dims, window, shift))
    if all(d % w == 0 for d, w in zip(dims, window)):
        np.testing.assert_array_equal(
            swin3d.shifted_window_region_ids(dims, window, shift),
            jswin.shifted_window_region_ids(dims, window, shift))
    np.testing.assert_array_equal(swin3d.relative_position_index(window),
                                  jswin.relative_position_index(window))
    heads = 3
    table = np.random.default_rng(0).standard_normal(
        ((2 * window[0] - 1) * (2 * window[1] - 1) * (2 * window[2] - 1),
         heads)).astype(np.float32)
    want = np.asarray(jswin.expand_bias_table(table, window))
    index = torch.from_numpy(swin3d.relative_position_index(window))
    got = swin3d.expand_bias_table(torch.from_numpy(table), index)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("rate,shakedrop", [(0.0, True), (0.3, True),
                                            (0.3, False)])
def test_eval_residual_gains_match_jax(rate, shakedrop):
    from vsn_tpu.models.layers import residual_branch_gains as jgains
    from vsn_tpu.models.layers import gated_residual as jgated
    from vsn_tpu_torch.models.layers import gated_residual, residual_branch_gains

    want = jgains(3, rate, shakedrop, (-1.0, 1.0), True, None)
    got = residual_branch_gains(3, rate, shakedrop)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    rng = np.random.default_rng(1)
    x, br = (rng.standard_normal((3, 4, 5)).astype(np.float32)
             for _ in range(2))
    np.testing.assert_allclose(
        gated_residual(torch.from_numpy(x), torch.from_numpy(br), got[0],
                       got[1], 0.5).detach().numpy(),
        np.asarray(jgated(x, br, want[0], want[1], 0.5)), rtol=1e-6,
        atol=1e-6)


def test_draw_gives_the_training_gains_in_draw_order():
    """``draw`` hands forward(draws=) the pairs a training forward would
    draw from the same generator, in the same order."""
    model = build_model(load_config(TINY), device="cpu").train()
    gains = model.residual_gains(2, "cpu", torch.Generator().manual_seed(3))
    want = [pair for blk, g in zip(model.blocks(), gains)
            if blk.drop_path_rate > 0.0 for pair in (g[:2], g[2:])]
    got = model.draw(2, "cpu", torch.Generator().manual_seed(3))
    assert len(got) == len(want) == model.num_draws() > 0
    for (gf, gb), (wf, wb) in zip(got, want):
        assert torch.equal(gf, wf) and torch.equal(gb, wb)
