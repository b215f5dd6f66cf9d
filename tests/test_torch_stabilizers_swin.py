"""The port's Swin-3D with the stabilizer options (LAYER_SCALE, POST_NORM,
ENABLE_STABLE and all three) against the JAX package on the CPU, fused
blocks: the port's K1/K2 plain versions with gamma and post-norm in band,
against JAX's fused path (the Pallas kernels of
vsn_tpu/ops/swin_block_kernels.py in interpret mode, under
``tests/test_swin_block_kernels.py::_ForceTpu``). The unfused blocks are
tests/test_torch_stabilizers_swin_unfused.py's.

Two tiny geometries: a two-stage Swin whose stages both divide by the
window (4x6x4 shifted, then 2x3x2 clamped: the window-resident path), and,
for all three options together, one whose second stage is padded (6x9x6,
then 3x5x3 padded to 4x6x4: the blocks' spatial path, against JAX's packed
layout, DEVIATIONS #1). Weights from the JAX initializer (the stable inits
under ENABLE_STABLE), made non-trivial (peaked attention at a fixed qkv
scale, O(1) logits, norm parameters, biases and LayerScale gammas away
from their init) and carried over by ``convert.state_dict_from_jax``. No
stochastic depth (no random draws); under ENABLE_STABLE the gains are beta
and the residual x-gain lam = sqrt(1 - 2 / 4). Eval logits, and the
training forward's loss and every parameter gradient, gamma included, to
1e-4 of each one's scale, f32 on both sides.
"""

import contextlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tests.test_swin_block_kernels import _ForceTpu
from vsn_tpu.config import load_config as jax_load_config
from vsn_tpu.models import build_model as jax_build_model
from vsn_tpu_torch.config import load_config
from vsn_tpu_torch.convert import state_dict_from_jax
from vsn_tpu_torch.models import build_model

TINY = dict(IMG_SIZE=[8, 12, 8], PATCH_SHAPE=[2, 2, 2],
            WINDOW_SIZE=[2, 3, 2], EMBED_DIM=8, DEPTH=[2, 2], HEADS=[1, 2],
            FP16=False, STOCHASTIC_DEPTH_PROB=0.0)
PADDED = dict(TINY, IMG_SIZE=[12, 18, 12])
OPTIONS = {
    "layer_scale": dict(LAYER_SCALE=True),
    "post_norm": dict(POST_NORM=True),
    "stable": dict(ENABLE_STABLE=True),
    "all": dict(LAYER_SCALE=True, POST_NORM=True, ENABLE_STABLE=True),
}
TOL = 1e-4
WEIGHT_SCALE = {"relative_position_bias_table": 50.0, "head": 50.0}
QKV_STD = 0.16   # 8x the default init's 0.02: peaked, not saturated


def perturb(path, leaf, rng):
    """Peaked attention (qkv at std QKV_STD, whatever the init: the stable
    init's 1/sqrt(d) times 8 would saturate the logits past the XLA path's
    -100 mask, DEVIATIONS #2), O(1) logits, and every norm parameter, bias
    and LayerScale gamma away from its init, so each one matters (a
    constant gamma would hide a transposed index)."""
    names = [getattr(p, "key", "") for p in path]
    leaf = np.asarray(leaf)
    if "qkv" in names and names[-1] == "kernel":
        return leaf * np.float32(QKV_STD / leaf.std())
    for name, k in WEIGHT_SCALE.items():
        if name in names and names[-1] != "bias":
            return leaf * k
    z = rng.standard_normal(leaf.shape).astype(np.float32)
    if "LayerScale_0" in names:
        return np.float32(0.5) + 0.1 * z
    if names[-1] == "alpha":
        return np.float32(1.5) + 0.2 * z
    if names[-1] in ("gamma", "scale"):
        return leaf + 0.2 * z
    if names[-1] in ("beta", "bias"):
        return leaf + 0.1 * z
    return leaf


def _volumes(shape, seed):
    return np.random.default_rng(seed).standard_normal(
        (2, *shape, 1)).astype(np.float32)


def _close(got, want, what):
    scale = float(np.abs(want).max())
    assert scale > 0, what
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * scale,
                               err_msg=what)


def check_against_jax(over, fused):
    """Eval logits, loss and every gradient of the port's model of ``over``
    against JAX's (``fused``: JAX's fused path under _ForceTpu)."""
    jmodel = jax_build_model(jax_load_config(extra_overrides=over))
    shape = tuple(over["IMG_SIZE"])
    variables = jax.jit(lambda k, x: jmodel.init(k, x, True))(
        jax.random.key(0), np.zeros((1, *shape, 1), np.float32))
    rng = np.random.default_rng(1)
    variables = jax.tree_util.tree_map_with_path(
        lambda p, v: perturb(p, v, rng), variables)
    model = build_model(load_config(over), device="cpu")
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    blk = model.blocks()[0]
    assert (blk.res1 is not None) == bool(over.get("LAYER_SCALE"))
    assert blk.post_norm == bool(over.get("POST_NORM"))
    assert blk.lam == (np.sqrt(0.5) if over.get("ENABLE_STABLE") else 1.0)
    assert model.fused() == fused

    x, ct = _volumes(shape, 0), np.random.default_rng(3).standard_normal(
        (2, 5)).astype(np.float32)
    rngs = {"dropout": jax.random.key(5), "shakedrop": jax.random.key(6)}

    def loss_fn(params):
        logits = jmodel.apply({"params": params}, x, False, rngs=rngs)
        return jnp.sum(logits * ct)

    evaluate = jax.jit(lambda v: jmodel.apply(v, x, True))
    grad_fn = jax.jit(jax.value_and_grad(loss_fn))
    with _ForceTpu() if fused else contextlib.nullcontext():
        want = np.asarray(evaluate(variables))
        want_loss, want_grads = grad_fn(variables["params"])

    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert np.abs(want).max() > 0.1   # O(1) logits: the tolerance bites
    _close(got, want, "eval logits")

    model.train()
    logits = model(torch.from_numpy(x))
    loss = (logits * torch.from_numpy(ct)).sum()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=TOL)
    want_sd = state_dict_from_jax({"params": want_grads})
    params = dict(model.named_parameters())
    assert set(want_sd) == set(params)
    for name, w in want_sd.items():
        _close(params[name].grad.numpy(), w.numpy(), name)


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_fused_swin_option_matches_jax(option):
    geometry = PADDED if option == "all" else TINY
    check_against_jax(dict(geometry, **OPTIONS[option]), fused=True)
