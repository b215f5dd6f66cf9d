"""USE_PALLAS_ATTENTION off in the port against the JAX package's XLA path
on the CPU (vsn_tpu/models/swin3d.py:660-665, :726-749, :1581;
vsn_tpu/models/vit3d.py:238-257, :305-318, :535).

With the flag off every block of both models takes its unfused path, whose
attention is the XLA branch (``layers.softmax_attention``: the -100 region
mask, not K4's or K1's -1e9), in eval and in training: no kernel wrapper is
called. A tiny LayerNorm Swin (stage 1 shifted, stage 2 padded, stage 3
clamped) and a tiny ViT, f32 on both sides, with weights made by the JAX
initializer and saturated logits (qkv x 8 as the stabilizer tests of the
fused path, the bias table x 50, the head x 50; STOCHASTIC_DEPTH_PROB 0, so
no draws): eval logits, and the training loss and every parameter gradient,
within 1e-5 of the largest logit, the loss and each gradient's largest
value. With the flag on, the same models call their kernel wrappers.
"""

from unittest import mock

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vsn_tpu.config import load_config as jax_load_config
from vsn_tpu.models import build_model as jax_build_model
from vsn_tpu_torch.config import load_config
from vsn_tpu_torch.convert import state_dict_from_jax
from vsn_tpu_torch.models import build_model, swin3d, vit3d
from vsn_tpu_torch.ops import _build

TOL = 1e-5
MODELS = {
    "swin": (dict(IMG_SIZE=[12, 18, 12], PATCH_SHAPE=[2, 2, 2],
                  WINDOW_SIZE=[2, 3, 2], EMBED_DIM=8, DEPTH=[2, 2, 2],
                  HEADS=[1, 2, 4]), (12, 18, 12)),
    "vit": (dict(ARCHITECTURE="ViT", IMG_SIZE=[16, 16, 16],
                 RESHAPE_SIZE=False, PATCH_SHAPE=[4, 4, 4], EMBED_DIM=128,
                 DEPTH=2, HEADS=2), (16, 16, 16)),
}
COMMON = dict(FP16=False, STOCHASTIC_DEPTH_PROB=0.0)
WEIGHT_SCALE = {"qkv": 8.0, "relative_position_bias_table": 50.0,
                "head": 50.0}
WRAPPERS = {swin3d: ("attn_half", "ln_mlp", "window_attention_qkv",
                     "spatial_to_windows", "windows_to_windows",
                     "windows_to_spatial"),
            vit3d: ("attn_half", "ln_mlp")}


def _perturb(path, leaf, rng):
    names = [getattr(p, "key", "") for p in path]
    leaf = np.asarray(leaf)
    for name, k in WEIGHT_SCALE.items():
        if name in names and names[-1] != "bias":
            return leaf * k
    z = rng.standard_normal(leaf.shape).astype(np.float32)
    if names[-1] == "scale":
        return leaf + 0.2 * z
    if names[-1] == "bias":
        return leaf + 0.1 * z
    return leaf


def _setup(name, use_pallas=False):
    over, shape = MODELS[name]
    over = dict(over, **COMMON, USE_PALLAS_ATTENTION=use_pallas)
    jmodel = jax_build_model(jax_load_config(extra_overrides=over))
    x0 = np.zeros((1, *shape, 1), np.float32)
    variables = jax.jit(lambda k, x: jmodel.init(k, x, True))(
        jax.random.key(0), x0)
    rng = np.random.default_rng(1)
    variables = jax.tree_util.tree_map_with_path(
        lambda p, v: _perturb(p, v, rng), variables)
    model = build_model(load_config(over), device="cpu")
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    x = np.random.default_rng(2).standard_normal((2, *shape, 1)).astype(
        np.float32)
    return jmodel, variables, model, x


class _Calls:
    """Every kernel wrapper the models call, counted (the wrapper still
    runs: on CPU tensors its plain version)."""

    def __enter__(self):
        self.counts = {}
        self._patches = []
        for module, names in WRAPPERS.items():
            for n in names:
                real = getattr(module, n)

                def counted(*a, _real=real, _n=n, **kw):
                    self.counts[_n] = self.counts.get(_n, 0) + 1
                    return _real(*a, **kw)
                p = mock.patch.object(module, n, counted)
                p.start()
                self._patches.append(p)
        _build.launches.clear()
        return self

    def __exit__(self, *exc):
        for p in self._patches:
            p.stop()

    def total(self):
        return sum(self.counts.values()) + sum(_build.launches.values())


def _unfused(model):
    if hasattr(model, "fused"):
        return not model.fused() and all(
            blk.attn.xla_branch() for blk in model.blocks())
    return all(not blk.fused_attn() and not blk.fused_mlp()
               for blk in model.blocks())


@pytest.mark.parametrize("name", sorted(MODELS))
def test_flag_off_eval_logits_match_jax_xla_path(name):
    jmodel, variables, model, x = _setup(name)
    want = np.asarray(jax.jit(lambda v, xx: jmodel.apply(v, xx, True))(
        variables, x))
    assert _unfused(model)
    with _Calls() as calls, torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert calls.total() == 0, calls.counts
    scale = np.abs(want).max()
    assert scale > 1.0   # saturated: O(1) and larger logits
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * scale)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_flag_off_training_grads_match_jax_xla_path(name):
    jmodel, variables, model, x = _setup(name)
    ct = np.random.default_rng(3).standard_normal((2, 5)).astype(np.float32)

    def loss_fn(params, xx):
        logits = jmodel.apply({"params": params}, xx, False,
                              rngs={"dropout": jax.random.key(5)})
        return jnp.sum(logits * ct)

    want_loss, want_grads = jax.jit(jax.value_and_grad(loss_fn))(
        variables["params"], x)
    model.train()
    assert _unfused(model)
    with _Calls() as calls:
        loss = (model(torch.from_numpy(x), draws=[])
                * torch.from_numpy(ct)).sum()
        loss.backward()
    assert calls.total() == 0, calls.counts
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=TOL)
    want = state_dict_from_jax({"params": want_grads})
    got = dict(model.named_parameters())
    assert set(want) == set(got)
    for key, w in want.items():
        g, w = got[key].grad.numpy(), w.numpy()
        scale = np.abs(w).max()
        assert scale > 0, key
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL * scale,
                                   err_msg=key)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_flag_on_calls_the_kernel_wrappers(name):
    """The counter sees the fused path: with the flag on (the default),
    the same model calls K1 and K2 (Swin: and K3) in eval."""
    _, _, model, x = _setup(name, use_pallas=True)
    assert not _unfused(model)
    with _Calls() as calls, torch.no_grad():
        model(torch.from_numpy(x))
    assert calls.counts.get("attn_half", 0) == sum(
        1 for _ in model.blocks())
    assert calls.counts.get("ln_mlp", 0) == sum(1 for _ in model.blocks())
    assert calls.counts.get("window_attention_qkv", 0) == 0
