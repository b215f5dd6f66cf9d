"""Whole tiny models at head dims above 128 against the JAX package on the
CPU: eval logits, the training loss and every parameter gradient, f32.

On the card the key-tiled body takes a head dim above 128 in slabs
(``csrc/attn_tiled.cuh``, the slab kernels); on the CPU the port's models
run the kernels' plain versions (tests/test_torch_attn_wide_heads.py holds
them to the JAX kernels one by one).

- A tiny Swin at EMBED_DIM 136, HEADS [1, 1] (d = 136, then 272 at the
  padded second stage) against JAX's fused path (its Pallas kernels in
  interpret mode), to 1e-4 of each one's scale:
  tests/test_torch_stabilizers_swin.py's check.
- A tiny ViT of 2 heads of 144 (embed 288) against JAX's ``ViT3D`` at
  ``dim_head=144``, its XLA and its fused path, likewise at 1e-4
  (tests/test_torch_vit3d.py). The configs give ViT no such head: the
  reference fixes ``dim_head`` at 64 (vsn_tpu/models/vit3d.py:399) and
  ``vit_from_config`` passes none, so both models are built directly; a
  config's HEADS that do not divide EMBED_DIM into heads of 64 take JAX's
  unfused blocks, which the port does not carry (ROADMAP Queue 1).
"""

import contextlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tests.test_swin_block_kernels import _ForceTpu
from tests.test_torch_stabilizers_swin import check_against_jax
from vsn_tpu.models.vit3d import ViT3D as JaxViT3D
from vsn_tpu_torch.convert import state_dict_from_jax
from vsn_tpu_torch.models.vit3d import ViT3D

SWIN_WIDE = dict(IMG_SIZE=[12, 18, 12], PATCH_SHAPE=[2, 2, 2],
                 WINDOW_SIZE=[2, 3, 2], DEPTH=[2, 2], FP16=False,
                 STOCHASTIC_DEPTH_PROB=0.0)


def test_tiny_swin_with_heads_above_128_matches_jax():
    """A two-stage Swin of one head a stage at EMBED_DIM 136, stage 1 6x9x6
    shifted (d = 136), stage 2 3x5x3 padded to 4x6x4 (d = 272): eval
    logits, the training loss and every parameter gradient against JAX's
    fused path (its Pallas kernels in interpret mode)."""
    check_against_jax(dict(SWIN_WIDE, EMBED_DIM=136, HEADS=[1, 1]), True)


VIT_WIDE = dict(img_size=(16, 16, 16), patch_size=(4, 4, 4), num_classes=5,
                embed_dim=288, depth=2, num_heads=2, dim_head=144,
                mlp_dim=576)
VIT_TOL = 1e-4
VIT_SCALE = {"qkv": 4.0, "head": 50.0}


def _vit_variables(jmodel):
    """JAX's init, made non-trivial as tests/test_torch_vit3d.py does
    (peaked attention, O(1) logits, norm parameters and biases away from
    their init)."""
    variables = jax.jit(lambda k, x: jmodel.init(k, x, True))(
        jax.random.key(0), np.zeros((1, 16, 16, 16, 1), np.float32))
    rng = np.random.default_rng(1)

    def perturb(path, leaf):
        names = [getattr(p, "key", "") for p in path]
        leaf = np.asarray(leaf)
        for name, k in VIT_SCALE.items():
            if name in names and names[-1] == "kernel":
                return leaf * np.float32(k)
        z = rng.standard_normal(leaf.shape).astype(np.float32)
        if names[-1] == "scale":
            return leaf + 0.2 * z
        if names[-1] == "bias":
            return leaf + 0.1 * z
        return leaf
    return jax.tree_util.tree_map_with_path(perturb, variables)


def _vit_close(got, want, what):
    scale = float(np.abs(want).max())
    assert scale > 0, what
    np.testing.assert_allclose(got, want, rtol=0, atol=VIT_TOL * scale,
                               err_msg=what)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "xla"])
def test_tiny_vit_with_heads_above_128_matches_jax(fused):
    """A ViT of 2 heads of 144 (N = 65): eval logits, the training loss and
    every parameter gradient against JAX's ViT3D at the same dim_head,
    fused (Pallas in interpret mode) or XLA."""
    jmodel = JaxViT3D(**VIT_WIDE, use_pallas=fused)
    variables = _vit_variables(jmodel)
    model = ViT3D(**VIT_WIDE)
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    attn = model.blocks()[0][0]
    assert (attn.heads, attn.dim_head) == (2, 144)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 16, 16, 16, 1)).astype(np.float32)
    ct = rng.standard_normal((2, 5)).astype(np.float32)

    def loss_fn(params):
        logits = jmodel.apply({"params": params}, x, False,
                              rngs={"dropout": jax.random.key(5)})
        return jnp.sum(logits * ct)

    with _ForceTpu() if fused else contextlib.nullcontext():
        want = np.asarray(jmodel.apply(variables, x, True))
        want_loss, want_grads = jax.value_and_grad(loss_fn)(
            variables["params"])
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert np.abs(want).max() > 0.5   # O(1) logits: the tolerance bites
    _vit_close(got, want, "eval logits")
    model.train()
    loss = (model(torch.from_numpy(x)) * torch.from_numpy(ct)).sum()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=VIT_TOL)
    want_sd = state_dict_from_jax({"params": want_grads})
    params = dict(model.named_parameters())
    assert set(want_sd) == set(params)
    for name, w in want_sd.items():
        _vit_close(params[name].grad.numpy(), w.numpy(), name)
