"""The port's ViT-3D with the stabilizer options (LAYER_SCALE, POST_NORM,
ENABLE_STABLE and all three, the combination of tests/test_vit3d.py)
against the JAX package's fused ViT path on the CPU (the Pallas kernels of
vsn_tpu/ops/swin_block_kernels.py in interpret mode, under
``tests/test_swin_block_kernels.py::_ForceTpu``): K1 (attention at head dim
64) and K2 with gamma and post-norm in band, where the post-norm LayerNorms
are the blocks' ``attn_norm`` / ``ff_norm``.

tests/test_torch_vit3d.py's tiny ViT (N = 65, 2 heads of 64, depth 2,
STOCHASTIC_DEPTH_PROB 0.2 with the DropPath gains injected on both sides),
weights from the JAX initializer (the stable inits under ENABLE_STABLE),
made non-trivial as tests/test_torch_stabilizers_swin.py makes them
(``perturb``). Eval logits, and the training forward's loss and every
parameter gradient, gamma included, to 1e-4 of each one's scale, f32.
"""

from unittest import mock

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tests.test_swin_block_kernels import _ForceTpu
from tests.test_torch_stabilizers_swin import OPTIONS, perturb
from tests.test_torch_vit3d import GAINS, TINY, _injected_gains
from vsn_tpu.config import load_config as jax_load_config
from vsn_tpu.models import build_model as jax_build_model
from vsn_tpu.models import layers as jlayers
from vsn_tpu_torch.config import load_config
from vsn_tpu_torch.convert import state_dict_from_jax
from vsn_tpu_torch.models import build_model

TOL = 1e-4


def _close(got, want, what):
    scale = float(np.abs(want).max())
    assert scale > 0, what
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * scale,
                               err_msg=what)


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_vit_option_matches_jax(option):
    over = dict(TINY, **OPTIONS[option])
    jmodel = jax_build_model(jax_load_config(extra_overrides=over))
    variables = jax.jit(lambda k, x: jmodel.init(k, x, True))(
        jax.random.key(0), np.zeros((1, 16, 16, 16, 1), np.float32))
    rng = np.random.default_rng(1)
    variables = jax.tree_util.tree_map_with_path(
        lambda p, v: perturb(p, v, rng), variables)
    model = build_model(load_config(over), device="cpu")
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    blk = model.blocks()[0]
    post = bool(over.get("POST_NORM"))
    assert (blk.attn_norm is not None, blk[0].norm is None) == (post, post)
    assert (blk.res1 is not None) == bool(over.get("LAYER_SCALE"))

    x = np.random.default_rng(2).standard_normal(
        (2, 16, 16, 16, 1)).astype(np.float32)
    ct = np.random.default_rng(3).standard_normal((2, 5)).astype(np.float32)

    def loss_fn(params):
        logits = jmodel.apply({"params": params}, x, False,
                              rngs={"dropout": jax.random.key(5)})
        return jnp.sum(logits * ct)

    with _ForceTpu():
        want = np.asarray(jax.jit(lambda v: jmodel.apply(v, x, True))(
            variables))
        with mock.patch.object(jlayers, "residual_branch_gains",
                               _injected_gains(GAINS)):
            want_loss, want_grads = jax.value_and_grad(loss_fn)(
                variables["params"])
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert np.abs(want).max() > 0.5   # O(1) logits: the tolerance bites
    _close(got, want, "eval logits")

    model.train()
    draws = [(torch.from_numpy(g), torch.from_numpy(g)) for g in GAINS]
    logits = model(torch.from_numpy(x), draws=draws)
    loss = (logits * torch.from_numpy(ct)).sum()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=TOL)
    want_sd = state_dict_from_jax({"params": want_grads})
    params = dict(model.named_parameters())
    assert set(want_sd) == set(params)
    for name, w in want_sd.items():
        _close(params[name].grad.numpy(), w.numpy(), name)
