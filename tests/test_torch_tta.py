"""The port's TTA (vsn_tpu_torch/eval/tta.py) and its warp against the JAX
package's (vsn_tpu/eval/tta.py, vsn_tpu/data/augment.py), JAX's threefry
draws injected:

* ``affine_warp_matmul`` on the same angles and translations (unit scales,
  zero padding, as TTA calls it), f32, within 1e-5 of the volume's scale;
* the 8 views of ``make_tta_views`` (identity, sagittal flip, 5 affines,
  the 0.9 centre crop resized back) in the cache's float16, within one
  f16 ulp at the volume's scale;
* ``entropy_weighted_average`` (weighted and uniform);
* ``make_tta_predictor`` on a tiny Swin and a tiny ViT: probs within 1e-5.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vsn_tpu.config import load_config as jax_load_config
from vsn_tpu.data import augment as ja
from vsn_tpu.data.augment import build_eval_transform as jax_eval_transform
from vsn_tpu.eval import tta as jt
from vsn_tpu.models import build_model as jax_build_model
from vsn_tpu_torch.config import load_config
from vsn_tpu_torch.convert import state_dict_from_jax
from vsn_tpu_torch.data import augment as ta
from vsn_tpu_torch.data.augment import build_eval_transform
from vsn_tpu_torch.eval import tta as tt
from vsn_tpu_torch.models import build_model

ROT = float(np.deg2rad(3.0))
MODELS = {
    "swin": dict(IMG_SIZE=[12, 18, 12], PATCH_SHAPE=[2, 2, 2],
                 WINDOW_SIZE=[2, 3, 2], EMBED_DIM=8, DEPTH=[2, 2, 2],
                 HEADS=[1, 2, 4], FP16=False),
    "vit": dict(ARCHITECTURE="ViT", IMG_SIZE=[16, 16, 16],
                RESHAPE_SIZE=False, PATCH_SHAPE=[4, 4, 4], EMBED_DIM=128,
                DEPTH=2, HEADS=2, FP16=False),
}


def jax_draws(rng, b, num_samples=5):
    """JAX's affine draws of make_tta_views for key ``rng``: view i's
    (angles, translation), as torch tensors."""
    out = []
    for i in range(num_samples):
        k_r, k_t = jax.random.split(jax.random.fold_in(rng, i))
        angles = jax.random.uniform(k_r, (b, 3), minval=-ROT, maxval=ROT)
        trans = jax.random.uniform(k_t, (b, 3), minval=-5.0, maxval=5.0)
        out.append((torch.from_numpy(np.array(angles)),
                    torch.from_numpy(np.array(trans))))
    return out


def _volumes(shape, b=2, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, *shape)) * 50 + 100).astype(np.float32)


@pytest.mark.parametrize("shape", [(12, 14, 10), (9, 16, 7)])
def test_affine_warp_matmul_matches_jax(shape):
    vols = _volumes(shape)
    rng = np.random.default_rng(1)
    angles = rng.uniform(-3 * ROT, 3 * ROT, (2, 3)).astype(np.float32)
    trans = rng.uniform(-5, 5, (2, 3)).astype(np.float32)
    warp = jax.jit(ja.affine_warp_matmul, static_argnames=("mode",))
    want = np.asarray(warp(jnp.asarray(vols), jnp.asarray(angles),
                           jnp.ones((2, 3)), jnp.asarray(trans), mode="zeros"))
    got = ta.affine_warp_matmul(torch.from_numpy(vols),
                                torch.from_numpy(angles),
                                torch.from_numpy(trans))
    assert got.dtype == torch.float32
    scale = np.abs(vols).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * scale)
    assert np.abs(want - vols).max() > 0.1 * scale  # it did move the volume


def test_identity_warp_is_the_volume():
    vols = torch.from_numpy(_volumes((6, 7, 5)))
    zero = torch.zeros(2, 3)
    torch.testing.assert_close(ta.affine_warp_matmul(vols, zero, zero),
                               vols, rtol=0, atol=1e-4)


def test_views_match_jax():
    x = _volumes((12, 18, 12))[..., None].astype(np.float16)
    rng = jax.random.key(3)
    jfn, jn = jt.make_tta_views()
    want = np.asarray(jax.jit(jfn)(jnp.asarray(x), rng))
    fn, n = tt.make_tta_views()
    draws = jax_draws(rng, 2)
    got = fn(torch.from_numpy(x), draws=lambda i: draws[i]).numpy()
    assert n == jn == 8 and got.shape == want.shape == (2, 8, 12, 18, 12, 1)
    assert got.dtype == want.dtype == np.float16
    ulp = np.spacing(np.float16(np.abs(want).max())).astype(np.float32)
    err = np.abs(got.astype(np.float32) - want.astype(np.float32)).max(
        axis=(0, 2, 3, 4, 5))
    assert (err <= ulp).all(), err
    gen = torch.Generator().manual_seed(0)
    drawn = fn(torch.from_numpy(x), gen)
    assert not torch.equal(drawn[:, 2:7], torch.from_numpy(want[:, 2:7]))


@pytest.mark.parametrize("weighted", [True, False])
def test_entropy_weighted_average_matches(weighted):
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((3, 8, 5)) * 3
    probs = (np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)).astype(
        np.float32)
    want = np.asarray(jt.entropy_weighted_average(jnp.asarray(probs),
                                                  weighted))
    got = tt.entropy_weighted_average(torch.from_numpy(probs), weighted)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_tta_predictor_matches_jax(name):
    over = MODELS[name]
    jcfg = jax_load_config(extra_overrides=over)
    jmodel = jax_build_model(jcfg)
    shape = tuple(over["IMG_SIZE"])
    variables = jax.jit(lambda k, x: jmodel.init(k, x, True))(
        jax.random.key(1), np.zeros((1, *shape, 1), np.float32))
    variables = jax.tree.map(np.asarray, variables)
    head = variables["params"]["head"]
    head["kernel"] = head["kernel"] * 50.0   # probs far from uniform
    x = _volumes(shape, seed=5)[..., None].astype(np.float16)
    rng = jax.random.key(6)
    jpredict, _ = jt.make_tta_predictor(jmodel, jax_eval_transform(jcfg))
    want = np.asarray(jax.jit(jpredict)(variables, jnp.asarray(x), rng))

    model = build_model(load_config(over), device="cpu")
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    predict, n = tt.make_tta_predictor(model,
                                       build_eval_transform(load_config(over)))
    draws = jax_draws(rng, 2)
    got = predict(torch.from_numpy(x), draws=lambda i: draws[i]).numpy()
    assert n == 8 and got.shape == want.shape == (2, 5)
    np.testing.assert_allclose(got.sum(1), 1.0, atol=1e-6)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert np.ptp(want, axis=1).min() > 0.1   # not a near-uniform average
