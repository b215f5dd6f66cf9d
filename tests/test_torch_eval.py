"""The port's eval path against the JAX package: Evaluator probs against
``make_eval_step`` composed with ``build_eval_transform``, the z-score, and
the carried config defaults against ``load_config()``."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vsn_tpu.config import load_config as jax_load_config
from vsn_tpu.data.augment import build_eval_transform as jax_eval_transform
from vsn_tpu.data.augment import zscore as jax_zscore
from vsn_tpu.models import build_model as jax_build_model
from vsn_tpu.train.step import make_eval_step as jax_make_eval_step
from vsn_tpu_torch.config import DEFAULTS, load_config
from vsn_tpu_torch.convert import state_dict_from_jax
from vsn_tpu_torch.data.augment import resize_batch, zscore
from vsn_tpu_torch.eval.evaluate import Evaluator
from vsn_tpu_torch.models import build_model

TINY = dict(IMG_SIZE=[12, 18, 12], PATCH_SHAPE=[2, 2, 2],
            WINDOW_SIZE=[2, 3, 2], EMBED_DIM=8, DEPTH=[2, 2, 2],
            HEADS=[1, 2, 4], FP16=False, USE_SHAKEDROP=True)


def test_carried_defaults_equal_load_config():
    cfg = jax_load_config()
    for key, value in DEFAULTS.items():
        assert cfg[key] == value, key
    port = load_config()
    assert port.num_classes == cfg.num_classes
    assert port.input_size == cfg.input_size
    assert load_config(dict(RESHAPE_SIZE=[8, 8, 8])).input_size == (8, 8, 8)


def test_zscore_matches_jax():
    # float16 volumes with a per-sample offset and scale, as the cache holds
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((3, 6, 7, 5, 1)) * [[[[[2.0]]]], [[[[0.5]]]],
                                                  [[[[9.0]]]]] + 3.0)
    x = x.astype(np.float16)
    want = np.asarray(jax_zscore(jnp.asarray(x)))
    got = zscore(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    const = np.ones((1, 2, 2, 2, 1), np.float32)  # std floor: no NaN
    np.testing.assert_array_equal(zscore(torch.from_numpy(const)).numpy(), 0)


def test_resize_is_identity_or_raises():
    x = torch.zeros(1, 4, 5, 6, 1)
    assert resize_batch(x, (4, 5, 6)) is x
    with pytest.raises(NotImplementedError):
        resize_batch(x, (8, 8, 8))


def test_evaluator_probs_match_jax_eval_step():
    cfg = jax_load_config(extra_overrides=TINY)
    jmodel = jax_build_model(cfg)
    x0 = np.zeros((1, 12, 18, 12, 1), np.float32)
    variables = jax.jit(lambda k, x: jmodel.init(k, x, True))(
        jax.random.key(1), x0)
    variables = jax.tree.map(np.asarray, variables)
    # head scaled so the probabilities are far from uniform
    variables["params"]["head"]["kernel"] = (
        variables["params"]["head"]["kernel"] * 50.0)
    rng = np.random.default_rng(2)
    images = (rng.standard_normal((5, 12, 18, 12, 1)) * 4 + 1).astype(
        np.float16)

    step, tfm = jax_make_eval_step(jmodel), jax_eval_transform(cfg)
    want = np.asarray(jax.jit(lambda v, im: step(v, tfm(im)))(
        variables, jnp.asarray(images)))

    model = build_model(load_config(TINY), device="cpu")
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    # batch 2: three batches, the last padded with one row and trimmed
    got = Evaluator(load_config(TINY), model, batch_size=2).predict(images)
    assert got.shape == (5, 5)
    np.testing.assert_allclose(got.sum(1), 1.0, atol=1e-6)
    # f32 on both sides, probs in [0, 1]: sum-order differences stay ~1e-7
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert want.max() > 0.5  # not a near-uniform comparison
