"""WATCH_GRADIENTS and USE_CHECKPOINT in the port's train step against the
JAX package's on the CPU.

A tiny LayerNorm Swin (stage 1 shifted, stage 2 padded, stage 3 clamped)
and a tiny ViT, f32, with the JAX initializer's weights and saturated
logits (qkv x 8, the bias table x 50, the head x 50, as
tests/test_torch_use_pallas_flag.py scales them; no random draws):

* one WATCH_GRADIENTS step (VALIDATION_FREQUENCY 1, so the step is a
  logged one) gives JAX's ``grad_norm/<module>`` keys and values and its
  ``attn_logit_max`` (the probe: the model built with USE_PALLAS_ATTENTION
  off, on micro-batch 0 at the step's starting weights) within 1e-4;
* with USE_CHECKPOINT every block's kernels run twice a pass (the
  backward recomputes them), the port's loss and every gradient equal its
  own without it bit for bit, and its step's loss and gradient norm are
  JAX's ``nn.remat`` step's within 1e-4.

The JAX step runs once per model with both options on (one compile each):
``nn.remat`` does not change what it computes.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tests.test_torch_use_pallas_flag import MODELS, _Calls, _setup
from vsn_tpu.config import load_config as jax_load_config
from vsn_tpu.models import build_model as jax_build_model
from vsn_tpu.train import step as jstep
from vsn_tpu.train.schedules import lr_wd_schedules as jax_schedules
from vsn_tpu_torch.config import load_config
from vsn_tpu_torch.convert import state_dict_from_jax
from vsn_tpu_torch.models import build_model
from vsn_tpu_torch.train.schedules import lr_wd_schedules
from vsn_tpu_torch.train.step import (
    init_train_state,
    make_grad_fn,
    make_train_step,
)
from vsn_tpu_torch.train.trainer import probe_twin

TOL = 1e-4
STEP = dict(FP16=False, STOCHASTIC_DEPTH_PROB=0.0, BATCH_SIZE=2,
            EFFECTIVE_BATCH_SIZE=2, STEPS=4, LR_WARMUP=0, WD_WARMUP=0,
            VALIDATION_FREQUENCY=1, SEED=0)


def _batch(shape, k):
    rng = np.random.default_rng(4)
    return {"image": rng.standard_normal((1, 2, *shape, 1)).astype(
                np.float32),
            "label": np.eye(k, dtype=np.float32)[rng.integers(0, k, (1, 2))]}


def _configs(name, **flags):
    over = dict(MODELS[name][0], **STEP, **flags)
    return jax_load_config(extra_overrides=over), load_config(over)


@pytest.fixture(scope="module")
def jax_runs():
    cache = {}

    def run(name):
        if name not in cache:
            _, variables, _, _ = _setup(name)
            batch = _batch(MODELS[name][1], 5)
            cache[name] = (variables, batch, _jax_step(
                name, variables, batch, WATCH_GRADIENTS=True,
                USE_CHECKPOINT=True))
        return cache[name]

    return run


def _jax_step(name, variables, batch, **flags):
    jcfg, _ = _configs(name, **flags)
    jmodel = jax_build_model(jcfg)
    probe = jax_build_model(jcfg.replace(USE_PALLAS_ATTENTION=False))
    step = jax.jit(jstep.make_train_step(jmodel, jcfg, *jax_schedules(jcfg),
                                         probe_model=probe))
    _, m = step(jstep.init_train_state(jcfg, variables),
                jax.tree.map(jnp.asarray, batch), jax.random.key(1))
    return {k: float(v) for k, v in m.items()}


def _port(name, variables, **flags):
    _, cfg = _configs(name, **flags)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    return cfg, model, init_train_state(cfg, model)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_watch_gradients_metrics_match_jax(name, jax_runs):
    variables, batch, want = jax_runs(name)
    cfg, model, state = _port(name, variables, WATCH_GRADIENTS=True)
    step = make_train_step(model, cfg, *lr_wd_schedules(cfg),
                           probe_model=probe_twin(cfg, "cpu"))
    got = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
    watched = sorted(k for k in want if k.startswith("grad_norm/")
                     or k == "attn_logit_max")
    assert sorted(k for k in got if k.startswith("grad_norm/")
                  or k == "attn_logit_max") == watched
    assert len(watched) >= 6
    assert want["attn_logit_max"] > 1.0   # O(1) and larger logits
    for key in watched + ["loss", "grad_norm"]:
        np.testing.assert_allclose(float(got[key]), want[key], rtol=TOL,
                                   err_msg=key)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_use_checkpoint_matches_plain_and_jax_remat(name, jax_runs):
    variables, batch, want = jax_runs(name)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    runs = {}
    for remat in (False, True):
        cfg, model, state = _port(name, variables, USE_CHECKPOINT=remat)
        with _Calls() as calls:
            loss = make_grad_fn(model, cfg)(state, tbatch, 0)
        blocks = len(model.blocks())
        assert calls.counts["attn_half"] == calls.counts["ln_mlp"] == \
            blocks * (2 if remat else 1)
        runs[remat] = (float(loss), state.params.grad.clone())
        if remat:
            m = make_train_step(model, cfg, *lr_wd_schedules(cfg))(state,
                                                                   tbatch)
    assert runs[True][0] == runs[False][0]
    assert torch.equal(runs[True][1], runs[False][1])
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(m[key]), want[key], rtol=TOL,
                                   err_msg=key)
