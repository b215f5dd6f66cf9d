"""The port's train step on a MedViT against the JAX ``make_train_step``:
one SAM + EMA + MixUp + label-smoothing + clipping step, two micro-batches
of two, of ``tests/test_resnet_medvit.py`` ``tiny_medvit``'s shape with
STOCHASTIC_DEPTH_PROB 0.2 (tests/test_torch_medvit3d.py's geometry: a
36x40x20 input, stage 2 reducing 75 tokens at r = 16), from one set of
weights and statistics carried over by ``convert.state_dict_from_jax``.
The BatchNorm statistics thread through both micro-batches and both SAM
passes; DropPath's gains are injected on both sides (JAX's threefry draws
cannot be reproduced): every micro-batch and pass gets the same per-forward
list, which JAX's ``drop_path`` (replaced at ``vsn_tpu.models.layers``)
hands out in call order in each of its two traces (one a SAM pass), and
the port's ``draws(step, micro, pass)`` returns.

Both sides run in f64 (``jax_enable_x64`` set and restored): with batch
statistics the gradients are ill-conditioned in f32. The JAX step sums the
micro-batch gradients in f32 (vsn_tpu/train/step.py:218-220), and both
sides take E-MHSA's scores, softmax and products in f32, so the step's
gradients carry f32 rounding.

Tolerances: loss to 1e-6 and grad norm to 1e-5 relative; the statistics
after the step to 1e-5 of their scale (a running variance's largest
element, or its square root for a mean: tests/test_torch_resnet_train_step.
py); every parameter and EMA weight to 2 lr (AdamW's first update moves an
element by about sign(g) lr, so an element whose gradient is within
rounding of 0 may move the other way), all but 1% of them to 1e-6.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_resnet_medvit import tiny_medvit
from tests.test_torch_medvit3d import SHAPE, TINY, _carried
from vsn_tpu.config import load_config as jax_load_config
from vsn_tpu.models import layers as jlayers
from vsn_tpu.train import step as jstep
from vsn_tpu.train.schedules import lr_wd_schedules as jax_schedules
from vsn_tpu_torch.config import load_config
from vsn_tpu_torch.convert import state_dict_from_jax
from vsn_tpu_torch.models import medvit3d as mv
from vsn_tpu_torch.train.schedules import lr_wd_schedules
from vsn_tpu_torch.train.step import (
    eval_params,
    init_train_state,
    make_batch_transform,
    make_train_step,
)

RATE = 0.2
OVER = dict(ARCHITECTURE="MedViT", IMG_SIZE=list(SHAPE[1:4]), DROPOUT=0.0,
            FP16=False, USE_SAM=True, USE_EMA=True, USE_MIXUP=True,
            LABEL_SMOOTHING=0.1, GRADIENT_CLIP=1.0, BATCH_SIZE=2,
            EFFECTIVE_BATCH_SIZE=4, STEPS=10, LR_WARMUP=0, WD_WARMUP=0,
            LR_BASE=3e-4, SEED=0, DISEASES=["CN", "AD", "FTD"])
F64 = np.float64
GAINS = [np.array([1.25, 0.0]), np.array([0.0, 1.25])]


def _batch():
    rng = np.random.default_rng(0)
    a, b, k = 2, 2, 3
    shape = (a, b, *SHAPE[1:])
    eye = np.eye(k, dtype=np.float32)
    return {
        "image": rng.standard_normal(shape).astype(np.float16),
        "image2": rng.standard_normal(shape).astype(np.float16),
        "label": eye[rng.integers(0, k, (a, b))],
        "label2": eye[rng.integers(0, k, (a, b))],
        "mix_lam": rng.beta(0.3, 0.3, (a, b)).astype(np.float32),
        "mix_apply": np.array([[True, False], [True, True]]),
        "mix_bounds": np.zeros((a, b, 6), np.int32),
    }


def _gains(n):
    return [GAINS[i % 2] for i in range(n)]


def _cycling_drop_path(n):
    """JAX's drop_path handing out ``_gains(n)`` in call order, again from
    the start after every n calls (one trace of a forward)."""
    calls = [0]

    def drop_path(x, rate, deterministic, rng):
        if deterministic or rate == 0.0:
            return x
        g = _gains(n)[calls[0] % n]
        calls[0] += 1
        return x * jnp.asarray(g).reshape((x.shape[0],) + (1,) * (x.ndim - 1))
    return drop_path


def _jax_state_dict(params, model_state):
    return state_dict_from_jax(
        {"params": jax.tree.map(np.asarray, params),
         "batch_stats": jax.tree.map(np.asarray, model_state["batch_stats"])},
        F64)


@pytest.fixture(scope="module")
def runs():
    over = dict(stochastic_depth_prob=RATE)
    jax.config.update("jax_enable_x64", True)
    try:
        _, variables = _carried(over)
        jmodel = tiny_medvit(dtype=jnp.float64, **over)
        jcfg = jax_load_config(extra_overrides=dict(OVER, FP64=True))
        port = mv.MedViT3D(**{**TINY, **over}, dtype=torch.float64).double()
        port.load_state_dict(state_dict_from_jax(variables, F64), strict=True)
        n = len(port.draw_plan(2))
        batch = _batch()
        state = jstep.init_train_state(jcfg, variables)
        lr, wd = jax_schedules(jcfg)
        step = jax.jit(jstep.make_train_step(jmodel, jcfg, lr, wd,
                                             jstep.make_batch_transform(jcfg)))
        with mock.patch.object(jlayers, "drop_path", _cycling_drop_path(n)):
            state, m = step(state, jax.tree.map(jnp.asarray, batch),
                            jax.random.key(1))
        jmetrics = {k: float(v) for k, v in m.items()}
        jfinal = _jax_state_dict(state.params, state.model_state)
        jema = _jax_state_dict(state.ema.ema["params"],
                               state.ema.ema["model_state"])
    finally:
        jax.config.update("jax_enable_x64", False)

    cfg = load_config(OVER)
    start = {k: v.clone() for k, v in port.state_dict().items()}
    tstate = init_train_state(cfg, port)
    lr, wd = lr_wd_schedules(cfg)
    draws = [tuple(torch.from_numpy(g) for _ in range(2)) for g in _gains(n)]
    tstep = make_train_step(port, cfg, lr, wd, make_batch_transform(cfg),
                            draws=lambda step, micro, pass_idx: draws)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    tmetrics = {k: float(v) for k, v in tstep(tstate, tbatch).items()}
    return dict(jax=(jmetrics, jfinal, jema), port=(tmetrics, tstate), n=n,
                start=start, lr=float(cfg.LR_BASE))


def test_loss_and_grad_norm_match_jax(runs):
    j, t = runs["jax"][0], runs["port"][0]
    assert runs["n"] == 2 * 5 + 3 * 3   # every block but the first draws
    np.testing.assert_allclose(t["loss"], j["loss"], rtol=1e-6)
    np.testing.assert_allclose(t["grad_norm"], j["grad_norm"], rtol=1e-5)
    for key in ("lr", "wd"):
        np.testing.assert_allclose(t[key], j[key], rtol=1e-6)
    assert t["skipped"] == j["skipped"] == 0


def _stat_scale(want, name):
    var = want[name.replace("running_mean", "running_var")].max().item()
    return var if name.endswith("running_var") else var ** 0.5


def _compare(got, want, lr, start):
    names = [n for n in want if "running" in n]
    assert names and set(names) <= set(got)
    for name in names:
        g, w = got[name].double(), want[name]
        assert not torch.equal(g, start[name].double()), name
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                   atol=1e-5 * _stat_scale(want, name),
                                   err_msg=name)
    errs = []
    for name, w in want.items():
        if "running" in name:
            continue
        g = got[name].double()
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=2 * lr,
                                   err_msg=name)
        errs.append((g - w).abs().reshape(-1))
    err = torch.cat(errs)
    assert (err > 1e-6).double().mean() < 0.01


def test_params_statistics_and_ema_match_jax(runs):
    _, jfinal, jema = runs["jax"]
    _, tstate = runs["port"]
    _compare(eval_params(tstate, False), jfinal, runs["lr"], runs["start"])
    _compare(eval_params(tstate, True), jema, runs["lr"], runs["start"])
    moved = eval_params(tstate, False)
    assert any(not torch.equal(moved[k], runs["start"][k].double())
               for k in moved if "running" not in k)
    assert int(tstate.ema.count) == 2
