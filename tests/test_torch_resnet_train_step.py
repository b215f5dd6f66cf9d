"""The port's train step on a ResNet against the JAX ``make_train_step``, for
two steps from one JAX initialization (carried over by
``convert.state_dict_from_jax``): SAM + EMA + MixUp + label smoothing +
clipping, two micro-batches per step, DROPOUT 0 (JAX draws its head mask
from threefry, which torch cannot reproduce), no warmup. The BatchNorm
statistics thread through both micro-batches and both SAM passes, the NaN
guard and the EMA. Also ``make_bn_refresh_step`` against JAX's.

Both sides run in f64 (``jax_enable_x64`` set and restored): with batch
statistics the gradients are ill-conditioned in f32 (tests/test_torch_
resnet3d.py), and in f32 the two frameworks' grad norms part by ~1e-3 after
one step. The JAX step sums micro-batch gradients in f32 (vsn_tpu/train/
step.py:218-220), so its gradients carry f32 rounding. ResNet-10 (the
[1,1,1,1] basic variant) at 32x48x48 leaves 16 values per channel in the
last stage's BatchNorm.

Tolerances: loss to 1e-6 and grad norm to 1e-5 relative on the first step,
1e-4 and 1e-3 on the second. Statistics are held to their own scale: a
running variance to its largest element, a running mean to the square root
of that (a mean is a difference of large sums, so its own size is no
measure); after the first step, and for the BN refresh of the carried
weights, to 1e-6 (measured <= 3e-7). Parameters, statistics and EMA after
two steps: AdamW's first update moves an element by about sign(g) * lr, so
an element whose gradient is within rounding of zero may move the other
way, and the second step's gradients then differ a little everywhere
(measured: statistics <= 1.1e-4 of their scale; parameters <= 5.1e-4, 3%
of the elements past 1e-5 and 0.07% past 1e-4). So every parameter agrees
to 2 * lr * steps and every statistic to 1e-3, all but 10% of the
parameters to 1e-5 and all but 0.5% to 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vsn_tpu.config import load_config as jax_load_config
from vsn_tpu.models import build_model as jax_build_model
from vsn_tpu.train import step as jstep
from vsn_tpu.train.schedules import lr_wd_schedules as jax_schedules
from vsn_tpu_torch.config import load_config
from vsn_tpu_torch.convert import state_dict_from_jax
from vsn_tpu_torch.models import build_model
from vsn_tpu_torch.models.resnet3d import resnet_from_config
from vsn_tpu_torch.train.schedules import lr_wd_schedules
from vsn_tpu_torch.train.step import (
    eval_params,
    init_train_state,
    make_batch_transform,
    make_bn_refresh_step,
    make_train_step,
)

SIZE = (32, 48, 48)
OVER = dict(ARCHITECTURE="ResNet", RESNET_VARIANT="resnet10",
            IMG_SIZE=list(SIZE), DROPOUT=0.0, FP16=False, USE_SAM=True,
            USE_EMA=True, USE_MIXUP=True, LABEL_SMOOTHING=0.1,
            GRADIENT_CLIP=1.0, BATCH_SIZE=2, EFFECTIVE_BATCH_SIZE=4,
            STEPS=10, LR_WARMUP=0, WD_WARMUP=0, LR_BASE=3e-4, SEED=0)
STEPS = 2
F64 = np.float64


def _batch(size=SIZE):
    rng = np.random.default_rng(0)
    a, b, k = 2, 2, 5
    shape = (a, b, *size, 1)
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


def _jax_state_dict(params, model_state):
    return state_dict_from_jax(
        {"params": jax.tree.map(np.asarray, params),
         "batch_stats": jax.tree.map(np.asarray, model_state["batch_stats"])},
        F64)


def _port_model(variables):
    model = resnet_from_config(load_config(OVER), dtype=torch.float64)
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    return model.double()


@pytest.fixture(scope="module")
def runs():
    jax.config.update("jax_enable_x64", True)
    try:
        jcfg = jax_load_config(extra_overrides=dict(OVER, FP64=True))
        jmodel = jax_build_model(jcfg)
        variables = jax.jit(lambda k, x: jmodel.init(k, x, True))(
            jax.random.key(0), np.zeros((1, *SIZE, 1), np.float32))
        variables = jax.tree.map(lambda t: np.asarray(t, np.float32),
                                 variables)
        batch = _batch()
        state = jstep.init_train_state(
            jcfg, jax.tree.map(lambda t: np.asarray(t, F64), variables))
        lr, wd = jax_schedules(jcfg)
        step = jax.jit(jstep.make_train_step(jmodel, jcfg, lr, wd,
                                             jstep.make_batch_transform(jcfg)))
        jmetrics, jstats1 = [], None
        for _ in range(STEPS):
            state, m = step(state, jax.tree.map(jnp.asarray, batch),
                            jax.random.key(1))
            jmetrics.append({k: float(v) for k, v in m.items()})
            if jstats1 is None:
                jstats1 = _jax_state_dict(state.params, state.model_state)
        jfinal = _jax_state_dict(state.params, state.model_state)
        jema = _jax_state_dict(state.ema.ema["params"],
                               state.ema.ema["model_state"])
        # the BN refresh of the carried weights over the same batch
        refresh = jax.jit(jstep.make_bn_refresh_step(
            jmodel, jcfg, jstep.make_batch_transform(jcfg)))
        start = jstep.init_train_state(
            jcfg, jax.tree.map(lambda t: np.asarray(t, F64), variables))
        refreshed = refresh(start.params, start.model_state,
                            jax.tree.map(jnp.asarray, batch),
                            jax.random.key(2))
        jrefresh = _jax_state_dict(start.params, refreshed)
    finally:
        jax.config.update("jax_enable_x64", False)

    cfg = load_config(OVER)
    model = _port_model(variables)
    transform = make_batch_transform(cfg)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    carried = {k: v.clone() for k, v in model.state_dict().items()}
    trefresh = make_bn_refresh_step(model, cfg, transform)(carried, tbatch)
    for name, v in model.state_dict().items():  # refresh changes nothing
        assert torch.equal(v, carried[name]), name
    tstate = init_train_state(cfg, model)
    lr, wd = lr_wd_schedules(cfg)
    tstep = make_train_step(model, cfg, lr, wd, transform)
    tmetrics, tstats1 = [], None
    for _ in range(STEPS):
        tmetrics.append({k: float(v) for k, v in tstep(tstate, tbatch).items()})
        if tstats1 is None:
            tstats1 = {k: v.clone() for k, v in eval_params(tstate,
                                                            False).items()}
    return dict(jax=(jmetrics, jstats1, jfinal, jema, jrefresh),
                port=(tmetrics, tstats1, tstate, trefresh),
                start=state_dict_from_jax(variables), lr=float(cfg.LR_BASE))


def test_loss_and_grad_norm_match_jax(runs):
    jm = runs["jax"][0]
    tm = runs["port"][0]
    for i, (j, t) in enumerate(zip(jm, tm)):
        rtol = 1e-6 if i == 0 else 1e-4
        np.testing.assert_allclose(t["loss"], j["loss"], rtol=rtol)
        np.testing.assert_allclose(t["grad_norm"], j["grad_norm"],
                                   rtol=10 * rtol)
        for key in ("lr", "wd"):
            np.testing.assert_allclose(t[key], j[key], rtol=1e-6)
        assert t["skipped"] == j["skipped"] == 0
    assert tm[1]["loss"] != tm[0]["loss"]


def _stat_scale(want, name):
    """A statistic's scale: the largest running variance of its BatchNorm,
    or that variance's square root for a running mean."""
    var = want[name.replace("running_mean", "running_var")].max().item()
    return var if name.endswith("running_var") else var ** 0.5


def _compare_stats(got, want, tol, start=None):
    names = [n for n in want if "running" in n]
    assert names and set(names) <= set(got)
    for name in names:
        g, w = got[name].double(), want[name]
        if start is not None:  # the statistics moved
            assert not torch.equal(g.float(), start[name]), name
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                   atol=tol * _stat_scale(want, name),
                                   err_msg=name)


def test_statistics_after_the_first_step_match_jax(runs):
    _compare_stats(runs["port"][1], runs["jax"][1], 1e-6, runs["start"])


def _compare(got, want, lr):
    _compare_stats(got, want, 1e-3)
    errs = []
    for name, w in want.items():
        if "running" in name:
            continue
        g = got[name].double()
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                   atol=2 * lr * STEPS, err_msg=name)
        errs.append((g - w).abs().reshape(-1))
    err = torch.cat(errs)
    assert (err > 1e-5).double().mean() < 0.1
    assert (err > 1e-4).double().mean() < 5e-3


def test_params_statistics_and_ema_match_jax(runs):
    _, _, jfinal, jema, _ = runs["jax"]
    _, _, tstate, _ = runs["port"]
    _compare(eval_params(tstate, False), jfinal, runs["lr"])
    _compare(eval_params(tstate, True), jema, runs["lr"])
    ema = eval_params(tstate, True)
    live = eval_params(tstate, False)
    for kind in ("running", "weight"):
        assert any(not torch.equal(ema[k], live[k]) for k in live
                   if kind in k)
    assert int(tstate.ema.count) == 1 + STEPS


def test_bn_refresh_matches_jax(runs):
    jrefresh = runs["jax"][4]
    trefresh = runs["port"][3]
    assert set(trefresh) == {k for k in jrefresh if "running" in k}
    _compare_stats(trefresh, jrefresh, 1e-6, runs["start"])


TINY = dict(OVER, IMG_SIZE=[16, 18, 16], FP16=True)


def test_nan_batch_leaves_params_and_statistics_bit_unchanged():
    cfg = load_config(TINY)
    model = build_model(cfg, device="cpu")
    state = init_train_state(cfg, model)
    lr, wd = lr_wd_schedules(cfg)
    step = make_train_step(model, cfg, lr, wd, make_batch_transform(cfg))
    batch = {k: torch.from_numpy(v) for k, v in _batch((16, 18, 16)).items()}
    step(state, batch)
    assert int(state.skipped) == 0
    bad = dict(batch, image=batch["image"].clone())
    bad["image"][1, 0, 0, 0, 0, 0] = float("nan")
    before = {k: v.clone() for k, v in eval_params(state, False).items()}
    ema_before = state.ema.ema.clone()
    m = step(state, bad)
    assert int(m["skipped"]) == 1 and int(state.skipped) == 1
    for name, v in eval_params(state, False).items():
        assert torch.equal(v, before[name]), name
    assert torch.equal(state.ema.ema, ema_before)
    # the statistics are the model's buffers: an eval forward reads them
    assert all(model.get_buffer(k).data_ptr() == v.data_ptr()
               for k, v in eval_params(state, False).items()
               if "running" in k)
