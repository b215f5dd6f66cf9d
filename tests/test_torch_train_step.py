"""The port's train step against the JAX ``make_train_step`` on a tiny Swin,
for two steps from one JAX initialization (carried over by
``convert.state_dict_from_jax``).

Config: f32 (FP16 off), SAM + EMA + MixUp + label smoothing + global-norm
clipping, two micro-batches per step, no stochastic depth (so no random
draws: JAX's threefry streams cannot be reproduced) and no warmup (the
first step moves the parameters). The model has the three stage kinds of
tests/test_torch_swin3d.py: divisible and shifted, padded, clamped. It
runs with LayerNorm (the fused blocks, K1/K2) and with DynamicTanh (the
unfused blocks, K4), the ``runs`` fixture's two parameters.

On the CPU the JAX model takes its unfused XLA path (mask -100, plain
rowmax softmax) and the port the plain versions of its kernels; the
difference is far below the tolerances. Loss, grad norm and the first
pass's gradients agree to 1e-4 (relative to each gradient's scale).
Parameters and EMA agree to 2 * lr * steps: AdamW's first update moves
each element by about sign(g) * lr, so an element whose gradient is near
zero may move the other way. Such elements are rare: all but 0.1% must
agree to 1e-5, which a wrong EMA decay or a dropped clip breaks for most
elements.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vsn_tpu.config import load_config as jax_load_config
from vsn_tpu.models import build_model as jax_build_model
from vsn_tpu.train import step as jstep
from vsn_tpu.train.schedules import lr_wd_schedules as jax_schedules
from vsn_tpu_torch.config import load_config
from vsn_tpu_torch.convert import jax_params_from_state_dict, state_dict_from_jax
from vsn_tpu_torch.models import build_model
from vsn_tpu_torch.train.schedules import lr_wd_schedules
from vsn_tpu_torch.train.step import (
    eval_params,
    init_train_state,
    make_batch_transform,
    make_grad_fn,
    make_train_step,
)

OVER = dict(IMG_SIZE=[12, 18, 12], PATCH_SHAPE=[2, 2, 2],
            WINDOW_SIZE=[2, 3, 2], EMBED_DIM=8, DEPTH=[2, 2, 2],
            HEADS=[1, 2, 4], FP16=False, STOCHASTIC_DEPTH_PROB=0.0,
            USE_SHAKEDROP=True, USE_SAM=True, USE_EMA=True, USE_MIXUP=True,
            LABEL_SMOOTHING=0.1, GRADIENT_CLIP=1.0, BATCH_SIZE=2,
            EFFECTIVE_BATCH_SIZE=4, STEPS=10, LR_WARMUP=0, WD_WARMUP=0,
            LR_BASE=3e-3, SEED=0)
STEPS = 2
TOL = 1e-4
# peaked attention and O(1) logits, as tests/test_torch_swin3d.py scales them;
# DynamicTanh's alpha from 0.5 to 1.5, so its tanh is not near-linear
WEIGHT_SCALE = {"qkv": 8.0, "relative_position_bias_table": 50.0,
                "head": 50.0, "alpha": 3.0}


def _scale(path, leaf):
    names = [getattr(p, "key", "") for p in path]
    for name, k in WEIGHT_SCALE.items():
        if name in names and names[-1] != "bias":
            return leaf * k
    return leaf


def _batch():
    rng = np.random.default_rng(0)
    a, b, k = 2, 2, 5
    shape = (a, b, 12, 18, 12, 1)
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


@pytest.fixture(scope="module", params=["nn.LayerNorm", "DynamicTanh"])
def runs(request):
    over = dict(OVER, NORM_LAYER=request.param)
    jcfg = jax_load_config(extra_overrides=over)
    jmodel = jax_build_model(jcfg)
    x0 = np.zeros((1, 12, 18, 12, 1), np.float32)
    variables = jax.jit(lambda k, x: jmodel.init(k, x, True))(
        jax.random.key(0), x0)
    variables = jax.tree_util.tree_map_with_path(
        lambda p, v: np.asarray(_scale(p, v)), variables)
    batch = _batch()

    # JAX: the first pass's gradients, then two steps
    loss_fn = jstep.make_loss_fn(jmodel, jcfg)
    transform = jstep.make_batch_transform(jcfg)
    grad_fn = jax.jit(jax.grad(lambda p, img, lab: loss_fn(
        p, {}, img, lab, {})[0]))
    jgrads = None
    for idx in range(2):
        micro = jax.tree.map(lambda t: jnp.asarray(t[idx]), batch)
        img, lab = transform(micro, jax.random.key(0))
        g = grad_fn(variables["params"], img, lab)
        jgrads = g if jgrads is None else jax.tree.map(jnp.add, jgrads, g)
    jgrads = jax.tree.map(lambda t: np.asarray(t) * 0.5, jgrads)
    state = jstep.init_train_state(jcfg, variables)
    lr, wd = jax_schedules(jcfg)
    step = jax.jit(jstep.make_train_step(jmodel, jcfg, lr, wd, transform))
    jmetrics = []
    for _ in range(STEPS):
        state, m = step(state, jax.tree.map(jnp.asarray, batch),
                        jax.random.key(1))
        jmetrics.append({k: float(v) for k, v in m.items()})

    # the port
    cfg = load_config(over)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    tstate = init_train_state(cfg, model)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    ttransform = make_batch_transform(cfg)
    make_grad_fn(model, cfg, ttransform)(tstate, tbatch, 0)
    tgrads = {k: v.clone() for k, v in
              tstate.params.tree(tstate.params.grad).items()}
    lr, wd = lr_wd_schedules(cfg)
    tstep = make_train_step(model, cfg, lr, wd, ttransform)
    tmetrics = [{k: float(v) for k, v in tstep(tstate, tbatch).items()}
                for _ in range(STEPS)]
    return dict(jax=(state, jmetrics, jgrads), port=(tstate, tmetrics, tgrads),
                variables=variables, lr=float(cfg.LR_BASE))


def test_loss_and_grad_norm_match_jax(runs):
    _, jm, _ = runs["jax"]
    _, tm, _ = runs["port"]
    for j, t in zip(jm, tm):
        for key in ("loss", "grad_norm", "lr", "wd"):
            np.testing.assert_allclose(t[key], j[key], rtol=TOL, err_msg=key)
        assert t["skipped"] == j["skipped"] == 0
    assert tm[1]["loss"] != tm[0]["loss"]


def test_first_pass_grads_match_jax_leaf_by_leaf(runs):
    _, _, jgrads = runs["jax"]
    _, _, tgrads = runs["port"]
    want = state_dict_from_jax({"params": jgrads})
    assert set(want) == set(tgrads)
    for name, w in want.items():
        g, w = tgrads[name].numpy(), w.numpy()
        scale = np.abs(w).max()
        assert scale > 0, name
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL * scale,
                                   err_msg=name)


def test_params_and_ema_match_jax(runs):
    jstate, _, _ = runs["jax"]
    tstate, _, _ = runs["port"]
    atol = 2 * runs["lr"] * STEPS
    for tree, flat in ((jstate.params, tstate.params.flat),
                       (jstate.ema.ema["params"], tstate.ema.ema)):
        want = state_dict_from_jax({"params": jax.tree.map(np.asarray, tree)})
        got = tstate.params.tree(flat)
        for name, w in want.items():
            np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=0,
                                       atol=atol, err_msg=name)
        err = torch.cat([(got[k] - w).abs().reshape(-1)
                         for k, w in want.items()])
        assert (err > 1e-5).float().mean() < 1e-3
    start = state_dict_from_jax(runs["variables"])
    moved = max((tstate.params.tree(tstate.params.flat)[k] - v).abs().max()
                for k, v in start.items())
    assert moved > 0.1 * runs["lr"]
    assert int(tstate.ema.count) == int(jstate.ema.count) == 1 + STEPS
    ema = eval_params(tstate, use_ema=True)
    assert any(not torch.equal(ema[k], v)
               for k, v in tstate.params.tree(tstate.params.flat).items())


def test_reverse_map_round_trips(runs):
    sd = state_dict_from_jax(runs["variables"])
    back = jax_params_from_state_dict(sd)
    flat_in = jax.tree_util.tree_leaves_with_path(runs["variables"])
    flat_out = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_in) == len(flat_out)
    for path, leaf in flat_in:
        np.testing.assert_array_equal(flat_out[path], leaf)


def test_nan_guard_skips_the_whole_update():
    cfg = load_config(OVER)
    model = build_model(cfg, device="cpu")
    state = init_train_state(cfg, model)
    lr, wd = lr_wd_schedules(cfg)
    step = make_train_step(model, cfg, lr, wd, make_batch_transform(cfg))
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    batch["image"][0, 0, 0, 0, 0, 0] = float("nan")
    before = (state.params.flat.clone(), state.ema.ema.clone(),
              state.opt.mu.clone())
    m = step(state, batch)
    assert int(m["skipped"]) == 1 and int(state.skipped) == 1
    assert state.step == 1 and int(state.opt.count) == 0
    assert torch.equal(state.params.flat, before[0])
    assert torch.equal(state.ema.ema, before[1])
    assert torch.equal(state.opt.mu, before[2])


@pytest.mark.parametrize("key", ["USE_CHECKPOINT", "WATCH_GRADIENTS",
                                 "PRELOAD_DEVICE"])
def test_trainer_options_build_a_step_that_runs(key):
    """Each of the three trainer options builds a step that runs and gives
    the plain step's loss: USE_CHECKPOINT (blocks recomputed in the
    backward), WATCH_GRADIENTS (the per-module gradient norms of the JAX
    top-level names, the probe on its logged step) and PRELOAD_DEVICE (a
    batch of row indices into a float16 store)."""
    from vsn_tpu_torch.data.resident import build_resident
    from vsn_tpu_torch.train.trainer import probe_twin

    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    weights = build_model(load_config(OVER), device="cpu").state_dict()
    losses = {}
    for on in (False, True):
        cfg = load_config(dict(OVER, VALIDATION_FREQUENCY=1,
                               **{key: "float16" if on and key ==
                                  "PRELOAD_DEVICE" else on}))
        model = build_model(cfg, device="cpu")
        model.load_state_dict(weights)
        state = init_train_state(cfg, model)
        lr, wd = lr_wd_schedules(cfg)
        step = make_train_step(model, cfg, lr, wd, make_batch_transform(cfg),
                               probe_model=probe_twin(cfg, "cpu"))
        b, store = batch, None
        if on and key == "PRELOAD_DEVICE":
            vols = torch.cat([batch["image"].flatten(0, 1),
                              batch["image2"].flatten(0, 1)]).numpy()
            store = build_resident(vols, cfg.PRELOAD_DEVICE, "cpu")
            b = {k: v for k, v in batch.items()
                 if k not in ("image", "image2")}
            b["image_idx"] = torch.arange(4, dtype=torch.int32).reshape(2, 2)
            b["partner_idx"] = b["image_idx"] + 4
        m = step(state, b, store)
        losses[on] = float(m["loss"])
        watched = sorted(k for k in m if "/" in k or k == "attn_logit_max")
        if on and key == "WATCH_GRADIENTS":
            assert watched == ["attn_logit_max", "grad_norm/head",
                               "grad_norm/layer0", "grad_norm/layer1",
                               "grad_norm/layer2", "grad_norm/norm",
                               "grad_norm/patch_embed",
                               "grad_norm/patch_embed_norm"]
            assert all(np.isfinite(float(m[k])) for k in watched)
            # the modules' norms are of the clipped gradients (clip 1.0)
            total = np.sqrt(sum(float(m[k]) ** 2 for k in watched
                                if k.startswith("grad_norm/")))
            np.testing.assert_allclose(
                total, min(float(m["grad_norm"]), cfg.GRADIENT_CLIP),
                rtol=1e-5)
        else:
            assert watched == []
    assert losses[True] == losses[False]
