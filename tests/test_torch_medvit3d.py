"""The port's MedViT-3D against vsn_tpu's on the CPU, in f64 on both sides
(``jax_enable_x64`` set and restored): BatchNorm over a few values per
channel is ill-conditioned at these sizes, as scripts/golden_parity_medvit.py
and tests/test_torch_resnet3d.py say.

The model has ``tests/test_resnet_medvit.py`` ``tiny_medvit``'s shape
(stem 16/8/16, depths (1, 2, 5, 1), dims [32, 32, 128, 64, 128, 128], head
dim 8: ECBs, and LTBs at the end of stages 2-4) on a 36x40x20 input: stage
grids 9x10x5, 5x5x3 (ceil-mode pool of odd extents), 3x3x2, 2x2x1, so
stage 2's LTB reduces 75 tokens at r = 16 (11 dropped) and stage 3's 18 at
r = 4 (2 dropped). The weights are non-trivial (BatchNorm scales and
shifts away from 1 and 0, convs and Dense kernels scaled up, statistics
away from 0 and 1) and carried over by ``convert.state_dict_from_jax`` (they are the port's init, made
non-trivial and carried into the JAX tree by the reverse map, which spares
a JAX init and training updates). Checked: eval logits, train-mode
logits, the updated ``batch_stats`` and every parameter gradient, with and
without LAYER_SCALE + ENABLE_STABLE + DropPath (its gains injected: JAX's
``drop_path`` replaced at ``vsn_tpu.models.layers``); and the parts alone:
``avg_pool_ceil`` at odd extents, ``EMHSA`` (eval and train, its
``sr_norm`` statistics), ``SELayer`` and ``ECALayer``.

Tolerances, relative to each quantity's largest value: 1e-9 for the parts
that compute in f64 on both sides (the pool, SE, ECA); 1e-6 where E-MHSA
runs (logits, statistics, E-MHSA alone): both sides take its scores and
products as f32 (the JAX einsums' preferred_element_type) and its softmax
in f32, so the two round at f32 (~6e-8) in different orders. Gradients to
1e-5 of the model's largest gradient (measured: <= 2.1e-6, at the stem's
conv, where that f32 rounding arrives through every BatchNorm; leaves whose
gradient is 0 up to rounding, such as a bias before a BatchNorm, are held
to the same absolute limit).
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_resnet_medvit import tiny_medvit
from vsn_tpu.models import layers as jlayers
from vsn_tpu.models import medvit3d as jmv
from vsn_tpu_torch.config import PRESETS, load_config
from vsn_tpu_torch.convert import jax_params_from_state_dict, state_dict_from_jax
from vsn_tpu_torch.models import build_model
from vsn_tpu_torch.models import medvit3d as mv

SHAPE = (2, 36, 40, 20, 1)
TINY = dict(num_classes=3, stem_chs=[16, 8, 16], depths=(1, 2, 5, 1),
            dims=[32, 32, 128, 64, 128, 128], head_dim=8,
            stochastic_depth_prob=0.0)
REGULARIZED = dict(layer_scale=True, layer_scale_init_value=0.5,
                   enable_stable=True, stochastic_depth_prob=0.2)
TOL = 1e-6
GRAD_TOL = 1e-5
F64 = np.float64


@pytest.fixture(scope="module")
def x64():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:  # a global flag: later jits in this process must not see it
        jax.config.update("jax_enable_x64", False)


def _carried(over, seed=0):
    """The JAX model and non-trivial variables (f64): the port's init at
    ``seed`` with BatchNorm scales 1 + 0.3 z, shifts, biases and LayerScale
    offsets 0.1 z, conv and Dense kernels x 3 (the head's x 30: O(1)
    logits), and statistics moved by five
    training forwards on other data; carried into the JAX tree by the
    reverse map."""
    model = mv.init_weights(mv.MedViT3D(**{**TINY, **over},
                                        dtype=torch.float64).double(),
                            torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, t in model.named_parameters():
            z = torch.from_numpy(rng.standard_normal(t.shape))
            if name.endswith(("bias", "gamma")):
                t.add_(0.1 * z)
            elif t.ndim == 1:
                t.add_(0.3 * z)
            else:
                t.mul_(30.0 if name.startswith("proj_head") else 3.0)
        other = torch.from_numpy(rng.standard_normal(SHAPE))
        model.train()
        for i in range(5):
            model(other + i, generator=torch.Generator().manual_seed(i))
    v = jax_params_from_state_dict(model.state_dict(), depths=TINY["depths"])
    v = jax.tree.map(lambda a: np.asarray(a, F64), v)
    return tiny_medvit(dtype=jnp.float64, **over), v


def _port(over, variables):
    model = mv.MedViT3D(**{**TINY, **over}, dtype=torch.float64).double()
    model.load_state_dict(state_dict_from_jax(variables, F64), strict=True)
    return model


GAINS = [np.array([1.25, 0.5]), np.array([0.0, 1.5])]


def _injected_gains(n):
    """JAX's drop_path replaced by the branch times the next of ``n`` gains
    (cycling over GAINS), in call order."""
    it = iter([GAINS[i % 2] for i in range(n)])

    def drop_path(x, rate, deterministic, rng):
        if deterministic or rate == 0.0:
            return x
        g = jnp.asarray(next(it)).reshape((x.shape[0],) + (1,) * (x.ndim - 1))
        return x * g
    return drop_path


def _close(got, want, tol, what):
    got, want = np.asarray(got), np.asarray(want)
    scale = np.abs(want).max()
    assert scale > 0, what
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale,
                               err_msg=what)


@pytest.mark.parametrize("over", [{}, REGULARIZED],
                         ids=["plain", "layerscale_stable_droppath"])
def test_model_eval_train_grads_and_statistics_match_jax(x64, over):
    jm, v = _carried(over)
    model = _port(over, v)
    x = np.random.default_rng(1).standard_normal(SHAPE)
    if not over:
        want = jax.jit(lambda vv, xx: jm.apply(vv, xx, True))(v, x)
        with torch.no_grad():
            got = model.eval()(torch.from_numpy(x))
        want = np.asarray(want)
        assert np.abs(want).max() > 0.5   # not a dead network
        assert np.abs(want[0] - want[1]).max() > 1e-3 * np.abs(want).max()
        _close(got, want, TOL, "eval logits")

    plan = model.train().draw_plan(2)
    n_gains = len(plan)
    assert all(shape is None for _, shape in plan)
    # ECBs 1, 3-6 (block 0's rate is 0) two each, LTBs 2, 7, 8 three each
    assert n_gains == (0 if not over else 2 * 5 + 3 * 3)
    ct = np.random.default_rng(2).standard_normal((2, 3))

    def loss(params):
        logits, upd = jm.apply({"params": params,
                                "batch_stats": v["batch_stats"]}, x, False,
                               mutable=["batch_stats"],
                               rngs={"dropout": jax.random.key(3)})
        return jnp.sum(logits * ct), (logits, upd)

    with mock.patch.object(jlayers, "drop_path", _injected_gains(n_gains)):
        grads, (want, upd) = jax.jit(jax.grad(loss, has_aux=True))(
            v["params"])
    draws = [tuple(torch.from_numpy(GAINS[i % 2]) for _ in range(2))
             for i in range(n_gains)]
    logits = model(torch.from_numpy(x), draws=draws)
    (logits * torch.from_numpy(ct)).sum().backward()
    _close(logits.detach(), want, TOL, "train logits")
    stats = state_dict_from_jax({"params": {}, "batch_stats": jax.tree.map(
        np.asarray, upd["batch_stats"])}, F64)
    state = model.state_dict()
    before = state_dict_from_jax(v, F64)
    assert len(stats) == sum("running" in k for k in state) > 0
    for name, w in stats.items():
        assert not torch.equal(w, before[name]), name
        _close(state[name], w, TOL, name)
    jg = state_dict_from_jax({"params": jax.tree.map(np.asarray, grads)}, F64)
    assert set(jg) == {n for n, _ in model.named_parameters()}
    scale = max(np.abs(w.numpy()).max() for w in jg.values())
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), jg[name].numpy(), rtol=0,
                                   atol=GRAD_TOL * scale, err_msg=name)


def test_parameter_names_are_the_reference_state_dicts_and_round_trip(x64):
    """The port's keys are those scripts/golden_parity_medvit.py reads
    (features.{f}, the LFF as conv.conv.{i}, mhca.group_conv3x3,
    e_mhsa.{q,k,v,proj,norm}), JAX's leaves map onto them one to one and
    back exactly at these depths."""
    shapes = jax.eval_shape(lambda: tiny_medvit().init(
        jax.random.key(0), jnp.ones(SHAPE), True))
    rng = np.random.default_rng(0)
    v = jax.tree.map(lambda s: rng.standard_normal(s.shape).astype(
        np.float32), shapes)
    sd = state_dict_from_jax(v)
    model = mv.MedViT3D(**TINY)
    assert set(sd) == set(model.state_dict())
    for key in ("stem.3.conv.weight", "stem.0.norm.running_var",
                "features.0.patch_embed.conv.weight",
                "features.2.mhca.group_conv3x3.weight",
                "features.2.conv.conv.6.fc.0.weight",
                "features.2.conv.conv.3.weight",
                "features.2.e_mhsa.norm.running_mean",
                "features.2.projection.norm.weight",
                "features.8.e_mhsa.proj.bias", "norm.running_mean",
                "proj_head.0.weight"):
        assert key in sd, key
    assert "features.8.e_mhsa.norm.weight" not in sd   # sr_ratio 1
    assert sd["features.2.conv.conv.3.weight"].shape == (384, 1, 3, 3, 3)
    back = jax_params_from_state_dict(sd, depths=TINY["depths"])
    flat_in = jax.tree_util.tree_leaves_with_path(v)
    flat_out = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_in) == len(flat_out)
    for path, leaf in flat_in:
        np.testing.assert_array_equal(flat_out[path], leaf)
    with pytest.raises(ValueError, match="depths"):
        jax_params_from_state_dict(sd)


@pytest.mark.parametrize("dims", [(9, 11, 9), (5, 6, 5), (4, 6, 2)])
def test_avg_pool_ceil_matches_jax(x64, dims):
    x = np.random.default_rng(0).standard_normal((2, *dims, 3))
    want = jmv.avg_pool_ceil(jnp.asarray(x), (2, 2, 2))
    got = mv.avg_pool_ceil(torch.from_numpy(x), (2, 2, 2))
    assert got.shape == want.shape == (2, *(-(-d // 2) for d in dims), 3)
    _close(got, want, 1e-12, "avg_pool_ceil")


def _dense_into(linear, tree):
    linear.weight.data = torch.from_numpy(np.asarray(tree["kernel"]).T.copy())
    if linear.bias is not None:
        linear.bias.data = torch.from_numpy(np.asarray(tree["bias"]).copy())


def test_emhsa_matches_jax_eval_and_train(x64):
    """E-MHSA alone at sr_ratio 2 on 18 tokens (r = 4: the last 2 dropped
    from the keys and values): eval, and train with its sr_norm batch
    statistics, output and updated statistics."""
    jm = jmv.EMHSA(head_dim=8, sr_ratio=2, dtype=jnp.float64)
    x = np.random.default_rng(0).standard_normal((2, 18, 32))
    v = jm.init(jax.random.key(0), x, True)
    v = {"params": jax.tree.map(lambda a: np.asarray(a) * 10, v["params"]),
         "batch_stats": jax.tree.map(lambda a: np.asarray(a, F64),
                                     v["batch_stats"])}
    port = mv.EMHSA(32, 8, 2, dtype=torch.float64).double()
    for name in ("q", "k", "v", "proj"):
        _dense_into(getattr(port, name), v["params"][name])
    bn = v["params"]["sr_norm"]
    port.norm.weight.data = torch.from_numpy(np.asarray(bn["scale"]).copy())
    port.norm.bias.data = torch.from_numpy(np.asarray(bn["bias"]).copy())
    assert port.reduced(18) == 4
    want = jm.apply(v, x, True)
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x))
    _close(got, want, TOL, "eval")
    want, upd = jm.apply(v, x, False, mutable=["batch_stats"])
    with torch.no_grad():
        got = port.train()(torch.from_numpy(x))
    _close(got, want, TOL, "train")
    stats = upd["batch_stats"]["sr_norm"]
    _close(port.norm.running_mean, stats["mean"], 1e-9, "mean")
    _close(port.norm.running_var, stats["var"], 1e-9, "var")


def test_se_and_eca_layers_match_jax(x64):
    x = np.random.default_rng(0).standard_normal((2, 3, 4, 5, 24))
    jse = jmv.SELayer(reduction=4, dtype=jnp.float64)
    v = jse.init(jax.random.key(0), x)["params"]
    se = mv.SELayer(24, 4).double()
    _dense_into(se.fc[0], v["fc1"])
    _dense_into(se.fc[2], v["fc2"])
    with torch.no_grad():
        _close(se(torch.from_numpy(x)), jse.apply({"params": v}, x), 1e-9,
               "SE")
    for kind in ("sigmoid", "h_sigmoid"):
        jeca = jmv.ECALayer(sigmoid_type=kind, dtype=jnp.float64)
        v = jeca.init(jax.random.key(1), x)["params"]
        eca = mv.ECALayer(24, sigmoid_type=kind, dtype=torch.float64).double()
        kernel = np.asarray(v["conv"]["kernel"])   # [k, 1, 1]
        assert eca.conv.weight.shape == (1, 1, kernel.shape[0]) == (1, 1, 3)
        eca.conv.weight.data = torch.from_numpy(
            kernel.transpose(2, 1, 0).copy() * 5)
        want = jeca.apply({"params": {"conv": {"kernel": kernel * 5}}}, x)
        with torch.no_grad():
            _close(eca(torch.from_numpy(x)), want, 1e-9, f"ECA {kind}")


@pytest.mark.parametrize("name", ["medvit-5c-no_seed-baseline",
                                  "medvit-3c-no_seed-baseline"])
def test_presets_build_medvit_s(name):
    """MedViT-S at the presets (DEPTH [3,4,10,3], head dim 32, MLP 3),
    built on the meta device; the parameter count is the JAX model's and
    LTBs close stages 2-4 (features 6, 11, 16, 19)."""
    cfg = load_config(preset=name)
    assert name in PRESETS and cfg.ARCHITECTURE == "MedViT"
    model = build_model(cfg, device="meta")
    kinds = [type(b).__name__ for b in model.features]
    assert [i for i, k in enumerate(kinds) if k == "LTB"] == [6, 11, 16, 19]
    assert model.features[6].e_mhsa.num_heads == 6   # 192 / 32
    from vsn_tpu.config import load_config as jax_load_config

    jm = jmv.medvit_from_config(jax_load_config(extra_overrides={
        k: cfg[k] for k in ("ARCHITECTURE", "DEPTH", "HEADS", "MLP_RATIO",
                            "DISEASES")}))
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.key(0), jnp.ones((1, 32, 32, 32, 1)), True))
    n_jax = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(
        shapes["params"]))
    assert sum(p.numel() for p in model.parameters()) == n_jax
