"""The port's ResNet-3D against vsn_tpu's, with the JAX weights and
statistics carried across by ``convert.state_dict_from_jax``: eval logits,
train-mode logits, the updated ``batch_stats`` and every parameter gradient,
for [1, 1, 1, 1] basic blocks with shortcut B and A and bottleneck blocks at
16x18x16; resnet18's parameter count; the convert round trip; the config
presets.

Tolerances. Eval forwards in f32 agree to 1e-4 of the logit scale (sum
order only). A training forward normalizes by batch statistics, and at this
size the last stage sees 2 values per channel, so the BatchNorm variance
mean(x^2) - mean^2 cancels: f32 logits differ by ~1e-3 of their scale
between frameworks and f32 gradients by up to ~70% in some leaves (the
ill-conditioning vsn_tpu/models/factory.py:19-22 describes). The training
forward and its gradients are therefore compared in f64 on both sides
(``jax_enable_x64`` set and restored, as scripts/golden_parity.py does):
logits and gradients to 1e-6 of each one's scale (the head runs in f32 on
both sides, as flax ``Dense(dtype=f32)``), statistics to 1e-9.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vsn_tpu.config import load_config as jax_load_config
from vsn_tpu.models import resnet3d as jres
from vsn_tpu_torch.config import PRESETS, READ_DEFAULTS, load_config
from vsn_tpu_torch.convert import jax_params_from_state_dict, state_dict_from_jax
from vsn_tpu_torch.models import build_model
from vsn_tpu_torch.models.resnet3d import RESNET_LAYERS, ResNet3D, init_weights

CONFIGS = Path(jres.__file__).resolve().parent.parent / "configs"
SHAPE = (2, 16, 18, 16, 1)
VARIANTS = [("basic", "B"), ("basic", "A"), ("bottleneck", "B")]


@pytest.fixture(scope="module", params=VARIANTS, ids=lambda v: "-".join(v))
def carried(request):
    """A JAX [1,1,1,1] ResNet with non-trivial f32 statistics (20 training
    updates on other data), and inputs."""
    block, kind = request.param
    jm = jres.ResNet3D(block=block, layers=[1, 1, 1, 1], num_classes=5,
                       shortcut_type=kind)
    rng = np.random.default_rng(0)
    x = rng.standard_normal(SHAPE).astype(np.float32)
    other = rng.standard_normal(SHAPE).astype(np.float32)
    v = jax.jit(lambda k, xx: jm.init(k, xx, True))(jax.random.key(0), x)
    update = jax.jit(lambda v, xx: jm.apply(v, xx, False,
                                            mutable=["batch_stats"])[1])
    for _ in range(20):
        v = {"params": v["params"], **update(v, other)}
    v = jax.tree.map(np.asarray, v)
    return block, kind, v, x


def _port(block, kind, variables, dtype=torch.float32):
    model = ResNet3D(block, [1, 1, 1, 1], 5, shortcut_type=kind, dtype=dtype)
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    return model.to(dtype)


def test_eval_logits_match_jax(carried):
    block, kind, v, x = carried
    jm = jres.ResNet3D(block=block, layers=[1, 1, 1, 1], num_classes=5,
                       shortcut_type=kind)
    want = np.asarray(jax.jit(lambda v, xx: jm.apply(v, xx, True))(v, x))
    model = _port(block, kind, v).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert np.abs(want).max() > 0.5  # not a dead network
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())
    before = {k: t.clone() for k, t in model.state_dict().items()}
    with torch.no_grad():
        model(torch.from_numpy(x))
    for k, t in model.state_dict().items():  # eval leaves the stats alone
        assert torch.equal(t, before[k]), k


@pytest.fixture
def x64():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:  # a global flag: later jits in this process must not see it
        jax.config.update("jax_enable_x64", False)


def test_train_forward_stats_and_grads_match_jax_in_f64(carried, x64):
    block, kind, v, x = carried
    jm = jres.ResNet3D(block=block, layers=[1, 1, 1, 1], num_classes=5,
                       shortcut_type=kind, dtype=jnp.float64)
    v64 = jax.tree.map(lambda a: np.asarray(a, np.float64), v)
    x64_ = x.astype(np.float64)

    def loss(params):
        logits, upd = jm.apply({"params": params,
                                "batch_stats": v64["batch_stats"]}, x64_,
                               False, mutable=["batch_stats"])
        return jnp.sum(jnp.sin(logits)), (logits, upd)

    grads, (want, upd) = jax.jit(jax.grad(loss, has_aux=True))(v64["params"])
    model = _port(block, kind, v, torch.float64).train()
    logits = model(torch.from_numpy(x64_))
    torch.sin(logits).sum().backward()
    want = np.asarray(want)
    np.testing.assert_allclose(logits.detach().numpy(), want, rtol=0,
                               atol=1e-6 * np.abs(want).max())
    stats = state_dict_from_jax({"params": {}, "batch_stats": jax.tree.map(
        np.asarray, upd["batch_stats"])}, np.float64)
    state = model.state_dict()
    assert len(stats) == sum("running" in k for k in state)
    for name, w in stats.items():
        assert not torch.equal(w, state_dict_from_jax(v)[name]), name
        np.testing.assert_allclose(state[name].numpy(), w.numpy(), rtol=1e-9,
                                   atol=1e-9, err_msg=name)
    jg = state_dict_from_jax({"params": jax.tree.map(np.asarray, grads)},
                             np.float64)
    for name, p in model.named_parameters():
        w = jg[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0,
                                   atol=1e-6 * np.abs(w).max(), err_msg=name)


def test_head_dropout_follows_flax():
    """Train-mode head dropout keeps a feature with p = 1 - DROPOUT and
    scales it by 1/p (flax Dropout), by the injected mask."""
    torch.manual_seed(0)
    x = torch.randn(SHAPE)
    model = init_weights(ResNet3D("basic", [1, 1, 1, 1], 5, head_dropout=0.25),
                         torch.Generator().manual_seed(0)).train()
    plain = ResNet3D("basic", [1, 1, 1, 1], 5).train()
    plain.load_state_dict(model.state_dict())
    w = model.resnet.fc.weight
    keep = torch.ones(2, 512, dtype=torch.bool)
    with torch.no_grad():
        plain.resnet.fc.weight.copy_(w / 0.75)
        torch.testing.assert_close(model(x, draws=keep), plain(x))
        got = model(x, draws=torch.zeros_like(keep))
        torch.testing.assert_close(got, model.resnet.fc.bias.expand(2, 5))
        with pytest.raises(ValueError):
            model(x)
        gen = torch.Generator().manual_seed(1)
        assert model.draw(2, "cpu", gen).float().mean() < 1


def test_resnet18_parameter_count_and_names_match_jax():
    cfg = jax_load_config(extra_overrides={"ARCHITECTURE": "ResNet",
                                           "DROPOUT": 0.1})
    jm = jres.resnet_from_config(cfg)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0),
                                            jnp.ones((1, 32, 32, 32, 1)),
                                            True))
    n_jax = sum(int(np.prod(l.shape)) for l in jax.tree.leaves(
        shapes["params"]))
    model = build_model(load_config(preset="resnet-5c-no_seed-baseline"),
                        device="cpu")
    assert RESNET_LAYERS["resnet18"] == ("basic", [2, 2, 2, 2])
    assert sum(p.numel() for p in model.parameters()) == n_jax
    assert model.head_dropout == 0.1 and not model.training
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    model.load_state_dict(state_dict_from_jax(zeros), strict=True)


def test_convert_round_trip_is_exact(carried):
    *_, v, _ = carried
    back = jax_params_from_state_dict(state_dict_from_jax(v))
    flat_in = jax.tree_util.tree_leaves_with_path(v)
    flat_out = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_in) == len(flat_out)
    for path, leaf in flat_in:
        np.testing.assert_array_equal(flat_out[path], leaf)


@pytest.mark.parametrize("name", sorted(PRESETS))
def test_presets_equal_load_config_of_their_yaml(name):
    jcfg = jax_load_config(CONFIGS / f"{name}.yaml")
    port = load_config(preset=name)
    for key, value in port.items():
        assert value == jcfg.get(key, READ_DEFAULTS.get(key)), key
    for key in jcfg:
        if key in PRESETS[name] or key not in port:
            continue
        assert port[key] == jcfg[key], key
    assert set(PRESETS[name]) <= set(jcfg)
    assert port.num_classes == jcfg.num_classes


def test_build_model_needs_a_card_or_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = load_config(dict(ARCHITECTURE="ResNet", RESNET_VARIANT="resnet10"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(cfg)
    model = build_model(cfg, device="cpu")
    assert next(model.parameters()).device.type == "cpu"
