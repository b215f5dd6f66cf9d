"""The training parts of the port against their JAX counterparts, on the same
arrays: residual-branch gains, the gated residual's VJP, the loss, the
LR/WD tables, AdamW, clipping, SAM, the EMA, MixUp/CutMix and the mix
planner.

The port's optimizer and EMA work on one flat buffer of every parameter;
here the JAX side gets a small tree and the port its flat concatenation,
and the results are compared leaf by leaf. Both sides are f32 with the
same operation order, so the tolerances are a few f32 ulps (1e-6), except
where noted.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vsn_tpu.config import load_config as jax_load_config
from vsn_tpu.data import mixers as jmixers
from vsn_tpu.models import layers as jlayers
from vsn_tpu.train import ema as jema
from vsn_tpu.train import losses as jlosses
from vsn_tpu.train import optim as joptim
from vsn_tpu.train import schedules as jschedules
from vsn_tpu_torch.config import load_config
from vsn_tpu_torch.data import mixers
from vsn_tpu_torch.models import layers
from vsn_tpu_torch.train import ema, losses, optim, schedules

TOL = 1e-6


# ---------------------------------------------------------------------------
# residual-branch gains and the gated residual
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(6))
def test_shakedrop_gains_from_injected_draws_match_jax(seed):
    n, p = 4, 0.5
    key = jax.random.key(seed)
    want = jlayers.residual_branch_gains(n, p, True, (-1.0, 1.0), False, key)
    k_gate, k_alpha, k_beta = jax.random.split(key, 3)
    gate = np.array(jax.random.bernoulli(k_gate, 1.0 - p, ()))
    alpha = np.array(jax.random.uniform(k_alpha, (n,), minval=-1.0,
                                        maxval=1.0))
    beta = np.array(jax.random.uniform(k_beta, (n,)))
    got = layers.shakedrop_gains(torch.from_numpy(gate),
                                 torch.from_numpy(alpha),
                                 torch.from_numpy(beta))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("seed", range(3))
def test_drop_path_gains_from_injected_draws_match_jax(seed):
    n, p = 8, 0.3
    key = jax.random.key(seed)
    want = jlayers.residual_branch_gains(n, p, False, (-1.0, 1.0), False, key)
    mask = np.array(jax.random.bernoulli(key, 1.0 - p, (n,)))
    got = layers.drop_path_gains(torch.from_numpy(mask), 1.0 - p)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_training_gains_have_the_stated_distribution():
    gen = torch.Generator().manual_seed(0)
    p, trials, n = 0.3, 4000, 4
    gates, alphas, betas = [], [], []
    for _ in range(trials):
        gf, gb = layers.residual_branch_gains(n, p, True, (-1.0, 1.0), False,
                                              gen)
        gate = bool((gf == 1).all() and (gb == 1).all())
        gates.append(gate)
        if not gate:
            alphas.append(gf)
            betas.append(gb)
    assert abs(np.mean(gates) - (1 - p)) < 0.03   # Bernoulli(1 - p), 4000 draws
    alphas, betas = torch.cat(alphas), torch.cat(betas)
    assert alphas.min() >= -1 and alphas.max() < 1 and abs(alphas.mean()) < 0.05
    assert betas.min() >= 0 and betas.max() < 1 and abs(betas.mean() - 0.5) < 0.03
    gf, gb = layers.residual_branch_gains(20000, p, False, (-1.0, 1.0), False,
                                          gen)
    assert torch.equal(gf, gb)
    assert set(torch.unique(gf).tolist()) == {0.0, np.float32(1 / (1 - p))}
    assert abs((gf > 0).float().mean().item() - (1 - p)) < 0.02
    for shakedrop in (False, True):
        ones = layers.residual_branch_gains(3, 0.0, shakedrop, (-1.0, 1.0),
                                            False, gen)
        assert all(torch.equal(g, torch.ones(3)) for g in ones)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gated_residual_vjp_matches_jax(dtype):
    rng = np.random.default_rng(0)
    x, br, do = (rng.standard_normal((3, 4, 5)).astype(np.float32)
                 for _ in range(3))
    gf, gb = np.float32([0.5, 1.5, -0.25]), np.float32([0.2, 0.9, 0.6])
    jdt = getattr(jnp, dtype)
    out, vjp = jax.vjp(lambda a, b: jlayers.gated_residual(
        a, b, jnp.asarray(gf), jnp.asarray(gb), 0.75),
        jnp.asarray(x).astype(jdt), jnp.asarray(br).astype(jdt))
    want = vjp(jnp.asarray(do).astype(jdt))
    tdt = getattr(torch, dtype)
    a = torch.from_numpy(x).to(tdt).requires_grad_()
    b = torch.from_numpy(br).to(tdt).requires_grad_()
    got_out = layers.gated_residual(a, b, torch.from_numpy(gf),
                                    torch.from_numpy(gb), 0.75)
    got = torch.autograd.grad(got_out, [a, b], torch.from_numpy(do).to(tdt))
    f32 = lambda t: np.asarray(jnp.asarray(t).astype(jnp.float32))
    np.testing.assert_array_equal(got_out.detach().float().numpy(), f32(out))
    for g, w in zip(got, want):
        assert g.dtype == tdt
        np.testing.assert_array_equal(g.float().numpy(), f32(w))


# ---------------------------------------------------------------------------
# loss and schedules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("smoothing", [0.0, 0.1])
@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_label_smoothing_loss_matches_jax(smoothing, reduction):
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((6, 5)).astype(np.float32) * 3
    lam = rng.random((6, 1)).astype(np.float32)
    eye = np.eye(5, dtype=np.float32)
    targets = lam * eye[rng.integers(0, 5, 6)] + (1 - lam) * eye[
        rng.integers(0, 5, 6)]
    want = jlosses.label_smoothing_loss(logits, targets, smoothing, reduction)
    got = losses.label_smoothing_loss(torch.from_numpy(logits),
                                      torch.from_numpy(targets), smoothing,
                                      reduction)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def test_smoothing_from_config_matches_jax():
    for value in (False, None, 0.1, 0):
        assert losses.smoothing_from_config(load_config(
            dict(LABEL_SMOOTHING=value))) == jlosses.smoothing_from_config(
            jax_load_config(extra_overrides=dict(LABEL_SMOOTHING=value)))


@pytest.mark.parametrize("args", [(3e-4, 1e-5, 2500, 50), (0.05, 1e-4, 7, 0),
                                  (1.0, 0.5, 10, 10), (1.0, 0.0, 0, 0)])
def test_cosine_schedule_is_bit_equal(args):
    np.testing.assert_array_equal(schedules.cosine_schedule_steps(*args),
                                  jschedules.cosine_schedule_steps(*args))


def test_lr_wd_tables_are_bit_equal():
    over = dict(STEPS=300, LR_WARMUP=20, WD_WARMUP=7)
    for got, want in zip(schedules.lr_wd_schedules(load_config(over)),
                         jschedules.lr_wd_schedules(
                             jax_load_config(extra_overrides=over))):
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# AdamW, clipping, SAM, EMA on a small tree vs its flat concatenation
# ---------------------------------------------------------------------------

SHAPES = {"w": (4, 3), "b": (3,), "table": (5, 2), "scale": (2,)}


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal(s) * scale).astype(np.float32)
            for k, s in SHAPES.items()}


def _flat(tree):
    return torch.cat([torch.from_numpy(tree[k]).reshape(-1) for k in SHAPES])


def _unflat(flat):
    out, off = {}, 0
    for k, s in SHAPES.items():
        n = int(np.prod(s))
        out[k] = flat[off:off + n].reshape(s).numpy()
        off += n
    return out


def _decay_mask():
    mask = optim.wd_mask(SHAPES)
    return torch.cat([torch.full((int(np.prod(s)),), mask[k])
                      for k, s in SHAPES.items()])


def _assert_tree(got_flat, want_tree, tol=TOL):
    got = _unflat(got_flat)
    for k in SHAPES:
        np.testing.assert_allclose(got[k], np.asarray(want_tree[k]), rtol=tol,
                                   atol=tol, err_msg=k)


def test_wd_mask_matches_jax_leaf_by_leaf():
    want = joptim.wd_mask({k: np.zeros(s) for k, s in SHAPES.items()})
    assert optim.wd_mask(SHAPES) == {k: bool(v) for k, v in want.items()}


def test_adamw_matches_jax_over_two_updates():
    params, jstate = _tree(0), None
    jparams = jax.tree.map(jnp.asarray, params)
    jstate = joptim.adamw_init(jparams)
    flat = _flat(params)
    state = optim.adamw_init(flat)
    for i, (lr, wd) in enumerate([(1e-2, 0.05), (3e-3, 0.02)]):
        grads = _tree(10 + i)
        jparams, jstate = joptim.adamw_update(
            jax.tree.map(jnp.asarray, grads), jstate, jparams,
            jnp.float32(lr), jnp.float32(wd))
        flat, state = optim.adamw_update(_flat(grads), state, flat, lr, wd,
                                         _decay_mask())
        _assert_tree(flat, jparams)
        _assert_tree(state.mu, jstate.mu)
        _assert_tree(state.nu, jstate.nu)
        assert int(state.count) == int(jstate.count)


def test_clip_and_global_norm_match_jax():
    grads = _tree(3, scale=2.0)
    jgrads = jax.tree.map(jnp.asarray, grads)
    for max_norm in (0.5, 1e3):
        want, wnorm = joptim.clip_by_global_norm(jgrads, max_norm)
        got, norm = optim.clip_by_global_norm(_flat(grads), max_norm)
        np.testing.assert_allclose(norm.item(), float(wnorm), rtol=TOL)
        _assert_tree(got, want)
    np.testing.assert_allclose(optim.global_norm(_flat(grads)).item(),
                               float(joptim.global_norm(jgrads)), rtol=TOL)


@pytest.mark.parametrize("adaptive", [False, True])
def test_sam_perturbation_matches_jax(adaptive):
    params, grads = _tree(4), _tree(5)
    want, wnorm = joptim.sam_perturbation(jax.tree.map(jnp.asarray, params),
                                          jax.tree.map(jnp.asarray, grads),
                                          0.05, adaptive)
    got, norm = optim.sam_perturbation(_flat(params), _flat(grads), 0.05,
                                       adaptive)
    np.testing.assert_allclose(norm.item(), float(wnorm), rtol=TOL)
    _assert_tree(got, want)
    for bad in (0.0, np.nan):   # zero or non-finite norm: zero perturbation
        g = _flat(grads) * 0 + bad
        e, _ = optim.sam_perturbation(_flat(params), g, 0.05, adaptive)
        assert torch.equal(e, torch.zeros_like(e))
    assert not optim.all_finite(torch.tensor([1.0, np.inf]))
    assert optim.all_finite(_flat(params))


def test_ema_matches_jax_over_five_pushes():
    n = 3
    jstate = jema.ema_init(jax.tree.map(jnp.asarray, _tree(0)), n)
    state = ema.ema_init(_flat(_tree(0)), n)
    assert state.ema.data_ptr() != _flat(_tree(0)).data_ptr()
    for i in range(5):
        snap = _tree(20 + i)
        jstate = jema.ema_update(jstate, jax.tree.map(jnp.asarray, snap),
                                 0.9, n)
        state = ema.ema_update(state, _flat(snap), 0.9, n)
        assert int(state.count) == int(jstate.count)
        _assert_tree(state.ema, jstate.ema)
        for slot in range(n):
            _assert_tree(state.queue[slot],
                         jax.tree.map(lambda q: q[slot], jstate.queue), 0.0)


# ---------------------------------------------------------------------------
# MixUp / CutMix and the planner
# ---------------------------------------------------------------------------

def _mix_batch(seed):
    rng = np.random.default_rng(seed)
    b = 4
    x1, x2 = (rng.standard_normal((b, 6, 5, 4, 1)).astype(np.float16)
              for _ in range(2))
    eye = np.eye(5, dtype=np.float32)
    y1, y2 = eye[rng.integers(0, 5, b)], eye[rng.integers(0, 5, b)]
    lam = rng.beta(0.3, 0.3, b).astype(np.float32)
    apply = np.array([True, False, True, True])
    bounds = np.array([[0, 1, 0, 3, 4, 2], [1, 0, 1, 5, 5, 4],
                       [2, 2, 2, 2, 5, 4], [0, 0, 0, 6, 5, 4]], np.int32)
    return x1, x2, y1, y2, lam, apply, bounds


def test_mixup_and_cutmix_match_jax():
    x1, x2, y1, y2, lam, apply, bounds = _mix_batch(0)
    t = torch.from_numpy
    want = jmixers.apply_mixup(x1, x2, y1, y2, lam, apply)
    got = mixers.apply_mixup(t(x1), t(x2), t(y1), t(y2), t(lam), t(apply))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL,
                                   atol=TOL)
    want = jmixers.apply_cutmix(x1, x2, y1, y2, bounds, lam, apply)
    got = mixers.apply_cutmix(t(x1), t(x2), t(y1), t(y2), t(bounds), t(lam),
                              t(apply))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    with pytest.raises(ValueError):
        mixers.build_mix_fn(load_config(dict(USE_MIXUP=True, USE_CUTMIX=True)))
    assert mixers.build_mix_fn(load_config()) is None


@pytest.mark.parametrize("mode", ["USE_MIXUP", "USE_CUTMIX", None])
def test_mix_planner_plans_are_bit_equal(mode):
    over = {mode: True} if mode else {}
    labels = np.array(["CN", "AD", "CN", "BV", "SD", "AD", "PNFA", "CN"] * 3)
    cfg, jcfg = load_config(over), jax_load_config(extra_overrides=over)
    diseases = list(cfg.DISEASES)
    idx = np.arange(len(labels))[::-1].copy()
    got = mixers.MixPlanner(labels, diseases, cfg, (20, 24, 20)).plan(
        idx, 0, np.random.default_rng(7))
    want = jmixers.MixPlanner(labels, diseases, jcfg, (20, 24, 20)).plan(
        idx, 0, np.random.default_rng(7))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got[k].dtype == want[k].dtype
    for lam in (0.2, 0.7):
        gb, gl = mixers.cutmix_bounds((9, 8, 7), lam, np.random.default_rng(1))
        wb, wl = jmixers.cutmix_bounds((9, 8, 7), lam, np.random.default_rng(1))
        np.testing.assert_array_equal(gb, wb)
        assert gl == wl
