"""chip_smoke.py's parity phases reject a kernel that drops a term, and its
training phase runs end to end at a tiny size.

On the CPU every wrapper runs its plain version, so a "kernel" here is the
plain version with one term removed or one index broken (a mutant). The
forward and backward parity phases must reject each mutant at the
tolerances they hold the CUDA kernels to on the card (f32 1e-4, bf16 2e-2
of the output's or each gradient's scale, movers and their adjoints
bit-exact) and accept the plain versions themselves. The calls are recorded
from one forward of a tiny Swin (stage 1 shifted and window-resident, stage
2 padded, stage 3 clamped and unshifted) at batch 2, in f32 and in bf16:
an eval forward for the forward phase, a training forward (ShakeDrop
draws) for the backward phase.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from vsn_tpu_torch.config import load_config
from vsn_tpu_torch.data.augment import zscore
from vsn_tpu_torch.models import build_model
from vsn_tpu_torch.models.swin3d import init_weights
from vsn_tpu_torch.train.step import init_train_state

TINY = dict(IMG_SIZE=[12, 18, 12], PATCH_SHAPE=[2, 2, 2],
            WINDOW_SIZE=[2, 3, 2], EMBED_DIM=8, DEPTH=[2, 2, 2],
            HEADS=[1, 2, 4], USE_SHAKEDROP=True)


def _zeros(i):
    return i, lambda a: torch.zeros_like(a[i])


def _first_gain(i):
    return i, lambda a: a[i][:1].expand(a[i].shape[0]).contiguous()


MUTANTS = {  # name -> (wrapper, [(argument index, new value from args)])
    "no relative-position bias": ("attn_half", [(5, lambda a: None)]),
    "no region mask": ("attn_half", [(6, lambda a: None)]),
    "no LayerNorm shift": ("attn_half", [_zeros(2)]),
    "no qkv bias": ("attn_half", [_zeros(4)]),
    "attention left out": ("attn_half", [_zeros(3), _zeros(4)]),
    "first sample's gain for all (K1)": ("attn_half", [_first_gain(9)]),
    "no LayerNorm scale": ("ln_mlp", [(1, lambda a: torch.ones_like(a[1]))]),
    "no fc1 bias": ("ln_mlp", [_zeros(4)]),
    "MLP left out": ("ln_mlp", [_zeros(5)]),
    "first sample's gain for all (K2)": ("ln_mlp", [_first_gain(7)]),
    "junction roll sign flipped": (
        "windows_to_windows", [(3, lambda a: tuple(-r for r in a[3]))]),
}


def _mutant(plain, changes):
    def kernel(*args, **kw):
        new = list(args)
        for i, fn in changes:
            new[i] = fn(args)
        return plain(*new, **kw)
    return kernel


def _record(dtype, train):
    model = build_model(load_config(dict(TINY, FP16=dtype == "bfloat16")))
    init_weights(model, torch.Generator().manual_seed(0))
    x = np.random.default_rng(0).standard_normal((2, 12, 18, 12, 1))
    x = zscore(torch.from_numpy(x.astype(np.float32)))
    if train:
        return chip_smoke.record_calls(
            model.train(), x, generator=torch.Generator().manual_seed(1))
    return chip_smoke.record_calls(model.eval(), x)


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def calls(request):
    return _record(request.param, train=False)


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def train_calls(request):
    return _record(request.param, train=True)


def test_plain_versions_pass_and_every_case_is_covered(calls):
    worst, kinds = chip_smoke.parity_phase(
        {"tiny": calls}, chip_smoke.kernel_table(),
        torch.Generator().manual_seed(3))
    assert set(worst) == set(chip_smoke.kernel_table())
    assert all(err == 0.0 for err in worst.values())
    assert {"shifted ids", "padded ids", "no mask"} <= kinds["tiny"]["attn_half"]


@pytest.mark.parametrize("mutant", sorted(MUTANTS))
def test_a_kernel_missing_a_term_fails(calls, mutant):
    name, changes = MUTANTS[mutant]
    table = chip_smoke.kernel_table()
    table[name] = (_mutant(table[name][1], changes), table[name][1])
    with pytest.raises(AssertionError, match=name):
        chip_smoke.parity_phase({"tiny": calls}, table,
                                torch.Generator().manual_seed(3))


def test_seeded_params_keep_shapes_and_give_distinct_gains(calls):
    gen = torch.Generator().manual_seed(3)
    for name, args in calls:
        new = chip_smoke.seeded_params(name, args, gen)
        assert len(new) == len(args)
        for a, b in zip(args, new):
            if isinstance(a, torch.Tensor):
                assert b.shape == a.shape and b.dtype == a.dtype
            else:
                assert (a is None) == (b is None)
        if name in chip_smoke.BLOCK_KERNELS:
            i = 9 if name == "attn_half" else 7
            gf, gb = new[i], new[i + 1]
            assert len(set(gf.tolist())) == gf.shape[0] == 2
            assert (gf != gb).all()


def test_main_refuses_to_run_without_a_card(monkeypatch):
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        chip_smoke.main()
    assert exc.value.code not in (0, None)


class _GradScale(torch.autograd.Function):
    """Identity forward; the backward scales the gradient by ``k``."""

    @staticmethod
    def forward(ctx, t, k):
        ctx.k = k
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.k, None


def _scaled_grad(i, k):
    return i, lambda a: _GradScale.apply(a[i], k)


class _W2WWrongAdjoint(torch.autograd.Function):
    """windows_to_windows whose adjoint keeps the roll (not negated)."""

    @staticmethod
    def forward(ctx, wins, window, dims, roll):
        from vsn_tpu_torch.ops import window_relayout as wr

        ctx.args = (window, dims, roll)
        return wr.windows_to_windows_reference(wins, window, dims, roll)

    @staticmethod
    def backward(ctx, g):
        from vsn_tpu_torch.ops import window_relayout as wr

        return (wr.windows_to_windows_reference(g, *ctx.args), None, None,
                None)


BACKWARD_MUTANTS = {  # name -> (wrapper, [(argument index, new value)])
    "backward uses gf for gb (K1b)": ("attn_half", [(10, lambda a: a[9])]),
    "backward uses gf for gb (K2b)": ("ln_mlp", [(8, lambda a: a[7])]),
    "dbias dropped": ("attn_half", [_scaled_grad(5, 0.0)]),
    "qkv weight grad from half the rows": ("attn_half",
                                           [_scaled_grad(3, 0.5)]),
    "LayerNorm shift grad dropped (K2b)": ("ln_mlp", [_scaled_grad(2, 0.0)]),
    "fc1 weight grad off by 3%": ("ln_mlp", [_scaled_grad(3, 1.03)]),
    "dx off by 3%": ("attn_half", [_scaled_grad(0, 1.03)]),
}


def test_plain_backward_passes_and_every_case_is_covered(train_calls):
    worst, kinds = chip_smoke.grad_parity_phase(
        {"tiny": train_calls}, chip_smoke.kernel_table(),
        torch.Generator().manual_seed(3))
    assert set(worst) == {chip_smoke.backward_name(n)
                          for n in chip_smoke.kernel_table()}
    assert all(err == 0.0 for err in worst.values())
    assert {"shifted ids", "padded ids", "no mask"} <= kinds["tiny"][
        "attn_half_bwd"]
    chip_smoke.saturation_phase(train_calls, chip_smoke.kernel_table(),
                                torch.Generator().manual_seed(4))


@pytest.mark.parametrize("mutant", sorted(BACKWARD_MUTANTS))
def test_a_backward_missing_a_term_fails(train_calls, mutant):
    name, changes = BACKWARD_MUTANTS[mutant]
    table = chip_smoke.kernel_table()
    table[name] = (_mutant(table[name][1], changes), table[name][1])
    with pytest.raises(AssertionError, match=name + "_bwd"):
        chip_smoke.grad_parity_phase({"tiny": train_calls}, table,
                                     torch.Generator().manual_seed(3))


def test_a_wrong_mover_adjoint_fails(train_calls):
    table = chip_smoke.kernel_table()
    table["windows_to_windows"] = (_W2WWrongAdjoint.apply,
                                   table["windows_to_windows"][1])
    with pytest.raises(AssertionError, match="windows_to_windows_adjoint"):
        chip_smoke.grad_parity_phase({"tiny": train_calls}, table,
                                     torch.Generator().manual_seed(3))


def test_training_phase_rehearsal_on_cpu():
    """The training phase's pieces at a tiny size: every parameter reached,
    finite metrics, and the plain route equal to the kernel route (both
    are the plain versions here)."""
    cfg = load_config(dict(TINY, FP16=True, USE_SAM=True, USE_EMA=True,
                           USE_MIXUP=True, LABEL_SMOOTHING=0.1, SEED=0,
                           BATCH_SIZE=2, EFFECTIVE_BATCH_SIZE=4,
                           LR_WARMUP=0, WD_WARMUP=0, STEPS=10))
    model = build_model(cfg)
    init_weights(model, torch.Generator().manual_seed(0))
    state = init_train_state(cfg, model)
    initial = state.params.flat.clone()
    batch = chip_smoke.train_batch(cfg, torch.device("cpu"), 5)
    assert batch["image"].shape == (chip_smoke.TRAIN_ACCUM, 2, 12, 18, 12, 1)
    draws = chip_smoke.Draws(model, 2, torch.device("cpu"), 0)
    assert len(draws(0, 0, 0)) == model.num_draws() > 0
    assert not chip_smoke.first_backward_grads(model, cfg, state, batch,
                                               draws)
    sync = lambda: None
    kernel, _ = chip_smoke.train_route(model, cfg, state, batch, draws, 2,
                                       sync)
    assert not torch.equal(state.params.flat, initial)
    with torch.no_grad():
        state.params.flat.copy_(initial)
    pstate = init_train_state(cfg, model)
    plain, _ = chip_smoke.train_route(model, cfg, pstate, batch, draws, 2,
                                      sync)
    assert chip_smoke.check_train_metrics(kernel, plain) == {
        "loss": 0.0, "grad_norm": 0.0}
    assert kernel[0]["loss"] != kernel[1]["loss"]
    with pytest.raises(AssertionError):
        chip_smoke.check_train_metrics(
            kernel, [dict(m, loss=m["loss"] * 1.1) for m in plain])
