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

import shutil
import subprocess
import sys
from pathlib import Path

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
    model = build_model(load_config(dict(TINY, FP16=dtype == "bfloat16")),
                        device="cpu")
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
    model = build_model(cfg, device="cpu")
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


# ---------------------------------------------------------------------------
# The ResNet slice: K5 parity, bounds, and the ResNet phases at a tiny size
# ---------------------------------------------------------------------------

def _stem_cases():
    gen = torch.Generator().manual_seed(9)
    return {f"{dt} {geom}": chip_smoke.stem_case(geom, 2, getattr(torch, dt),
                                                torch.device("cpu"), gen)
            for dt in ("float32", "bfloat16") for geom in chip_smoke.STEM_GEOMS}


def _roll_taps(kernel):
    """The kernel's taps shifted by one (tap t reads tap t - 1's weights)."""
    return kernel.reshape(-1, kernel.shape[-1]).roll(1, 0).reshape(
        kernel.shape)


STEM_MUTANTS = {  # name -> (wrapper, mutant of its plain version)
    "tap order shifted by one (K5f)": (
        "stem_im2col", lambda plain: lambda x, k, s, p, dt: plain(
            x, _roll_taps(k), s, p, dt)),
    "tap order shifted by one (K5w)": (
        "stem_im2col_dw", lambda plain: lambda x, g, ks, s, p, dt:
        _roll_taps(plain(x, g, ks, s, p, dt))),
    "stride-2 offset off by one (K5f)": (
        "stem_im2col", lambda plain: lambda x, k, s, p, dt: plain(
            x.roll(1, dims=2), k, s, p, dt)),
    "stride-2 offset off by one (K5w)": (
        "stem_im2col_dw", lambda plain: lambda x, g, ks, s, p, dt: plain(
            x.roll(1, dims=2), g, ks, s, p, dt)),
    "split-K reduction over one slice only (K5w)": (
        "stem_im2col_dw", lambda plain: lambda x, g, ks, s, p, dt: plain(
            x[:1], g[:1], ks, s, p, dt)),
}


def test_stem_plain_versions_pass_every_case():
    worst = chip_smoke.stem_parity_phase(_stem_cases(),
                                         chip_smoke.stem_table())
    assert set(worst) == set(chip_smoke.STEM)
    assert all(err == 0.0 for err in worst.values())


@pytest.mark.parametrize("mutant", sorted(STEM_MUTANTS))
def test_a_stem_kernel_with_a_wrong_index_fails(mutant):
    name, make = STEM_MUTANTS[mutant]
    table = chip_smoke.stem_table()
    table[name] = (make(table[name][1]), table[name][1])
    with pytest.raises(AssertionError, match=name):
        chip_smoke.stem_parity_phase(_stem_cases(), table)


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_bounds_follow_the_shapes():
    """K5f at micro 12 (the ResNet stem): 2 * 343 * 64 FLOP for each of the
    12 * 144 * 84 * 72 output tokens, 458.8 GFLOP, 0.464 ms at 989 TFLOP/s
    against 1.42 GB, 0.425 ms at 3.35 TB/s; K5w the same FLOP; a mover only
    bytes."""
    x = _meta(12, 144, 168, 144, 1)
    kernel = _meta(7, 7, 7, 1, 64, dtype=torch.float32)
    g = _meta(12, 144, 84, 72, 64)
    calls = [("stem_im2col", (x, kernel, (1, 2, 2), (3, 3, 3), g))]
    flops, _ = chip_smoke.call_work("stem_im2col", calls[0][1])
    assert flops == 2 * 343 * 64 * 12 * 144 * 84 * 72
    for name in chip_smoke.STEM:
        ms, by = chip_smoke.bound_ms(name, calls)
        assert by == "operations" and ms == pytest.approx(0.4639, abs=1e-3)
    mover = [("spatial_to_windows", (_meta(8, 36, 42, 36, 96),))]
    ms, by = chip_smoke.bound_ms("spatial_to_windows_adjoint", mover)
    assert by == "bytes" and ms == pytest.approx(
        2 * 8 * 36 * 42 * 36 * 96 * 2 / 3.35e12 * 1e3)
    assert chip_smoke.bound_ms("attn_half", mover) == (0.0, "operations")


def test_swin_bounds_cover_every_recorded_call(calls):
    dtype = str(calls[0][1][0].dtype).removeprefix("torch.")
    names = [n for n in chip_smoke.KERNELS if n not in chip_smoke.STEM]
    for name in names + ["attention", "attention_bwd", "copy"]:
        ms, by = chip_smoke.bound_ms(name, calls, dtype)
        assert ms > 0 and by in ("bytes", "operations"), name
    # a backward does more work than its forward; the copy probe only moves
    for fwd in ("attn_half", "ln_mlp", "attention"):
        assert (chip_smoke.bound_ms(fwd + "_bwd", calls, dtype)[0]
                > chip_smoke.bound_ms(fwd, calls, dtype)[0])
    assert chip_smoke.bound_ms("copy", calls, dtype)[1] == "bytes"


RESNET_TINY = dict(RESNET_VARIANT="resnet10", IMG_SIZE=[16, 18, 16],
                   BATCH_SIZE=2, EFFECTIVE_BATCH_SIZE=4, USE_SAM=True,
                   USE_EMA=True, USE_MIXUP=True, MIXUP_PROB=0.5,
                   LABEL_SMOOTHING=0.1, SEED=0)


def test_resnet_phases_rehearsal_on_cpu():
    """The ResNet eval and training phases' pieces at a tiny size: refreshed
    statistics, Evaluator with the model's and with substituted weights,
    head-dropout draws, every parameter reached, the statistics moved and
    the EMA's apart, and the plain-stem route equal to the kernel route
    (both are the plain versions here)."""
    from vsn_tpu_torch.eval.evaluate import Evaluator
    from vsn_tpu_torch.models.resnet3d import init_weights as resnet_init
    from vsn_tpu_torch.train.step import eval_params

    cpu = torch.device("cpu")
    cfg = load_config(RESNET_TINY, preset=chip_smoke.RESNET_PRESET)
    assert cfg.DROPOUT == 0.1 and cfg.gradient_accumulation_steps() == 2
    model = resnet_init(build_model(cfg, device="cpu"),
                        torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    images = (rng.standard_normal((4, 16, 18, 16, 1)) * 50 + 100).astype(
        np.float16)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    stats = chip_smoke.refresh_statistics(model, cfg, images, 2)
    assert all(not torch.equal(v, before[k]) for k, v in stats.items())
    evaluator = Evaluator(cfg, model, batch_size=2)
    probs = evaluator.predict(images)
    chip_smoke.check_probs(probs, 4, 5)
    with chip_smoke.plain_stem():
        chip_smoke.compare_probs("tiny", probs, evaluator.predict(images))
    with pytest.raises(AssertionError):
        chip_smoke.compare_probs("tiny", probs, probs[:, ::-1].copy())

    state = init_train_state(cfg, model)
    initial = state.params.flat.clone()
    initial_stats = state.model_state.flat.clone()
    batch = chip_smoke.train_batch(cfg, cpu, 5)
    draws = chip_smoke.Draws(model, 2, cpu, 0)
    assert draws(0, 0, 0).shape == (2, 512)
    chip_smoke.reach_every_parameter(model, cfg, state, batch, draws, "tiny")
    with torch.no_grad():
        state.model_state.flat.copy_(initial_stats)
    sync = lambda: None
    kernel, _ = chip_smoke.train_route(model, cfg, state, batch, draws, 1,
                                       sync)
    after0 = state.params.flat.clone()
    more, _ = chip_smoke.train_route(model, cfg, state, batch, draws, 1, sync)
    chip_smoke.params_moved(state, initial, after0, "tiny")
    chip_smoke.statistics_checks(state, initial_stats)
    ema_probs = evaluator.predict(images[:2], eval_params(state, use_ema=True))
    chip_smoke.check_probs(ema_probs, 2, 5)
    with torch.no_grad():
        state.params.flat.copy_(initial)
        state.model_state.flat.copy_(initial_stats)
    pstate = init_train_state(cfg, model)
    with chip_smoke.plain_stem():
        plain, _ = chip_smoke.train_route(model, cfg, pstate, batch, draws, 2,
                                          sync)
    # the plain stem's weight gradient comes from autograd's conv VJP, the
    # kernel route's from stem_dw_reference: sums in another order
    rel = chip_smoke.check_train_metrics(kernel + more, plain)
    assert max(rel.values()) < 1e-5


# One-line edits of csrc/stem_im2col.cu that chip_smoke.py must reject on the
# card (exit 1, in its K5 parity phase): name -> (line, its mutant)
SOURCE_MUTANTS = {
    "tap order shifted by one (K5f weights)": (
        "w_s[i] = round_to<T>(wt[i]);",
        "w_s[i] = round_to<T>(wt[(i + g.c) % (taps * g.c)]);"),
    "stride-2 offset off by one (the halo's rows)": (
        "const int y = yo0 * g.sy - g.py + r;",
        "const int y = yo0 * g.sy - g.py + r + (g.sy == 2);"),
    "split-K reduction over one slice only (K5w)": (
        "if (!active) return;",
        "if (!active || blockIdx.x != 0) return;"),
}
ROOT = Path(__file__).resolve().parent.parent
STEM_SOURCE = ROOT / "vsn_tpu_torch" / "csrc" / "stem_im2col.cu"


@pytest.mark.parametrize("mutant", sorted(SOURCE_MUTANTS))
def test_source_mutants_name_one_line_of_the_source(mutant):
    line, new = SOURCE_MUTANTS[mutant]
    assert STEM_SOURCE.read_text().count(line) == 1 and new != line


@pytest.mark.cuda
@pytest.mark.parametrize("mutant", sorted(SOURCE_MUTANTS))
def test_a_mutated_stem_source_makes_chip_smoke_fail(mutant, tmp_path):
    """chip_smoke.py run from a copy of the port (the script and its
    package) whose stem kernel has one line mutated exits 1, failing the K5
    parity."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    line, new = SOURCE_MUTANTS[mutant]
    copy = tmp_path / "checkout"
    copy.mkdir()
    shutil.copy(ROOT / "chip_smoke.py", copy)
    shutil.copytree(ROOT / "vsn_tpu_torch", copy / "vsn_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    src = copy / STEM_SOURCE.relative_to(ROOT)
    src.write_text(src.read_text().replace(line, new))
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=copy,
                         capture_output=True, text=True, timeout=900)
    print(res.stdout[-3000:], res.stderr[-3000:])
    assert res.returncode == 1
    assert "stem kernels disagree with their plain versions" in res.stderr
