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

import math
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


def _record(dtype, train, over=TINY, blocks=None):
    model = build_model(load_config(dict(over, FP16=dtype == "bfloat16")),
                        device="cpu")
    init_weights(model, torch.Generator().manual_seed(0))
    x = np.random.default_rng(0).standard_normal((2, 12, 18, 12, 1))
    x = zscore(torch.from_numpy(x.astype(np.float32)))
    if train:
        return chip_smoke.record_calls(
            model.train(), x, blocks,
            generator=torch.Generator().manual_seed(1))
    return chip_smoke.record_calls(model.eval(), x, blocks)


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
    """Every Swin kernel's bound from the calls of its own path: K1/K2/K3
    from the LayerNorm model's, K4 from the DynamicTanh model's, V1 and V3
    from the V calls made of those K4 calls (the probes' bounds come from
    their own calls: test_probe_bounds_follow_the_shapes)."""
    dtype = str(calls[0][1][0].dtype).removeprefix("torch.")
    blocks = []
    dyt = _record(dtype, False, DYT_TINY, blocks)
    calls = calls + dyt + chip_smoke.v_main_calls(chip_smoke.v_calls(
        dyt, blocks, torch.Generator().manual_seed(0)))
    names = [n for n in chip_smoke.KERNELS if n not in chip_smoke.STEM
             and n not in chip_smoke.PROBES]
    for name in names:
        ms, by = chip_smoke.bound_ms(name, calls, dtype)
        assert ms > 0 and by in ("bytes", "operations"), name
    # a backward does more work than its forward
    for fwd in ("attn_half", "ln_mlp", "attention"):
        assert (chip_smoke.bound_ms(fwd + "_bwd", calls, dtype)[0]
                > chip_smoke.bound_ms(fwd, calls, dtype)[0])


def test_k4_bounds_follow_the_shapes():
    """K4f at Swin-T stage 1, micro 8 (qkv [1728, 252, 288] bf16, bias [3,
    252, 252], ids [216, 252]): 4 * 1728 * 252^2 * 96 FLOP (0.043 ms at 989
    TFLOP/s) against qkv, bias and ids read and out written (0.100 ms at
    3.35 TB/s): bound by bytes; K4b does 10 / 4 of the FLOP and moves
    qkv, bias twice, dout once."""
    qkv = _meta(1728, 252, 288)
    bias = _meta(3, 252, 252, dtype=torch.float32)
    ids = _meta(216, 252, dtype=torch.int32)
    calls = [("attention", (qkv, bias, ids, 32 ** -0.5, 3))]
    work = 1728 * 252 * 252 * 96
    out = 1728 * 252 * 96 * 2
    qkv_b, bias_b, ids_b = 3 * out, 3 * 252 * 252 * 4, 216 * 252 * 4
    assert chip_smoke.call_work("attention", calls[0][1]) == (
        4 * work, qkv_b + bias_b + ids_b + out)
    assert chip_smoke.call_work("attention_bwd", calls[0][1]) == (
        10 * work, 2 * (qkv_b + bias_b) + ids_b + out)
    ms, by = chip_smoke.bound_ms("attention", calls)
    assert by == "bytes" and ms == pytest.approx(
        (qkv_b + bias_b + ids_b + out) / 3.35e12 * 1e3)
    assert chip_smoke.bound_ms("attention_bwd", calls)[0] > ms


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
    res = _run_mutated_chip_smoke(STEM_SOURCE, *SOURCE_MUTANTS[mutant],
                                  tmp_path)
    assert res.returncode == 1
    assert "stem kernels disagree with their plain versions" in res.stderr


def _run_mutated_chip_smoke(source, line, new, tmp_path):
    """Run chip_smoke.py from a copy of the script and the port package
    whose ``source`` has ``line`` replaced by ``new``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    copy = tmp_path / "checkout"
    copy.mkdir()
    shutil.copy(ROOT / "chip_smoke.py", copy)
    shutil.copytree(ROOT / "vsn_tpu_torch", copy / "vsn_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    src = copy / source.relative_to(ROOT)
    src.write_text(src.read_text().replace(line, new))
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=copy,
                         capture_output=True, text=True, timeout=900)
    print(res.stdout[-6000:], res.stderr[-3000:])
    return res


# ---------------------------------------------------------------------------
# The unfused-block slice: K4 parity, its mutants, the DynamicTanh phases
# ---------------------------------------------------------------------------

DYT_TINY = dict(TINY, NORM_LAYER="DynamicTanh", DROPOUT=0.2)


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def k4_calls(request):
    """The K4 calls of a tiny DynamicTanh Swin's eval forward."""
    return _record(request.param, False, DYT_TINY)


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def k4_train_calls(request):
    """The K4 calls of its training forward (dropout and ShakeDrop draws)."""
    return _record(request.param, True, DYT_TINY)


def test_k4_plain_versions_pass_and_every_case_is_covered(k4_calls,
                                                          k4_train_calls):
    table = chip_smoke.attention_table()
    gen = torch.Generator().manual_seed(3)
    for calls in (k4_calls, k4_train_calls):
        assert {name for name, _ in calls} == {"attention"}
        assert len(calls) == 6   # one per block: every block is unfused
        worst, kinds = chip_smoke.parity_phase({"tiny": calls}, table, gen)
        bworst, bkinds = chip_smoke.grad_parity_phase({"tiny": calls}, table,
                                                      gen)
        assert worst == {"attention": 0.0}
        assert bworst == {"attention_bwd": 0.0}
        cases = {"shifted ids", "padded ids", "no mask"}
        assert cases <= kinds["tiny"]["attention"]
        assert cases <= bkinds["tiny"]["attention_bwd"]
    chip_smoke.saturation_phase(k4_calls, table, gen, "attention")


def _ids_row_bw(a):
    """Window bw reads ids row bw (the last row past the end), not bw % W."""
    ids, bw = a[2], a[0].shape[0]
    return ids[torch.arange(bw).clamp(max=ids.shape[0] - 1)]


K4_MUTANTS = {  # name -> [(argument index, new value from args)]
    "ids row bw instead of bw % W": [(2, _ids_row_bw)],
    "head 0's bias for every head": [
        (1, lambda a: a[1][:1].expand_as(a[1]).contiguous())],
}


@pytest.mark.parametrize("mutant", sorted(K4_MUTANTS))
def test_a_k4_with_a_wrong_index_fails(k4_calls, mutant):
    table = chip_smoke.attention_table()
    table["attention"] = (_mutant(table["attention"][1], K4_MUTANTS[mutant]),
                          table["attention"][1])
    with pytest.raises(AssertionError, match="attention"):
        chip_smoke.parity_phase({"tiny": k4_calls}, table,
                                torch.Generator().manual_seed(3))


class _GradSliceScale(torch.autograd.Function):
    """Identity forward; the backward scales channels [lo, hi) of the last
    axis of the gradient by ``k``."""

    @staticmethod
    def forward(ctx, t, lo, hi, k):
        ctx.span = lo, hi, k
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        lo, hi, k = ctx.span
        g = g.clone()
        g[..., lo:hi] *= k
        return g, None, None, None


def _dk_without_scale(plain):
    def kernel(qkv, bias, ids, scale, heads):
        c = qkv.shape[-1] // 3
        return plain(_GradSliceScale.apply(qkv, c, 2 * c, 1 / scale), bias,
                     ids, scale, heads)
    return kernel


class _DbiasFromOneWindow(torch.autograd.Function):
    """K4 whose dbias is window 0's alone, not the sum over every window."""

    @staticmethod
    def forward(ctx, qkv, bias, ids, scale, heads):
        from vsn_tpu_torch.ops import window_attention as wa

        ctx.save_for_backward(qkv, bias, ids)
        ctx.static = scale, heads
        return wa.window_attention_qkv_math(qkv, bias, ids, scale, heads)

    @staticmethod
    def backward(ctx, g):
        from vsn_tpu_torch.ops import window_attention as wa

        qkv, bias, ids = ctx.saved_tensors
        dqkv, _ = wa.window_attention_qkv_backward_reference(
            qkv, bias, ids, g, *ctx.static)
        _, dbias = wa.window_attention_qkv_backward_reference(
            qkv[:1], bias, ids[:1], g[:1], *ctx.static)
        return dqkv, dbias, None, None, None


K4_BACKWARD_MUTANTS = {  # name -> mutant of the plain version
    "dk without scale": _dk_without_scale,
    "dbias from one window": lambda plain: _DbiasFromOneWindow.apply,
}


@pytest.mark.parametrize("mutant", sorted(K4_BACKWARD_MUTANTS))
def test_a_k4_backward_missing_a_term_fails(k4_train_calls, mutant):
    table = chip_smoke.attention_table()
    plain = table["attention"][1]
    table["attention"] = (K4_BACKWARD_MUTANTS[mutant](plain), plain)
    # the forward is the plain one: only the backward phase can catch it
    chip_smoke.parity_phase({"tiny": k4_train_calls}, table,
                            torch.Generator().manual_seed(3))
    with pytest.raises(AssertionError, match="attention_bwd"):
        chip_smoke.grad_parity_phase({"tiny": k4_train_calls}, table,
                                     torch.Generator().manual_seed(3))


def test_dyt_training_phase_rehearsal_on_cpu():
    """The DynamicTanh + DROPOUT training phase's pieces at a tiny size:
    keep masks among the draws, drawn alike at every call; every parameter,
    each DyT alpha included, reached; the plain route equal to the kernel
    route (both are the plain versions here)."""
    cfg = load_config(dict(DYT_TINY, FP16=True, USE_SAM=True, USE_EMA=True,
                           USE_MIXUP=True, LABEL_SMOOTHING=0.1, SEED=0,
                           BATCH_SIZE=2, EFFECTIVE_BATCH_SIZE=4,
                           LR_WARMUP=0, WD_WARMUP=0, STEPS=10))
    model = build_model(cfg, device="cpu")
    init_weights(model, torch.Generator().manual_seed(0))
    assert not model.train().fused()
    state = init_train_state(cfg, model)
    alphas = [n for n in state.params.names if n.endswith(".alpha")]
    assert len(alphas) == 2 * 6 + 2 + 1 + 1   # blocks, mergings, embed, final
    initial = state.params.flat.clone()
    batch = chip_smoke.train_batch(cfg, torch.device("cpu"), 5)
    draws = chip_smoke.Draws(model, 2, torch.device("cpu"), 0)
    masks, again = ([d for d in draws(0, 1, 1) if isinstance(d, torch.Tensor)]
                    for _ in range(2))
    assert len(masks) == 1 + 3 * 6 and all(m.dtype == torch.bool
                                           for m in masks)
    assert all(torch.equal(a, b) for a, b in zip(masks, again))
    chip_smoke.reach_every_parameter(model, cfg, state, batch, draws, "tiny")
    sync = lambda: None
    kernel, _ = chip_smoke.train_route(model, cfg, state, batch, draws, 2,
                                       sync)
    assert not torch.equal(state.params.flat, initial)
    with torch.no_grad():
        state.params.flat.copy_(initial)
    pstate = init_train_state(cfg, model)
    with chip_smoke.patched_model_ops(lambda name, kernel, plain: plain):
        plain, _ = chip_smoke.train_route(model, cfg, pstate, batch, draws, 2,
                                          sync)
    assert chip_smoke.check_train_metrics(kernel, plain) == {
        "loss": 0.0, "grad_norm": 0.0}


# One-line edits of csrc/window_attention_qkv.cu that chip_smoke.py must
# reject on the card (exit 1, in its K4 parity phase): name -> (line, mutant)
K4_SOURCE = ROOT / "vsn_tpu_torch" / "csrc" / "window_attention_qkv.cu"
K4_SOURCE_MUTANTS = {
    "ids row (bw + 1) % W (K4f and K4b)": (
        "return bw % rows;",
        "return (bw + 1) % rows;"),
    "head 0's bias for every head (K4f)": (
        "const float* bias_h = p.bias + (long long)h * n * n;",
        "const float* bias_h = p.bias;"),
    "dk without scale (K4b)": (
        "p.dk[at.in(j) + lane] = from_f32<T>(ak * p.scale);",
        "p.dk[at.in(j) + lane] = from_f32<T>(ak);"),
    "dbias from one window (K4b)": (
        "atomicAdd(&dbias_h[(long long)i * n + j], ds);",
        "if (bw == 0) atomicAdd(&dbias_h[(long long)i * n + j], ds);"),
}


@pytest.mark.parametrize("mutant", sorted(K4_SOURCE_MUTANTS))
def test_k4_source_mutants_name_one_line_of_the_source(mutant):
    line, new = K4_SOURCE_MUTANTS[mutant]
    assert K4_SOURCE.read_text().count(line) == 1 and new != line


@pytest.mark.cuda
@pytest.mark.parametrize("mutant", sorted(K4_SOURCE_MUTANTS))
def test_a_mutated_k4_source_makes_chip_smoke_fail(mutant, tmp_path):
    """chip_smoke.py run from a copy whose K4 source has one line mutated
    exits 1, failing the K4 parity (forward or backward)."""
    res = _run_mutated_chip_smoke(K4_SOURCE, *K4_SOURCE_MUTANTS[mutant],
                                  tmp_path)
    assert res.returncode == 1
    assert "kernels disagree with their plain versions: DyT" in res.stderr


# ---------------------------------------------------------------------------
# V1 and V3 on the K4 calls: the V phase at a tiny size, its mutants
# ---------------------------------------------------------------------------

# the tiny model has no clamped N = 150 stage
TINY_V_CASES = {name: cases - {"N=150"}
                for name, cases in chip_smoke.V_CASES.items()}


@pytest.fixture(scope="module")
def v_calls():
    """(triples, V sets) of a tiny DynamicTanh Swin's eval and training
    forwards in f32 and bf16, as chip_smoke.py's V phase builds them from
    the K4 calls."""
    gen = torch.Generator().manual_seed(5)
    triples = {}
    for dtype in ("float32", "bfloat16"):
        for train in (False, True):
            blocks = []
            calls = _record(dtype, train, DYT_TINY, blocks)
            triples[f"tiny {dtype} train={train}"] = chip_smoke.v_calls(
                calls, blocks, gen)
    return triples, chip_smoke.v_sets(triples, gen)


def test_v_plain_versions_pass_and_every_case_is_covered(v_calls):
    """Every K4 call becomes one V1 and one V3 call (the block's window and
    padded grid recorded with it); the padded V1 call and the call whose 3
    id rows do not divide its 8 windows per sample are in every set; the
    plain versions pass against themselves, saturated logits included."""
    triples, sets = v_calls
    for label, t in triples.items():
        assert len(t) == 6
        names = [name for name, _ in sets[label]]
        assert names.count("attention_split") == 7
        assert names.count("attention_windows") == 7
        for k4, v1, v3 in t:
            assert v1[0].shape[2] == k4[0].shape[1] == math.prod(v3[5])
            assert v3[0].shape[0] == 2 and v3[0].is_contiguous()
        padded = sets[label][-2][1]
        assert padded[0].shape[2] == chip_smoke.PAD_N
        assert (padded[4][:, t[0][1][0].shape[2]:] == -1).all()
        synthetic = sets[label][-1][1]
        assert chip_smoke.windows_per_sample(synthetic[0], synthetic[5]) == 8
        assert synthetic[2].shape[0] == 3
    worst = chip_smoke.v_parity_phase(sets, chip_smoke.v_table(),
                                      torch.Generator().manual_seed(3),
                                      TINY_V_CASES)
    assert worst == dict.fromkeys(chip_smoke.V_PER_CALL, 0.0)
    with pytest.raises(AssertionError, match="lacks attention_split cases"):
        chip_smoke.v_parity_phase(
            {label: calls[:-2] for label, calls in sets.items()},
            chip_smoke.v_table(), torch.Generator().manual_seed(3),
            TINY_V_CASES)


def test_v_path_and_its_timings_on_cpu(v_calls, monkeypatch):
    """The V path's plumbing: the main calls of a training forward through
    both entry points, forward and backward (no launch on the CPU, so the
    count check fails here), the K4 agreement, the timing and bound
    helpers with a stand-in timer."""
    triples, _ = v_calls
    for label, t in triples.items():
        d1, d3 = chip_smoke.k4_agreement(t)
        dtype = str(t[0][0][0].dtype).removeprefix("torch.")
        assert d3 == 0.0 and d1 <= chip_smoke.TOL[dtype], label
    t = triples["tiny bfloat16 train=True"]
    main = chip_smoke.v_main_calls(t)
    gen = torch.Generator().manual_seed(4)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    counts = chip_smoke.v_path(main, gen)
    assert not any(counts.values())
    with pytest.raises(AssertionError, match="V path attention_split"):
        chip_smoke.check_counts(counts, chip_smoke.V_PER_CALL, len(t),
                                "V path")
    monkeypatch.setattr(chip_smoke, "cuda_ms", lambda fn, reps=3: (
        fn(), 1.0)[1])
    ms, plain = chip_smoke.kernel_times(main)
    assert ms == plain == dict.fromkeys(chip_smoke.V_PER_CALL, 6.0)
    assert chip_smoke.composite_times(main) == (6.0, 6.0)
    for name in chip_smoke.V_KERNELS:
        fwd = chip_smoke.bound_ms(name, main, dtype)
        bwd = chip_smoke.bound_ms(name + "_bwd", main, dtype)
        assert fwd[0] > 0 and bwd[0] > fwd[0]


def test_v_bounds_equal_k4s_on_the_same_call():
    """V1 and V3 do K4's work on the same values: the same FLOP and bytes
    at Swin-T stage 1, micro 8 (qkv [1728, 252, 288] bf16)."""
    qkv = _meta(1728, 252, 288)
    bias = _meta(3, 252, 252, dtype=torch.float32)
    ids = _meta(216, 252, dtype=torch.int32)
    q = _meta(1728, 3, 252, 32)
    v1 = (q, q, q, bias, ids, 32 ** -0.5)
    v3 = (_meta(8, 36, 42, 36, 288), bias, ids, 32 ** -0.5, 3, (6, 7, 6))
    k4 = (qkv, bias, ids, 32 ** -0.5, 3)
    for suffix in ("", "_bwd"):
        want = chip_smoke.call_work("attention" + suffix, k4)
        assert chip_smoke.call_work("attention_split" + suffix, v1) == want
        assert chip_smoke.call_work("attention_windows" + suffix, v3) == want


class _DvIntoDk(torch.autograd.Function):
    """V1 whose backward writes dv into dk (and leaves dv as dk's)."""

    @staticmethod
    def forward(ctx, q, k, v, bias, ids, scale):
        from vsn_tpu_torch.ops import window_attention as wa

        ctx.save_for_backward(q, k, v, bias, ids)
        ctx.scale = scale
        return wa.window_attention_reference(q, k, v, bias, ids, scale)

    @staticmethod
    def backward(ctx, g):
        from vsn_tpu_torch.ops import window_attention as wa

        dq, _, dv, dbias = wa.window_attention_backward_reference(
            *ctx.saved_tensors, g, ctx.scale)
        return dq, dv, dv, dbias, None, None


def _global_ids_row(plain):
    """V3 whose window takes the global ids row bw % W over B * nW windows
    (K4's rule), not its flat index within its sample mod W."""
    from vsn_tpu_torch.models.swin3d import window_partition, window_reverse
    from vsn_tpu_torch.ops import window_attention as wa

    def kernel(qkv, bias, ids, scale, heads, window):
        out = wa.window_attention_qkv_reference(
            window_partition(qkv, window), bias, ids, scale, heads)
        return window_reverse(out, window, qkv.shape[1:4])
    return kernel


def _window_grid_swapped(plain):
    """V3 that reads and writes window (D = j, H = i) with the ids row of
    window (i, j): the D and H window indices swapped (square grids)."""
    def swap(x, window):
        b, d, h, w, c = x.shape
        nwd, nwh = d // window[0], h // window[1]
        if nwd != nwh:
            return x
        x = x.reshape(b, nwd, window[0], nwh, window[1], w, c)
        return x.transpose(1, 3).reshape(b, d, h, w, c)

    def kernel(qkv, bias, ids, scale, heads, window):
        out = plain(swap(qkv, window), bias, ids, scale, heads, window)
        return swap(out, window)
    return kernel


V_MUTANTS = {  # name -> (wrapper, mutant of its plain version, failure)
    "heads read one head off (V1f)": (
        "attention_split", lambda plain: lambda q, k, v, *rest: plain(
            q.roll(1, 1), k.roll(1, 1), v.roll(1, 1), *rest),
        "attention_split out"),
    "dv written to dk (V1b)": (
        "attention_split", lambda plain: _DvIntoDk.apply,
        "attention_split_bwd dk"),
    "ids row from the global bw % W (V3f)": (
        "attention_windows", _global_ids_row, "attention_windows out"),
    "D and H window indices swapped (V3f)": (
        "attention_windows", _window_grid_swapped, "attention_windows out"),
}


@pytest.mark.parametrize("mutant", sorted(V_MUTANTS))
def test_a_v_kernel_with_a_wrong_index_fails(v_calls, mutant):
    _, sets = v_calls
    name, make, failure = V_MUTANTS[mutant]
    table = chip_smoke.v_table()
    table[name] = (make(table[name][1]), table[name][1])
    with pytest.raises(AssertionError, match=failure):
        chip_smoke.v_parity_phase(sets, table,
                                  torch.Generator().manual_seed(3),
                                  TINY_V_CASES)


# One-line edits of csrc/window_attention_qkv.cu that chip_smoke.py must
# reject on the card (exit 1, in its V phase): name -> (line, mutant, the
# kernel whose parity fails)
V_SOURCE_MUTANTS = {
    "head stride d instead of N d (V1)": (
        "const HeadStrides s = {(long long)heads * n * d, (long long)n * d, d};",
        "const HeadStrides s = {(long long)heads * n * d, d, d};",
        "attention_split"),
    "dv written to dk (V1b)": (
        "p.dv = dv;", "p.dv = dk;", "attention_split_bwd"),
    "H and D window indices swapped (V3)": (
        "return ((b * md + i * wd) * mh + j * wh) * mw + kw * ww;",
        "return ((b * md + j * wd) * mh + i * wh) * mw + kw * ww;",
        "attention_windows"),
    "ids row from the global bw % W (V3)": (
        "return (bw % windows()) % rows;", "return bw % rows;",
        "attention_windows"),
}


@pytest.mark.parametrize("mutant", sorted(V_SOURCE_MUTANTS))
def test_v_source_mutants_name_one_line_of_the_source(mutant):
    line, new, _ = V_SOURCE_MUTANTS[mutant]
    assert K4_SOURCE.read_text().count(line) == 1 and new != line


@pytest.mark.cuda
@pytest.mark.parametrize("mutant", sorted(V_SOURCE_MUTANTS))
def test_a_mutated_v_source_makes_chip_smoke_fail(mutant, tmp_path):
    """chip_smoke.py run from a copy whose V1/V3 addressing has one line
    mutated exits 1, failing the V phase's parity (K4's passes: the
    mutants touch only the split and window-grid layouts)."""
    line, new, kernel = V_SOURCE_MUTANTS[mutant]
    res = _run_mutated_chip_smoke(K4_SOURCE, line, new, tmp_path)
    assert res.returncode == 1
    assert "disagree with their plain versions: DyT" in res.stderr
    assert f" {kernel} " in res.stderr.splitlines()[-1]


# ---------------------------------------------------------------------------
# The attention probes P1-P5: the P phase at a tiny size, its mutants
# ---------------------------------------------------------------------------

P_WINDOWS = 16  # windows of the rehearsal (P4 and P5 take 8 per block)


@pytest.fixture(scope="module")
def probe_sets():
    """The runs and the P phase's two sets at 16 windows: the scripts' own
    inputs (the first windows of micro-batch 1) and the f32 sensitive
    ones."""
    from vsn_tpu_torch.probes import script_inputs

    xw, *w = script_inputs("cpu", micro=1)
    gen = torch.Generator().manual_seed(13)
    sets = {"scripts' inputs": (xw[:P_WINDOWS].contiguous(), *w),
            "f32 sensitive": chip_smoke.probe_inputs((P_WINDOWS, 252, 96),
                                                     "cpu", gen)}
    return chip_smoke.probe_runs(), sets


def test_probes_table_lists_every_run():
    runs = chip_smoke.probe_runs()
    assert [run.key for run in runs] == list(chip_smoke.PROBES)
    assert [run.name for run in runs] == [
        name for name, _, _ in chip_smoke.PROBES.values()]
    for key, (_, src, rep) in chip_smoke.PROBES.items():
        assert chip_smoke.KERNELS[key] == (src, rep)
        assert (ROOT / src).exists() and (ROOT / rep.split(":")[0]).exists()
    assert len(chip_smoke.KERNELS) == 18 + 2 + 13   # K1's tiled body: 2


def test_probe_plain_versions_pass(probe_sets):
    runs, sets = probe_sets
    worst = chip_smoke.probe_parity_phase(sets, chip_smoke.probe_table(runs),
                                          runs)
    assert worst == dict.fromkeys(chip_smoke.PROBES, 0.0)


def _wb_ignored(wb):
    """A kernel that ran one window per block over BW / wb blocks: the
    windows past the first BW / wb never written (zeros here)."""
    def make(plain):
        def kernel(x, *w):
            out = plain(x, *w).clone()
            out[x.shape[0] // wb:] = 0
            return out
        return kernel
    return make


PROBE_MUTANTS = {  # name -> (launch key, mutant of its plain version)
    "nobias run for full2d": (
        "attn_ablate.full2d",
        lambda plain: lambda x, *w: _ap().attn_ablate_reference("nobias", x,
                                                                *w)),
    "noln run for full2d": (
        "attn_ablate.full2d",
        lambda plain: lambda x, *w: _ap().attn_ablate_reference("noln", x,
                                                                *w)),
    "wb ignored (P5 full2d_wb8)": ("attn_slot.full.wb8", _wb_ignored(8)),
    "wb ignored (P4 copy_only_wb8)": ("copy_windows.wb8", _wb_ignored(8)),
    "copy off by one window (P2)": (
        "copy_windows.wb1", lambda plain: lambda x, *w: x.roll(-1, 0)),
}


def _ap():
    from vsn_tpu_torch.ops import attn_probe

    return attn_probe


@pytest.mark.parametrize("mutant", sorted(PROBE_MUTANTS))
def test_a_probe_kernel_with_a_wrong_argument_fails(probe_sets, mutant):
    runs, sets = probe_sets
    key, make = PROBE_MUTANTS[mutant]
    table = chip_smoke.probe_table(runs)
    table[key] = (make(table[key][1]), table[key][1])
    with pytest.raises(AssertionError, match=f" {key}"):
        chip_smoke.probe_parity_phase(sets, table, runs)


def _full2d_rounding_before_normalizing(x, wqkv, bias, wproj):
    """The probes' full2d with p = round(e) / sum instead of round(e /
    sum): SM_PLAIN's order reversed."""
    r = lambda t: t.to(torch.bfloat16).float()
    bw, n, c = x.shape
    heads, d = bias.shape[0], c // bias.shape[0]
    xc = x - x.mean(dim=-1, keepdim=True)
    y = xc * torch.rsqrt((xc * xc).mean(dim=-1, keepdim=True) + 1e-5)
    q, k, v = r(r(y) @ r(wqkv)).reshape(bw, n, 3, heads, d).permute(
        2, 0, 3, 1, 4)
    s = (q @ k.transpose(-1, -2)) * d ** -0.5 + bias
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    ao = ((r(e) / e.sum(dim=-1, keepdim=True)) @ v).transpose(1, 2)
    return x + r(ao.reshape(bw, n, c)) @ r(wproj)


def test_probe_compare_catches_p_rounded_before_normalizing(probe_sets):
    """Rounding exp(s) before the division moves every p by up to a bf16
    step: the branch's RMS check rejects it where its largest difference
    alone would not."""
    _, sets = probe_sets
    x, *w = sets["f32 sensitive"]
    want = _ap().attn_ablate_reference("full2d", x, *w)
    got = _full2d_rounding_before_normalizing(x, *w)
    err, (max_ratio, rms_ratio), ok = chip_smoke.probe_compare(
        "attn_ablate.full2d", x, got, want)
    assert not ok and rms_ratio > 1.5 and max_ratio < 1


def test_probe_path_and_times_on_cpu(probe_sets, monkeypatch):
    """The probe path's plumbing through both entry points (nothing
    launches on the CPU, so the count check fails naming the first run),
    and the time helper with a stand-in timer: plain ms for every run,
    copy_'s for the copies only, K1f on the same x."""
    from vsn_tpu_torch.probes import attn_ablate, attn_ablate2

    runs, sets = probe_sets
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    for mod in (attn_ablate, attn_ablate2):
        main = mod.main
        monkeypatch.setattr(mod, "main", lambda main=main: main(
            "cpu", micro=1, reps=1, warmup=0))
    with pytest.raises(AssertionError,
                       match="probe path attn_ablate.full2d: 0 launches, "
                             "expected 24"):
        chip_smoke.probe_path(runs)
    monkeypatch.setattr(chip_smoke, "cuda_ms", lambda fn, reps=3: (
        fn(), 1.0)[1])
    plain, library, k1f = chip_smoke.probe_times(
        runs, sets["scripts' inputs"], 2, "cpu")
    assert plain == dict.fromkeys(chip_smoke.PROBES, 1.0) and k1f == 1.0
    assert {k for k, v in library.items() if v is not None} == {
        k for k in chip_smoke.PROBES if k.startswith("copy_windows")}


def test_k1f_at_the_probes_parameters_is_k1s_function(probe_sets):
    """K1f with the probes' parameters (LN 1/0, zero biases, gains 1, no
    ids) differs from the probes' full2d only by K1's softmax (shift
    max(rowmax, 0), rounding before the 1/sum scale): within the bf16
    limit at the scripts' inputs."""
    from vsn_tpu_torch.ops import swin_block_kernels as sbk

    _, sets = probe_sets
    xw, *w = sets["scripts' inputs"]
    k1 = sbk.attn_half_reference(*chip_smoke.k1f_stage1_args(xw, *w, 2))
    full = _ap().attn_ablate_reference("full2d", xw, *w)
    assert k1.dtype == full.dtype == torch.bfloat16
    assert (k1.float() - full.float()).abs().max() <= 2e-2 * full.abs().max()


def _meta_probe(dtype=torch.bfloat16):
    return (_meta(1728, 252, 96, dtype=dtype),
            _meta(96, 288, dtype=torch.float32),
            _meta(3, 252, 252, dtype=torch.float32),
            _meta(96, 96, dtype=torch.float32))


def test_probe_bounds_follow_the_shapes():
    """At the stage-1 call (x [1728, 252, 96] bf16): full2d does 8 rows C^2
    (qkv, proj) and 4 rows N C (q k^T, p v) FLOP, 74.2 GFLOP, 0.075 ms at
    989 TFLOP/s, over 0.050 ms of bytes: bound by operations;
    linear_only drops the attention and the bias, attn_only the products
    and weights (bound by bytes), nobias the bias; the copies move x twice;
    f32 x doubles x's bytes."""
    args = _meta_probe()
    rows, x_b = 1728 * 252, 1728 * 252 * 96 * 2
    w_b, b_b = (96 * 288 + 96 * 96) * 4, 3 * 252 * 252 * 4
    gemm, attn = 8 * rows * 96 * 96, 4 * rows * 252 * 96
    work = chip_smoke.call_work
    assert work("attn_ablate.full2d", args) == (gemm + attn,
                                                2 * x_b + w_b + b_b)
    assert work("attn_slot.full.wb8", args) == work("attn_ablate.full2d",
                                                    args)
    assert work("attn_ablate.linear_only", args) == (gemm, 2 * x_b + w_b)
    assert work("attn_slot.lin.wb8", args) == (gemm, 2 * x_b + w_b)
    assert work("attn_ablate.attn_only", args) == (attn, 2 * x_b + b_b)
    assert work("attn_ablate.nobias", args) == (gemm + attn, 2 * x_b + w_b)
    for key in ("copy_windows.wb1", "copy_windows.wb1.ops",
                "copy_windows.wb8"):
        assert work(key, args) == (0, 2 * x_b)
        assert chip_smoke.bound_ms(key, [(key, args)])[1] == "bytes"
    f32 = _meta_probe(torch.float32)
    assert work("attn_slot.full.wb8.f32", f32)[1] == 4 * x_b + w_b + b_b
    ms, by = chip_smoke.bound_ms("attn_ablate.full2d",
                                 [("attn_ablate.full2d", args)])
    assert by == "operations" and ms == pytest.approx(0.0750, abs=1e-4)
    assert chip_smoke.bound_ms("attn_ablate.attn_only", [
        ("attn_ablate.attn_only", args)])[1] == "bytes"


# One-line edits of csrc/attn_half.cu's probe policies that chip_smoke.py
# must reject on the card (exit 1, in its probe phase): name -> (line, its
# mutant, a run whose parity fails). K1f's instantiation is untouched by
# each (K1's softmax policy, one window per block, packed qkv).
P_SOURCE_MUTANTS = {
    "p normalized after rounding (SM_PLAIN)": (
        "for (int j = lane; j < n; j += 32) u[j] = round_to<T>(u[j] / sum);",
        "for (int j = lane; j < n; j += 32) u[j] = round_to<T>(u[j]) / sum;",
        "attn_ablate.full2d"),
    "nosm factor 0.01 (SM_SCALE)": (
        "u[j] = round_to<T>(0.001f * u[j]);",
        "u[j] = round_to<T>(0.01f * u[j]);", "attn_ablate.nosm"),
    "window stride 1 instead of wb": (
        "const long long bw = group * wb + slot;",
        "const long long bw = group + slot;", "attn_slot.full.wb8"),
    "attn_only reads k from a neighbouring head": (
        "const int ko = ATTN_ONLY ? 0 : c;",
        "const int ko = ATTN_ONLY ? (h ? -d : d) : c;",
        "attn_ablate.attn_only"),
}
K1_SOURCE = ROOT / "vsn_tpu_torch" / "csrc" / "attn_half.cu"


@pytest.mark.parametrize("mutant", sorted(P_SOURCE_MUTANTS))
def test_probe_source_mutants_name_one_line_of_the_source(mutant):
    line, new, key = P_SOURCE_MUTANTS[mutant]
    assert K1_SOURCE.read_text().count(line) == 1 and new != line
    assert key in chip_smoke.PROBES


@pytest.mark.cuda
@pytest.mark.parametrize("mutant", sorted(P_SOURCE_MUTANTS))
def test_a_mutated_probe_source_makes_chip_smoke_fail(mutant, tmp_path):
    """chip_smoke.py run from a copy whose probe policy has one line
    mutated exits 1, failing the probe phase (the K1 phases before it
    pass: K1f's instantiation does not reach the mutated lines)."""
    line, new, key = P_SOURCE_MUTANTS[mutant]
    res = _run_mutated_chip_smoke(K1_SOURCE, line, new, tmp_path)
    assert res.returncode == 1
    assert "probe kernels disagree with their plain versions" in res.stderr
    assert f" {key}" in res.stderr.splitlines()[-1]
