"""chip_smoke.py's residual-mode phases (K1/K2 with in-band LayerScale,
post-norm, and both) and its stabilizer paths at a tiny size, on the CPU.

On the CPU every wrapper runs its plain version, so a "kernel" here is the
plain version with one piece of a mode's arithmetic changed (a mutant). The
residual parity phase must accept the plain versions, on the calls of a
tiny Swin (stage 1 shifted and window-resident, stage 2 padded, stage 3
clamped; tests/test_torch_chip_smoke.py's) and of a tiny ViT (N = 65, head
dim 64), and reject each mutant at the tolerances it holds the CUDA kernels
to on the card. The mutants of the explicit backward swap
``swin_block_kernels._out_backward`` for a broken copy while the mutant's
side runs (the phase runs a kernel's forward and backward before its plain
version's). Then the stabilizer paths' pieces: the launch counts they
expect, the training route with every parameter (gamma included) reached,
the mode timings with a stand-in timer, the bounds; and, on a card only,
one-line edits of the CUDA sources of the modes make chip_smoke.py exit 1.
"""

from unittest import mock

import numpy as np
import pytest
import torch

import chip_smoke
from test_torch_chip_smoke import (
    ROOT,
    TINY,
    _run_mutated_chip_smoke,
    one_thread,
)
from vsn_tpu_torch.config import load_config
from vsn_tpu_torch.data.augment import zscore
from vsn_tpu_torch.models import build_model
from vsn_tpu_torch.models.swin3d import init_weights
from vsn_tpu_torch.models.vit3d import init_weights as vit_init
from vsn_tpu_torch.ops import swin_block_kernels as sbk
from vsn_tpu_torch.train.step import init_train_state

VIT_TINY = dict(ARCHITECTURE="ViT", IMG_SIZE=[16, 16, 16], RESHAPE_SIZE=False,
                PATCH_SHAPE=[4, 4, 4], EMBED_DIM=128, DEPTH=2, HEADS=2,
                STOCHASTIC_DEPTH_PROB=0.2)


def _record(over, shape, dtype, train):
    cfg = load_config(dict(over, FP16=dtype == "bfloat16"))
    model = build_model(cfg, device="cpu")
    init = vit_init if cfg.ARCHITECTURE == "ViT" else init_weights
    init(model, torch.Generator().manual_seed(0))
    x = np.random.default_rng(0).standard_normal((2, *shape, 1))
    x = zscore(torch.from_numpy(x.astype(np.float32)))
    if train:
        return chip_smoke.record_calls(
            model.train(), x, generator=torch.Generator().manual_seed(1))
    return chip_smoke.record_calls(model.eval(), x)


@pytest.fixture(scope="module")
def sets():
    """The phase's sets at a tiny size: Swin eval calls in f32 and bf16 and
    training calls in bf16, and ViT eval calls in f32."""
    return {
        "swin float32": _record(TINY, (12, 18, 12), "float32", False),
        "swin bfloat16": _record(TINY, (12, 18, 12), "bfloat16", False),
        "swin bfloat16 train": _record(TINY, (12, 18, 12), "bfloat16", True),
        "vit float32": _record(VIT_TINY, (16, 16, 16), "float32", False),
    }


def _path(label):
    """The path ("swin" or "vit") whose calls a set of ``sets`` holds."""
    return label.split()[0]


def _each_path(sets, gen, table=None):
    """The residual phase on the Swin sets, then on the ViT ones, as
    chip_smoke.py's phases 8a and 3a run it."""
    worst = {}
    for path in ("swin", "vit"):
        worst.update(chip_smoke.residual_parity_phase(
            {k: v for k, v in sets.items() if _path(k) == path}, gen, path,
            table))
    return worst


def test_plain_versions_pass_in_every_mode(sets):
    worst = _each_path(sets, torch.Generator().manual_seed(3))
    names = {chip_smoke.mode_name(base, mode, _path(label))
             for label, calls in sets.items() for name, args in calls
             if name in chip_smoke.BLOCK_KERNELS
             for base in (name, f"{name}_bwd")
             for mode in chip_smoke.RESIDUAL_MODES}
    assert set(worst) == names
    assert all(err == 0.0 for err in worst.values())
    # every kernel of the stabilizer paths is held to its plain version
    assert set(chip_smoke.RESIDUAL_KERNELS) <= names
    assert "attn_half_tiled_post" in names and "ln_mlp_bwd_post" in names


_OUT_BACKWARD = sbk._out_backward   # the plain one, for the mutants to call


class _Switch:
    """Which side of a parity check runs: the mutant's (``on``) or the
    plain version's."""
    on = False


def _switched(table, mutant_fn):
    """kernel_table() with both block kernels' sides switching
    ``_out_backward`` to ``mutant_fn`` while the mutant side runs."""
    def out_backward(*args):
        return (mutant_fn if _Switch.on else _OUT_BACKWARD)(*args)

    def side(fn, on):
        def call(*args, **kw):
            _Switch.on = on
            return fn(*args, **kw)
        return call

    new = dict(table)
    for name in chip_smoke.BLOCK_KERNELS:
        plain = table[name][1]
        new[name] = (side(plain, True), side(plain, False))
    return new, mock.patch.object(sbk, "_out_backward", out_backward)


def _without_bias_term(do, a, w, b, norm_w, norm_b, gamma, post, cdt):
    out = list(_OUT_BACKWARD(do, a, w, b, norm_w, norm_b, gamma, post, cdt))
    if gamma is not None and not post:
        out[3] = out[3] - b * do.sum(0)
    return tuple(out)


def _dw_unscaled(do, a, w, b, norm_w, norm_b, gamma, post, cdt):
    out = list(_OUT_BACKWARD(do, a, w, b, norm_w, norm_b, gamma, post, cdt))
    if gamma is not None and not post:
        out[1] = out[1] / gamma[:, None]
    return tuple(out)


def _dgamma_after_scaling(do, a, w, b, norm_w, norm_b, gamma, post, cdt):
    out = list(_OUT_BACKWARD(do, a, w, b, norm_w, norm_b, gamma, post, cdt))
    if gamma is not None and not post:
        out[3] = (w * out[1]).sum(1) + b * out[2]
    return tuple(out)


def _no_post_norm_backward(do, a, w, b, norm_w, norm_b, gamma, post, cdt):
    out = list(_OUT_BACKWARD(do, a, w, b, norm_w, norm_b, gamma, post, cdt))
    if post:
        d = do * gamma if gamma is not None else do
        out[0] = d
        out[1] = sbk._r(d, cdt).t() @ sbk._r(a, cdt)
        out[2] = d.sum(0)
    return tuple(out)


BACKWARD_MUTANTS = {  # name -> (mutated _out_backward, kernel it shows in)
    "dgamma without the b * s term": (_without_bias_term, "_bwd_ls"),
    "dW left unscaled by gamma": (_dw_unscaled, "_bwd_ls"),
    "dgamma taken after the scaling": (_dgamma_after_scaling, "_bwd_ls"),
    "post-norm backward without its LN backward": (_no_post_norm_backward,
                                                   "_bwd_post"),
}


@pytest.mark.parametrize("mutant", sorted(BACKWARD_MUTANTS))
def test_a_mode_backward_mutant_fails(sets, mutant):
    fn, shows = BACKWARD_MUTANTS[mutant]
    table, patch = _switched(chip_smoke.kernel_table(), fn)
    with patch, pytest.raises(AssertionError, match=shows):
        _each_path(sets, torch.Generator().manual_seed(3), table)


def test_post_norm_applied_to_the_input_fails(sets):
    """A kernel that takes post_norm as pre-norm (its LayerNorm on the
    input, none on the branch) fails the forward check."""
    table = chip_smoke.kernel_table()
    for name in chip_smoke.BLOCK_KERNELS:
        plain = table[name][1]

        def pre(*args, _plain=plain, **kw):
            return _plain(*args, **dict(kw, post_norm=False))
        table[name] = (pre, plain)
    with pytest.raises(AssertionError, match="_post"):
        _each_path(sets, torch.Generator().manual_seed(3), table)


def test_stabilizer_path_counts_and_training_pieces(monkeypatch):
    """The counts the stabilizer paths expect, and their training pieces at
    a tiny size: LayerScale + post-norm + DeepScaleLM on a tiny Swin, every
    parameter (the gammas included) reached by one backward, the training
    route, and the mode timings and bounds with a stand-in timer."""
    expected = chip_smoke.in_mode(chip_smoke.PER_PASS, "_post_ls")
    # Swin's K1 calls count the key-tiled body's launches
    assert expected["attn_half_tiled_post_ls"] == expected[
        "ln_mlp_bwd_post_ls"] == 12 and "attn_half_tiled" not in expected
    assert chip_smoke.entry_name("attn_half_tiled_post_ls", "swin") == \
        "attn_half_post_ls"
    assert chip_smoke.entry_name("attn_half_tiled_post_ls", "vit") == \
        "attn_half_tiled_post_ls"
    assert chip_smoke.entry_name("ln_mlp_bwd_post_ls", "swin") == \
        "ln_mlp_bwd_post_ls"
    assert expected["windows_to_windows_adjoint"] == 2
    vit = chip_smoke.in_mode(chip_smoke.VIT_PER_PASS, "_post_ls")
    assert set(vit) <= set(chip_smoke.KERNELS)
    counts = dict.fromkeys(chip_smoke.KERNELS, 0)
    counts.update({k: 12 * 4 for k in vit})
    chip_smoke.check_counts(counts, vit, 4, "tiny")
    counts["attn_half_post"] = 1   # a mode outside KERNELS
    with pytest.raises(AssertionError, match="attn_half_post"):
        chip_smoke.check_counts(counts, vit, 4, "tiny")

    over, mode = chip_smoke.STABILIZER_PATHS["post_ls"]
    cfg = load_config(dict(TINY, ENABLE_STABLE=True, **over, FP16=True,
                           USE_SAM=True, USE_EMA=True, USE_MIXUP=True,
                           LABEL_SMOOTHING=0.1, SEED=0, BATCH_SIZE=2,
                           EFFECTIVE_BATCH_SIZE=4, LR_WARMUP=0, WD_WARMUP=0,
                           STEPS=10))
    model = init_weights(build_model(cfg, device="cpu"),
                         torch.Generator().manual_seed(0))
    state = init_train_state(cfg, model)
    batch = chip_smoke.train_batch(cfg, torch.device("cpu"), 5)
    draws = chip_smoke.Draws(model, 2, torch.device("cpu"), 0)
    assert not chip_smoke.first_backward_grads(model, cfg, state, batch,
                                               draws)
    assert sum(n.endswith(".gamma") for n in state.params.names) == 12
    metrics, _ = chip_smoke.train_route(model, cfg, state, batch, draws, 1,
                                        lambda: None)
    assert np.isfinite(metrics[0]["loss"]) and not metrics[0]["skipped"]

    calls = _record(TINY, (12, 18, 12), "bfloat16", True)
    monkeypatch.setattr(chip_smoke, "cuda_ms", lambda fn, reps=3: (
        fn(), 1.0)[1])
    ms, plain = chip_smoke.mode_times(calls, mode, "swin")
    assert ms == plain and set(ms) == {
        "attn_half_post_ls", "attn_half_bwd_post_ls", "ln_mlp_post_ls",
        "ln_mlp_bwd_post_ls"}
    assert ms["attn_half_post_ls"] == 6.0   # one K1 call a block
    for name in ms:
        got = chip_smoke.bound_ms(name, calls)
        base = chip_smoke.bound_ms(chip_smoke.RESIDUAL_KERNELS[name], calls)
        assert got[0] >= base[0] > 0


def test_result_line_takes_each_mode_from_its_path():
    """Every RESIDUAL_KERNELS entry of the result line gets the launches
    its own stabilizer path measured, non-zero, over the Swin baseline's 0
    for it (the tiled ones ViT's, not Swin's: ViT's path runs one pass more
    here, so a count taken from the other path shows), and a mode that its
    path launched no time fails."""
    passes = (1 + chip_smoke.TIMED_STEPS) * chip_smoke.TRAIN_ACCUM * 2

    def measured(per_pass, units):  # as launch_counts returns them
        counts = dict.fromkeys(chip_smoke.KERNELS, 0)
        counts.update({k: n * units for k, n in per_pass.items()})
        return counts

    units = {key: passes + (key == "vit_all")
             for key in chip_smoke.STABILIZER_PATHS}
    paths = {key: measured(chip_smoke.in_mode(
        chip_smoke.VIT_PER_PASS if key == "vit_all" else chip_smoke.PER_PASS,
        mode), units[key])
        for key, (_, mode) in chip_smoke.STABILIZER_PATHS.items()}
    path_counts = measured(chip_smoke.PER_PASS, passes)   # the baseline's
    path_counts.update(chip_smoke.residual_launches(paths))
    for name in chip_smoke.RESIDUAL_KERNELS:
        assert path_counts[name] == 12 * units[chip_smoke.RESIDUAL_PATH[name]]
    assert chip_smoke.RESIDUAL_PATH["attn_half_bwd_tiled_post_ls"] \
        == "vit_all" and chip_smoke.RESIDUAL_PATH["ln_mlp_post_ls"] \
        == "post_ls"
    paths["vit_all"]["attn_half_tiled_post_ls"] = 0
    with pytest.raises(AssertionError, match="attn_half_tiled_post_ls"):
        chip_smoke.residual_launches(paths)


# One-line edits of the modes' CUDA sources that chip_smoke.py must reject on
# the card (exit 1, in its residual parity phase 3a): name -> (source, line,
# its mutant)
SOURCE_MUTANTS = {
    "dgamma without the b * s term": (
        "common.cuh", "p.dgamma[o] += d + p.bias[o] * p.db[o];",
        "p.dgamma[o] += d;"),
    "dW left unscaled by gamma": (
        "common.cuh", "mv[j][e] *= g;", "mv[j][e] *= 1.f;"),
    "post-norm backward without its LN backward": (
        "common.cuh", "out[e] = POST ? v : p.lam * res[k].get(e) + v;",
        "out[e] = POST ? d_of(k, e) : p.lam * res[k].get(e) + v;"),
    "gamma's row and column swapped in the epilogue": (
        "common.cuh", "((LS & LS_EPI) ? v * p.gamma[n] : v)",
        "((LS & LS_EPI) ? v * p.gamma[m % p.n] : v)"),
    "post-norm forward without gamma": (
        "common.cuh", "g_s[j] = p.gamma ? p.gamma[j] : 1.f;", "g_s[j] = 1.f;"),
}
# The message of the phase that must reject each mutant: the residual
# parity phase 3a, but for the lines of the row kernels, which phase 2b
# holds alone first: the LN-backward body, the post-norm forward's finish
# and the LayerScale gradients (the CPU rehearsal's mode mutants of the
# same names show phase 3a rejecting a post-norm backward without its LN
# backward and the two LayerScale faults too)
MODE_FAILS = "residual modes disagree with their plain versions"
ROW_FAILS = "row kernels disagree with their plain versions"
MUTANT_FAILS = {"post-norm backward without its LN backward":
                "LN-backward launches disagree with their plain versions",
                "dgamma without the b * s term": ROW_FAILS,
                "dW left unscaled by gamma": ROW_FAILS,
                "post-norm forward without gamma": ROW_FAILS}
CSRC = ROOT / "vsn_tpu_torch" / "csrc"


@pytest.mark.parametrize("mutant", sorted(SOURCE_MUTANTS))
def test_mode_source_mutants_name_one_line_of_the_source(mutant):
    src, line, new = SOURCE_MUTANTS[mutant]
    assert (CSRC / src).read_text().count(line) == 1 and new != line
    assert set(MUTANT_FAILS) <= set(SOURCE_MUTANTS)


@pytest.mark.cuda
@pytest.mark.parametrize("mutant", sorted(SOURCE_MUTANTS))
def test_a_mutated_mode_source_makes_chip_smoke_fail(mutant, tmp_path):
    """chip_smoke.py run from a copy of the port whose residual-mode code
    has one line mutated exits 1 in the first phase that runs that line
    (``MUTANT_FAILS``; the residual parity phase otherwise)."""
    src, line, new = SOURCE_MUTANTS[mutant]
    res = _run_mutated_chip_smoke(CSRC / src, line, new, tmp_path)
    assert res.returncode == 1
    assert MUTANT_FAILS.get(mutant, MODE_FAILS) in res.stderr
