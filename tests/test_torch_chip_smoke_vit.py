"""chip_smoke.py's ViT phases, rehearsed on the CPU at a tiny size.

A tiny ViT (16^3 input, patch 4: N = 65, so the key tiles of 64 leave a
ragged last tile of one key; embed 128, 2 heads of 64) records its K1 and
K2 calls: eval forwards in f32 and bf16, a training forward with DropPath
draws. On the CPU every wrapper runs its plain version, so the phases must
accept the plain versions and reject argument-level mutants of K1: the
ragged last key tile left out, the max(rowmax, 0) clamp dropped (only the
saturation phase's logits near -200 see it), the per-sample gains ignored.
The forced-tiled phase's calls, the ViT bounds and the ViT training phase's
pieces (every parameter reached, the plain route equal to the kernel
route) are checked here too.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from vsn_tpu_torch.config import load_config
from vsn_tpu_torch.data.augment import zscore
from vsn_tpu_torch.models.vit3d import ViT3D
from vsn_tpu_torch.ops import swin_block_kernels as sbk
from vsn_tpu_torch.train.step import init_train_state

VIT_TINY = dict(ARCHITECTURE="ViT", IMG_SIZE=[16, 16, 16], RESHAPE_SIZE=False,
                PATCH_SHAPE=[4, 4, 4], EMBED_DIM=128, DEPTH=2, HEADS=2,
                STOCHASTIC_DEPTH_PROB=0.2, SEED=0)
CASES = {"no mask", "no bias", "N=65"}


def _x(seed=0):
    x = np.random.default_rng(seed).standard_normal((2, 16, 16, 16, 1))
    return zscore(torch.from_numpy(x.astype(np.float32)))


@pytest.fixture(scope="module")
def vit_sets():
    sets = {}
    for dtype in ("float32", "bfloat16"):
        model = chip_smoke.seeded_model(
            load_config(dict(VIT_TINY, FP16=dtype == "bfloat16")), "cpu")
        sets[f"{dtype} B=2"] = chip_smoke.record_calls(model, _x())
    sets["bfloat16 B=2 train"] = chip_smoke.record_calls(
        model.train(), _x(1), generator=torch.Generator().manual_seed(1))
    return sets


def test_seeded_vit_and_its_calls(vit_sets):
    for label, calls in vit_sets.items():
        names = [n for n, _ in calls]
        assert names == ["attn_half", "ln_mlp"] * 2, label
        x = calls[0][1][0]
        assert tuple(x.shape) == (2, 65, 128)
        assert calls[0][1][4] is None and calls[0][1][5] is None
        assert calls[0][1][6] is None
    gf = vit_sets["bfloat16 B=2 train"][2][1][9]   # block 1 draws
    assert set(gf.tolist()) <= {0.0, 1 / 0.8}


def test_vit_plain_versions_pass_and_cover_the_cases(vit_sets):
    worst = chip_smoke.vit_parity_phase(
        vit_sets, torch.Generator().manual_seed(3), cases=CASES)
    assert set(worst) == {"attn_half_tiled", "attn_half_bwd_tiled", "ln_mlp",
                          "ln_mlp_bwd"}
    assert all(err == 0.0 for err in worst.values())
    with pytest.raises(AssertionError, match="lacks"):   # N = 65, not 811
        chip_smoke.vit_parity_phase({"f32": vit_sets["float32 B=2"]},
                                    torch.Generator().manual_seed(3))
    assert chip_smoke.tiled_saturation_phase(
        vit_sets["float32 B=2"], torch.Generator().manual_seed(4)) == [0.0,
                                                                        0.0]


def _ragged_tile_skipped(plain):
    """K1 with the keys of its last, ragged key tile left out."""
    def kernel(*args, lam=1.0):
        args = list(args)
        x, heads = args[0], args[12]
        n = x.shape[1]
        last = (n - 1) // chip_smoke.KEY_TILE * chip_smoke.KEY_TILE
        mask = torch.zeros(heads, n, n, device=x.device)
        mask[:, :, last:] = -1e9
        args[5] = mask if args[5] is None else args[5] + mask
        return plain(*args, lam=lam)
    return kernel


def _unclamped(plain):
    """K1 shifted by the plain row max, not max(rowmax, 0): a per-row bias
    that brings every row's max to 0 (softmax is invariant to it; the
    clamped form is not where a row's max is below 0)."""
    def kernel(*args, lam=1.0):
        x, nw, nb, qw, qb, bias, ids, pw, pb, gf, gb, scale, heads = args
        outs = []
        for b in range(x.shape[0]):
            with torch.no_grad():
                parts = sbk._attention_parts(x[b:b + 1], nw, nb, qw, qb, bias,
                                             ids, scale, heads)
                s = sbk._scores(parts[3], parts[4], bias, ids, scale)[0]
            shift = (-s.amax(-1, keepdim=True)).expand_as(s)
            outs.append(plain(x[b:b + 1], nw, nb, qw, qb,
                              shift if bias is None else bias + shift, ids,
                              pw, pb, gf[b:b + 1], gb[b:b + 1], scale, heads,
                              lam=lam))
        return torch.cat(outs)
    return kernel


def _gains_ignored(plain):
    def kernel(*args, lam=1.0):
        args = list(args)
        args[9], args[10] = torch.ones_like(args[9]), torch.ones_like(args[10])
        return plain(*args, lam=lam)
    return kernel


VIT_MUTANTS = {
    "the ragged last key tile left out": _ragged_tile_skipped,
    "the max(rowmax, 0) clamp dropped": _unclamped,
    "the per-sample gains ignored": _gains_ignored,
}


@pytest.mark.parametrize("mutant", sorted(VIT_MUTANTS))
def test_a_tiled_k1_mutant_fails_the_vit_phase(vit_sets, mutant):
    table = chip_smoke.kernel_table()
    plain = table["attn_half"][1]
    table["attn_half"] = (VIT_MUTANTS[mutant](plain), plain)
    with pytest.raises(AssertionError):
        chip_smoke.vit_parity_phase(vit_sets, torch.Generator().manual_seed(3),
                                    table, CASES)
        chip_smoke.tiled_saturation_phase(vit_sets["float32 B=2"],
                                          torch.Generator().manual_seed(4),
                                          table)


def test_the_clamp_is_seen_only_at_negative_logits(vit_sets):
    """The unclamped mutant passes ordinary logits and 45 / 200 and fails
    at -200, where the clamped shift makes every exp underflow."""
    table = chip_smoke.kernel_table()
    plain = table["attn_half"][1]
    table["attn_half"] = (_unclamped(plain), plain)
    calls = vit_sets["float32 B=2"]
    chip_smoke.tiled_saturation_phase(calls, torch.Generator().manual_seed(4),
                                      table, logits=(45.0, 200.0))
    with pytest.raises(AssertionError, match="-200"):
        chip_smoke.tiled_saturation_phase(
            calls, torch.Generator().manual_seed(4), table, logits=(-200.0,))


def test_forced_tiled_calls_cut_a_swin_stage_call():
    from tests.test_torch_chip_smoke import _record

    calls = _record("float32", False)
    full, small = chip_smoke.forced_tiled_calls(calls, n_small=5)
    assert full[1][5] is not None and full[1][6] is not None
    assert "shifted ids" in chip_smoke.case_kind(*full)
    x, bias, ids = small[1][0], small[1][5], small[1][6]
    assert x.shape[1] == 5 and bias.shape[1:] == (5, 5) and ids.shape[1] == 5
    assert torch.equal(x, full[1][0][:, :5])
    assert not sbk.attention_tiled(full[1][0].shape[1], 8)
    # the forced phase's comparisons, on the plain versions here
    worst, _ = chip_smoke.parity_phase({"forced": [full, small]},
                                       chip_smoke.kernel_table(),
                                       torch.Generator().manual_seed(5))
    assert worst["attn_half"] == 0.0


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_vit_k1_bound_at_micro_24():
    """K1 at ViT-S's call, micro 24 (x [24, 811, 384] bf16): qkv 6 rows C^2,
    proj 2 rows C^2 and q k^T + p v 4 rows N C FLOP, 47.2 GFLOP, 0.0477 ms
    at 989 TFLOP/s: bound by operations; the tiled names take K1's work."""
    c, n, b = 384, 811, 24
    f32 = torch.float32
    args = (_meta(b, n, c), _meta(c, dtype=f32), _meta(c, dtype=f32),
            _meta(3 * c, c, dtype=f32), None, None, None,
            _meta(c, c, dtype=f32), _meta(c, dtype=f32), _meta(b, dtype=f32),
            _meta(b, dtype=f32), 0.125, 6)
    calls = [("attn_half", args)]
    rows = b * n
    flops = 8 * rows * c * c + 4 * rows * n * c
    assert chip_smoke.call_work("attn_half_tiled", args)[0] == flops
    ms, by = chip_smoke.bound_ms("attn_half_tiled", calls)
    assert by == "operations" and ms == pytest.approx(flops / 989e12 * 1e3)
    assert ms == pytest.approx(0.0477, abs=2e-4)
    assert chip_smoke.bound_ms("attn_half_bwd_tiled", calls)[0] > ms


def test_vit_k1b_tiled_bound_is_the_functions_own_work():
    """K1b's tiled body at ViT-S's call, micro 24, is counted by K1b's own
    work, as the whole-window K1b: 22 rows C^2 GEMM FLOP and twelve
    attention products' 12 rows N C (s, ao, dp, dv, dq, dk), and the
    function's bytes. What K1f keeps for it (ao in bf16, the row
    statistics [24, 6, 811, 2] and the f32 o) is the port's design,
    counted apart (``kept_bytes``)."""
    c, n, b = 384, 811, 24
    f32 = torch.float32
    args = (_meta(b, n, c), _meta(c, dtype=f32), _meta(c, dtype=f32),
            _meta(3 * c, c, dtype=f32), None, None, None,
            _meta(c, c, dtype=f32), _meta(c, dtype=f32), _meta(b, dtype=f32),
            _meta(b, dtype=f32), 0.125, 6)
    rows = b * n
    work = chip_smoke.call_work("attn_half_bwd_tiled", args)
    assert work == chip_smoke.call_work("attn_half_bwd", args)
    assert work[0] == 22 * rows * c * c + 12 * rows * n * c
    assert chip_smoke.kept_bytes("attn_half", args) == (
        2 * rows * c + 8 * b * 6 * n + 4 * rows * c)


def test_vit_training_phase_rehearsal_on_cpu():
    """The ViT training phase's pieces at a tiny size: DropPath draws from
    ``model.draw``, every parameter reached, two steps, the plain route
    equal to the kernel route (both the plain versions here)."""
    cfg = load_config(dict(VIT_TINY, FP16=False, USE_SAM=True, USE_EMA=True,
                           USE_MIXUP=True, USE_SHAKEDROP=True,
                           LABEL_SMOOTHING=0.1, BATCH_SIZE=2,
                           EFFECTIVE_BATCH_SIZE=4))
    model = chip_smoke.seeded_model(cfg, "cpu")
    assert isinstance(model, ViT3D) and model.num_draws() == 2
    state = init_train_state(cfg, model)
    initial = state.params.flat.clone()
    cpu = torch.device("cpu")
    batch = chip_smoke.train_batch(cfg, cpu, 5)
    draws = chip_smoke.Draws(model, 2, cpu, 0)
    assert len(draws(0, 0, 0)) == 2
    chip_smoke.reach_every_parameter(model, cfg, state, batch, draws, "tiny")
    sync = lambda: None
    kernel, _ = chip_smoke.train_route(model, cfg, state, batch, draws, 1,
                                       sync)
    after0 = state.params.flat.clone()   # lr 0 at step 0 (LR_WARMUP)
    kernel += chip_smoke.train_route(model, cfg, state, batch, draws, 1,
                                     sync)[0]
    chip_smoke.params_moved(state, initial, after0, "tiny vit")
    with torch.no_grad():
        state.params.flat.copy_(initial)
    pstate = init_train_state(cfg, model)
    with chip_smoke.patched_model_ops(lambda name, kernel, plain: plain):
        plain, _ = chip_smoke.train_route(model, cfg, pstate, batch, draws, 2,
                                          sync)
    assert chip_smoke.check_train_metrics(kernel, plain) == {
        "loss": 0.0, "grad_norm": 0.0}


def test_vit_eval_path_pieces_on_cpu():
    """144x168x144-style volumes reach the ViT only through the eval
    transform's resize: Evaluator over H 20 -> 16 on the CPU, probs checked,
    the plain route equal."""
    from vsn_tpu_torch.eval.evaluate import Evaluator

    cfg = load_config(dict(VIT_TINY, IMG_SIZE=[16, 20, 16],
                           RESHAPE_SIZE=[16, 16, 16]))
    model = chip_smoke.seeded_model(cfg, "cpu")
    rng = np.random.default_rng(0)
    images = (rng.standard_normal((3, 16, 20, 16, 1)) * 50 + 100).astype(
        np.float16)
    evaluator = Evaluator(cfg, model, batch_size=2)
    probs = evaluator.predict(images)
    chip_smoke.check_probs(probs, 3, 5)
    with chip_smoke.patched_model_ops(lambda name, kernel, plain: plain):
        chip_smoke.compare_probs("tiny vit", probs, evaluator.predict(images))
    assert chip_smoke.VIT_PER_PASS == {"attn_half_tiled": 12, "ln_mlp": 12,
                                       "attn_half_bwd_tiled": 12,
                                       "ln_mlp_bwd": 12}


def test_tiled_launch_times_plumbing_on_cpu(vit_sets, monkeypatch):
    """The launch-alone and SDPA timing phase on the CPU, clocks replaced:
    every function it times runs, the tiled kernels' names are picked out
    of the profiler's, and the SDPA call takes the calls' q, k, v."""
    import collections

    seen = []

    def kernels_ms(fn, label, reps=3):
        fn()
        seen.append(label)
        return collections.Counter({
            "window_attention_tiled_kernel<bf16, 2>": 1.0,
            "attention_bwd_rows_kernel<bf16, 2>": 2.0,
            "attention_bwd_keys_kernel<bf16, 2>": 3.0, "gemm_kernel": 9.0})

    monkeypatch.setattr(chip_smoke, "device_kernel_ms", kernels_ms)
    monkeypatch.setattr(chip_smoke, "cuda_ms", lambda fn, reps=3: (
        fn(), 0.5)[1])
    got = chip_smoke.tiled_launch_times(vit_sets["bfloat16 B=2"], "cpu")
    assert got == (1.0, 5.0, 1.0, 1.0)   # 2 K1 calls of 0.5 ms each
    assert seen == ["vit_k1f", "vit_k1b"]


def _unclamped_statistics(qkv, bias, ids, scale, heads):
    """The tiled forward launch whose row statistics take the plain row max
    for the shift, not max(rowmax, 0)."""
    ao, _, o = sbk.attention_tiled_reference(qkv, bias, ids, scale, heads)
    bw, n, _ = qkv.shape
    q, k, _ = qkv.float().reshape(bw, n, 3, heads, -1).permute(2, 0, 3, 1, 4)
    s = sbk._scores(q, k, bias, ids, scale)
    m = s.amax(-1, keepdim=True)
    r = 1.0 / (torch.exp(s - m).sum(-1, keepdim=True) + 1e-30)
    return ao, torch.cat([m, r], -1), o


def _s1_dropped(qkv, dao, o, stats, bias, ids, scale, heads):
    """The tiled backward launch with s1 = dO . o taken as 0."""
    return sbk.attention_tiled_backward_reference(
        qkv, dao, torch.zeros_like(o), stats, bias, ids, scale, heads)


def test_tiled_launch_parity_phase_on_cpu(vit_sets, monkeypatch):
    """The launch-level phase on the CPU, where the launches run their
    plain versions: every output of every call, and of the saturated
    logits added to the first set, within its limit; a launch whose
    statistics drop the clamp at 0 (seen at logits -200) or whose backward
    drops s1 fails it."""
    sets = {k: vit_sets[k] for k in ("float32 B=2", "bfloat16 B=2")}
    gen = lambda: torch.Generator().manual_seed(6)
    assert chip_smoke.tiled_launch_parity_phase(
        sets, gen(), chip_smoke.TILED_LOGITS) == 0.0
    for name, mutant in (("attention_tiled_launch", _unclamped_statistics),
                         ("attention_tiled_backward_launch", _s1_dropped)):
        with monkeypatch.context() as m:
            m.setattr(sbk, name, mutant)
            with pytest.raises(AssertionError, match="tiled attention"):
                chip_smoke.tiled_launch_parity_phase(sets, gen(),
                                                     chip_smoke.TILED_LOGITS)


def test_forced_tiled_times_plumbing_on_cpu(monkeypatch):
    """The forced-tiled timing on Swin's stage-1 calls on the CPU, clocks
    replaced: both bodies' K1f and K1b run on the calls with the most
    windows, the attention kernels are picked out of the profiler's names,
    and K1b gets nothing kept from K1f here (the plain backward)."""
    import collections

    from tests.test_torch_chip_smoke import _record

    calls = _record("float32", False)
    seen = []

    def kernels_ms(fn, label, reps=3):
        fn()
        seen.append(label)
        return collections.Counter({
            "window_attention_kernel<float>": 1.0,
            "window_attention_bwd_kernel<float>": 2.0,
            "attention_tiled_mma_kernel<float, 32>": 3.0,
            "attention_bwd_rows_mma_kernel<float, 32>": 4.0,
            "attention_bwd_keys_mma_kernel<float, 32>": 5.0,
            "gemm_kernel": 9.0})

    monkeypatch.setattr(chip_smoke, "device_kernel_ms", kernels_ms)
    monkeypatch.setattr(chip_smoke, "cuda_ms", lambda fn, reps=3: (
        fn(), 0.5)[1])
    out = chip_smoke.forced_tiled_times(calls, "cpu")
    assert out["forward attention whole-window"] == 1.0
    assert out["backward attention whole-window"] == 2.0
    assert out["forward attention tiled"] == 3.0
    assert out["backward attention tiled"] == 9.0
    assert out["K1f tiled"] == out["K1b whole-window"] == 0.5
    assert len(seen) == 4
    assert chip_smoke.k1_kept(calls[0][1]) == {}
