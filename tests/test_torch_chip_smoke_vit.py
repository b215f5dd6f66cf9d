"""chip_smoke.py's ViT phases, rehearsed on the CPU at a tiny size.

A tiny ViT (16^3 input, patch 4: N = 65, so the key tiles of 64 leave a
ragged last tile of one key; embed 128, 2 heads of 64) records its K1 and
K2 calls: eval forwards in f32 and bf16, a training forward with DropPath
draws. On the CPU every wrapper runs its plain version, so the phases must
accept the plain versions and reject argument-level mutants of K1: the
ragged last key tile left out, the max(rowmax, 0) clamp dropped (only the
saturation phase's logits near -200 see it), the per-sample gains ignored.
The Swin route phase's calls and its timing plumbing, the ViT bounds and
the ViT training phase's pieces (every parameter reached, the plain route
equal to the kernel route) are checked here too.
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
    """The Swin route phase's calls: one K1 call of every stage case (the
    tiny Swin's shifted, unshifted and padded windows), then the shifted
    one cut to 5 tokens; the phase on the plain versions here (no launch),
    where its launch count check must see the key-tiled body's launches."""
    from tests.test_torch_chip_smoke import _record

    calls = _record("float32", False)
    route = chip_smoke.swin_route_calls(calls, n_small=5)
    *stages, small = route
    kinds = [chip_smoke.case_kind(*c) for c in stages]
    assert len({frozenset(k) for k in kinds}) == len(stages) == 3
    assert {"shifted ids", "no mask", "padded ids"} <= set().union(*kinds)
    full = next(c for c in stages if "shifted ids" in chip_smoke.case_kind(*c))
    assert full[1][5] is not None and full[1][6] is not None
    x, bias, ids = small[1][0], small[1][5], small[1][6]
    assert x.shape[1] == 5 and bias.shape[1:] == (5, 5) and ids.shape[1] == 5
    assert torch.equal(x, full[1][0][:, :5])
    # the tiny Swin's head dim of 8 takes the key-tiled body, as every one
    assert all(sbk.takes_head_dim(a[0].shape[-1] // a[12]) for _, a in route)
    # the route phase's comparisons, on the plain versions here
    worst, _ = chip_smoke.parity_phase({"route": route},
                                       chip_smoke.kernel_table(),
                                       torch.Generator().manual_seed(5))
    assert worst["attn_half"] == 0.0
    with pytest.raises(AssertionError, match="Swin route launches"):
        chip_smoke.swin_route_phase({"f32": calls},
                                    torch.Generator().manual_seed(5))


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
    work: 22 rows C^2 GEMM FLOP and twelve
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
    every function it times runs, the launches alone by events queued
    behind the spin kernel, the backward split into its phases by the
    profiler's shares, and the SDPA call takes the calls' q, k, v."""
    seen, timed = [], []

    def shares(fn, label, tags):
        fn()
        seen.append(label)
        return dict(zip(tags, (0.4, 0.6)))

    def events_ms(fn, reps=3, queued=False):
        fn()
        timed.append(queued)
        return 0.5

    monkeypatch.setattr(chip_smoke, "phase_shares", shares)
    monkeypatch.setattr(chip_smoke, "cuda_ms", events_ms)
    got = chip_smoke.tiled_launch_times(vit_sets["bfloat16 B=2"], "cpu")
    assert got == (0.5, 0.5, 1.0, 1.0)   # SDPA: 2 K1 calls of 0.5 ms each
    assert seen == ["vit_k1b"]
    assert timed == [True, True, False, False, False, False]


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
    """The Swin K1 timing (phase 17) on the CPU, clocks replaced: every
    stage's K1f, K1b, the launches alone, K4f's launch on the same values
    and SDPA's forward and backward run; phases A and B are the profiler's
    shares of the backward launches' events time, K1b gets nothing kept
    from K1f here (the plain backward), and the sums add the stages."""

    from tests.test_torch_chip_smoke import _record

    calls = _record("bfloat16", True)
    seen = []

    def shares(fn, label, tags):
        fn()
        seen.append((label, tags))
        return dict(zip(tags, (0.25, 0.5)))

    timed = []

    def events_ms(fn, reps=3, queued=False):
        fn()
        timed.append((reps, queued))
        return 0.5

    monkeypatch.setattr(chip_smoke, "phase_shares", shares)
    monkeypatch.setattr(chip_smoke, "cuda_ms", events_ms)
    stages = {tuple(a[0].shape) for n, a in calls if n == "attn_half"}
    out = chip_smoke.swin_k1_times(calls, "cpu")
    k = len(stages)
    assert out["forward"] == out["K4f"] == out["backward"] == 0.5 * k
    assert out["phase A"] == 0.125 * k and out["phase B"] == 0.25 * k
    assert {tags for _, tags in seen} == {("attention_bwd_rows",
                                           "attention_bwd_keys")}
    assert out["K1f"] == out["K1b"] == 0.5 * k
    assert out["SDPA"] == out["SDPA backward"] == 0.5 * 6   # one a call
    assert len(seen) == k
    # K1f, K1b, then the three launches alone over LAUNCH_REPS queued calls
    assert timed.count((chip_smoke.LAUNCH_REPS, True)) == 3 * k
    assert out["kept bytes"] == sum(chip_smoke.kept_bytes("attn_half", a)
                                    for n, a in calls if n == "attn_half")
    assert chip_smoke.k1_kept(calls[0][1]) == {}


def _counted_k1(*args, **kw):
    """K1's plain version counting as the card's key-tiled K1 and K1b."""
    from vsn_tpu_torch.ops import _build

    _build.launches["attn_half_tiled"] += 1
    out = sbk.attn_half_reference(*args, **kw)
    if out.requires_grad:
        out.register_hook(lambda g: _build.launches.update(
            {"attn_half_bwd_tiled": 1}))
    return out


def _unmasked_backward(qkv, dao, o, stats, bias, ids, scale, heads):
    """K1b's tiled launches without the region mask."""
    return sbk.attention_tiled_backward_reference(qkv, dao, o, stats, bias,
                                                  None, scale, heads)


def test_swin_route_phase_on_cpu(monkeypatch):
    """Phase 7 whole on the CPU, K1's plain version counting as the tiled
    body's launches: the stage calls, the saturated logits at the last
    stage's ragged key tile and the launches alone; a backward launch that
    drops the region mask fails it."""
    from tests.test_torch_chip_smoke import _record

    table = chip_smoke.kernel_table()
    table["attn_half"] = (_counted_k1, table["attn_half"][1])
    monkeypatch.setattr(chip_smoke, "kernel_table", lambda: dict(table))
    sets = {"float32 B=2": _record("float32", False),
            "bfloat16 B=2": _record("bfloat16", False)}
    gen = lambda: torch.Generator().manual_seed(8)
    worst = chip_smoke.swin_route_phase(sets, gen())
    assert set(worst) == {"attn_half", "attn_half_bwd"}
    assert all(err == 0.0 for err in worst.values())
    monkeypatch.setattr(sbk, "attention_tiled_backward_launch",
                        _unmasked_backward)
    with pytest.raises(AssertionError, match="tiled attention launches"):
        chip_smoke.swin_route_phase(sets, gen())


def _counted_k4(body):
    """K4's plain version counting as the card's K4f and K4b (``body``
    "tiled") or under other counters."""
    from vsn_tpu_torch.ops import _build
    from vsn_tpu_torch.ops import window_attention as wa

    names = (("attention", "attention_bwd") if body == "tiled"
             else ("attention_other", "attention_other_bwd"))

    def fn(*args, **kw):
        _build.launches[names[0]] += 1
        out = wa.window_attention_qkv_reference(*args, **kw)
        if out.requires_grad:
            out.register_hook(lambda g: _build.launches.update(
                {names[1]: 1}))
        return out
    return fn


def _counted_whole_window(*args, **kw):
    """K1's plain version counting under the counters of the whole-window
    body that the tiled body replaced (``attn_half`` / ``attn_half_bwd``)."""
    from vsn_tpu_torch.ops import _build

    _build.launches["attn_half"] += 1
    out = sbk.attn_half_reference(*args, **kw)
    if out.requires_grad:
        out.register_hook(lambda g: _build.launches.update(
            {"attn_half_bwd": 1}))
    return out


@pytest.mark.parametrize("body", ["tiled", "whole-window"])
def test_odd_head_dim_phase_on_cpu(monkeypatch, body):
    """Phase 7's odd-head-dim part on the CPU at tiny geometries, K1's and
    K4's plain versions counting as the card's launches: the Swin route's
    calls re-headed to d = 4 (the tiny widths 8, 16 and 32: 2, 4 and 8
    heads), K1 at N = 8 in f32 and bf16, K1 and K4 at d = 10 over 64
    windows in bf16; the launches alone and SDPA timed with a stand-in
    timer. It passes with the tiled body's counters and fails with any
    other's; a width that does not split raises."""
    from tests.test_torch_chip_smoke import _record

    calls = _record("float32", False)
    for name, args in chip_smoke.swin_route_calls(calls):
        re = chip_smoke.reheaded(args, 4)
        assert re[12] == args[0].shape[-1] // 4
        assert re[5].shape == (re[12], args[0].shape[1], args[0].shape[1])
        assert re[11] == 4 ** -0.5
    with pytest.raises(ValueError, match="heads of 3"):
        chip_smoke.reheaded(next(a for n, a in calls if n == "attn_half"),
                            3)
    monkeypatch.setattr(chip_smoke, "ODD_HEAD_DIMS", (4,))
    monkeypatch.setattr(chip_smoke, "ODD_N_GEOMETRY",
                        ((4, 4, 2), (2, 2, 2), (1, 1, 1), 12, 3))
    monkeypatch.setattr(chip_smoke, "ODD_WIDE",
                        ((4, 6, 4), (2, 3, 2), (1, 1, 1), 20, 2))
    table = chip_smoke.kernel_table()
    atable = chip_smoke.attention_table()
    if body == "tiled":
        table["attn_half"] = (_counted_k1, table["attn_half"][1])
    else:
        table["attn_half"] = (_counted_whole_window, table["attn_half"][1])
    atable["attention"] = (_counted_k4(body), atable["attention"][1])
    monkeypatch.setattr(chip_smoke, "kernel_table", lambda: dict(table))
    monkeypatch.setattr(chip_smoke, "attention_table", lambda: dict(atable))
    monkeypatch.setattr(chip_smoke, "cuda_ms",
                        lambda fn, reps=3, queued=False: (fn(), 1.0)[1])
    gen = torch.Generator().manual_seed(8)
    if body != "tiled":
        with pytest.raises(AssertionError, match="odd-head-dim launches"):
            chip_smoke.odd_head_dim_phase({"f32": calls}, "cpu", gen, "cpu")
        return
    sets = chip_smoke.odd_head_dim_sets({"f32": calls}, "cpu", gen)
    assert {a[0].shape[-1] // (a[12] if n == "attn_half" else 3 * a[4])
            for c in sets.values() for n, a in c} == {4, 10}
    wide = sets["d=10 stage 1 micro 8 bfloat16"]
    assert [n for n, _ in wide] == ["attn_half", "attention"]
    assert wide[0][1][0].shape == (64, 12, 20)
    assert wide[1][1][0].shape == (64, 12, 60) and wide[1][1][2].shape[0] == 8
    worst, slabs, counts, route = chip_smoke.odd_head_dim_phase(
        {"f32": calls}, "cpu", gen, "cpu")
    assert set(worst) == {"attn_half", "attn_half_bwd", "attention",
                          "attention_bwd"}
    assert all(err == 0.0 for err in worst.values())
    assert slabs == {} and set(route) == set(sets)
    assert counts["attention"] == 2 * sum(
        n == "attention" for c in route.values() for n, _ in c)
    times = chip_smoke.odd_head_times(sets, gen, "cpu")
    assert set(times) == {("d=4 N=8 bfloat16", "K1"),
                          ("d=10 stage 1 micro 8 bfloat16", "K1"),
                          ("d=10 stage 1 micro 8 bfloat16", "K4")}
    assert all(t == dict.fromkeys(("forward", "backward", "SDPA",
                                   "SDPA backward"), 1.0)
               for t in times.values())


def test_wide_head_dim_sets_on_cpu(monkeypatch):
    """Phase 7's calls above the tiled body's widest head at tiny sizes (the
    widest stood in for by 4): the route's calls re-headed to 8 where 8
    divides their width, K4 on each one's windows (the unshifted call's
    with one row of zero ids), and the K4 / V1 / V3 set at
    WIDE_V_HEAD_DIM; each call's head dim and launch counter (``head_dim``,
    ``body_counter``); the plain versions pass their parity phases
    there."""
    from tests.test_torch_chip_smoke import _record

    calls = _record("float32", False)
    monkeypatch.setattr(chip_smoke, "ODD_HEAD_DIMS", (8,))
    monkeypatch.setattr(chip_smoke, "TILED_HEAD_DIM", 4)
    monkeypatch.setattr(chip_smoke, "WIDE_V_HEAD_DIM", 8)
    monkeypatch.setattr(chip_smoke, "WIDE_V",
                        ((4, 6, 4), (2, 3, 2), (1, 1, 1), 16, 2))
    monkeypatch.setattr(chip_smoke, "ODD_N_GEOMETRY",
                        ((4, 4, 2), (2, 2, 2), (1, 1, 1), 12, 3))
    monkeypatch.setattr(chip_smoke, "ODD_WIDE",
                        ((4, 6, 4), (2, 3, 2), (1, 1, 1), 20, 2))
    gen = torch.Generator().manual_seed(9)
    sets = chip_smoke.odd_head_dim_sets({"f32": calls}, "cpu", gen)
    route = sets["d=8 f32"]
    k1 = [a for n, a in route if n == "attn_half"]
    k4 = [a for n, a in route if n == "attention"]
    assert k1 and len(k4) == len(k1) and len(route) == 2 * len(k1)
    assert any(a[6] is None for a in k1)
    assert all(a[2] is not None for a in k4)
    assert all(chip_smoke.head_dim(n, a) == 8 for n, a in route)
    v = sets["d=8 K4 V1 V3 float32"]
    assert [n for n, _ in v] == ["attention", "attention_split",
                                 "attention_windows"]
    assert all(chip_smoke.head_dim(n, a) == 8 for n, a in v)
    assert chip_smoke.body_counter("attn_half", 8) == "attn_half_slabs"
    assert chip_smoke.body_counter("attn_half_bwd", 4) == "attn_half_bwd_tiled"
    assert chip_smoke.body_counter("attention_bwd", 8) == \
        "attention_bwd_slabs"
    assert chip_smoke.body_counter("attention_split", 4) == "attention_split"
    assert chip_smoke.sdpa_backend(*chip_smoke.seeded_params(
        "attention", k4[0], gen)) in {"math", "flash_attention",
                                     "efficient_attention", "cudnn_attention"}
    table = {**chip_smoke.kernel_table(), **chip_smoke.attention_table(),
             **chip_smoke.v_table()}
    wide = {k: sets[k] for k in ("d=8 f32", "d=8 K4 V1 V3 float32")}
    worst, _ = chip_smoke.parity_phase(wide, table, gen)
    bworst, _ = chip_smoke.grad_parity_phase(wide, table, gen)
    assert set(worst) == {"attn_half", "attention", "attention_split",
                          "attention_windows"}
    assert all(e == 0.0 for e in (*worst.values(), *bworst.values()))
    monkeypatch.setattr(chip_smoke, "cuda_ms",
                        lambda fn, reps=3, queued=False: (fn(), 1.0)[1])
    ms, plain, bounds = chip_smoke.slab_times(v)
    names = {chip_smoke.SLAB_NAME[n] for n in (
        "attention", "attention_bwd", "attention_split",
        "attention_split_bwd", "attention_windows", "attention_windows_bwd")}
    assert set(ms) == set(plain) == set(bounds) == names
    assert all(b[0] > 0 for b in bounds.values())


@pytest.mark.parametrize("arch", ["swin", "vit"])
def test_wide_head_run_on_cpu(monkeypatch, arch):
    """Phase 16b's run at a tiny size on the CPU (no launches there: every
    count 0), through ``Evaluator.predict`` and one ``make_train_step``
    step against the plain route: a Swin of one head a stage, and a ViT
    built through ``wide_vit_model`` (2 heads of 64 stood in for 2 of
    192); the K1 calls of a training micro-batch at the new head dims."""
    from tests.test_torch_chip_smoke import TINY

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats", lambda: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda: 0)
    if arch == "swin":
        over = dict(TINY, HEADS=[1, 1, 1], FP16=True)
        build = lambda cfg: chip_smoke.seeded_model(cfg, "cpu")
        dims = {8, 16, 32}
    else:
        over = dict(VIT_TINY, EMBED_DIM=128, HEADS=6, FP16=True)
        monkeypatch.setattr(chip_smoke, "WIDE_VIT_HEADS", (2, 64))
        build = lambda cfg: chip_smoke.wide_vit_model(cfg, "cpu")
        dims = {64}
    cfg = load_config(over)
    train_cfg = load_config(dict(
        over, USE_SAM=True, USE_EMA=True, USE_MIXUP=True, SEED=0,
        BATCH_SIZE=2, EFFECTIVE_BATCH_SIZE=4, LR_WARMUP=0, WD_WARMUP=0,
        STEPS=10))
    batch = chip_smoke.train_batch(train_cfg, torch.device("cpu"), 5)
    images = np.random.default_rng(1).standard_normal(
        (chip_smoke.BATCH, *cfg.input_size, 1)).astype(np.float16)
    counts, calls = chip_smoke.wide_head_run(
        cfg, train_cfg, build, batch, images, {}, {}, f"tiny {arch}", "cpu")
    assert not any(counts.values())
    assert calls and all(n == "attn_half" for n, _ in calls)
    assert {chip_smoke.head_dim(n, a) for n, a in calls} == dims
    assert all(a[0].shape[0] == 2 * (a[0].shape[0] // 2) for _, a in calls)


def test_swin_attention_bound_at_micro_8():
    """The attention alone of Swin-T's 12 training calls at micro-batch 8
    (``attention_work``): 143.9 GFLOP forward, 0.146 ms at 989 TFLOP/s,
    against 1.175 GB (qkv read and ao written in bf16, the f32 bias read),
    0.351 ms at 3.35 TB/s: bound by bytes; backward 2.064 GB (qkv and dao
    read, dqkv written, the bias read and dbias written), 0.616 ms, against
    0.364 ms of products."""
    f32 = torch.float32
    calls = []
    for bw, c, heads, n, copies in ((1728, 96, 3, 252, 2),
                                    (216, 192, 6, 252, 2),
                                    (64, 384, 12, 252, 6),
                                    (8, 768, 24, 150, 2)):
        args = (_meta(bw, n, c), *[None] * 4, _meta(heads, n, n, dtype=f32),
                None, *[None] * 4, 32 ** -0.5, heads)
        calls += [args] * copies
    fwd = [sum(chip_smoke.attention_work(a)[i] for a in calls)
           for i in (0, 1)]
    bwd = [sum(chip_smoke.attention_work(a, True)[i] for a in calls)
           for i in (0, 1)]
    assert fwd[0] == pytest.approx(143.9e9, rel=1e-3)
    assert fwd[1] == pytest.approx(1.175e9, rel=1e-3)
    assert bwd[1] == pytest.approx(2.064e9, rel=1e-3)
    assert chip_smoke.work_bound_ms(*fwd) == (pytest.approx(
        0.351, abs=1e-3), "bytes")
    assert chip_smoke.work_bound_ms(*bwd) == (pytest.approx(
        0.616, abs=1e-3), "bytes")
    assert bwd[0] / 989e12 * 1e3 == pytest.approx(0.364, abs=1e-3)
