"""chip_smoke.py's unfused-block slice at a tiny size: K4 parity, its
mutants and the DynamicTanh phases, then V1 and V3 on the K4 calls (split
from tests/test_torch_chip_smoke.py, whose shared pieces it imports).
"""

import math

import pytest
import torch

import chip_smoke
from vsn_tpu_torch.config import load_config
from vsn_tpu_torch.models import build_model
from vsn_tpu_torch.models.swin3d import init_weights
from vsn_tpu_torch.train.step import init_train_state
from test_torch_chip_smoke import (
    DYT_TINY,
    ROOT,
    _meta,
    _mutant,
    _record,
    _run_mutated_chip_smoke,
    one_thread,
)


def test_k4_bounds_follow_the_shapes():
    """K4f at Swin-T stage 1, micro 8 (qkv [1728, 252, 288] bf16, bias [3,
    252, 252], ids [216, 252]): 4 * 1728 * 252^2 * 96 FLOP (0.043 ms at 989
    TFLOP/s) against qkv, bias and ids read and out written (0.100 ms at
    3.35 TB/s): bound by bytes; K4b does 10 / 4 of the FLOP and moves
    qkv, bias twice, dout once. The state K4f keeps for K4b (the row
    statistics [1728, 3, 252, 2] f32 and, bf16, the f32 o; in f32, out
    itself) is the port's design, counted apart and not in the bound."""
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
    stats = 1728 * 3 * 252 * 8
    assert chip_smoke.kept_bytes("attention", calls[0][1]) == stats + 2 * out
    f32 = (_meta(1728, 252, 288, dtype=torch.float32), bias, ids,
           32 ** -0.5, 3)
    assert chip_smoke.kept_bytes("attention", f32) == stats


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


def test_k4_saturation_and_launch_phases_on_cpu(k4_calls, k4_train_calls):
    """The K4 saturation phase (45, 200, -200 on a shifted call, then with
    the top logits in the ragged last key tile of the first call of each
    N) and the launch-level phase (K4f with its kept state, K4b from it)
    on the plain versions: they pass, and a wrong kept statistic fails the
    launch-level phase: a max off by 1, or a 1 / sum off by 0.1%."""
    from vsn_tpu_torch.ops import window_attention as wa

    if k4_calls[0][1][0].dtype == torch.float32:
        worst = chip_smoke.k4_saturation_phase(
            k4_calls, torch.Generator().manual_seed(3))
        assert worst == [0.0, 0.0]
    sets = {"tiny": k4_calls, "tiny train": k4_train_calls}
    assert chip_smoke.launch_parity_phase(
        sets, torch.Generator().manual_seed(4)) == 0.0
    plain = wa.window_attention_qkv_kept_reference

    for shift, factor in (([1.0, 0.0], [1.0, 1.0]),
                          ([0.0, 0.0], [1.0, 1.001])):
        def wrong_stats(*args):
            out, stats, o = plain(*args)
            return out, (stats + torch.tensor(shift)) * torch.tensor(
                factor), o

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(wa, "window_attention_qkv_launch", wrong_stats)
            with pytest.raises(AssertionError, match="the K4 launches on"):
                chip_smoke.launch_parity_phase(
                    sets, torch.Generator().manual_seed(4))


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


# One-line edits of the lines K4f / K4b run that chip_smoke.py must reject
# on the card (exit 1): name -> (source, line, mutant, what the failure
# names). The first four are lines of the key-tiled body (csrc/
# attn_tiled.cuh) that K1's tiled calls run too, so a run may fail in K1's
# phase 3 (ViT's calls, with a bias at saturation) before K4's phase 4;
# the ids row is only K4's in this run (ViT's calls have no ids). The last
# two are K4's softmax policy (csrc/window_attention_qkv.cu).
CSRC = ROOT / "vsn_tpu_torch" / "csrc"
K4_SOURCE = CSRC / "window_attention_qkv.cu"
TILED_SOURCE = CSRC / "attn_tiled.cuh"
K4_SOURCE_MUTANTS = {
    "ids row (bw + 1) % W (K4f and K4b)": (
        TILED_SOURCE, "return ids ? ids + (bw % ids_rows) * n : nullptr;",
        "return ids ? ids + ((bw + 1) % ids_rows) * n : nullptr;",
        "kernels disagree with their plain versions: DyT"),
    "head 0's bias for every head (K4f and K4b)": (
        TILED_SOURCE, "return bias + ((long long)h * n + i) * n;",
        "return bias + (long long)i * n;", "at logits"),
    "dk without scale (K4b)": (
        TILED_SOURCE, "dk[dt][e] = live ? dk[dt][e] * scale : 0.f;",
        "dk[dt][e] = live ? dk[dt][e] : 0.f;",
        "backward kernels disagree with their plain versions"),
    "dbias from one window (K4b)": (
        TILED_SOURCE,
        "float* dbias0 = dbias && live0 ? bias_row(dbias, h, n, i0) : "
        "nullptr;",
        "float* dbias0 = dbias && live0 && bw == 0 ? bias_row(dbias, h, n, "
        "i0) : nullptr;", "at logits"),
    "K4's shift started at 0, not -inf (K4f)": (
        K4_SOURCE, "static constexpr float kShift0 = -INFINITY;",
        "static constexpr float kShift0 = 0.f;", "K4 at logits -200"),
    "the bias dropped from K4's score (K4f and K4b)": (
        K4_SOURCE,
        "const float s = __fadd_rn(__fmul_rn(acc, scale), bias_i ? bias_i[j] "
        ": 0.f);",
        "const float s = __fmul_rn(acc, scale);",
        "kernels disagree with their plain versions: DyT"),
}


@pytest.mark.parametrize("mutant", sorted(K4_SOURCE_MUTANTS))
def test_k4_source_mutants_name_one_line_of_the_source(mutant):
    source, line, new, _ = K4_SOURCE_MUTANTS[mutant]
    assert source.read_text().count(line) == 1 and new != line


@pytest.mark.cuda
@pytest.mark.parametrize("mutant", sorted(K4_SOURCE_MUTANTS))
def test_a_mutated_k4_source_makes_chip_smoke_fail(mutant, tmp_path):
    """chip_smoke.py run from a copy in which one line that K4 runs is
    mutated exits 1, failing a parity check (K4's, or K1's tiled calls'
    where the line is theirs too)."""
    source, line, new, failure = K4_SOURCE_MUTANTS[mutant]
    res = _run_mutated_chip_smoke(source, line, new, tmp_path)
    assert res.returncode == 1
    assert failure in res.stderr, res.stderr[-2000:]


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
    count check fails here), the K4 agreement gate (V1's and V3's plain
    versions are K4's on the heads merged and the windows partitioned, so
    every difference is 0 here too), the timing and bound helpers with a
    stand-in timer."""
    triples, _ = v_calls
    gen = torch.Generator().manual_seed(6)
    for label, t in triples.items():
        diff = chip_smoke.k4_agreement(t, gen)
        assert diff == dict.fromkeys(diff, 0.0) and len(diff) == 6, label
    t = triples["tiny bfloat16 train=True"]
    dtype = "bfloat16"
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


def test_v_launch_phase_and_k4_gate_on_cpu(v_calls):
    """The V launch-level phase (V1f / V3f with their kept state, V1b / V3b
    from it, against their plain versions) passes on the plain versions,
    and fails on a wrong kept statistic; the K4 agreement gate fails on a
    V1f whose o is one f32 step off (bit equality, not a tolerance)."""
    from vsn_tpu_torch.ops import window_attention as wa

    triples, sets = v_calls
    gen = lambda: torch.Generator().manual_seed(7)
    assert chip_smoke.launch_parity_phase(
        sets, gen(), chip_smoke.V_KERNELS, "V") == 0.0
    plain = wa.window_attention_windows_kept_reference

    def wrong_stats(*args):
        out, stats, o = plain(*args)
        return out, stats * torch.tensor([1.0, 1.001]), o

    def o_off(*args):
        out, stats, o = wa.window_attention_kept_reference(*args)
        return out, stats, torch.nextafter(o, o + 1)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(wa, "window_attention_windows_launch", wrong_stats)
        with pytest.raises(AssertionError, match="the V launches on"):
            chip_smoke.launch_parity_phase(sets, gen(), chip_smoke.V_KERNELS,
                                           "V")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(wa, "window_attention_launch", o_off)
        with pytest.raises(AssertionError, match=r"\['V1f'\] not bit-equal"):
            chip_smoke.k4_agreement(triples["tiny float32 train=False"],
                                    gen())


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


def test_v_kept_bytes_equal_k4s_on_the_same_call():
    """V1's and V3's kept state (the row statistics [1728, 3, 252, 2] f32
    and the f32 o) is K4's at Swin-T stage 1, micro 8, counted apart from
    the bounds: 1728 * 252 * (3 * 8 + 96 * 4) bytes in bf16, the
    statistics alone in f32."""
    bias = _meta(3, 252, 252, dtype=torch.float32)
    ids = _meta(216, 252, dtype=torch.int32)
    for dtype, o32 in ((torch.bfloat16, 96 * 4), (torch.float32, 0)):
        q = _meta(1728, 3, 252, 32, dtype=dtype)
        k4 = (_meta(1728, 252, 288, dtype=dtype), bias, ids, 32 ** -0.5, 3)
        v1 = (q, q, q, bias, ids, 32 ** -0.5)
        v3 = (_meta(8, 36, 42, 36, 288, dtype=dtype), bias, ids, 32 ** -0.5,
              3, (6, 7, 6))
        want = 1728 * 252 * (3 * 8 + o32)
        assert chip_smoke.kept_bytes("attention", k4) == want
        assert chip_smoke.kept_bytes("attention_split", v1) == want
        assert chip_smoke.kept_bytes("attention_windows", v3) == want


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


# One-line edits of csrc/window_attention_qkv.cu's V layouts (``Split``,
# ``MapRows``) that chip_smoke.py must reject on the card (exit 1, in its V
# phase): name -> (line, mutant, the kernel whose parity fails)
V_SOURCE_MUTANTS = {
    "head stride d instead of N d (V1)": (
        "const long long off = (bw * heads + h) * n * d;",
        "const long long off = (bw * heads * n + h) * d;",
        "attention_split"),
    "dv written to dk (V1b)": (
        "dv[in(t) + ch] = dv_t;", "dk[in(t) + ch] = dv_t;",
        "attention_split_bwd"),
    "K read from q's base (V1)": (
        "stage_tile<T, D, P>(ks, k + in(t0), ld, nrows, d, plain);",
        "stage_tile<T, D, P>(ks, q + in(t0), ld, nrows, d, plain);",
        "attention_split"),
    "H and D window indices swapped (V3)": (
        "return ((b * md + i * wd) * mh + j * wh) * mw + kw * ww;",
        "return ((b * md + j * wd) * mh + i * wh) * mw + kw * ww;",
        "attention_windows"),
    "ids row from the global bw % W (V3)": (
        "return (bw % windows()) % rows;", "return bw % rows;",
        "attention_windows"),
    "a token's row ignoring the wh ww jump between slices (V3)": (
        "return ((long long)td * mh + th) * mw + tw;",
        "return (long long)a * mw + tw;", "attention_windows"),
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
    mutants touch only the Split and MapRows layouts)."""
    line, new, kernel = V_SOURCE_MUTANTS[mutant]
    res = _run_mutated_chip_smoke(K4_SOURCE, line, new, tmp_path)
    assert res.returncode == 1
    assert "disagree with their plain versions: DyT" in res.stderr
    assert f" {kernel} " in res.stderr.splitlines()[-1]
