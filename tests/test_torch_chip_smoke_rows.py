"""chip_smoke.py's row-kernel phase (2b) and its K3 launch-alone times at a
tiny size on the CPU: the LN-backward launches that K1 / K2 calls make,
their operands, the parity phase against the plain versions (which must
reject a launch that drops a term, or whose second run gives other bits),
the LN-backward path's counts, the other row kernels' calls and checks,
and the bounds (split from tests/test_torch_chip_smoke.py, whose shared
pieces it imports).

On the CPU ``ln_bwd_launch`` / ``postnorm_bwd_launch`` and the other row
wrappers run their plain versions, so a "kernel" here is the plain version
with one term changed (a mutant). The calls are the training forward of a
Swin at Swin-T's depths [2, 2, 6, 2] (stage 1 window-resident, stages 3 and
4 clamped) and of a ViT of depth 12, at batch 2; the times (CUDA events on
the card) are stood in for by a clock that runs each call once.
"""

import collections
import math

import numpy as np
import pytest
import torch

import chip_smoke
from test_torch_chip_smoke import _record, one_thread  # noqa: F401
from test_torch_chip_smoke_vit import VIT_TINY
from vsn_tpu_torch.config import load_config
from vsn_tpu_torch.data.augment import zscore
from vsn_tpu_torch.models import build_model
from vsn_tpu_torch.models.swin3d import init_weights as swin_init
from vsn_tpu_torch.models.vit3d import init_weights as vit_init
from vsn_tpu_torch.ops import swin_block_kernels as sbk

# Swin-T's depths and heads, tiny widths and grid: stages of 12x14x12,
# 6x7x6, 3x4x3 and 2x2x2 tokens under the 6x7x6 window
SWIN_DEPTHS = dict(IMG_SIZE=[24, 28, 24], PATCH_SHAPE=[2, 2, 2],
                   WINDOW_SIZE=[6, 7, 6], EMBED_DIM=8, DEPTH=[2, 2, 6, 2],
                   HEADS=[1, 2, 4, 8], USE_SHAKEDROP=True)


def _stage_rows(batch, dims, window):
    """Rows of a Swin stage's K1 / K2 calls: each axis's window clamped to
    the axis where the axis is not larger, the grid padded to it."""
    rows = batch
    for d, w in zip(dims, window):
        w = min(w, d)
        rows *= -(-d // w) * w
    return rows


def _swin_calls():
    model = build_model(load_config(SWIN_DEPTHS), device="cpu")
    swin_init(model, torch.Generator().manual_seed(0))
    x = np.random.default_rng(0).standard_normal((2, 24, 28, 24, 1))
    x = zscore(torch.from_numpy(x.astype(np.float32)))
    return chip_smoke.record_calls(
        model.train(), x, generator=torch.Generator().manual_seed(1))


@pytest.fixture(scope="module")
def row_sets():
    vit = build_model(load_config(dict(VIT_TINY, DEPTH=12)), device="cpu")
    vit_init(vit, torch.Generator().manual_seed(0))
    x = np.random.default_rng(0).standard_normal((2, 16, 16, 16, 1))
    x = zscore(torch.from_numpy(x.astype(np.float32)))
    vit_calls = chip_smoke.record_calls(
        vit.train(), x, generator=torch.Generator().manual_seed(1))
    return {"swin": chip_smoke.row_launch_set(_swin_calls()),
            "vit": chip_smoke.row_launch_set(vit_calls)}


def test_the_shape_set_has_24_calls_a_pass_at_each_stages_rows(row_sets):
    """24 LN-backward launches a micro-batch pass for Swin-T's depths and
    for ViT-S's (one in K1b and one in K2b per block), at each stage's (M,
    C): Swin's widths double per stage, its rows follow the window-padded
    grid; ViT's rows are B x (tokens + CLS)."""
    swin, vit = row_sets["swin"], row_sets["vit"]
    assert sum(swin.values()) == 24 and sum(vit.values()) == 24
    dims, want = (12, 14, 12), collections.Counter()
    for stage, depth in enumerate((2, 2, 6, 2)):
        m, c = _stage_rows(2, dims, (6, 7, 6)), 8 << stage
        for label, hidden in (("K1b LN1", 0), ("K2b LN2", 4 * c)):
            want[chip_smoke.RowLaunch(label, m, c, m // 2, hidden)] += depth
        dims = tuple(-(-d // 2) for d in dims)
    assert swin == want
    m = 2 * (4 ** 3 + 1)
    assert vit == {chip_smoke.RowLaunch("K1b LN1", m, 128, m // 2, 0): 12,
                   chip_smoke.RowLaunch("K2b LN2", m, 128, m // 2, 512): 12}


def test_the_rows_of_the_slices_swin_t_and_vit_s():
    """The formula above at the slice's calls: Swin-T at micro-batch 8 of
    144x168x144 (stage 3's 9x11x9 grid padded to 12x14x12, stage 4's 5x6x5
    clamped), ViT-S at micro-batch 24 (811 tokens)."""
    dims, rows = (36, 42, 36), []
    for _ in range(4):
        rows.append(_stage_rows(8, dims, (6, 7, 6)))
        dims = tuple(-(-d // 2) for d in dims)
    assert rows == [435456, 54432, 16128, 1200]


def test_ln_bwd_calls_and_the_bound():
    """Swin-T stage 1 at micro-batch 8, bf16, is bound by its bytes: x,
    do_res and dx bf16, dy f32, the row statistics, w, dw, db (pre-norm); the
    f32 branch read and written, do_res, the gains, w, b, gamma and their
    three gradients (post-norm)."""
    launch = chip_smoke.RowLaunch("K1b LN1", 435456, 96, 54432, 0)
    flops, nbytes = chip_smoke.ln_bwd_work("ln_bwd", launch)
    assert flops == 13 * 435456 * 96
    assert nbytes == 435456 * 96 * 10 + 8 * 435456 + 12 * 96
    ms, by = chip_smoke.work_bound_ms(flops, nbytes, "float32")
    assert by == "bytes" and ms == pytest.approx(nbytes / 3.35e12 * 1e3)
    flops, nbytes = chip_smoke.ln_bwd_work("postnorm_bwd", launch)
    assert nbytes == 435456 * 96 * 10 + 4 * 8 + 24 * 96
    gen = torch.Generator().manual_seed(0)
    small = chip_smoke.RowLaunch("K2b LN2", 74, 24, 37, 96)
    pre = chip_smoke.ln_bwd_call("ln_bwd", small, "bfloat16", "cpu", gen)
    assert pre[0].dtype == pre[4].dtype == torch.bfloat16
    assert pre[1].shape == (74, 2) and pre[3].dtype == torch.float32
    post = chip_smoke.ln_bwd_call("postnorm_bwd", small, "float32", "cpu",
                                  gen)
    assert post[2].shape == (2,) and post[3] == 37 and post[6].shape == (24,)


def _sets(row_sets):
    return {**{k: (v, "bfloat16") for k, v in row_sets.items()},
            "swin f32": (row_sets["swin"], "float32")}


def test_ln_bwd_plain_versions_pass(row_sets):
    worst = chip_smoke.ln_bwd_parity_phase(_sets(row_sets), "cpu")
    assert worst == {"ln_bwd": 0.0, "postnorm_bwd": 0.0}


def _pre(change):
    """A pre-norm "kernel": the plain version with its arguments changed."""
    return lambda *a: sbk.ln_backward_rows_reference(*change(list(a)))


def _post(change):
    return lambda *a: sbk.postnorm_backward_rows_reference(*change(list(a)))


def _set(a, i, v):
    a[i] = v
    return a


LN_MUTANTS = {  # name -> (mode, its mutant of the plain version)
    "residual line dropped": ("ln_bwd", _pre(lambda a: _set(a, 5, 0.0))),
    "LN scale dropped": ("ln_bwd", _pre(
        lambda a: _set(a, 2, torch.ones_like(a[2])))),
    "the statistics of the neighbouring row": ("ln_bwd", _pre(
        lambda a: _set(a, 1, a[1].roll(1, 0)))),
    "dw over half the rows": ("ln_bwd", lambda *a: (
        lambda out: (out[0], sbk.ln_backward_rows_reference(
            *[t[: t.shape[0] // 2] if torch.is_tensor(t) and t.dim() == 2
              else t for t in a])[1], out[2]))(
        sbk.ln_backward_rows_reference(*a))),
    "post-norm gains of the first sample for all": ("postnorm_bwd", _post(
        lambda a: _set(a, 2, a[2][:1].expand_as(a[2]).contiguous()))),
    "post-norm gamma dropped": ("postnorm_bwd", _post(
        lambda a: _set(a, 6, torch.ones_like(a[6])))),
    "post-norm LN shift dropped from dgamma": ("postnorm_bwd", _post(
        lambda a: _set(a, 5, torch.zeros_like(a[5])))),
}


@pytest.mark.parametrize("mutant", sorted(LN_MUTANTS))
def test_an_ln_bwd_launch_missing_a_term_fails(row_sets, mutant):
    name, kernel = LN_MUTANTS[mutant]
    table = chip_smoke.ln_bwd_table()
    table[name] = (kernel, table[name][1])
    with pytest.raises(AssertionError, match="LN-backward launches disagree"):
        chip_smoke.ln_bwd_parity_phase(_sets(row_sets), "cpu", table)


def test_unequal_bits_between_two_launches_fail(row_sets):
    """A launch whose second run gives other bits (as an order of sums that
    varies from run to run would) makes the phase raise, though each run is
    within its tolerance."""
    runs = collections.Counter()

    def flaky(*a):
        dx, dw, db = sbk.ln_backward_rows_reference(*a)
        runs[a[0].shape] += 1
        if runs[a[0].shape] % 2 == 0:
            dw = dw + 1e-7 * dw.abs().max()
        return dx, dw, db

    table = chip_smoke.ln_bwd_table()
    table["ln_bwd"] = (flaky, table["ln_bwd"][1])
    with pytest.raises(AssertionError, match="differ between two runs"):
        chip_smoke.ln_bwd_parity_phase({"swin": (row_sets["swin"],
                                                 "float32")}, "cpu", table)


def test_ln_bwd_path_counts_one_launch_per_call(row_sets, monkeypatch):
    """The path's plumbing: every launch as often as a pass makes it, the
    counters at 0 before; the wrappers counted by stand-ins (the CPU path
    counts nothing)."""
    from vsn_tpu_torch.ops import _build

    table = chip_smoke.ln_bwd_table()

    def counted(name):
        def fn(*a):
            _build.launches[name] += 1
            return table[name][1](*a)
        return fn

    monkeypatch.setattr(chip_smoke, "ln_bwd_table", lambda: {
        k: (counted(k), v[1]) for k, v in table.items()})
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    _build.launches["ln_bwd"] += 5   # cleared by the path
    counts = chip_smoke.ln_bwd_path(row_sets, "cpu")
    assert counts["ln_bwd"] == counts["postnorm_bwd"] == 48
    _build.launches.clear()


@pytest.fixture
def one_call_clock(monkeypatch):
    """CUDA-event times stood in for: each timed function runs once and
    takes 1 ms."""
    def clock(fn, *a, **kw):
        fn()
        return 1.0
    monkeypatch.setattr(chip_smoke, "launch_ms", clock)
    monkeypatch.setattr(chip_smoke, "cuda_ms", clock)


def test_ln_bwd_times_sum_each_launch_by_its_calls(row_sets, one_call_clock):
    """Per set and mode, each launch's times by the calls a pass makes (the
    library yardstick runs on the CPU too), and the bound of the sum."""
    out = chip_smoke.ln_bwd_times(row_sets, "cpu", "cpu")
    for label, launches in row_sets.items():
        for name in chip_smoke.LN_BWD_KERNELS:
            ms, plain, bound, lib = out[(label, name)]
            assert ms == plain == lib == sum(launches.values()) == 24
            flops = sum(t * chip_smoke.ln_bwd_work(name, la)[0]
                        for la, t in launches.items())
            nbytes = sum(t * chip_smoke.ln_bwd_work(name, la)[1]
                         for la, t in launches.items())
            assert bound == chip_smoke.work_bound_ms(flops, nbytes,
                                                     "float32")


def test_ln_bwd_entries_sum_every_set_that_the_path_counts(
        row_sets, one_call_clock):
    """The result line's ``ln_bwd`` / ``postnorm_bwd`` entries describe the
    launches that ``ln_bwd_path`` counts: both sets' (24 + 24 a pass at
    one ms each), with the bound of the summed work."""
    entries = chip_smoke.ln_bwd_entries(
        chip_smoke.ln_bwd_times(row_sets, "cpu", "cpu"), row_sets)
    for name in chip_smoke.LN_BWD_KERNELS:
        ms, plain, bound, lib = entries[name]
        assert ms == plain == lib == 48
        work = [sum(t * chip_smoke.ln_bwd_work(name, la)[i]
                    for launches in row_sets.values()
                    for la, t in launches.items()) for i in (0, 1)]
        assert bound == chip_smoke.work_bound_ms(*work, "float32")


def test_row_kernel_calls_follow_the_modes(row_sets):
    """K1's call: LN rows, dbproj's column sum, the post-norm forward, the
    LayerScale gradients of proj [C, C]; K2's besides dfc1_b's column sum
    over dh1 [M, hidden], and fc2's [C, hidden]."""
    for launch in row_sets["swin"]:
        calls = chip_smoke.row_kernel_calls(launch)
        kinds = collections.Counter(k for k, _, _ in calls)
        k1 = launch.label.startswith("K1")
        assert kinds == {"ln_rows": 1, "colsum": 1 if k1 else 2,
                         "postnorm_fwd": 1, "layerscale_grads": 1}
        shapes = {what: shape for _, what, shape in calls}
        m, c = launch.m, launch.c
        if k1:
            assert shapes["proj"] == (c, c) and shapes["dbproj"][:2] == (m, c)
        else:
            assert shapes["fc2"] == (c, 4 * c)
            assert shapes["dfc1_b"] == (m, 4 * c, "f32")


def test_row_kernel_plain_versions_pass_and_a_mutant_fails(
        row_sets, one_call_clock, monkeypatch):
    chip_smoke.row_kernel_times(row_sets, "cpu", "cpu")
    kernel, plain = sbk.ROW_KERNELS["colsum"]
    monkeypatch.setitem(sbk.ROW_KERNELS, "colsum", (
        lambda a, *rest: plain(a[: a.shape[0] // 2], *rest) if not rest
        else plain(a, rest[0][:1].expand_as(rest[0]), rest[1]), plain))
    with pytest.raises(AssertionError, match="row kernels disagree"):
        chip_smoke.row_kernel_times(row_sets, "cpu", "cpu")


def test_row_kernel_bounds():
    """LN rows read x once and write y and the statistics; a column sum
    reads its rows and the gains once; LayerScale reads w and dw, writes
    dw."""
    x = torch.zeros(100, 96, dtype=torch.bfloat16)
    w = torch.zeros(96)
    assert chip_smoke.row_kernel_work("ln_rows", (x, w, w)) == (
        5 * 9600, 2 * 19200 + 800 + 768)
    assert chip_smoke.row_kernel_work("colsum", (x, torch.zeros(2), 50)) \
        == (2 * 9600, 19200 + 8 + 384)
    wt = torch.zeros(96, 384)
    assert chip_smoke.row_kernel_work(
        "layerscale_grads", (wt, w, w, wt, w, w))[1] == 3 * 96 * 384 * 4 + \
        5 * 96 * 4


def test_mover_launch_times_cover_each_call_and_its_adjoint(one_call_clock):
    """Every mover call of a training forward, forward and adjoint, once
    each; the sums per name; the bytes counted include the map's 4 a row."""
    calls = _record("bfloat16", train=True)
    out = chip_smoke.mover_launch_times(calls, "cpu")
    movers = collections.Counter(n for n, _ in calls
                                 if n in chip_smoke.MOVERS)
    for name, n in movers.items():
        assert out[name] == out[f"{name}_adjoint"] == n
    name, args = next((n, a) for n, a in calls if n in chip_smoke.MOVERS)
    x = args[0]
    assert chip_smoke.call_work(name, args)[1] == 2 * x.numel() * 2 + \
        4 * (x.numel() // x.shape[-1])
    assert not math.isnan(sum(out.values()))


def test_k3_alone_needs_a_card(monkeypatch):
    """``chip_smoke.py --k3-alone`` exits, printing no times, without a
    card, as the whole script does."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        chip_smoke.k3_alone()
