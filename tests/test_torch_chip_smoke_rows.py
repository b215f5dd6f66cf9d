"""chip_smoke.py's row-kernel phase (2b) and its K3 launch-alone times at a
tiny size on the CPU: the LN-backward launches that K1 / K2 calls make,
their operands, the parity phase against the plain versions (which must
reject a launch that drops a term, or whose second run gives other bits),
the LN-backward path's counts; the same for LN's rows and the column sums
(their parity phase, path and result-line entries); the other row kernels'
calls and checks, the bounds, and the wide-row check's calls and phase
(split from tests/test_torch_chip_smoke.py, whose shared pieces it
imports).

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
    reads its rows and the gains once; the post-norm forward reads the f32
    branch and x once and writes out; LayerScale reads w and dw, writes
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
    branch = torch.zeros(100, 96)
    assert chip_smoke.row_kernel_work(
        "postnorm_fwd", (branch, x, w, w, w, torch.zeros(2), 50, 1.0)) == (
            8 * 9600, 38400 + 2 * 19200 + 3 * 384 + 8)
    assert chip_smoke.row_shape_work("postnorm_fwd", (100, 96), 50) == \
        chip_smoke.row_kernel_work(
            "postnorm_fwd", (branch, x, w, w, w, torch.zeros(2), 50, 1.0))
    assert chip_smoke.row_shape_work("layerscale_grads", (96, 384), 1) == \
        (3 * 96 * 384, 12 * 96 * 384 + 20 * 96)


def test_row_shape_work_counts_what_the_arguments_count(row_sets):
    """The bound of LN's rows and the column sums from their shapes alone
    (``row_shape_work``, the result line's bound over the recorded calls)
    is the bound from their seeded arguments (``row_kernel_work``)."""
    gen = torch.Generator().manual_seed(0)
    for launch in row_sets["swin"]:
        for kname, _, shape in chip_smoke.row_kernel_calls(launch):
            if kname in chip_smoke.ROW_KERNEL_ENTRIES:
                args = chip_smoke.row_kernel_args(kname, shape, launch, "cpu",
                                                  gen)
                assert chip_smoke.row_shape_work(
                    kname, shape, launch.rows_per_sample) == \
                    chip_smoke.row_kernel_work(kname, args)


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


def test_mover_gather_is_each_k3_entrys_function():
    """The library's gather beside K3 (``mover_gather``: one index_select
    over relayout_map's row map laid over the batch) gives every mover's
    and adjoint's output of a training forward's calls bit for bit."""
    calls = _record("bfloat16", train=True)
    table = chip_smoke.kernel_table()
    adjoints = chip_smoke.mover_adjoints()
    gen = torch.Generator().manual_seed(7)
    seen = set()
    for name, args in calls:
        if name not in chip_smoke.MOVERS:
            continue
        want = table[name][1](*args)
        g = torch.randn(want.shape, generator=gen).to(want.dtype)
        for kname, src, ref in ((name, args[0], want),
                                (f"{name}_adjoint", g,
                                 adjoints[name][1](g, args))):
            rows, index = chip_smoke.mover_gather(kname, args, src)
            got = rows.index_select(0, index).reshape(ref.shape)
            assert torch.equal(got, ref), kname
        seen.add(name)
    assert seen == set(chip_smoke.MOVERS)


def test_mover_library_times_cover_each_k3_entry(one_call_clock):
    """One index_select a mover call and adjoint, summed by entry."""
    calls = _record("bfloat16", train=True)
    out = chip_smoke.mover_library_times(calls, "cpu")
    movers = collections.Counter(n for n, _ in calls
                                 if n in chip_smoke.MOVERS)
    assert set(out) == set(chip_smoke.MOVER_MAPS)
    for name, n in movers.items():
        assert out[name] == out[f"{name}_adjoint"] == n


def test_k3_alone_needs_a_card(monkeypatch):
    """``chip_smoke.py --k3-alone`` exits, printing no times, without a
    card, as the whole script does."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        chip_smoke.k3_alone()


# LN's rows and the column sums (phase 2b holds them as it holds the LN
# backward): mutants of their plain versions that the row parity phase
# must reject. name -> (kernel, its mutant of the plain version)
ROW_MUTANTS = {
    "column sums: the first third of the rows only": ("colsum", lambda a, *r: (
        sbk.colsum_reference(a[: a.shape[0] // 3], *r) if not r else
        sbk.colsum_reference(a[: a.shape[0] // 3], r[0], r[1]))),
    "column sums: the first sample's gain for all": ("colsum", lambda a, *r: (
        sbk.colsum_reference(a) if not r else sbk.colsum_reference(
            a, r[0][:1].expand_as(r[0]).contiguous(), r[1]))),
    "LN rows: the variance about 0": ("ln_rows", lambda x, w, b: (
        lambda xf: ((xf * torch.rsqrt((xf * xf).mean(1, keepdim=True)
                                      + 1e-5) * w + b).to(x.dtype),
                    sbk.ln_rows_reference(x, w, b)[1]))(x.float())),
    "LN rows: the statistics of the neighbouring row": ("ln_rows", lambda *a: (
        lambda y, st: (y, st.roll(1, 0)))(*sbk.ln_rows_reference(*a))),
    "post-norm forward: without gamma": ("postnorm_fwd", lambda br, x, w, b,
                                         gamma, *r: sbk.postnorm_fwd_reference(
                                             br, x, w, b, None, *r)),
    "post-norm forward: the variance about 0": (
        "postnorm_fwd", lambda br, x, w, b, gamma, gains, rps, lam: (
            lam * x.float() + sbk._gain_rows(gains, rps, x.shape[0]) * (
                ((br - br.mean(1, keepdim=True)) * torch.rsqrt(
                    (br * br).mean(1, keepdim=True) + 1e-5) * w + b)
                * gamma)).to(x.dtype)),
    "LayerScale gradients: dgamma without the b * s term": (
        "layerscale_grads", lambda w, bias, *r: sbk.layerscale_grads_reference(
            w, 0 * bias, *r)),
    "LayerScale gradients: dgamma from the scaled M": (
        "layerscale_grads", lambda w, bias, gamma, dw, db, dgamma: (
            lambda out: (out[0], out[1], dgamma + (w * out[0]).sum(1)
                         + bias * db))(sbk.layerscale_grads_reference(
                             w, bias, gamma, dw, db, dgamma))),
    "LayerScale gradients: dW left unscaled": (
        "layerscale_grads", lambda w, bias, gamma, dw, *r: (
            lambda out: (dw, *out[1:]))(sbk.layerscale_grads_reference(
                w, bias, gamma, dw, *r))),
}


def test_row_plain_versions_pass(row_sets):
    worst = chip_smoke.row_parity_phase(_sets(row_sets), "cpu")
    assert worst == {"ln_rows": 0.0, "colsum": 0.0, "postnorm_fwd": 0.0,
                     "layerscale_grads": 0.0}


@pytest.mark.parametrize("mutant", sorted(ROW_MUTANTS))
def test_a_row_launch_missing_a_term_fails(row_sets, mutant):
    name, kernel = ROW_MUTANTS[mutant]
    table = chip_smoke.row_table()
    table[name] = (kernel, table[name][1])
    with pytest.raises(AssertionError, match="row kernels disagree"):
        chip_smoke.row_parity_phase(_sets(row_sets), "cpu", table)


def test_unequal_column_sum_bits_between_two_launches_fail(row_sets):
    """A column sum whose second run gives other bits (an order of sums
    that varies from run to run, as atomics give) makes the phase raise,
    though each run is within its tolerance."""
    runs = collections.Counter()

    def flaky(a, *rest):
        out = sbk.colsum_reference(a, *rest)
        runs[a.shape] += 1
        return out + 1e-7 * out.abs().max() * (runs[a.shape] % 2 == 0)

    table = chip_smoke.row_table()
    table["colsum"] = (flaky, table["colsum"][1])
    with pytest.raises(AssertionError, match="row kernel launches differ"):
        chip_smoke.row_parity_phase({"swin": (row_sets["swin"], "float32")},
                                    "cpu", table)


def test_unequal_layerscale_bits_between_two_launches_fail(row_sets):
    """LayerScale gradients whose dgamma differs in its last bits on a
    second run (a dot summed in an order that varies) make the phase
    raise, though each run is within its tolerance."""
    runs = collections.Counter()

    def flaky(w, *rest):
        dw, db, dgamma = sbk.layerscale_grads_reference(w, *rest)
        runs[w.shape] += 1
        return dw, db, dgamma + 1e-7 * dgamma.abs().max() * (
            runs[w.shape] % 2 == 0)

    table = chip_smoke.row_table()
    table["layerscale_grads"] = (flaky, table["layerscale_grads"][1])
    with pytest.raises(AssertionError, match="row kernel launches differ"):
        chip_smoke.row_parity_phase({"vit": (row_sets["vit"], "float32")},
                                    "cpu", table)


def test_row_kernel_args_hold_parameters_as_views_into_a_buffer(row_sets):
    """The post-norm forward's LN scale, shift and gamma and the
    LayerScale gradients' W start 4 bytes into their storage, as views of
    the flat parameter buffer do; the timed call on the CPU is the
    wrapper's."""
    gen = torch.Generator().manual_seed(0)
    launch = next(la for la in row_sets["swin"] if la.label.startswith("K2"))
    calls = {k: s for k, _, s in chip_smoke.row_kernel_calls(launch)}
    pn = chip_smoke.row_kernel_args("postnorm_fwd", calls["postnorm_fwd"],
                                    launch, "cpu", gen)
    ls = chip_smoke.row_kernel_args("layerscale_grads",
                                    calls["layerscale_grads"], launch, "cpu",
                                    gen)
    for t in (*pn[2:5], ls[0]):
        assert t.storage_offset() == 1 and t.is_contiguous()
    assert ls[0].shape == (launch.c, launch.hidden)
    kernel, plain = sbk.ROW_KERNELS["layerscale_grads"]
    got = chip_smoke.row_timed_call("layerscale_grads", ls, kernel)()
    for a, e in zip(got, plain(*ls)):
        assert torch.equal(a, e)


def test_rows_alone_needs_a_card(monkeypatch):
    """``chip_smoke.py --rows-alone`` exits, printing no times, without a
    card, as the whole script does."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        chip_smoke.rows_alone()


def test_row_path_counts_one_launch_per_call(row_sets, monkeypatch):
    """The row path's plumbing: LN's rows once per K1b / K2b call (24 a
    pass), the column sums once per bias gradient (K1b's dbproj, K2b's
    dfc2_b and dfc1_b: 36 a pass), the post-norm forward's finish once per
    K1f / K2f call and the LayerScale gradients once per K1b / K2b call (24
    a pass each), for both sets, the counters at 0 before; the wrappers
    counted by stand-ins (the CPU path counts nothing)."""
    from vsn_tpu_torch.ops import _build

    table = chip_smoke.row_table()

    def counted(name):
        def fn(*a):
            _build.launches[name] += 1
            return table[name][1](*a)
        return fn

    monkeypatch.setattr(chip_smoke, "row_table", lambda: {
        k: (counted(k), v[1]) for k, v in table.items()})
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    _build.launches["colsum"] += 5   # cleared by the path
    counts = chip_smoke.row_path(row_sets, "cpu")
    assert counts["ln_rows"] == 48 and counts["colsum"] == 72
    assert counts["postnorm_fwd"] == counts["layerscale_grads"] == 48
    assert sum(counts.values()) == 216
    _build.launches.clear()


def test_row_entries_sum_every_set_that_the_path_counts(
        row_sets, one_call_clock):
    """The result line's row entries describe the launches that
    ``row_path`` counts: both sets' (24 + 24 a pass, the column sums' 36 +
    36, at one ms each; ``Tensor.sum(0)`` and ``native_layer_norm`` run on
    the CPU too; no single call computes the post-norm finish or the
    LayerScale gradients: null), with the bound of the summed work."""
    times = chip_smoke.row_kernel_times(row_sets, "cpu", "cpu")
    entries = chip_smoke.row_entries(times, row_sets)
    assert set(entries) == set(chip_smoke.ROW_KERNEL_ENTRIES)
    for name, n in (("ln_rows", 48), ("colsum", 72), ("postnorm_fwd", 48),
                    ("layerscale_grads", 48)):
        ms, plain, bound, lib = entries[name]
        assert ms == plain == n
        assert lib == (n if name in ("ln_rows", "colsum") else None)
        flops = nbytes = 0
        for launches in row_sets.values():
            for la, t in launches.items():
                for kname, _, shape in chip_smoke.row_kernel_calls(la):
                    if kname == name:
                        args = chip_smoke.row_kernel_args(
                            kname, shape, la, "cpu",
                            torch.Generator().manual_seed(0))
                        f, b = chip_smoke.row_kernel_work(kname, args)
                        flops, nbytes = flops + t * f, nbytes + t * b
        assert bound == chip_smoke.work_bound_ms(flops, nbytes, "float32")
    only = chip_smoke.row_kernel_times(row_sets, "cpu", "cpu",
                                       names=("colsum",))
    assert {k for _, k in only} == {"colsum"}


def test_the_wide_rows_calls():
    """The wide-row check's calls: Swin-T's stage-4 rows at micro-batch 8
    (8 windows of 150 tokens, 1200 rows), K1 at C = 1536 (24 heads of 64)
    and at C = 300 (12 heads of 25, a head dim that the key-tiled body takes
    too: its bf16 rows staged by plain loads), K2 at hidden 4C, seeded
    parameters and distinct gains."""
    gen = torch.Generator().manual_seed(0)
    for c, heads in chip_smoke.WIDE_ROWS:
        (n1, k1), (n2, k2) = chip_smoke.wide_calls("cpu", gen, c, heads)
        assert (n1, n2) == ("attn_half", "ln_mlp")
        assert k1[0].shape == (8, 150, c) and k1[0].dtype == torch.bfloat16
        assert k1[3].shape == (3 * c, c) and k1[5].shape == (heads, 150, 150)
        assert k1[6] is None and k1[12] == heads
        assert k2[0].shape == (1200, c) and k2[3].shape == (4 * c, c)
        assert k2[7].shape == (8,) and not torch.equal(k2[7], k2[8])
        assert sbk.takes_head_dim(c // heads)
    assert {c % 8 for c, _ in chip_smoke.WIDE_ROWS} == {0, 4}


def test_wide_rows_phase_passes_and_a_mutant_fails(monkeypatch):
    """The phase on narrow stand-ins for the wide rows (the CPU runs the
    plain versions on both sides): passes; a K2 with its LN scale half
    again fails it."""
    monkeypatch.setattr(chip_smoke, "WIDE_ROWS", ((16, 2), (12, 3)))
    monkeypatch.setattr(chip_smoke, "WIDE_WINDOWS", 2)
    monkeypatch.setattr(chip_smoke, "WIDE_N", 10)
    worst = chip_smoke.wide_row_phase("cpu", torch.Generator().manual_seed(0))
    assert worst == {"attn_half_bwd": 0.0, "ln_mlp_bwd": 0.0}
    table = chip_smoke.kernel_table()
    plain = table["ln_mlp"][1]
    table["ln_mlp"] = (lambda x, w, *a, **k: plain(x, 1.5 * w, *a, **k),
                       plain)
    with pytest.raises(AssertionError, match="at the wide rows"):
        chip_smoke.wide_row_phase("cpu", torch.Generator().manual_seed(0),
                                  table)
