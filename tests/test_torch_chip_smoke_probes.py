"""chip_smoke.py's attention-probe phase (P1-P5) at a tiny size and its
mutants (split from tests/test_torch_chip_smoke.py, whose shared pieces it
imports).
"""


import pytest
import torch

import chip_smoke
from test_torch_chip_smoke import (
    ROOT,
    _meta,
    _run_mutated_chip_smoke,
    one_thread,
)


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
    # K1's tiled body: 2; K1/K2 in the stabilizer paths' residual modes: 10;
    # the GEMM and weight-gradient bodies of K1 / K2 alone: 2; the LN
    # backward of K1b / K2b alone in its two modes: 2; LN's rows, the
    # column sums, the post-norm forward's finish and the LayerScale
    # gradients of K1 / K2 alone: 4; the tiled body's slab kernels (head
    # dims above 128) under K1f / K1b, K4f / K4b, V1f / V1b, V3f / V3b: 8
    assert len(chip_smoke.KERNELS) == 18 + 2 + 13 + 10 + 2 + 2 + 4 + 8


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
    the copies' kernels and copy_ for the copies only, K1f on the same x."""
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
    monkeypatch.setattr(chip_smoke, "cuda_ms",
                        lambda fn, reps=3, queued=False: (fn(), 1.0)[1])
    plain, library, k1f, copies = chip_smoke.probe_times(
        runs, sets["scripts' inputs"], 2, "cpu")
    assert plain == dict.fromkeys(chip_smoke.PROBES, 1.0) and k1f == 1.0
    copy_keys = {k for k in chip_smoke.PROBES if k.startswith("copy_windows")}
    assert {k for k, v in library.items() if v is not None} == copy_keys
    assert copies == dict.fromkeys(copy_keys, 1.0)


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


# One-line edits of the probes' policies and layout on the key-tiled body
# (csrc/attn_half.cu, csrc/attn_tiled.cuh) that chip_smoke.py must reject on
# the card (exit 1, in its probe phase): name -> (source, line, its mutant,
# a run whose parity fails). K1f's and K4f's instantiations are untouched by
# each (their policies and layouts; one window per block).
CSRC = ROOT / "vsn_tpu_torch" / "csrc"
P_SOURCE_MUTANTS = {
    "the second pass dropped: p rounded before normalizing (ProbeSoftmax)": (
        "attn_half.cu", "static constexpr Probs kProbs = Probs::kNormalized;",
        "static constexpr Probs kProbs = Probs::kOnline;",
        "attn_ablate.full2d"),
    "nosm factor 0.01 (ProbeScaled)": (
        "attn_half.cu", "return __fmul_rn(0.001f, s);",
        "return __fmul_rn(0.01f, s);", "attn_ablate.nosm"),
    "window stride 1 instead of wb": (
        "attn_tiled.cuh", "scale, plain, lay, bw * lay.wb + slot, h, q0);",
        "scale, plain, lay, bw + slot, h, q0);", "attn_slot.full.wb8"),
    "attn_only reads k from a neighbouring head": (
        "attn_half.cu", "k = ATTN_ONLY ? 0 : c;", "k = ATTN_ONLY ? d : c;",
        "attn_ablate.attn_only"),
    "attn_only's out without x (ProbeRows)": (
        "attn_half.cu", "y[to] = from_f32<TX>(to_f32(x[to]) + o);",
        "y[to] = from_f32<TX>(o);", "attn_ablate.attn_only"),
}


@pytest.mark.parametrize("mutant", sorted(P_SOURCE_MUTANTS))
def test_probe_source_mutants_name_one_line_of_the_source(mutant):
    src, line, new, key = P_SOURCE_MUTANTS[mutant]
    assert (CSRC / src).read_text().count(line) == 1 and new != line
    assert key in chip_smoke.PROBES


@pytest.mark.cuda
@pytest.mark.parametrize("mutant", sorted(P_SOURCE_MUTANTS))
def test_a_mutated_probe_source_makes_chip_smoke_fail(mutant, tmp_path):
    """chip_smoke.py run from a copy whose probe policy or layout has one
    line mutated exits 1, failing the probe phase (the K1 and K4 phases
    before it pass: their instantiations do not reach the mutated lines)."""
    src, line, new, key = P_SOURCE_MUTANTS[mutant]
    res = _run_mutated_chip_smoke(CSRC / src, line, new, tmp_path)
    assert res.returncode == 1
    assert "probe kernels disagree with their plain versions" in res.stderr
    assert f" {key}" in res.stderr.splitlines()[-1]
