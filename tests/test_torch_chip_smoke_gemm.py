"""chip_smoke.py's GEMM phase (2a) at a tiny size on the CPU: the launches
that K1 / K2 calls make, their operands, the parity phase against the plain
versions (which must reject a launch missing a term), the GEMM path's
counts and the bounds (split from tests/test_torch_chip_smoke.py, whose
shared pieces it imports).

On the CPU ``gemm_launch`` / ``wgrad_launch`` run their plain versions, so
a "kernel" here is the plain version with one term removed or one index
broken (a mutant); the calls are a tiny Swin's training forward (stage 1
shifted, stage 2 padded, stage 3 clamped) at batch 2, in f32 and bf16.
"""

import collections

import pytest
import torch
import torch.nn.functional as F

import chip_smoke
from test_torch_chip_smoke import _record, one_thread
from vsn_tpu_torch.ops import swin_block_kernels as sbk


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def gemm_sets(request):
    calls = _record(request.param, train=True)
    return calls, chip_smoke.gemm_launch_set(calls), request.param


def test_block_gemm_launches_follow_the_calls(gemm_sets):
    """Seven launches per K1 and per K2 call, at the call's rows, width
    and hidden width; each set counts how many calls make a launch."""
    calls, launches, _ = gemm_sets
    blocks = [(n, a) for n, a in calls if n in chip_smoke.BLOCK_KERNELS]
    assert sum(launches.values()) == 7 * len(blocks)
    for name, args in blocks:
        got = chip_smoke.block_gemm_launches(name, args)
        assert len(got) == 7 and set(got) <= set(launches)
        x = args[0]
        c = x.shape[-1]
        rows = x.numel() // c
        nsamp = args[9 if name == "attn_half" else 7].shape[0]
        assert {launch.m for launch in got} == {rows}
        assert {launch.rows_per_sample for launch in got} == {rows // nsamp}
        kinds = collections.Counter(launch.kind for launch in got)
        assert kinds == {"gemm": 5, "wgrad": 2}
        if name == "attn_half":
            assert {(launch.k, launch.n) for launch in got} == {
                (c, 3 * c), (c, c), (3 * c, c)}
        else:
            hid = args[3].shape[0]
            assert {(launch.k, launch.n) for launch in got} == {
                (c, hid), (hid, c)}


def test_gemm_call_gives_each_row_operand_a_nonzero_tail(gemm_sets):
    _, launches, dtype = gemm_sets
    gen = torch.Generator().manual_seed(0)
    for launch in launches:
        args, kw = chip_smoke.gemm_call(launch, dtype, "cpu", gen)
        rows = [args[0], *(args[1:2] if launch.kind == "wgrad" else ()),
                *(kw[k] for k in ("resid", "out32") if k in kw)]
        for t in rows:
            assert t.shape[0] == launch.m and t.is_contiguous()
            tail = torch.as_strided(t, (chip_smoke.GEMM_TAIL, t.shape[1]),
                                    t.stride(), t.numel())
            assert bool((tail != 0).any())


def test_gemm_plain_versions_pass(gemm_sets):
    _, launches, dtype = gemm_sets
    worst = chip_smoke.gemm_parity_phase({"tiny": (list(launches), dtype)},
                                         "cpu")
    assert worst == {"gemm": 0.0, "wgrad": 0.0}


def _gemm(change):
    """A GEMM "kernel": the plain version with its keywords changed."""
    return lambda *a, **kw: sbk.gemm_reference(*a, **change(a, dict(kw)))


def _gelu_for_gelu_grad(a, w, epi, cdt, **kw):
    out, out32 = sbk.gemm_reference(a, w, epi, cdt, **kw)
    if epi == "gelu_grad":
        out32 = out.float()
    return out, out32


def _last_k_tile_dropped(a, w, epi, cdt, **kw):
    """The products of the last 32 depth steps (or the last half of a
    shorter depth) left out: the weight's rows for them zeroed."""
    k = a.shape[1]
    w = w.clone()
    if kw.get("w_kn"):
        w[k - min(32, k // 2):] = 0
    else:
        w[:, k - min(32, k // 2):] = 0
    return sbk.gemm_reference(a, w, epi, cdt, **kw)


GEMM_MUTANTS = {  # name -> (body, its mutant of the plain version)
    "LayerNorm dropped": ("gemm", _gemm(lambda a, kw: {**kw, "ln": None})),
    "LayerNorm scale dropped": ("gemm", _gemm(
        lambda a, kw: {**kw, "ln": kw.get("ln") and (
            torch.ones_like(kw["ln"][0]), kw["ln"][1])})),
    "prologue gain dropped": ("gemm", _gemm(
        lambda a, kw: {**kw, "a_gain": None, "ls": None, "gamma": None})),
    "residual gain of the first sample for all": ("gemm", _gemm(
        lambda a, kw: {**kw, "gains": kw.get("gains") if kw.get("gains") is
                       None else kw["gains"][:1].expand_as(kw["gains"])})),
    "bias dropped": ("gemm", _gemm(lambda a, kw: {**kw, "bias": None})),
    "GELU for GELU'": ("gemm", _gelu_for_gelu_grad),
    "last k-tile dropped": ("gemm", _last_k_tile_dropped),
    "weight gradient without its gain": (
        "wgrad", lambda a, b, cdt, **kw: sbk.wgrad_reference(a, b, cdt)),
    "weight gradient over half the rows": (
        "wgrad", lambda a, b, cdt, **kw: sbk.wgrad_reference(
            a[: a.shape[0] // 2], b[: a.shape[0] // 2], cdt, **kw)),
}


@pytest.mark.parametrize("mutant", sorted(GEMM_MUTANTS))
def test_a_gemm_launch_missing_a_term_fails(gemm_sets, mutant):
    _, launches, dtype = gemm_sets
    kind, kernel = GEMM_MUTANTS[mutant]
    table = chip_smoke.gemm_table()
    table[kind] = (kernel, table[kind][1])
    with pytest.raises(AssertionError, match="GEMM launches disagree"):
        chip_smoke.gemm_parity_phase({"tiny": (list(launches), dtype)},
                                     "cpu", table)


def test_gemm_path_counts_one_launch_per_call(gemm_sets, monkeypatch):
    """The GEMM path's plumbing: every launch once through its wrapper,
    the counters at 0 before; a wrapper counted by a stand-in (the CPU path
    counts nothing)."""
    from vsn_tpu_torch.ops import _build

    _, launches, _ = gemm_sets
    table = chip_smoke.gemm_table()

    def counted(kind):
        def fn(*a, **kw):
            _build.launches[kind] += 1
            return table[kind][1](*a, **kw)
        return fn

    monkeypatch.setattr(chip_smoke, "gemm_table", lambda: {
        k: (counted(k), v[1]) for k, v in table.items()})
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    _build.launches["gemm"] += 5   # cleared by the path
    counts = chip_smoke.gemm_path(list(launches), "cpu")
    kinds = collections.Counter(launch.kind for launch in launches)
    assert counts["gemm"] == kinds["gemm"]
    assert counts["wgrad"] == kinds["wgrad"]
    _build.launches.clear()


def test_gemm_bounds_follow_the_shapes():
    """Swin-T stage 1's qkv at micro-batch 8 (435,456 x 96 -> 288, bf16,
    LayerNorm prologue) is bound by its bytes: A read, the f32 weight,
    bias and LayerNorm vectors read, qkv written; ViT-S's fc1 at
    micro-batch 24 (19,464 x 384 -> 1536, GELU) by its operations."""
    qkv = chip_smoke.GemmLaunch("K1f qkv", "gemm", ("bias", None, False,
                                                    "ln"), 435456, 96, 288,
                                54432)
    flops, nbytes = chip_smoke.gemm_work(qkv)
    assert flops == 2 * 435456 * 96 * 288
    assert nbytes == (435456 * 96 * 2 + 4 * (288 * 96 + 288 + 2 * 96)
                      + 435456 * 288 * 2)
    ms, by = chip_smoke.work_bound_ms(flops, nbytes)
    assert by == "bytes" and ms == pytest.approx(nbytes / 3.35e12 * 1e3)
    fc1 = chip_smoke.GemmLaunch("K2f fc1", "gemm", ("gelu", None, False,
                                                    "ln"), 19464, 384, 1536,
                                811)
    assert chip_smoke.work_bound_ms(*chip_smoke.gemm_work(fc1))[1] == \
        "operations"
    dw1 = chip_smoke.GemmLaunch("K2b dW1", "wgrad", ("f32", False), 19464,
                                1536, 384, 811)
    assert chip_smoke.gemm_work(dw1) == (
        2 * 19464 * 1536 * 384, 19464 * 1536 * 4 + 19464 * 384 * 2
        + 4 * 1536 * 384)


def test_gemm_bound_of_a_call_set_sums_its_launches(gemm_sets):
    calls, launches, dtype = gemm_sets
    for kind in chip_smoke.GEMM_KERNELS:
        flops = nbytes = 0
        for launch, times in launches.items():
            if launch.kind == kind:
                f, b = chip_smoke.gemm_work(launch, dtype)
                flops, nbytes = flops + times * f, nbytes + times * b
        assert chip_smoke.bound_ms(kind, calls, dtype) == \
            chip_smoke.work_bound_ms(flops, nbytes, dtype)


def test_the_gelu_mutant_differs_from_gelu_grad():
    """The GELU' mutant is a real change (GELU and GELU' differ on the
    operands' range), so its rejection above is not vacuous."""
    v = torch.linspace(-3, 3, 101)
    assert (F.gelu(v) - sbk._gelu_grad(v)).abs().max() > 0.5
