"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device (marker ``cuda``) and skips without
one. Run them on the card, where JAX is not installed, without the
JAX-side conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py

Tolerances, as chip_smoke.py holds them: f32 kernels against f32 plain
versions with TF32 off differ only in the order of sums, 1e-4 of the
output scale; bf16 outputs may differ by one bf16 rounding step of the
output (2^-8 relative), 2e-2 of the scale; the movers are bit-exact. The
backward kernels (K1b, K2b, K4b) are held to the plain backward with the
same tolerances, each gradient relative to its own scale: their parameter
gradients (K4b's dbias) are sums over every row or window, reduced with
f32 atomics in an order that varies from run to run. The movers' adjoints
are bit-exact.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from vsn_tpu_torch.models.swin3d import (
    padded_window_region_ids,
    shifted_window_region_ids,
)
from vsn_tpu_torch.ops import _build
from vsn_tpu_torch.ops import attn_probe as ap
from vsn_tpu_torch.ops import swin_block_kernels as sbk
from vsn_tpu_torch.ops import window_attention as wa
from vsn_tpu_torch.ops import window_relayout as wr

pytestmark = pytest.mark.cuda
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _close(got, want, dtype):
    assert got.dtype == want.dtype == dtype and got.shape == want.shape
    err = (got.float() - want.float()).abs().max().item()
    assert err <= TOL[dtype] * max(1.0, want.float().abs().max().item()), err


def _attn_args(dev, dims, window, shift, heads, c, ids_kind, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    r = lambda *s, k=1.0: (torch.randn(*s, generator=g) * k).to(dev)
    if ids_kind == "padded":
        ids = padded_window_region_ids(dims, window, shift)
    elif ids_kind == "shifted":
        ids = shifted_window_region_ids(dims, window, shift)
    else:
        ids = None
    nw = 1
    for d, w in zip(dims, window):
        nw *= -(-d // w)
    n = window[0] * window[1] * window[2]
    ids = None if ids is None else torch.from_numpy(ids).to(dev)
    ws = c ** -0.5  # unit-variance projections: O(1) logits at every width
    return (r(2 * nw, n, c).to(dtype), 1 + r(c, k=0.1), r(c, k=0.1),
            r(3 * c, c, k=ws), r(3 * c, k=0.1), r(heads, n, n), ids,
            r(c, c, k=ws), r(c, k=0.1),
            torch.tensor([0.7, 1.3], device=dev),
            torch.tensor([0.4, 1.1], device=dev), (c // heads) ** -0.5, heads)


ATTN_SHAPES = [  # the four Swin-T stage kinds; head dims 8, 12 and 40
    ((12, 14, 12), (6, 7, 6), (3, 3, 3), 3, 96, "shifted"),
    ((12, 14, 12), (6, 7, 6), (0, 0, 0), 3, 96, None),
    ((9, 11, 9), (6, 7, 6), (3, 3, 3), 12, 384, "padded"),
    ((5, 6, 5), (5, 6, 5), (0, 0, 0), 24, 768, None),
    ((4, 6, 4), (2, 3, 2), (1, 1, 1), 2, 16, "shifted"),
    ((4, 6, 4), (2, 3, 2), (1, 1, 1), 3, 36, "shifted"),
    ((12, 14, 12), (6, 7, 6), (3, 3, 3), 3, 120, "shifted"),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dims,window,shift,heads,c,ids_kind", ATTN_SHAPES)
def test_attn_half_matches_plain(dev, dtype, dims, window, shift, heads, c,
                                 ids_kind):
    """One launch of the key-tiled body at every head dim: Swin-T's d = 32,
    d = 8, 12 (bf16 rows staged by plain loads) and 40."""
    args = _attn_args(dev, dims, window, shift, heads, c, ids_kind, dtype)
    name = "attn_half_tiled"
    before = _build.launches[name]
    got = sbk.attn_half(*args)
    torch.cuda.synchronize()
    assert _build.launches[name] == before + 1
    _close(got, sbk.attn_half_reference(*args), dtype)


def test_attn_half_saturated_logits_and_no_bias(dev):
    args = list(_attn_args(dev, (4, 4, 4), (2, 2, 2), (1, 1, 1), 2, 64,
                           "shifted", torch.float32))
    args[5] = args[5] * 8 + 200.0   # logits ~200: rowmax shift keeps exp exact
    got = sbk.attn_half(*args)
    assert torch.isfinite(got).all()
    _close(got, sbk.attn_half_reference(*args), torch.float32)
    args[5] = None
    _close(sbk.attn_half(*args), sbk.attn_half_reference(*args),
           torch.float32)


def _mlp_args(dev, rows, c, dtype, lam=0.9):
    g = torch.Generator().manual_seed(1)
    r = lambda *s, k=1.0: (torch.randn(*s, generator=g) * k).to(dev)
    hid = 4 * c
    return (r(rows, c).to(dtype), 1 + r(c, k=0.1), r(c, k=0.1),
            r(hid, c, k=c ** -0.5), r(hid, k=0.1), r(c, hid, k=hid ** -0.5),
            r(c, k=0.1), torch.tensor([0.7, 1.3], device=dev),
            torch.tensor([0.4, 1.1], device=dev), lam)


MLP_SHAPES = [(2 * 2016, 384), (2 * 150, 768), (2 * 37, 24)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,c", MLP_SHAPES)
def test_ln_mlp_matches_plain(dev, dtype, rows, c):
    g = torch.Generator().manual_seed(1)
    r = lambda *s, k=1.0: (torch.randn(*s, generator=g) * k).to(dev)
    hid = 4 * c
    args = _mlp_args(dev, rows, c, dtype)
    before = _build.launches["ln_mlp"]
    got = sbk.ln_mlp(*args)
    torch.cuda.synchronize()
    assert _build.launches["ln_mlp"] == before + 1
    _close(got, sbk.ln_mlp_reference(*args), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("c", [96, 3, 6])   # 16-, 1- and 4-byte chunks
def test_movers_are_bit_exact(dev, dtype, c):
    dims, window = (12, 14, 12), (6, 7, 6)
    x = torch.randn(2, *dims, c, device=dev).to(dtype)
    for roll in [(0, 0, 0), (3, 3, 3), (9, 11, 9), (7, 10, 1)]:
        wins = wr.spatial_to_windows(x, window, roll)
        assert torch.equal(wins, wr.spatial_to_windows_reference(x, window,
                                                                 roll))
        for fn, ref in ((wr.windows_to_windows,
                         wr.windows_to_windows_reference),
                        (wr.windows_to_spatial,
                         wr.windows_to_spatial_reference)):
            assert torch.equal(fn(wins, window, dims, roll),
                               ref(wins, window, dims, roll))


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    args = list(_attn_args(dev, (4, 6, 4), (2, 3, 2), (1, 1, 1), 2, 16,
                           "shifted", torch.float32))
    bad = list(args)
    bad[0] = args[0].half()
    with pytest.raises(TypeError):
        sbk.attn_half(*bad)
    bad = list(args)
    bad[3] = args[3].cpu()
    with pytest.raises(ValueError):
        sbk.attn_half(*bad)
    bad = list(args)
    bad[0] = args[0].transpose(0, 1).contiguous().transpose(0, 1)
    with pytest.raises(ValueError):
        sbk.attn_half(*bad)
    with pytest.raises(ValueError):
        wr.spatial_to_windows(torch.zeros(1, 5, 6, 5, 4, device=dev),
                              (2, 3, 2))
    assert np.isfinite(sbk.attn_half(*args).float().cpu().numpy()).all()


def _grads(fn, args, dout, diff):
    """Gradients of sum(fn(*args) * dout) w.r.t. the args at ``diff``."""
    args = list(args)
    for i in diff:
        args[i] = args[i].detach().clone().requires_grad_()
    out = fn(*args)
    assert out.grad_fn is not None
    return torch.autograd.grad(out, [args[i] for i in diff], dout)


def _close_grads(got, want, dtype):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        err = (g.float() - w.float()).abs().max().item()
        scale = w.float().abs().max().item()
        assert err <= TOL[dtype] * scale, (err, scale)


ATTN_DIFF = (0, 1, 2, 3, 4, 5, 7, 8)    # x, LN, qkv w/b, bias, proj w/b
MLP_DIFF = (0, 1, 2, 3, 4, 5, 6)


@pytest.mark.parametrize("lam", [0.0, 1.0])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dims,window,shift,heads,c,ids_kind", ATTN_SHAPES)
def test_attn_half_bwd_matches_plain(dev, dtype, dims, window, shift, heads,
                                     c, ids_kind, lam):
    args = _attn_args(dev, dims, window, shift, heads, c, ids_kind, dtype)
    args = (*args, lam)
    dout = torch.randn(args[0].shape, generator=torch.Generator().manual_seed(
        2)).to(dev, dtype)
    name = "attn_half_bwd_tiled"
    before = _build.launches[name]
    got = _grads(sbk.attn_half, args, dout, ATTN_DIFF)
    torch.cuda.synchronize()
    assert _build.launches[name] == before + 1
    _close_grads(got, _grads(sbk.attn_half_reference, args, dout, ATTN_DIFF),
                 dtype)


@pytest.mark.parametrize("logit", [45.0, 200.0])
def test_attn_half_bwd_at_saturated_logits(dev, logit):
    args = list(_attn_args(dev, (4, 4, 4), (2, 2, 2), (1, 1, 1), 2, 64,
                           "shifted", torch.float32))
    args[5] = args[5] * 8 + logit
    dout = torch.randn(args[0].shape, device=dev)
    got = _grads(sbk.attn_half, args, dout, ATTN_DIFF)
    assert all(torch.isfinite(g).all() for g in got)
    _close_grads(got, _grads(sbk.attn_half_reference, args, dout, ATTN_DIFF),
                 torch.float32)


def _vit_args(dev, b, n, heads, dtype, bias=None, seed=0):
    """A K1 call as ViT makes it: [B, N, 64 * heads] x, no qkv bias, no
    region mask, ``bias`` as given (None for ViT), distinct per-sample
    gains gf != gb, unit-variance projections."""
    c = 64 * heads
    g = torch.Generator().manual_seed(seed)
    r = lambda *s, k=1.0: (torch.randn(*s, generator=g) * k).to(dev)
    return (r(b, n, c).to(dtype), 1 + r(c, k=0.1), r(c, k=0.1),
            r(3 * c, c, k=c ** -0.5), None, bias, None,
            r(c, c, k=c ** -0.5), r(c, k=0.1),
            torch.linspace(0.6, 1.4, b, device=dev),
            torch.linspace(1.25, 0.35, b, device=dev), 64 ** -0.5, heads)


def _tiled_case(fn, args, lam, dout, diff):
    """(output, gradients) of one K1 call with lam."""
    return fn(*args, lam=lam), _grads(lambda *a: fn(*a, lam=lam), args, dout,
                                      diff)


# (B, N, heads): ViT-S's call at two samples; N below one tile, one tile and
# a ragged one past it, a head count of 4
TILED_SHAPES = [(2, 811, 6), (2, 13, 2), (3, 37, 2), (2, 64, 2), (2, 65, 4)]
VIT_DIFF = (0, 1, 2, 3, 7, 8)           # x, LN, qkv w, proj w/b


@pytest.mark.parametrize("lam", [0.0, 1.0])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n,heads", TILED_SHAPES)
def test_attn_half_tiled_matches_plain(dev, dtype, b, n, heads, lam):
    """d = 64: the key-tiled K1f and K1b (phases A and B), one launch of
    each per call."""
    args = _vit_args(dev, b, n, heads, dtype)
    dout = torch.randn(args[0].shape, generator=torch.Generator().manual_seed(
        2)).to(dev, dtype)
    before = dict(_build.launches)
    out, got = _tiled_case(sbk.attn_half, args, lam, dout, VIT_DIFF)
    torch.cuda.synchronize()
    for name, k in (("attn_half_tiled", 2), ("attn_half_bwd_tiled", 1)):
        assert _build.launches[name] == before.get(name, 0) + k, name
    want_out, want = _tiled_case(sbk.attn_half_reference, args, lam, dout,
                                 VIT_DIFF)
    _close(out, want_out, dtype)
    _close_grads(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dims,window,shift,heads,c,ids_kind", ATTN_SHAPES)
def test_attn_half_forced_tiled_on_swin_calls(dev, dtype, dims, window,
                                              shift, heads, c, ids_kind):
    """Swin's calls (relative-position bias, shifted and padded region ids,
    qkv bias) take the key-tiled body through K1's entry point, forward and
    backward, at every head dim: Swin-T's 32 and 8, 12 and 40."""
    args = _attn_args(dev, dims, window, shift, heads, c, ids_kind, dtype)
    dout = torch.randn(args[0].shape, generator=torch.Generator().manual_seed(
        2)).to(dev, dtype)
    before = dict(_build.launches)
    out, got = _tiled_case(sbk.attn_half, args, 1.0, dout, ATTN_DIFF)
    torch.cuda.synchronize()
    for name, k in (("attn_half_tiled", 2), ("attn_half_bwd_tiled", 1)):
        assert _build.launches[name] == before.get(name, 0) + k, name
    want_out, want = _tiled_case(sbk.attn_half_reference, args, 1.0, dout,
                                 ATTN_DIFF)
    _close(out, want_out, dtype)
    _close_grads(got, want, dtype)


# (BW, N, heads, head dim, bias, ids): ViT's call; a ragged tile, bias and
# ids at Swin's head dim; other head dims (48, 24, 40, 100: channels past d
# staged as zeros; 128; 12 and 25: bf16 rows staged by plain loads); above
# 128 the slab kernels (136, 192, 256, 384, 768, 2048: 2 to 16 slabs of 128,
# the last one part zeros at 136; 129: plain loads, a slab of 1 channel)
LAUNCH_SHAPES = [(2, 811, 6, 64, False, False), (4, 252, 3, 32, True, True),
                 (4, 37, 3, 32, True, True), (2, 150, 2, 128, True, False),
                 (2, 100, 2, 48, False, False), (2, 100, 2, 16, False, True),
                 (4, 252, 3, 24, True, True), (2, 100, 3, 12, True, True),
                 (2, 70, 3, 40, True, False), (2, 65, 2, 25, False, True),
                 (1, 130, 1, 100, True, False),
                 (2, 100, 2, 129, False, True), (2, 65, 2, 136, True, True),
                 (2, 150, 2, 192, True, True), (2, 70, 1, 256, True, False),
                 (2, 150, 1, 384, True, True), (1, 130, 1, 768, True, False),
                 (2, 37, 1, 2048, True, True)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bw,n,heads,hd,bias,ids", LAUNCH_SHAPES)
def test_tiled_launches_match_plain(dev, dtype, bw, n, heads, hd, bias, ids):
    """K1's tiled attention launches alone against their plain versions
    (chip_smoke.tiled_launch_compare): ao, o, the row statistics, dq, dk,
    dv, dbqkv and dbias; one count of each launch."""
    g = torch.Generator().manual_seed(n)
    c = heads * hd
    x = torch.randn(bw, n, c, generator=g).to(dev, dtype)
    args = [x, None, None, None, None,
            torch.randn(heads, n, n, generator=g).to(dev) if bias else None,
            torch.randint(0, 3, (2, n), generator=g, dtype=torch.int32).to(
                dev) if ids else None,
            None, None, None, None, hd ** -0.5, heads]
    qkv = torch.randn(bw, n, 3 * c, generator=g).to(dev, dtype)
    dao = torch.randn(bw, n, c, generator=g).to(dev, dtype)
    before = dict(_build.launches)
    rows = chip_smoke.tiled_launch_compare(args, qkv, dao)
    torch.cuda.synchronize()
    assert all(ok for *_, ok in rows), rows
    assert {r[0] for r in rows} >= {"ao", "o", "max", "1/sum", "dq", "dk",
                                    "dv", "dbqkv"} | (
        {"dbias"} if bias else set())
    for name in ("attention_tiled_launch", "attention_tiled_bwd_launch"):
        assert _build.launches[name] == before.get(name, 0) + 1, name


def test_tiled_launch_rejects_head_dims_off_the_mma_depth(dev):
    """Head dims off the mma depth of 16 launch (d = 24: channels past d
    staged as zeros; d = 8192, the widest: 64 slabs); above 8192 the
    wrapper rejects."""
    for d in (24, 8192):
        qkv = torch.zeros(2, 16, 3 * d, device=dev)
        ao, stats, _ = sbk.attention_tiled_launch(qkv, None, None, 0.2, 1)
        torch.cuda.synchronize()
        assert ao.shape == (2, 16, d) and torch.isfinite(stats).all()
    qkv = torch.zeros(2, 16, 3 * 8193, device=dev)
    with pytest.raises(ValueError, match="head dims up to 8192"):
        sbk.attention_tiled_launch(qkv, None, None, 0.2, 1)


@pytest.mark.parametrize("logit", [45.0, 200.0, -200.0])
def test_attn_half_tiled_top_logit_in_the_ragged_tile(dev, logit):
    """Logits near ``logit`` (bias 8 z + logit) with the top ones in the
    last, ragged key tile (keys 768-810, 12 above the rest), so each row's
    running max grows at the last tile; at -200 every exp underflows under
    the max(rowmax, 0) shift and the attention output is 0."""
    g = torch.Generator().manual_seed(4)
    bias = torch.randn(2, 811, 811, generator=g) * 8 + logit
    bias[:, :, 768:] += 12.0
    args = _vit_args(dev, 2, 811, 2, torch.float32, bias=bias.to(dev))
    dout = torch.randn(args[0].shape, generator=g).to(dev)
    diff = VIT_DIFF + (5,)
    out, got = _tiled_case(sbk.attn_half, args, 1.0, dout, diff)
    assert torch.isfinite(out).all()
    assert all(torch.isfinite(t).all() for t in got)
    want_out, want = _tiled_case(sbk.attn_half_reference, args, 1.0, dout,
                                 diff)
    _close(out, want_out, torch.float32)
    _close_grads(got, want, torch.float32)


@pytest.mark.parametrize("lam", [0.0, 1.0])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,c", MLP_SHAPES)
def test_ln_mlp_bwd_matches_plain(dev, dtype, rows, c, lam):
    args = _mlp_args(dev, rows, c, dtype, lam)
    dout = torch.randn(args[0].shape, generator=torch.Generator().manual_seed(
        3)).to(dev, dtype)
    before = _build.launches["ln_mlp_bwd"]
    got = _grads(sbk.ln_mlp, args, dout, MLP_DIFF)
    torch.cuda.synchronize()
    assert _build.launches["ln_mlp_bwd"] == before + 1
    _close_grads(got, _grads(sbk.ln_mlp_reference, args, dout, MLP_DIFF),
                 dtype)


MOVER_GEOMETRY = [  # Swin-T stage 1 and 2 grids, unshifted and shifted
    ((36, 42, 36), (0, 0, 0)), ((36, 42, 36), (3, 3, 3)),
    ((18, 21, 18), (0, 0, 0)), ((18, 21, 18), (33, 39, 33)),
]


@pytest.mark.parametrize("dims,roll", MOVER_GEOMETRY)
def test_mover_adjoints_are_bit_exact(dev, dims, roll):
    """A training forward through a mover keeps its graph (grad_fn), and
    the adjoint kernel equals autograd through the plain form bit for
    bit."""
    window = (6, 7, 6)
    x = torch.randn(2, *dims, 8, device=dev).bfloat16()
    wins = wr.spatial_to_windows_reference(x, window)
    cases = (("spatial_to_windows", x, (window, roll)),
             ("windows_to_windows", wins, (window, dims, roll)),
             ("windows_to_spatial", wins, (window, dims, roll)))
    for name, src, rest in cases:
        fn, ref = getattr(wr, name), getattr(wr, name + "_reference")
        before = _build.launches[name + "_adjoint"]
        a = src.detach().clone().requires_grad_()
        out = fn(a, *rest)
        assert out.grad_fn is not None, name
        g = torch.randn(out.shape, device=dev).bfloat16()
        (got,) = torch.autograd.grad(out, a, g)
        assert _build.launches[name + "_adjoint"] == before + 1
        b = src.detach().clone().requires_grad_()
        (want,) = torch.autograd.grad(ref(b, *rest), b, g)
        assert torch.equal(got, want), name


STEM_GEOMETRY = [  # (shape DHW, kernel, strides, C_out), as chip_smoke.py
    ((12, 14, 12), (7, 7, 7), (1, 2, 2), 16),
    ((12, 14, 12), (3, 3, 3), (2, 2, 2), 16),
    ((8, 10, 8), (3, 3, 3), (1, 1, 1), 16),
    ((9, 11, 13), (3, 5, 3), (2, 2, 1), 16),
    ((16, 18, 16), (7, 7, 7), (1, 2, 2), 64),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,ks,strides,c_out", STEM_GEOMETRY)
def test_stem_kernels_match_plain(dev, shape, ks, strides, c_out, dtype):
    """K5f and K5w against their plain versions (TF32 off for the f32 plain
    conv); dW is a sum over every token: in bf16 the tensor-core bodies'
    block partials added in order, in f32 the FMA body's f32 atomics."""
    from vsn_tpu_torch.ops import stem_im2col as stem

    torch.backends.cudnn.allow_tf32 = False
    pad = tuple(k // 2 for k in ks)
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, *shape, 1, generator=g).to(dev, dtype)
    kernel = (torch.randn(*ks, 1, c_out, generator=g) * 0.1).to(dev)
    y = stem.stem_conv_im2col(x, kernel, strides, pad, dtype)
    _close(y, stem.stem_conv_reference(x, kernel, strides, pad, dtype), dtype)
    gy = torch.randn(y.shape, generator=g).to(dev, dtype)
    dw = stem.stem_conv_dw(x, gy, ks, strides, pad, dtype)
    want = stem.stem_dw_reference(x, gy, ks, strides, pad, dtype)
    assert dw.dtype == want.dtype == torch.float32
    err = (dw - want).abs().max().item()
    assert err <= TOL[dtype] * want.abs().max().item(), err


@pytest.mark.parametrize("shape,ks,strides,c_out", STEM_GEOMETRY)
def test_stem_dw_is_bit_identical_across_launches(dev, shape, ks, strides,
                                                  c_out):
    """K5w's tensor-core body (bf16) gives the same dW bits on every launch:
    each block sums a fixed run of rows and the partials are added in
    order, as the TPU kernel's one revisited output block."""
    from vsn_tpu_torch.ops import stem_im2col as stem

    pad = tuple(k // 2 for k in ks)
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, *shape, 1, generator=g).to(dev, torch.bfloat16)
    outs = stem.output_shape(shape, ks, strides, pad)
    gy = torch.randn(2, *outs, c_out, generator=g).to(dev, torch.bfloat16)
    first = stem.stem_conv_dw(x, gy, ks, strides, pad, torch.bfloat16)
    for _ in range(3):
        assert torch.equal(stem.stem_conv_dw(x, gy, ks, strides, pad,
                                             torch.bfloat16), first)


def test_stem_fma_route_matches_plain(dev):
    """The FMA bodies on bf16 operands (``_fma=True``, chip_smoke.py's
    yardstick) against the plain versions, counted apart."""
    from vsn_tpu_torch.ops import stem_im2col as stem

    shape, ks, strides, c_out = STEM_GEOMETRY[-1]
    pad = tuple(k // 2 for k in ks)
    g = torch.Generator().manual_seed(2)
    x = torch.randn(2, *shape, 1, generator=g).to(dev, torch.bfloat16)
    kernel = (torch.randn(*ks, 1, c_out, generator=g) * 0.1).to(dev)
    before = dict(_build.launches)
    y = stem.stem_conv_im2col(x, kernel, strides, pad, torch.bfloat16,
                              _fma=True)
    _close(y, stem.stem_conv_reference(x, kernel, strides, pad,
                                       torch.bfloat16), torch.bfloat16)
    gy = torch.randn(y.shape, generator=g).to(dev, torch.bfloat16)
    dw = stem.stem_conv_dw(x, gy, ks, strides, pad, torch.bfloat16, _fma=True)
    want = stem.stem_dw_reference(x, gy, ks, strides, pad, torch.bfloat16)
    assert (dw - want).abs().max() <= 2e-2 * want.abs().max()
    torch.cuda.synchronize()
    for name in ("stem_im2col_fma", "stem_im2col_dw_fma"):
        assert _build.launches[name] == before.get(name, 0) + 1, name
    for name in ("stem_im2col", "stem_im2col_dw"):
        assert _build.launches[name] == before.get(name, 0), name


def test_stem_autograd_launches_k5f_and_k5w(dev):
    """On the card the stem's forward is K5f and its weight gradient K5w,
    one launch each; dx is taken only when x asks for it."""
    from vsn_tpu_torch.ops import stem_im2col as stem

    x = torch.randn(2, 16, 18, 16, 1, device=dev).bfloat16()
    kernel = (torch.randn(7, 7, 7, 1, 64, device=dev) * 0.05).requires_grad_()
    before = dict(_build.launches)
    y = stem.stem_conv_im2col(x, kernel, (1, 2, 2), (3, 3, 3))
    y.float().square().sum().backward()
    torch.cuda.synchronize()
    for name in ("stem_im2col", "stem_im2col_dw"):
        assert _build.launches[name] == before.get(name, 0) + 1, name
    assert kernel.grad is not None and x.grad is None
    xg = x.detach().float().requires_grad_()
    stem.stem_conv_im2col(xg, kernel.detach(), (1, 2, 2), (3, 3, 3),
                          torch.bfloat16).float().sum().backward()
    assert xg.grad is not None and xg.grad.shape == xg.shape


def _k4_args(dev, dims, window, shift, heads, c, ids_kind, dtype, seed=0):
    """(qkv, bias, ids, scale, heads) of one K4 call at B = 2: unit-normal
    qkv (O(1) logits at a head dim of 32), an O(1) bias, and the stage's
    region ids (one row of zeros when unshifted and unpadded)."""
    g = torch.Generator().manual_seed(seed)
    args = _attn_args(dev, dims, window, shift, heads, c, ids_kind, dtype,
                      seed)
    n = args[0].shape[1]
    ids = args[6]
    if ids is None:
        ids = torch.zeros((1, n), dtype=torch.int32, device=dev)
    qkv = torch.randn(args[0].shape[0], n, 3 * c, generator=g).to(dev, dtype)
    return qkv, args[5], ids, (c // heads) ** -0.5, heads


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dims,window,shift,heads,c,ids_kind", ATTN_SHAPES)
def test_window_attention_qkv_matches_plain(dev, dtype, dims, window, shift,
                                            heads, c, ids_kind):
    """K4f against the plain forward, and K4b's dqkv and dbias against the
    plain backward, at the Swin-T stage kinds (shifted, unshifted, padded
    with -1 pad ids, clamped N = 150) and a head dim of 8."""
    args = _k4_args(dev, dims, window, shift, heads, c, ids_kind, dtype)
    before = dict(_build.launches)
    _close(wa.window_attention_qkv(*args),
           wa.window_attention_qkv_reference(*args), dtype)
    dout = torch.randn(args[0].shape[:2] + (c,),
                       generator=torch.Generator().manual_seed(4)).to(dev, dtype)
    got = _grads(wa.window_attention_qkv, args, dout, (0, 1))
    torch.cuda.synchronize()
    for name in ("attention", "attention_bwd"):
        want = before.get(name, 0) + (2 if name == "attention" else 1)
        assert _build.launches[name] == want, name
    _close_grads(got, _grads(wa.window_attention_qkv_reference, args, dout,
                             (0, 1)), dtype)


@pytest.mark.parametrize("logit", [45.0, 200.0, -200.0])
def test_window_attention_qkv_at_saturated_logits(dev, logit):
    args = list(_k4_args(dev, (12, 14, 12), (6, 7, 6), (3, 3, 3), 3, 96,
                         "shifted", torch.float32))
    args[1] = args[1] * 8 + logit
    _close(wa.window_attention_qkv(*args),
           wa.window_attention_qkv_reference(*args), torch.float32)
    dout = torch.randn(args[0].shape[:2] + (96,), device=dev)
    got = _grads(wa.window_attention_qkv, args, dout, (0, 1))
    assert all(torch.isfinite(g).all() for g in got)
    _close_grads(got, _grads(wa.window_attention_qkv_reference, args, dout,
                             (0, 1)), torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads,d", [(2, 4), (2, 12), (3, 32), (2, 64),
                                     (1, 128), (3, 40), (2, 24), (1, 100),
                                     (2, 129), (2, 136), (2, 192), (1, 256),
                                     (1, 384), (1, 768)])
def test_window_attention_qkv_head_dims(dev, dtype, heads, d):
    """K4 at head dims 4 and 12 (rows of bf16 channels that are not whole
    16-byte chunks: staged by plain loads; 12 also in f32), 32, 64 and 128
    (the tiled body's D = 64 and 128), 24, 40 and 100 (off the mma depth:
    channels past d staged as zeros), 129 to 768 (the slab kernels) on a
    shifted stage-1-like call with the ragged key tile (N = 70 = 64 + 6):
    K4f, K4b's dqkv and dbias, and the kept state against the plain
    versions."""
    from vsn_tpu_torch.models.swin3d import shifted_window_region_ids

    g = torch.Generator().manual_seed(d)
    ids = torch.from_numpy(shifted_window_region_ids(
        (4, 10, 14), (2, 5, 7), (1, 2, 3))).to(dev)
    n, c = 70, heads * d
    args = (torch.randn(2 * ids.shape[0], n, 3 * c, generator=g).to(
        dev, dtype), torch.randn(heads, n, n, generator=g).to(dev), ids,
        d ** -0.5, heads)
    _close(wa.window_attention_qkv(*args),
           wa.window_attention_qkv_reference(*args), dtype)
    dout = torch.randn(args[0].shape[:2] + (c,), generator=g).to(dev, dtype)
    _close_grads(_grads(wa.window_attention_qkv, args, dout, (0, 1)),
                 _grads(wa.window_attention_qkv_reference, args, dout,
                        (0, 1)), dtype)
    rows = chip_smoke.launch_compare("attention", args, dout)
    assert all(ok for *_, ok in rows), rows


def test_window_attention_qkv_rejects_what_the_kernels_do_not_take(dev):
    args = list(_k4_args(dev, (4, 6, 4), (2, 3, 2), (1, 1, 1), 2, 16,
                         "shifted", torch.float32))
    for i, bad in ((0, args[0].half()), (1, args[1].cpu()),
                   (2, args[2][:3].contiguous()), (2, args[2].long())):
        new = list(args)
        new[i] = bad
        with pytest.raises((TypeError, ValueError)):
            wa.window_attention_qkv(*new)
    qkv = torch.zeros(args[0].shape[:2] + (3 * 2 * 129,), device=dev)
    with pytest.raises(ValueError, match="head dims"):   # d = 129
        wa.window_attention_qkv(qkv, args[1], args[2], 129 ** -0.5, 2)
    with pytest.raises(ValueError, match="kept o"):
        wa.window_attention_qkv_backward(*args[:3], qkv[..., :16],
                                         *args[3:])


def _v1_args(dev, dims, window, shift, heads, c, ids_kind, dtype):
    """A K4 call's values as V1's (q, k, v [BW, H, N, d], bias, ids,
    scale)."""
    qkv, bias, ids, scale, _ = _k4_args(dev, dims, window, shift, heads, c,
                                        ids_kind, dtype)
    bw, n, _ = qkv.shape
    q, k, v = (t.contiguous() for t in qkv.reshape(
        bw, n, 3, heads, c // heads).permute(2, 0, 3, 1, 4))
    return q, k, v, bias, ids, scale


def _v3_args(dev, dims, window, shift, heads, c, ids_kind, dtype):
    """A K4 call's values as V3's (qkv [2, D, H, W, 3C] on the padded grid,
    bias, ids, scale, heads, window)."""
    from vsn_tpu_torch.models.swin3d import window_reverse

    qkv, bias, ids, scale, _ = _k4_args(dev, dims, window, shift, heads, c,
                                        ids_kind, dtype)
    grid = tuple(-(-d // w) * w for d, w in zip(dims, window))
    return (window_reverse(qkv, window, grid).contiguous(), bias, ids, scale,
            heads, window)


def _v_check(fn, ref, args, diff, dout, dtype, names):
    """One forward and one backward of ``fn`` (one launch each of
    ``names``) against ``ref``'s."""
    before = dict(_build.launches)
    _close(fn(*args), ref(*args), dtype)
    got = _grads(fn, args, dout, diff)
    torch.cuda.synchronize()
    for name, extra in zip(names, (2, 1)):
        assert _build.launches[name] == before.get(name, 0) + extra, name
    _close_grads(got, _grads(ref, args, dout, diff), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dims,window,shift,heads,c,ids_kind", ATTN_SHAPES)
def test_window_attention_split_matches_plain(dev, dtype, dims, window, shift,
                                              heads, c, ids_kind):
    """V1f against the plain forward and V1b's dq, dk, dv, dbias against the
    plain backward at the Swin-T stage kinds and a head dim of 8."""
    args = _v1_args(dev, dims, window, shift, heads, c, ids_kind, dtype)
    dout = torch.randn(args[0].shape, generator=torch.Generator().manual_seed(
        5)).to(dev, dtype)
    _v_check(wa.window_attention, wa.window_attention_split_reference, args,
             (0, 1, 2, 3), dout, dtype,
             ("attention_split", "attention_split_bwd"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_window_attention_split_at_n_256(dev, dtype):
    """V1 at Swin-T stage 1 with N padded to 256 (zero rows, pad ids -1):
    the backward's 172 KB of shared memory."""
    import chip_smoke

    args = chip_smoke.padded_split_call(_v1_args(
        dev, (12, 14, 12), (6, 7, 6), (3, 3, 3), 3, 96, "shifted", dtype))
    assert args[0].shape[2] == 256 and (args[4][:, 252:] == -1).all()
    dout = torch.randn(args[0].shape, generator=torch.Generator().manual_seed(
        6)).to(dev, dtype)
    _v_check(wa.window_attention, wa.window_attention_split_reference, args,
             (0, 1, 2, 3), dout, dtype,
             ("attention_split", "attention_split_bwd"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dims,window,shift,heads,c,ids_kind", ATTN_SHAPES)
def test_window_attention_windows_matches_plain(dev, dtype, dims, window,
                                                shift, heads, c, ids_kind):
    """V3f against the plain forward and V3b's dqkv and dbias against the
    plain backward on the stage kinds' padded maps."""
    args = _v3_args(dev, dims, window, shift, heads, c, ids_kind, dtype)
    x = args[0]
    dout = torch.randn((*x.shape[:4], c), generator=torch.Generator()
                       .manual_seed(7)).to(dev, dtype)
    _v_check(wa.window_attention_windows,
             wa.window_attention_windows_reference, args, (0, 1), dout, dtype,
             ("attention_windows", "attention_windows_bwd"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_window_attention_windows_ids_row_within_the_sample(dev, dtype):
    """3 id rows over 8 windows per sample at B = 2: window r of each sample
    on row r % 3, not the global bw % 3."""
    import chip_smoke

    args = chip_smoke.synthetic_windows_call(
        dtype, dev, torch.Generator().manual_seed(8))
    x = args[0]
    dout = torch.randn((*x.shape[:4], x.shape[4] // 3), generator=torch
                       .Generator().manual_seed(9)).to(dev, dtype)
    _v_check(wa.window_attention_windows,
             wa.window_attention_windows_reference, args, (0, 1), dout, dtype,
             ("attention_windows", "attention_windows_bwd"))


@pytest.mark.parametrize("logit", [45.0, 200.0])
def test_v1_and_v3_at_saturated_logits(dev, logit):
    shape = ((12, 14, 12), (6, 7, 6), (3, 3, 3), 3, 96, "shifted",
             torch.float32)
    for fn, ref, args, bias_at, diff in (
            (wa.window_attention, wa.window_attention_split_reference,
             list(_v1_args(dev, *shape)), 3, (0, 1, 2, 3)),
            (wa.window_attention_windows,
             wa.window_attention_windows_reference,
             list(_v3_args(dev, *shape)), 1, (0, 1))):
        args[bias_at] = args[bias_at] * 8 + logit
        out = ref(*args)
        _close(fn(*args), out, torch.float32)
        dout = torch.randn(out.shape, device=dev)
        got = _grads(fn, args, dout, diff)
        assert all(torch.isfinite(g).all() for g in got)
        _close_grads(got, _grads(ref, args, dout, diff), torch.float32)


def test_v1_equals_v3_and_both_agree_with_k4(dev):
    """V1, V3 and K4 run one tiled body on three layouts: on the same
    values, V1f (heads merged) and V3f (windows partitioned) give K4f's
    out, row statistics and o bit for bit, in bf16 and f32 (chip_smoke's
    ``k4_agreement``, which also holds V1b's and V3b's dbias to K4b's)."""
    for dtype in (torch.float32, torch.bfloat16):
        shape = ((12, 14, 12), (6, 7, 6), (3, 3, 3), 3, 96, "shifted", dtype)
        k4 = _k4_args(dev, *shape)
        triple = (k4, chip_smoke.split_call(k4), _v3_args(dev, *shape))
        diff = chip_smoke.k4_agreement([triple], torch.Generator()
                                       .manual_seed(3))
        assert diff["V1f"] == diff["V3f"] == 0.0, diff


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads,d", [(2, 4), (2, 12), (3, 32), (2, 64),
                                     (1, 128), (3, 40), (2, 129), (2, 136),
                                     (2, 192), (1, 256), (1, 384), (1, 768)])
def test_v1_and_v3_head_dims(dev, dtype, heads, d):
    """V1 and V3 at head dims 4 and 12 (staged by plain loads), 32, 64,
    128 and 40, and above 128 on the slab kernels (counted as ``_slabs``),
    on a shifted call with the ragged key tile (N = 70 = 64 + 6): the
    wrappers forward and backward, and the launches with their kept state,
    against the plain versions; V1f and V3f bit-equal to K4f."""
    from vsn_tpu_torch.models.swin3d import window_reverse

    g = torch.Generator().manual_seed(d)
    dims, window = (4, 10, 14), (2, 5, 7)
    ids = torch.from_numpy(shifted_window_region_ids(dims, window,
                                                     (1, 2, 3))).to(dev)
    n, c = 70, heads * d
    k4 = (torch.randn(2 * ids.shape[0], n, 3 * c, generator=g).to(
        dev, dtype), torch.randn(heads, n, n, generator=g).to(dev), ids,
        d ** -0.5, heads)
    v1 = chip_smoke.split_call(k4)
    v3 = (window_reverse(k4[0], window, dims).contiguous(), *k4[1:], window)
    for name, args, fn, ref, diff in (
            ("attention_split", v1, wa.window_attention,
             wa.window_attention_split_reference, (0, 1, 2, 3)),
            ("attention_windows", v3, wa.window_attention_windows,
             wa.window_attention_windows_reference, (0, 1))):
        dout = chip_smoke.cotangent(name, args, g)
        _v_check(fn, ref, args, diff, dout, dtype,
                 (wa.body_key(name, d), wa.body_key(name + "_bwd", d)))
        rows = chip_smoke.launch_compare(name, args, dout)
        assert all(ok for *_, ok in rows), rows
    diff = chip_smoke.k4_agreement([(k4, v1, v3)], g)
    assert diff["V1f"] == diff["V3f"] == 0.0, diff


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_v3_launches_at_the_3_over_8_call(dev, dtype):
    """V3f's launch with its kept state and V3b from it against their
    plain versions at 3 id rows over 8 windows per sample (window r of a
    sample on row r % 3)."""
    args = chip_smoke.synthetic_windows_call(
        dtype, dev, torch.Generator().manual_seed(10))
    dout = chip_smoke.cotangent("attention_windows", args,
                                torch.Generator().manual_seed(11))
    rows = chip_smoke.launch_compare("attention_windows", args, dout)
    assert all(ok for *_, ok in rows), rows


def test_v1_and_v3_reject_what_the_kernels_do_not_take(dev):
    q, k, v, bias, ids, scale = _v1_args(dev, (4, 6, 4), (2, 3, 2),
                                         (1, 1, 1), 2, 16, "shifted",
                                         torch.float32)
    for i, bad in ((0, q.half()), (1, k.cpu()), (3, bias[:1].contiguous()),
                   (4, ids[:3].contiguous())):
        new = [q, k, v, bias, ids, scale]
        new[i] = bad
        with pytest.raises((TypeError, ValueError)):
            wa.window_attention(*new)
    qkv, bias, ids, scale, heads, window = _v3_args(
        dev, (4, 6, 4), (2, 3, 2), (1, 1, 1), 2, 16, "shifted", torch.float32)
    for i, bad in ((0, qkv[:, :3].contiguous()), (0, qkv.half()),
                   (2, ids.long()), (5, (2, 2, 2))):
        new = [qkv, bias, ids, scale, heads, window]
        new[i] = bad
        with pytest.raises((TypeError, ValueError)):
            wa.window_attention_windows(*new)
    z = torch.zeros(2, 2, 12, 129, device=dev)   # head dim 129
    with pytest.raises(ValueError, match="head dim"):
        wa.window_attention(z, z, z, bias, ids, scale)
    with pytest.raises(ValueError, match="kept o"):
        wa.window_attention_backward(q, k, v, bias, ids, q, scale)
    with pytest.raises(ValueError, match="kept o"):
        wa.window_attention_windows_backward(
            qkv, bias, ids, qkv[..., :qkv.shape[-1] // 3].contiguous(), scale,
            heads, window)


# ---------------------------------------------------------------------------
# The attention probes P1-P5 (ops/attn_probe.py) against their plain versions
# ---------------------------------------------------------------------------

PROBE_CASES = ([(key, "script") for key in chip_smoke.PROBES]
               + [(key, "sensitive") for key in chip_smoke.PROBES
                  if not key.startswith("copy_windows")])


@pytest.fixture(scope="module")
def probe_sets():
    """16 windows of the scripts' inputs and of chip_smoke.py's f32
    sensitive ones, on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from vsn_tpu_torch.probes import script_inputs

    dev = torch.device("cuda", 0)
    xw, *w = script_inputs(dev, micro=1)
    gen = torch.Generator(dev).manual_seed(13)
    return {"script": (xw[:16].contiguous(), *w),
            "sensitive": chip_smoke.probe_inputs((16, 252, 96), dev, gen)}


@pytest.mark.parametrize("key,which", PROBE_CASES)
def test_probe_matches_plain(dev, probe_sets, key, which):
    """Every probe run at the scripts' inputs (copies bit-exact, bf16 out to
    2e-2) and every P1 / P5 run with f32 x at the sensitive inputs (the
    branch's max and RMS, chip_smoke.probe_compare); one call adds the
    run's launches per call to its counter."""
    run = {r.key: r for r in chip_smoke.probe_runs()}[key]
    xs, *w = probe_sets[which]
    x = xs if which == "sensitive" else run.x(xs)
    counter = ap.launch_key(run.kind, run.variant, run.wb,
                            x.dtype == torch.float32)
    before = _build.launches[counter]
    got = run.kernel(x, *w)
    torch.cuda.synchronize()
    assert _build.launches[counter] == before + run.launches
    err, ratios, ok = chip_smoke.probe_compare(key, x, got, run.plain(x, *w))
    assert ok, (err, ratios)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("variant", ap.ABLATIONS)
def test_probe_at_another_geometry(dev, variant, dtype):
    """N = 12, C = 16, 2 heads (head dim 8), 4 windows: P1 and P5 at wb 2
    beside it."""
    g = torch.Generator().manual_seed(2)
    z = lambda *s: torch.randn(*s, generator=g).to(dev)
    x = (3 * z(4, 12, 16) + 1 + 2 * z(4, 12, 1)).to(dtype)
    w = (z(16, 48) * 0.25, z(2, 12, 12), z(16, 16) * 0.25)
    err, ratios, ok = chip_smoke.probe_compare(
        f"attn_ablate.{variant}", x, ap.attn_ablate(variant, x, *w),
        ap.attn_ablate_reference(variant, x, *w))
    assert ok, (err, ratios)
    if variant in ap.SLOT_VARIANTS.values():
        slot = {v: k for k, v in ap.SLOT_VARIANTS.items()}[variant]
        got = ap.attn_slot(2, slot, x, *w)
        assert torch.equal(got, ap.attn_ablate(variant, x, *w))


def test_probe_wrappers_reject_what_the_kernels_do_not_take(dev):
    x = torch.zeros(4, 12, 16, device=dev, dtype=torch.bfloat16)
    w = [torch.zeros(16, 48, device=dev), torch.zeros(2, 12, 12, device=dev),
         torch.zeros(16, 16, device=dev)]
    with pytest.raises(ValueError, match="blocks of 3"):
        ap.attn_slot(3, "full", x, *w)
    with pytest.raises(ValueError, match="wqkv"):
        ap.attn_ablate("full2d", x, w[0].cpu(), *w[1:])
    misaligned = torch.zeros(4 * 12 * 16 + 1, device=dev,
                             dtype=torch.bfloat16)[1:].view(4, 12, 16)
    with pytest.raises(ValueError, match="16-byte"):
        ap.copy_windows(misaligned)


# One-line edits of K1's key-tiled body that chip_smoke.py must reject on
# the card (exit 1, in its phase 3: parity on ViT's calls or the saturation
# with the top logits in the ragged last key tile; the slab kernels' in
# phase 7, whose re-headed calls take them): name -> (source, line, its
# mutant). The clamp and s1's term of ds are K1's softmax policy
# (``K1Softmax``); the other lines K4's tiled kernels run too, but K1's
# phase 3 comes first.
_CSRC = Path(__file__).resolve().parent.parent / "vsn_tpu_torch" / "csrc"
TILED_SOURCE_MUTANTS = {
    "K1f: the ragged tile's missing keys scored 0, not -inf": (
        "attn_tiled.cuh",
        "s[nt][e] = s[nt][2 + e] = P::kProbs == Probs::kScaled ? 0.f : "
        "-INFINITY;", "s[nt][e] = s[nt][2 + e] = 0.f;"),
    "K1f: the max(rowmax, 0) clamp dropped": (
        "attn_tiled.cuh", "static constexpr float kShift0 = 0.f;",
        "static constexpr float kShift0 = -INFINITY;"),
    "K1f: no rescale of l and O when the running max grows": (
        "attn_tiled.cuh",
        "const float alpha0 = expf(m0 - mn0), alpha1 = expf(m1 - mn1);",
        "const float alpha0 = 1.f, alpha1 = 1.f;"),
    "K1f: the running sum not rescaled": (
        "attn_tiled.cuh", "l0 = l0 * alpha0 + part0;", "l0 = l0 + part0;"),
    "K1b: s1 = rowsum(p * dp) dropped from ds": (
        "attn_tiled.cuh",
        "return __fsub_rn(__fmul_rn(p, dp), __fmul_rn(s1, p));",
        "return __fmul_rn(p, dp);"),
    "K1b phase B: p not scaled by the kept 1 / sum": (
        "attn_tiled.cuh", "sti[0], sti[1]);", "sti[0], 1.f);"),
    # the slab kernels' (head dims above 128; phase 7's re-headed calls)
    "K1b phase A on slabs: dbias added by every slab's block": (
        "attn_tiled.cuh",
        "const bool adds_dbias = dbias && blk.so == 0;",
        "const bool adds_dbias = dbias != nullptr;"),
}
TILED_FAILURES = ("kernels disagree with their plain versions",
                  "tiled K1 at logits")

# One-line edits of K1's route at Swin's calls, of the lines of the
# key-tiled body that only Swin's calls reach (the region mask and the
# relative-position bias: ViT's calls carry neither) and of what only head
# dims off the mma depth reach, that chip_smoke.py must reject on the card
# (exit 1: in its Swin parity phases 6-8, or in phase 3, whose saturated
# logits give ViT's call a bias, or in phase 7's launch counts of the
# route, or at the first call of a head dim that is not a multiple of 16:
# phase 2b's wide rows at d = 25, phase 7's re-headed calls): name ->
# (source under vsn_tpu_torch, line, its mutant)
SWIN_ROUTE_MUTANTS = {
    "route: head dims off the mma depth refused again": (
        "ops/window_attention.py", "return 0 < d <= MAX_HEAD_DIM",
        "return 0 < d <= MAX_HEAD_DIM and d % 16 == 0"),
    "K1: plain loads skipped where bf16 rows are not whole 16-byte chunks": (
        "csrc/attn_tiled.cuh", "bool plain = d % (16 / (int)sizeof(T));",
        "bool plain = false;"),
    "K1Softmax: the region mask dropped": (
        "csrc/attn_tiled.cuh",
        "if (id_row) s = __fadd_rn(s, id_row[j] != id_i ? kNegInf : 0.f);",
        "if (id_row) s = __fadd_rn(s, 0.f);"),
    "K1Softmax: the relative-position bias dropped": (
        "csrc/attn_tiled.cuh", "if (bias_i) s = __fadd_rn(s, bias_i[j]);",
        "if (bias_i) s = __fadd_rn(s, 0.f);"),
    "K1f: the tiled launch given no bias": (
        "csrc/attn_half.cu",
        "err = launch_attention_tiled<T>(qkv_buf, bias, ids, ids_rows, ao_buf,",
        "err = launch_attention_tiled<T>(qkv_buf, nullptr, ids, ids_rows, "
        "ao_buf,"),
    "K1b: the tiled backward given no region ids": (
        "csrc/attn_half_bwd.cu",
        "return launch_attention_bwd_tiled<T>(qkv, dao, o, row_stats, bias, "
        "ids, ids_rows, s1, dqkv,",
        "return launch_attention_bwd_tiled<T>(qkv, dao, o, row_stats, bias, "
        "nullptr, ids_rows, s1, dqkv,"),
}
SWIN_ROUTE_FAILURES = ("kernels disagree with their plain versions",
                       "tiled K1 at logits", "Swin route launches",
                       "head dims up to", "CUDA error")
_PORT = _CSRC.parent


@pytest.mark.parametrize("mutant", sorted(SWIN_ROUTE_MUTANTS))
def test_swin_route_mutants_name_one_line_of_the_source(mutant):
    src, line, new = SWIN_ROUTE_MUTANTS[mutant]
    assert (_PORT / src).read_text().count(line) == 1 and new != line


@pytest.mark.parametrize("mutant", sorted(SWIN_ROUTE_MUTANTS))
def test_a_mutated_swin_route_makes_chip_smoke_fail(dev, mutant, tmp_path):
    """chip_smoke.py run from a copy of the port whose route at Swin's
    calls, or a line of the tiled body that only they reach, has one line
    mutated exits 1."""
    from test_torch_chip_smoke import _run_mutated_chip_smoke

    src, line, new = SWIN_ROUTE_MUTANTS[mutant]
    res = _run_mutated_chip_smoke(_PORT / src, line, new, tmp_path)
    assert res.returncode == 1
    assert any(f in res.stderr for f in SWIN_ROUTE_FAILURES), \
        res.stderr[-2000:]


@pytest.mark.parametrize("mutant", sorted(TILED_SOURCE_MUTANTS))
def test_tiled_source_mutants_name_one_line_of_the_source(mutant):
    src, line, new = TILED_SOURCE_MUTANTS[mutant]
    assert (_CSRC / src).read_text().count(line) == 1 and new != line


@pytest.mark.parametrize("mutant", sorted(TILED_SOURCE_MUTANTS))
def test_a_mutated_tiled_source_makes_chip_smoke_fail(dev, mutant, tmp_path):
    """chip_smoke.py run from a copy of the port whose tiled K1 kernels
    have one line mutated exits 1 in a parity phase (ViT's, or phase 7's
    for the slab kernels)."""
    from test_torch_chip_smoke import _run_mutated_chip_smoke

    src, line, new = TILED_SOURCE_MUTANTS[mutant]
    res = _run_mutated_chip_smoke(_CSRC / src, line, new, tmp_path)
    assert res.returncode == 1
    assert any(f in res.stderr for f in TILED_FAILURES), res.stderr[-2000:]


# ---------------------------------------------------------------------------
# The GEMM and weight-gradient bodies of K1 / K2 alone (csrc/gemm.cu)
# ---------------------------------------------------------------------------

# (epilogue, LayerScale flag, W as [K, N], A's prologue: "ln", "gain",
# "f32" or "plain"): every mode of sbk.GEMM_MODES with each prologue that
# K1, K2 or the probes launch it with (an f32 A only under bf16)
GEMM_CASES = [
    ("bias", None, False, "ln"), ("bias", None, False, "plain"),
    ("gelu", None, False, "ln"), ("gelu", None, False, "plain"),
    ("residual", None, False, "plain"), ("residual", "epi", False, "plain"),
    ("gelu_grad", None, False, "plain"), ("f32", None, False, "plain"),
    ("bias", None, True, "gain"), ("bias", "pro", True, "gain"),
    ("bias", None, True, "f32"), ("bias", None, True, "ln"),
    ("mul_f32", None, True, "gain"), ("mul_f32", "pro", True, "gain"),
    ("mul_f32", None, True, "f32"), ("f32", None, True, "plain"),
    ("f32", None, True, "f32"), ("add_resid", None, True, "plain"),
    ("add_resid", None, True, "f32"),
]
# (M, K, N): Swin's stage-1 qkv cut to a ragged 70 rows; a K and N that
# are not whole tiles, N not a multiple of 8 (element-wise W loads and
# stores); several tiles of each
GEMM_SHAPES = [(70, 96, 288), (300, 40, 50), (1000, 384, 1152)]


def _gemm_check(dev, launch, dtype, fma=False):
    gen = torch.Generator(dev).manual_seed(5)
    args, kw = chip_smoke.gemm_call(launch, dtype, dev, gen)
    table = chip_smoke.gemm_table()
    if fma:
        kernel, plain = table[launch.kind]
        table[launch.kind] = (
            lambda *a, **k: kernel(*a, **k, _fma=True), plain)
    key = launch.kind + ("_fma" if fma else "")
    before = _build.launches[key]
    err, ratio = chip_smoke.gemm_compare(launch, args, kw, table)
    torch.cuda.synchronize()
    assert _build.launches[key] == before + 1
    assert ratio <= 1.0, (err, ratio)


@pytest.mark.parametrize("shape", GEMM_SHAPES)
@pytest.mark.parametrize("case,dtype", [
    (case, dtype) for case in GEMM_CASES for dtype in ("float32", "bfloat16")
    if dtype == "bfloat16" or case[3] != "f32"],   # f32 A is f32's own type
    ids=lambda v: "-".join(map(str, v)) if isinstance(v, tuple) else v)
def test_gemm_launch_matches_plain(dev, case, dtype, shape):
    """Every GEMM mode, prologue and type against ``gemm_reference`` to
    chip_smoke.py's GEMM_TOL (bf16 out 2e-2, out32 under bf16 1e-3, f32
    1e-4 of each output's scale), per-sample gains over 2 samples."""
    m, k, n = shape
    _gemm_check(dev, chip_smoke.GemmLaunch("card", "gemm", case, m, k, n,
                                           m // 2), dtype)


@pytest.mark.parametrize("shape", GEMM_SHAPES)
@pytest.mark.parametrize("case", GEMM_CASES[:6], ids=lambda c: "-".join(
    map(str, c)))
def test_gemm_fma_yardstick_matches_plain(dev, case, shape):
    """The FMA body on bf16 operands (``_fma``, chip_smoke.py's
    yardstick) computes the same function."""
    m, k, n = shape
    _gemm_check(dev, chip_smoke.GemmLaunch("card", "gemm", case, m, k, n,
                                           m // 2), "bfloat16", fma=True)


@pytest.mark.parametrize("dtype,a_type,fma", [
    ("float32", "T", False), ("bfloat16", "T", False),
    ("bfloat16", "f32", False), ("bfloat16", "T", True),
    ("bfloat16", "f32", True)])   # the f32 body is the FMA body
@pytest.mark.parametrize("gained", [False, True])
@pytest.mark.parametrize("m,n1,n2", [(70, 96, 288), (5000, 40, 50),
                                     (20000, 384, 1152)])
def test_wgrad_launch_matches_plain(dev, m, n1, n2, gained, dtype, a_type,
                                    fma):
    """The weight gradient over one split and over several (20000 rows),
    ragged edges, with and without the per-sample gain, against
    ``wgrad_reference`` to 1e-3 (bf16) / 1e-4 (f32) of its scale; with
    ``fma`` the FMA body on bf16 operands (chip_smoke.py's yardstick)."""
    _gemm_check(dev, chip_smoke.GemmLaunch(
        "card", "wgrad", (a_type, gained), m, n1, n2, m // 2), dtype, fma)


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_gemm_launch_probe_proj_at_a_row_stride(dev, out_dtype):
    """The probes' proj: A the q slice of a packed [M, 3K] qkv (lda = 3K),
    W as [K, N], out and the residual bf16 or f32."""
    g = torch.Generator(dev).manual_seed(6)
    z = lambda *s: torch.randn(*s, generator=g, device=dev)
    qkv = z(70, 288).to(torch.bfloat16)
    kw = dict(w_kn=True, resid=z(70, 96).to(out_dtype),
              gains=torch.ones(1, device=dev), lam=1.0, out_dtype=out_dtype)
    args = (qkv[:, :96], z(96, 96) * 96 ** -0.5, "residual", torch.bfloat16)
    got = sbk.gemm_launch(*args, **kw)[0]
    _close(got, sbk.gemm_reference(*args, **kw)[0], out_dtype)


def test_gemm_wrappers_reject_what_the_kernels_do_not_take(dev):
    a = torch.zeros(70, 96, device=dev, dtype=torch.bfloat16)
    w = torch.zeros(288, 96, device=dev)
    with pytest.raises(ValueError, match="not a launch of K1 / K2"):
        sbk.gemm_launch(a, w.t().contiguous(), "gelu", torch.bfloat16,
                        w_kn=True)
    with pytest.raises(ValueError, match="not a launch of K1 / K2"):
        sbk.gemm_launch(a.float(), w, "gelu", torch.bfloat16)
    with pytest.raises(ValueError, match="lacks an argument"):
        sbk.gemm_launch(a, w, "residual", torch.bfloat16)
    with pytest.raises(TypeError, match="dtype"):
        sbk.gemm_launch(a, w.half(), "bias", torch.bfloat16)
    with pytest.raises(ValueError, match="wgrad_launch"):
        sbk.wgrad_launch(a.half(), a, torch.bfloat16)


# One-line edits of the tensor-core GEMM and weight-gradient bodies that
# chip_smoke.py must reject on the card (exit 1, in its GEMM phase 2a, or
# at the CUDA error of a read past an operand): name -> (source, line, its
# mutant)
GEMM_SOURCE_MUTANTS = {
    "GEMM: the last k-tile dropped": (
        "common.cuh", "const int nk = (p.k + kMmaBK - 1) / kMmaBK;",
        "const int nk = (p.k + kMmaBK - 1) / kMmaBK - 1;"),
    "GEMM: LayerNorm statistics of the wrong row": (
        "common.cuh",
        "x = (x - mu_s[r]) * rstd_s[r] * p.ln_w[k + e] + p.ln_b[k + e];",
        "x = (x - mu_s[r ^ 1]) * rstd_s[r ^ 1] * p.ln_w[k + e] + "
        "p.ln_b[k + e];"),
    "GEMM: the prologue's row gain skipped": (
        "common.cuh", "const float g = p.a_gain ? scale_s[r] : 1.f;",
        "const float g = 1.f;"),
    "GEMM: the residual gain of the first sample for all": (
        "common.cuh",
        "(EPI == EPI_RESIDUAL && m < p.m) ? p.gains[m / p.rows_per_sample]"
        " : 1.f;",
        "(EPI == EPI_RESIDUAL && m < p.m) ? p.gains[0] : 1.f;"),
    "GEMM: GELU written where EPI_GELU_GRAD writes GELU'": (
        "common.cuh",
        "for (int e = 0; e < 8; ++e) d[e] = gelu_erf_grad(v[e]);",
        "for (int e = 0; e < 8; ++e) d[e] = gelu_erf(v[e]);"),
    "wgrad: the ragged last split reads past M": (
        "common.cuh", "const long long r1 = min(r0 + p.rows, p.m);",
        "const long long r1 = r0 + p.rows;"),
    "wgrad: the first split's atomicAdd dropped": (
        "common.cuh",
        "if (oj < p.n2) atomicAdd(&p.out[(long long)oi * p.n2 + oj], "
        "acc[i][j][2 * hh + e]);",
        "if (oj < p.n2 && blockIdx.z) atomicAdd(&p.out[(long long)oi * "
        "p.n2 + oj], acc[i][j][2 * hh + e]);"),
}
GEMM_FAILURES = ("GEMM launches disagree with their plain versions",
                 "CUDA error", "illegal memory access")


@pytest.mark.parametrize("mutant", sorted(GEMM_SOURCE_MUTANTS))
def test_gemm_source_mutants_name_one_line_of_the_source(mutant):
    src, line, new = GEMM_SOURCE_MUTANTS[mutant]
    assert (_CSRC / src).read_text().count(line) == 1 and new != line


@pytest.mark.parametrize("mutant", sorted(GEMM_SOURCE_MUTANTS))
def test_a_mutated_gemm_source_makes_chip_smoke_fail(dev, mutant, tmp_path):
    """chip_smoke.py run from a copy of the port whose tensor-core GEMM or
    weight-gradient body has one line mutated exits 1."""
    from test_torch_chip_smoke import _run_mutated_chip_smoke

    src, line, new = GEMM_SOURCE_MUTANTS[mutant]
    res = _run_mutated_chip_smoke(_CSRC / src, line, new, tmp_path)
    assert res.returncode == 1
    assert any(f in res.stderr for f in GEMM_FAILURES), res.stderr[-2000:]



# ---------------------------------------------------------------------------
# The LayerNorm backward of K1b / K2b alone (csrc/common.cuh, entry points
# csrc/row_kernels.cu) and the K3 gather over its row map
# ---------------------------------------------------------------------------

# (M, C): Swin-T's stage widths and ViT-S's at ragged row counts (several
# blocks, a ragged last run), the tests' narrow widths, single columns (C =
# 12, not a multiple of 8), and the wide rows, whose lane group spans 2-8
# warps: 1024 and 1280 (64 lanes), 1536 (Swin-T's stage 4 at EMBED_DIM 192,
# 64 lanes x 3 units), 4096, 6144 (LN's rows' w and b: 48 KB of shared
# memory besides the row sums') and 8192 (256 lanes), and single columns
# above 256: 300 (64 lanes x 8), 3000 (256 x 16) and 8191 (256 x 32)
LN_SHAPES = [(70, 96), (5000, 96), (3001, 192), (2016, 384), (300, 768),
             (74, 24), (111, 8), (50, 12), (40, 1024), (1200, 1280),
             (1200, 1536), (700, 300), (300, 4096), (64, 6144), (150, 3000),
             (130, 8192), (64, 8191)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["ln_bwd", "postnorm_bwd"])
@pytest.mark.parametrize("m,c", LN_SHAPES)
def test_ln_bwd_launch_matches_plain_and_repeats_its_bits(dev, m, c, name,
                                                          dtype):
    """Each mode against its plain version to chip_smoke.py's limits (dx /
    dbranch TOL of the activation type, dw / db / dgamma LN_BWD_TOL of their
    scale), and a second launch on the same inputs gives the same bits in
    every output (block partials summed in block order)."""
    rps = m // 2 if m % 2 == 0 else m
    launch = chip_smoke.RowLaunch("card", m, c, rps, 0)
    args = chip_smoke.ln_bwd_call(name, launch, dtype, dev,
                                  torch.Generator(dev).manual_seed(7))
    before = _build.launches[name]
    err, ratio, same = chip_smoke.ln_bwd_compare(name, args,
                                                 chip_smoke.ln_bwd_table())
    torch.cuda.synchronize()
    assert _build.launches[name] == before + 2
    assert ratio <= 1.0, (err, ratio)
    assert same


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_post_norm_without_gamma_and_pre_norm_at_deepscalelm_lam(dev, dtype):
    """Post-norm alone (no LayerScale: dgamma not written) and the
    pre-norm residual line at DeepScaleLM's lam."""
    g = torch.Generator(dev).manual_seed(8)
    z = lambda *s: torch.randn(*s, generator=g, device=dev)
    m, c = 2 * 811, 384
    branch, do_res = 2 * z(m, c) - 0.5, z(m, c).to(dtype)
    gb, w, b = torch.tensor([0.7, 1.3], device=dev), 1 + 0.1 * z(c), z(c)
    got = sbk.postnorm_bwd_launch(branch.clone(), do_res, gb, 811, w, b)
    want = sbk.postnorm_backward_rows_reference(branch, do_res, gb, 811, w, b)
    assert got[3] is None and want[3] is None
    for i, (a, e) in enumerate(zip(got[:3], want[:3])):
        tol = TOL[torch.float32] if i else TOL[dtype]
        err = (a - e).abs().max().item()
        assert err <= tol * max(1.0, e.abs().max().item()), (i, err)
    x = (3 * z(m, c) + 1).to(dtype)
    stats = sbk.ln_rows_reference(x, torch.ones_like(w),
                                  torch.zeros_like(w))[1]
    args = (x, stats, w, z(m, c), do_res, 0.9129)
    dx, dw, db = sbk.ln_bwd_launch(*args)
    ref = sbk.ln_backward_rows_reference(*args)
    _close(dx, ref[0], dtype)
    for a, e in zip((dw, db), ref[1:]):
        assert (a - e).abs().max().item() <= 1e-3 * e.abs().max().item()


def test_ln_bwd_wrappers_take_every_width_to_8192_and_no_wider(dev):
    """The plan takes every C from 1 to 8192 (the widths above are launched
    by the parity test); 8193 raises, and so do the dtypes and row counts
    the body does not take."""
    x = torch.zeros(10, 8193, device=dev)
    stats = torch.zeros(10, 2, device=dev)
    with pytest.raises(ValueError, match="C <= 8192"):
        sbk.ln_bwd_launch(x, stats, torch.ones(8193, device=dev), x, x)
    assert all(_build.library().vsn_ln_bwd_blocks(10, c)
               for c in range(1, 8193))
    x = torch.zeros(10, 300, device=dev)
    w = torch.ones(300, device=dev)
    with pytest.raises(TypeError, match="dtype"):
        sbk.ln_bwd_launch(x.half(), stats, w, x, x.half())
    with pytest.raises(ValueError, match="rows over samples"):
        sbk.postnorm_bwd_launch(x[:, :96].contiguous(), x[:, :96].contiguous(),
                                torch.ones(3, device=dev), 3, w[:96], w[:96])


# (M, N, kind): the column sums at the K1b / K2b calls' shapes: the gated
# do_res (bf16) at Swin-T's stage 1 and 4 widths and ViT-S's, at Swin-T's
# stage 4 of EMBED_DIM 192 (1536: two column groups) and at a width of single
# columns (300); f32 (dh1, dbranch) at hidden 3072 (four column groups of
# 96 units), 384 and 1000 (single columns); rows over 3 samples, ragged
COLSUM_SHAPES = [(5001, 96, "gated"), (300, 768, "gated"),
                 (19464, 384, "gated"), (1200, 1536, "gated"),
                 (700, 300, "gated"), (1200, 3072, "f32"),
                 (5001, 384, "f32"), (301, 1000, "f32"), (7, 24, "gated")]


def _colsum_args(dev, m, n, kind, dtype=torch.bfloat16):
    g = torch.Generator(dev).manual_seed(9)
    a = torch.randn(m, n, generator=g, device=dev)
    if kind == "f32":
        return (a,)
    rps = -(-m // 3)
    return (a.to(dtype), torch.linspace(0.6, 1.4, -(-m // rps), device=dev),
            rps)


@pytest.mark.parametrize("m,n,kind", COLSUM_SHAPES)
def test_colsum_launch_matches_plain_and_repeats_its_bits(dev, m, n, kind):
    """``colsum_launch`` against ``colsum_reference`` within LN_BWD_TOL of
    its scale (the same f32 terms summed in another order), one launch
    counted a call, and two launches on the same inputs give the same bits
    (block partials summed in block order)."""
    args = _colsum_args(dev, m, n, kind)
    before = _build.launches["colsum"]
    got, again = sbk.colsum_launch(*args), sbk.colsum_launch(*args)
    want = sbk.colsum_reference(*args)
    torch.cuda.synchronize()
    assert _build.launches["colsum"] == before + 2
    tol = chip_smoke.LN_BWD_TOL["bfloat16"]
    assert got.dtype == torch.float32 and got.shape == (n,)
    assert (got - want).abs().max().item() <= tol * max(
        1.0, want.abs().max().item())
    assert torch.equal(got, again)


def test_colsum_launch_at_a_misaligned_view_and_f32_gated(dev):
    """A row operand 4 bytes into its storage (copied by the wrapper) and
    the gated sum over f32 rows (f32 activations)."""
    m, n = 1001, 96
    g = torch.Generator(dev).manual_seed(10)
    base = torch.randn(m * n + 1, generator=g, device=dev)
    a = base[1:].view(m, n)
    assert a.data_ptr() % 16
    gains = torch.tensor([0.7, 1.3], device=dev)
    for args in ((a,), (a, gains, 501), (a.to(torch.bfloat16), gains, 501)):
        want = sbk.colsum_reference(*args)
        got = sbk.colsum_launch(*args)
        assert (got - want).abs().max().item() <= 1e-3 * want.abs().max()


# (M, C) of LN's rows: the LN-backward shapes (the same plan)
LN_ROWS_SHAPES = LN_SHAPES


@pytest.mark.parametrize("x_dtype,y_dtype", [
    (torch.bfloat16, torch.bfloat16), (torch.float32, torch.float32),
    (torch.float32, torch.bfloat16)])   # the probe P1 attn_only's form
@pytest.mark.parametrize("m,c", LN_ROWS_SHAPES)
def test_ln_rows_launch_matches_plain_and_repeats_its_bits(dev, m, c,
                                                           x_dtype, y_dtype):
    """``ln_rows_launch`` against ``ln_rows_reference``: y within TOL of its
    type (one rounding step where the f32 values round apart), the row
    statistics within 1e-4 of their scale (the row's sums in another
    order); parameters views 4 bytes into a buffer, as training's; two
    launches give the same bits."""
    g = torch.Generator(dev).manual_seed(11)
    z = lambda *s: torch.randn(*s, generator=g, device=dev)
    vec = lambda v: torch.cat([v.new_zeros(1), v])[1:]
    x = (3 * z(m, c) + 1 + z(m, 1)).to(x_dtype)
    w, b = vec(1 + 0.1 * z(c)), vec(0.1 * z(c))
    before = _build.launches["ln_rows"]
    y, stats = sbk.ln_rows_launch(x, w, b, y_dtype)
    y2, stats2 = sbk.ln_rows_launch(x, w, b, y_dtype)
    want_y, want_stats = sbk.ln_rows_reference(x, w, b, y_dtype)
    torch.cuda.synchronize()
    assert _build.launches["ln_rows"] == before + 2
    _close(y, want_y, y_dtype)
    err = (stats - want_stats).abs().max().item()
    assert err <= 1e-4 * max(1.0, want_stats.abs().max().item()), err
    assert torch.equal(y, y2) and torch.equal(stats, stats2)


@pytest.mark.parametrize("gamma", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,c", LN_SHAPES)   # the same row plan
def test_postnorm_fwd_launch_matches_plain_and_repeats_its_bits(dev, m, c,
                                                                dtype, gamma):
    """``postnorm_fwd_launch`` against ``postnorm_fwd_reference`` at every
    class of width the row plan takes (multiples of 8 up to 8192, single
    columns, lane groups across warps), with and without gamma, at
    DeepScaleLM's lam: out within TOL of its type (one rounding step where
    the f32 values round apart); LN's parameters views 4 bytes into a
    buffer, as training's; two launches give the same bits."""
    g = torch.Generator(dev).manual_seed(12)
    z = lambda *s: torch.randn(*s, generator=g, device=dev)
    vec = lambda v: torch.cat([v.new_zeros(1), v])[1:]
    rps = m // 2 if m % 2 == 0 else m
    args = (2 * z(m, c) - 0.5 + z(m, 1), z(m, c).to(dtype),
            vec(1 + 0.1 * z(c)), vec(0.1 * z(c)),
            vec(0.5 + 0.1 * z(c)) if gamma else None,
            torch.linspace(0.6, 1.4, m // rps, device=dev), rps, 0.9129)
    before = _build.launches["postnorm_fwd"]
    got = sbk.postnorm_fwd_launch(*args)
    again = sbk.postnorm_fwd_launch(*args)
    want = sbk.postnorm_fwd_reference(*args)
    torch.cuda.synchronize()
    assert _build.launches["postnorm_fwd"] == before + 2
    _close(got, want, dtype)
    assert torch.equal(got, again)


# (N, K) of the LayerScale gradients: Swin-T's proj and fc2 at its four
# stage widths and ViT-S's (N = 96: rows split over a cluster of two
# blocks), K above 8192 (lane groups of 256 looping; at N = 8 eight slices),
# K not a multiple of 4 (single columns) and a tiny call
LS_SHAPES = [(96, 96), (96, 384), (192, 192), (192, 768), (384, 384),
             (384, 1536), (768, 768), (768, 3072), (64, 12288), (8, 32768),
             (37, 150), (5, 7)]


@pytest.mark.parametrize("offset", [0, 1, 2, 3])   # W's floats past 16 bytes
@pytest.mark.parametrize("n,k", LS_SHAPES)
def test_layerscale_grads_launch_matches_plain_and_repeats_its_bits(dev, n,
                                                                    k,
                                                                    offset):
    """``layerscale_grads_launch`` against ``layerscale_grads_reference``
    with W a view 0-3 floats past a 16-byte boundary (a view into the flat
    parameter buffer): dw and db scaled by gamma bit for bit (the same f32
    product), dgamma within 1e-4 of its scale (the row's dot in another
    order); two launches give the same bits."""
    g = torch.Generator(dev).manual_seed(13)
    z = lambda *s: torch.randn(*s, generator=g, device=dev)
    w = torch.cat([z(offset), k ** -0.5 * z(n * k)])[offset:].view(n, k)
    assert w.data_ptr() % 16 == 4 * offset
    args = (w, 0.1 * z(n), 0.5 + 0.1 * z(n), z(n, k), z(n), z(n))
    before = _build.launches["layerscale_grads"]
    got = sbk.layerscale_grads_launch(*args)
    again = sbk.layerscale_grads_launch(*args)
    want = sbk.layerscale_grads_reference(*args)
    torch.cuda.synchronize()
    assert _build.launches["layerscale_grads"] == before + 2
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    err = (got[2] - want[2]).abs().max().item()
    assert err <= 1e-4 * max(1.0, want[2].abs().max().item()), err
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_layerscale_grads_in_place_on_an_unaligned_dw(dev):
    """The C entry point updates dw, db and dgamma in place, as K1b / K2b
    launch it; a dw 4 bytes into its storage takes the single-column body:
    the same values."""
    n, k = 192, 768
    g = torch.Generator(dev).manual_seed(14)
    z = lambda *s: torch.randn(*s, generator=g, device=dev)
    w, bias, gamma = k ** -0.5 * z(n, k), 0.1 * z(n), 0.5 + 0.1 * z(n)
    dw = torch.cat([z(1), z(n * k)])[1:].view(n, k)
    db, dgamma = z(n), z(n)
    want = sbk.layerscale_grads_reference(w, bias, gamma, dw, db, dgamma)
    err = _build.library().vsn_layerscale_grads(
        w.data_ptr(), bias.data_ptr(), gamma.data_ptr(), dw.data_ptr(),
        db.data_ptr(), dgamma.data_ptr(), n, k, _build.stream_of(w))
    torch.cuda.synchronize()
    assert err == 0
    assert torch.equal(dw, want[0]) and torch.equal(db, want[1])
    assert (dgamma - want[2]).abs().max().item() <= 1e-4 * max(
        1.0, want[2].abs().max().item())


@pytest.mark.parametrize("offset", [2, 1])   # 4- and 2-byte aligned views
def test_movers_at_a_misaligned_view(dev, offset):
    """Source and destination rows that 16 bytes do not divide (a view 4 or
    2 bytes into its storage) move by 4- or 1-byte chunks, bit-exact."""
    dims, window, roll = (12, 14, 12), (6, 7, 6), (3, 3, 3)
    n = 2 * 12 * 14 * 12 * 96
    base = torch.randn(n + offset, device=dev).to(torch.bfloat16)
    x = base[offset:].view(2, *dims, 96)
    assert x.data_ptr() % 16
    wins = wr.spatial_to_windows(x, window, roll)
    assert torch.equal(wins, wr.spatial_to_windows_reference(x, window,
                                                             roll))
    back = wr.windows_to_spatial(wins, window, dims, tuple(-r for r in roll))
    assert torch.equal(back, x)


# One-line edits of the row kernels (the LN backward, the column sums, LN's
# rows, the post-norm forward's finish, the LayerScale gradients) and of
# K3's gather that chip_smoke.py must reject on the card (exit 1: in its
# row-kernel phase 2b, or in its mover parity, phase 6): name -> (source,
# line, its mutant)
ROW_SOURCE_MUTANTS = {
    "LN backward: mean(dxhat xhat) dropped": (
        "common.cuh",
        "const float m1 = group_sum(s1, lanes) / p.c, m2 = group_sum(s2, "
        "lanes) / p.c;",
        "const float m1 = group_sum(s1, lanes) / p.c, m2 = 0.f;"),
    "LN backward: dw / db of the first block only": (
        "common.cuh",
        "for (int g = slice; g < blocks; g += kLnSumSlices) {",
        "for (int g = slice; g < 1; g += kLnSumSlices) {"),
    "LN backward: the slices' sums picked by the clock's parity": (
        "common.cuh", "a += red[i][0][lane];",
        "a += red[(clock() & 1) ? kLnSumSlices - i : i][0][lane];"),
    "column sums: the first block's partial only": (
        "common.cuh",
        "return launch_ordered_sum(part, plan.blocks, n, 0, nullptr, nullptr,"
        " nullptr, out, nullptr,",
        "return launch_ordered_sum(part, 1, n, 0, nullptr, nullptr, nullptr, "
        "out, nullptr,"),
    "LN rows: the variance about 0": (
        "common.cuh", "const float t = xin[k].get(e) - mu;",
        "const float t = xin[k].get(e);"),
    "post-norm forward: the variance about 0": (
        "common.cuh", "const float t = br[k].get(e) - mu;",
        "const float t = br[k].get(e);"),
    "LayerScale gradients: dgamma from the scaled M": (
        "common.cuh",
        "dot = fmaf(wv[j][e], mv[j][e], dot);  // dgamma from the unscaled M",
        "dot = fmaf(wv[j][e], mv[j][e] * g, dot);"),
    "K3: each row from its neighbour's source": (
        "window_relayout.cu",
        "if (r < rows) v[i] = src[(unsigned)__ldg(map + r) * (unsigned)chunks"
        " + c];",
        "if (r < rows) v[i] = src[(unsigned)__ldg(map + (r ? r - 1 : 0)) * "
        "(unsigned)chunks + c];"),
}
ROW_FAILURES = ("LN-backward launches disagree with their plain versions",
                "LN-backward launches differ between two runs",
                "kernels disagree with their plain versions",
                "row kernel launches differ between two runs")


@pytest.mark.parametrize("mutant", sorted(ROW_SOURCE_MUTANTS))
def test_row_source_mutants_name_one_line_of_the_source(mutant):
    src, line, new = ROW_SOURCE_MUTANTS[mutant]
    assert (_CSRC / src).read_text().count(line) == 1 and new != line


@pytest.mark.parametrize("mutant", sorted(ROW_SOURCE_MUTANTS))
def test_a_mutated_row_source_makes_chip_smoke_fail(dev, mutant, tmp_path):
    """chip_smoke.py run from a copy of the port whose LN-backward body or
    K3 gather has one line mutated exits 1."""
    from test_torch_chip_smoke import _run_mutated_chip_smoke

    src, line, new = ROW_SOURCE_MUTANTS[mutant]
    res = _run_mutated_chip_smoke(_CSRC / src, line, new, tmp_path)
    assert res.returncode == 1
    assert any(f in res.stderr for f in ROW_FAILURES), res.stderr[-2000:]
