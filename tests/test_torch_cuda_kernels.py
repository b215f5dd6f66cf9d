"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device (marker ``cuda``) and skips without
one. Run them on the card, where JAX is not installed, without the
JAX-side conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py

Tolerances, as chip_smoke.py holds them: f32 kernels against f32 plain
versions with TF32 off differ only in the order of sums, 1e-4 of the
output scale; bf16 outputs may differ by one bf16 rounding step of the
output (2^-8 relative), 2e-2 of the scale; the movers are bit-exact. The
backward kernels (K1b, K2b) are held to the plain backward with the same
tolerances, each gradient relative to its own scale: their parameter
gradients are sums over every row, reduced with f32 atomics in an order
that varies from run to run. The movers' adjoints are bit-exact.
"""

import numpy as np
import pytest
import torch

from vsn_tpu_torch.models.swin3d import (
    padded_window_region_ids,
    shifted_window_region_ids,
)
from vsn_tpu_torch.ops import _build
from vsn_tpu_torch.ops import swin_block_kernels as sbk
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


ATTN_SHAPES = [  # the four Swin-T stage kinds, and a head dim of 8
    ((12, 14, 12), (6, 7, 6), (3, 3, 3), 3, 96, "shifted"),
    ((12, 14, 12), (6, 7, 6), (0, 0, 0), 3, 96, None),
    ((9, 11, 9), (6, 7, 6), (3, 3, 3), 12, 384, "padded"),
    ((5, 6, 5), (5, 6, 5), (0, 0, 0), 24, 768, None),
    ((4, 6, 4), (2, 3, 2), (1, 1, 1), 2, 16, "shifted"),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dims,window,shift,heads,c,ids_kind", ATTN_SHAPES)
def test_attn_half_matches_plain(dev, dtype, dims, window, shift, heads, c,
                                 ids_kind):
    args = _attn_args(dev, dims, window, shift, heads, c, ids_kind, dtype)
    before = _build.launches["attn_half"]
    got = sbk.attn_half(*args)
    torch.cuda.synchronize()
    assert _build.launches["attn_half"] == before + 1
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
    before = _build.launches["attn_half_bwd"]
    got = _grads(sbk.attn_half, args, dout, ATTN_DIFF)
    torch.cuda.synchronize()
    assert _build.launches["attn_half_bwd"] == before + 1
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
    conv); dW is a sum over every token, reduced with f32 atomics."""
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
