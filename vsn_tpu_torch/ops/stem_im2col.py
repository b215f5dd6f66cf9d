"""K5: the single-channel stem convolution and its weight gradient (port of
vsn_tpu/ops/stem_im2col.py).

``stem_conv_im2col(x, kernel, strides, padding, dtype)`` is conv(x, kernel)
for a C_in = 1 input, as an implicit im2col GEMM over the kernel's taps:

    y[tok, c]  = sum_t im2col[t, tok] * W[t, c]      (K5f, forward)
    dW[t, c]   = sum_tok im2col[t, tok] * g[tok, c]  (K5w, weight gradient)

It is a ``torch.autograd.Function``. For a tensor on a CUDA device the
forward launches K5f and the weight gradient K5w (``csrc/stem_im2col.cu``);
for a tensor on the CPU they run their plain versions,
``stem_conv_reference`` and ``stem_dw_reference``. Neither falls back to
the other. In bf16 both run on the tensor cores: K5f on the weights that
``pad_taps`` lays out (the taps as (dz, dy, dx) rows with dx padded to 8),
K5w as blocks that each sum a fixed run of output rows into a partial of a
scratch [blocks, taps, C] (``dw_plan``) and a second kernel that adds the
partials in order: no atomics, and dW has the same bits on every run. In
f32 both run FMA bodies, K5w adding into a zeroed dW with f32 atomics (an
order that varies between runs). ``_fma=True`` runs the FMA bodies on bf16
operands, counted apart (``stem_im2col_fma``, ``stem_im2col_dw_fma``):
chip_smoke.py's yardstick, the bodies bf16 took before. dx, when ``x``
requires a gradient, is the plain conv's input gradient on every device,
as the JAX package takes it from XLA's conv VJP
(vsn_tpu/ops/stem_im2col.py:387-392); the stem is the network's first
layer, so it is None there.

Layouts are JAX's: x [B, D, H, W, 1], kernel [kd, kh, kw, 1, C_out]
(DHWIO), output [B, Do, Ho, Wo, C_out]. Precision follows the TPU kernel:
x and the kernel are rounded to ``dtype`` (stem_im2col.py:359-362), products
accumulate in f32, and the output is rounded once; dW is f32 and sums
products of ``dtype``-rounded operands.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Sequence

import torch
import torch.nn.functional as F

from vsn_tpu_torch.ops._build import check, expect, launches, library, stream_of


def should_im2col(strides: Sequence[int], kernel_shape: Sequence[int],
                  padding: Sequence[int], c_in: int) -> bool:
    """The JAX package's gate (stem_im2col.py:71-88): C_in = 1, odd kernels
    with SAME-style padding, strides in {1, 2}, 64 to 512 taps and a z
    extent of at most 8 parity planes."""
    if c_in != 1:
        return False
    if any(s not in (1, 2) for s in strides):
        return False
    if any(k % 2 == 0 or p != k // 2 for k, p in zip(kernel_shape, padding)):
        return False
    taps = 1
    for k in kernel_shape:
        taps *= k
    zin = ((kernel_shape[0] + 1) // 2 if strides[0] == 2
           else kernel_shape[0])
    return 64 <= taps <= 512 and zin <= 8


def output_shape(shape, kernel_shape, strides, padding):
    """Conv output extents of spatial ``shape`` (D, H, W)."""
    return tuple((n + 2 * p - k) // s + 1 for n, k, s, p in
                 zip(shape, kernel_shape, strides, padding))


def tap_layout(kernel_shape, strides, padding):
    """(f, kw8, rows) of K5f's bf16 weight operand: depth row
    ``(dz*kh + dy)*kw8 + dx + f`` holds tap (dz, dy, dx), every other row is
    zero. kw8 = kw + f rounded up to 8, so that a k16 step of the tensor-core
    body is two (dz, dy) rows of 8; rows = kd*kh*kw8 rounded up to 16. At
    x-stride 2, f = px mod 2 zero slots in front of dx put each A register's
    depth pair (2t, 2t + 1) on an even input column, 2 xo + 2t - f - px, so
    the kernel reads it with one aligned 32-bit load (the 7^3 stem: f = 1,
    kw8 = 8, rows 400)."""
    kd, kh, kw = kernel_shape
    f = padding[2] % 2 if strides[2] == 2 else 0
    kw8 = -(-(kw + f) // 8) * 8
    return f, kw8, -(-(kd * kh * kw8) // 16) * 16


def pad_taps(kernel, strides, padding, dtype):
    """K5f's weight operand: kernel [kd, kh, kw, 1, C] rounded to ``dtype``
    in ``tap_layout``'s rows, [rows, C]."""
    kd, kh, kw, _, c = kernel.shape
    f, kw8, rows = tap_layout((kd, kh, kw), strides, padding)
    out = kernel.new_zeros((rows, c), dtype=dtype)
    out[:kd * kh * kw8].view(kd * kh, kw8, c)[:, f:f + kw] = \
        kernel.reshape(kd * kh, kw, c)
    return out


def unpad_taps(w, kernel_shape, strides, padding):
    """The inverse of ``pad_taps``: [rows, C] -> [kd, kh, kw, 1, C]."""
    kd, kh, kw = kernel_shape
    f, kw8, _ = tap_layout(kernel_shape, strides, padding)
    return w[:kd * kh * kw8].reshape(kd, kh, kw8, -1)[:, :, f:f + kw, None]


DW_ROWS = 6          # K5w: output rows a group, at most
DW_MAX_TAPS = 512    # K5w: taps its tensor-core body takes
SMEM_BYTES = 232448  # shared memory a block may use on this card


def dw_smem(rows, ow, kernel_shape, strides, padding):
    """Shared-memory bytes of K5w's tensor-core body at ``rows`` output rows
    a group (as csrc/stem_im2col.cu launch_dw_mma counts them): the ring of
    kd + sz input planes of the group's halo (bf16 rows of wp elements, lpad
    of them left of x = 0), two buffers of cotangent rows of ow rounded up
    to 16 token slots x 64 channels, and kd plane offsets."""
    (kd, kh, kw), (sz, sy, sx), px = kernel_shape, strides, padding[2]
    owp = -(-ow // 16) * 16
    lpad = -(-px // 8) * 8
    wp = -(-(lpad + sx * (owp - 1) + kw - px) // 8) * 8
    slab = (rows - 1) * sy + kh
    return 2 * ((kd + sz) * slab * wp + 2 * rows * owp * 64) + \
        4 * (-(-kd // 4) * 4)


class DwPlan(NamedTuple):
    """K5w's tensor-core launch: ``rows`` output rows a group, ``groups``
    row groups, ``per_block`` consecutive groups a block (the last block
    fewer) and ``blocks`` blocks, one an SM at most; the scratch of partials
    is ``scratch`` = [blocks, taps, C] f32."""
    rows: int
    groups: int
    per_block: int
    blocks: int
    scratch: tuple


def dw_plan(batch, out_shape, kernel_shape, strides, padding, c_out, sms):
    """K5w's launch for ``batch`` volumes of output extents ``out_shape``
    (Do, Ho, Wo) on a card of ``sms`` multiprocessors: a group is up to
    DW_ROWS output rows of one (b, zo), as many as fit the shared memory
    (``dw_smem``); a block sums a fixed run of consecutive groups (zo
    fastest, as the kernel walks them). The plan fixes which tokens each
    block sums, so dW's bits depend only on the shapes and the card."""
    od, oh, ow = out_shape
    taps = kernel_shape[0] * kernel_shape[1] * kernel_shape[2]
    if taps > DW_MAX_TAPS:
        raise ValueError(f"stem conv dW: {taps} taps; the kernel takes at "
                         f"most {DW_MAX_TAPS}")
    rows = min(oh, DW_ROWS)
    while rows > 1 and dw_smem(rows, ow, kernel_shape, strides,
                               padding) > SMEM_BYTES:
        rows -= 1
    if dw_smem(rows, ow, kernel_shape, strides, padding) > SMEM_BYTES:
        raise ValueError(f"stem conv dW: Wo={ow} does not fit the kernel's "
                         "shared memory")
    groups = batch * od * -(-oh // rows)
    per_block = -(-groups // min(groups, sms))
    blocks = -(-groups // per_block)
    return DwPlan(rows, groups, per_block, blocks, (blocks, taps, c_out))


@functools.lru_cache(maxsize=None)
def _sms(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def _aligned(t):
    """``t``, or a copy of it whose data starts on a 16-byte boundary."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _acc_dtype(dt):
    """The accumulation type of compute dtype ``dt``: at least f32."""
    return torch.promote_types(dt, torch.float32)


def stem_conv_reference(x, kernel, strides, padding, dtype=None):
    """Plain version of the forward: the conv in (at least) f32 on operands
    rounded to ``dtype``, rounded once to ``dtype``. Differentiable by
    autograd."""
    dt = dtype or x.dtype
    acc = _acc_dtype(dt)
    xs = x.to(dt).to(acc)[..., 0][:, None]                  # [B, 1, D, H, W]
    w = kernel.to(dt).to(acc).permute(4, 3, 0, 1, 2)        # [C, 1, kd, kh, kw]
    y = F.conv3d(xs, w, stride=tuple(strides), padding=tuple(padding))
    return y.permute(0, 2, 3, 4, 1).to(dt).contiguous()


def stem_dw_reference(x, g, kernel_shape, strides, padding, dtype=None):
    """Plain version of the weight gradient: the plain conv's VJP in (at
    least) f32 on ``dtype``-rounded x and g; f32 [kd, kh, kw, 1, C]."""
    dt = dtype or x.dtype
    acc = _acc_dtype(dt)
    w = torch.zeros((*kernel_shape, 1, g.shape[-1]), dtype=acc,
                    device=x.device, requires_grad=True)
    with torch.enable_grad():
        y = stem_conv_reference(x.detach().to(dt), w, strides, padding, acc)
        (dw,) = torch.autograd.grad(y, w, g.detach().to(dt).to(acc))
    return dw


def _dx_reference(x, kernel, g, strides, padding, dt):
    """dx of the plain conv (the JAX package's XLA conv VJP)."""
    with torch.enable_grad():
        xx = x.detach().requires_grad_()
        y = stem_conv_reference(xx, kernel.detach(), strides, padding, dt)
        (dx,) = torch.autograd.grad(y, xx, g)
    return dx


def _geometry(x, kernel_shape, strides, padding):
    """Validate a direct call as vsn_tpu's _geometry asserts; returns the
    output extents."""
    if x.ndim != 5 or x.shape[-1] != 1:
        raise ValueError(f"stem conv: x {tuple(x.shape)} is not "
                         "[B, D, H, W, 1]")
    if any(s not in (1, 2) for s in strides):
        raise ValueError(f"stem conv: strides {tuple(strides)} not in {{1, 2}}")
    if any(k % 2 == 0 or p != k // 2 for k, p in zip(kernel_shape, padding)):
        raise ValueError(f"stem conv: odd kernel with SAME padding required, "
                         f"got {tuple(kernel_shape)} pad {tuple(padding)}")
    return output_shape(x.shape[1:4], kernel_shape, strides, padding)


def _check_kernel_args(x, c_out, dt):
    if dt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"stem conv: dtype {dt} (f32 or bf16)")
    if c_out % 8 or c_out > 64:
        raise ValueError(f"stem conv: C_out={c_out}; the kernels take a "
                         "multiple of 8 up to 64")
    expect(x, "x", x.shape, dt, x.device)


def _geom_args(x, kernel_shape, strides, padding, outs, c_out):
    return (*x.shape[:4], *kernel_shape, *strides, *padding, c_out, *outs)


def _fwd_kernel(x, kernel, strides, padding, dt, fma=False):
    """K5f: launch ``csrc/stem_im2col.cu`` (x already in ``dt``): bf16 the
    tensor-core body on ``pad_taps``'s operand, f32 (or ``fma``) the FMA
    body on the f32 kernel."""
    kernel_shape, c_out = tuple(kernel.shape[:3]), kernel.shape[-1]
    outs = _geometry(x, kernel_shape, strides, padding)
    _check_kernel_args(x, c_out, dt)
    expect(kernel, "kernel", (*kernel_shape, 1, c_out), torch.float32,
           x.device)
    mma = dt == torch.bfloat16 and not fma
    w = pad_taps(kernel, strides, padding, dt) if mma else kernel
    y = torch.empty((x.shape[0], *outs, c_out), dtype=dt, device=x.device)
    with torch.cuda.device(x.device):
        err = library().vsn_stem_conv_fwd(
            int(dt == torch.bfloat16), int(fma), x.data_ptr(), w.data_ptr(),
            y.data_ptr(), *_geom_args(x, kernel_shape, strides, padding, outs,
                                      c_out), stream_of(x))
    name = "stem_im2col_fma" if fma else "stem_im2col"
    check(err, name)
    launches[name] += 1
    return y


def _dw_kernel(x, g, kernel_shape, strides, padding, dt, fma=False):
    """K5w: launch ``csrc/stem_im2col.cu`` (x and g already in ``dt``):
    bf16 the tensor-core body into ``dw_plan``'s scratch and the ordered
    sum of its partials, f32 (or ``fma``) the FMA body's atomics into a
    zeroed dW."""
    outs = _geometry(x, kernel_shape, strides, padding)
    c_out = g.shape[-1]
    _check_kernel_args(x, c_out, dt)
    expect(g, "g", (x.shape[0], *outs, c_out), dt, x.device)
    shape = (*kernel_shape, 1, c_out)
    if dt == torch.bfloat16 and not fma:
        plan = dw_plan(x.shape[0], outs, kernel_shape, strides, padding,
                       c_out, _sms(x.device.index or 0))
        g = _aligned(g)
        part = torch.empty(plan.scratch, dtype=torch.float32, device=x.device)
        dw = torch.empty(shape, dtype=torch.float32, device=x.device)
        extra = (part.data_ptr(), plan.rows, plan.blocks)
    else:
        dw = torch.zeros(shape, dtype=torch.float32, device=x.device)
        extra = (None, 0, 0)
    with torch.cuda.device(x.device):
        err = library().vsn_stem_conv_dw(
            int(dt == torch.bfloat16), int(fma), x.data_ptr(), g.data_ptr(),
            dw.data_ptr(), *extra, *_geom_args(x, kernel_shape, strides,
                                               padding, outs, c_out),
            stream_of(x))
    name = "stem_im2col_dw_fma" if fma else "stem_im2col_dw"
    check(err, name)
    launches[name] += 1
    return dw


def stem_conv_dw(x, g, kernel_shape, strides, padding, dtype=None,
                 _fma=False):
    """The weight gradient dW [kd, kh, kw, 1, C] (f32) of the stem conv for
    cotangent ``g`` [B, Do, Ho, Wo, C]: K5w on a CUDA device (``_fma``: its
    FMA body on bf16, the yardstick), the plain version on the CPU."""
    dt = dtype or x.dtype
    if _fma and dt != torch.bfloat16:
        raise ValueError("stem conv: _fma runs the FMA body on bf16 operands")
    if x.device.type == "cpu":
        return stem_dw_reference(x, g, kernel_shape, strides, padding, dt)
    return _dw_kernel(x.to(dt).contiguous(), g.to(dt).contiguous(),
                      tuple(kernel_shape), tuple(strides), tuple(padding), dt,
                      _fma)


class _StemConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, plain, x, kernel, strides, padding, dt, fma):
        ctx.plain, ctx.geom, ctx.fma = plain, (strides, padding, dt), fma
        ctx.save_for_backward(x, kernel)
        if plain:
            return stem_conv_reference(x, kernel, strides, padding, dt)
        return _fwd_kernel(x.to(dt).contiguous(), kernel.contiguous(),
                           strides, padding, dt, fma)

    @staticmethod
    def backward(ctx, g):
        x, kernel = ctx.saved_tensors
        strides, padding, dt = ctx.geom
        dx = dkernel = None
        if ctx.needs_input_grad[2]:
            shape = tuple(kernel.shape[:3])
            dw = (stem_dw_reference(x, g, shape, strides, padding, dt)
                  if ctx.plain else stem_conv_dw(x, g, shape, strides,
                                                 padding, dt, ctx.fma))
            dkernel = dw.to(kernel.dtype)
        if ctx.needs_input_grad[1]:
            dx = _dx_reference(x, kernel, g.to(dt), strides, padding,
                               dt).to(x.dtype)
        return None, dx, dkernel, None, None, None, None


def stem_conv_im2col(x, kernel, strides, padding, dtype=None, _fma=False):
    """conv(x, kernel) for a single-channel x [B, D, H, W, 1] and kernel
    [kd, kh, kw, 1, C_out] (odd, SAME padding, strides 1 or 2): K5f forward
    and K5w weight gradient on a CUDA device (``_fma``: their FMA bodies on
    bf16, the yardstick), the plain versions on the CPU. Returns
    [B, Do, Ho, Wo, C_out] in ``dtype`` (default x.dtype). Gate with
    ``should_im2col`` first, as ``UnfoldedConv`` does."""
    dt = dtype or x.dtype
    strides = tuple(int(s) for s in strides)
    padding = tuple(int(p) for p in padding)
    _geometry(x, kernel.shape[:3], strides, padding)
    if _fma and dt != torch.bfloat16:
        raise ValueError("stem conv: _fma runs the FMA bodies on bf16 "
                         "operands")
    return _StemConv.apply(x.device.type == "cpu", x, kernel, strides,
                           padding, dt, bool(_fma))
