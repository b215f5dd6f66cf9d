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
the other. dx, when ``x`` requires a gradient, is the plain conv's input
gradient on every device, as the JAX package takes it from XLA's conv VJP
(vsn_tpu/ops/stem_im2col.py:387-392); the stem is the network's first
layer, so it is None there.

Layouts are JAX's: x [B, D, H, W, 1], kernel [kd, kh, kw, 1, C_out]
(DHWIO), output [B, Do, Ho, Wo, C_out]. Precision follows the TPU kernel:
x and the kernel are rounded to ``dtype`` (stem_im2col.py:359-362), products
accumulate in f32, and the output is rounded once; dW is f32 and sums
products of ``dtype``-rounded operands.
"""

from __future__ import annotations

from typing import Sequence

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


def _fwd_kernel(x, kernel, strides, padding, dt):
    """K5f: launch ``csrc/stem_im2col.cu`` (x already in ``dt``)."""
    kernel_shape, c_out = tuple(kernel.shape[:3]), kernel.shape[-1]
    outs = _geometry(x, kernel_shape, strides, padding)
    _check_kernel_args(x, c_out, dt)
    expect(kernel, "kernel", (*kernel_shape, 1, c_out), torch.float32,
           x.device)
    y = torch.empty((x.shape[0], *outs, c_out), dtype=dt, device=x.device)
    with torch.cuda.device(x.device):
        err = library().vsn_stem_conv_fwd(
            int(dt == torch.bfloat16), x.data_ptr(), kernel.data_ptr(),
            y.data_ptr(), *_geom_args(x, kernel_shape, strides, padding, outs,
                                      c_out), stream_of(x))
    check(err, "stem_im2col")
    launches["stem_im2col"] += 1
    return y


def _dw_kernel(x, g, kernel_shape, strides, padding, dt):
    """K5w: launch ``csrc/stem_im2col.cu`` (x and g already in ``dt``)."""
    outs = _geometry(x, kernel_shape, strides, padding)
    c_out = g.shape[-1]
    _check_kernel_args(x, c_out, dt)
    expect(g, "g", (x.shape[0], *outs, c_out), dt, x.device)
    dw = torch.zeros((*kernel_shape, 1, c_out), dtype=torch.float32,
                     device=x.device)
    with torch.cuda.device(x.device):
        err = library().vsn_stem_conv_dw(
            int(dt == torch.bfloat16), x.data_ptr(), g.data_ptr(),
            dw.data_ptr(), *_geom_args(x, kernel_shape, strides, padding,
                                       outs, c_out), stream_of(x))
    check(err, "stem_im2col_dw")
    launches["stem_im2col_dw"] += 1
    return dw


def stem_conv_dw(x, g, kernel_shape, strides, padding, dtype=None):
    """The weight gradient dW [kd, kh, kw, 1, C] (f32) of the stem conv for
    cotangent ``g`` [B, Do, Ho, Wo, C]: K5w on a CUDA device, the plain
    version on the CPU."""
    dt = dtype or x.dtype
    if x.device.type == "cpu":
        return stem_dw_reference(x, g, kernel_shape, strides, padding, dt)
    return _dw_kernel(x.to(dt).contiguous(), g.to(dt).contiguous(),
                      tuple(kernel_shape), tuple(strides), tuple(padding), dt)


class _StemConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, plain, x, kernel, strides, padding, dt):
        ctx.plain, ctx.geom = plain, (strides, padding, dt)
        ctx.save_for_backward(x, kernel)
        if plain:
            return stem_conv_reference(x, kernel, strides, padding, dt)
        return _fwd_kernel(x.to(dt).contiguous(), kernel.contiguous(),
                           strides, padding, dt)

    @staticmethod
    def backward(ctx, g):
        x, kernel = ctx.saved_tensors
        strides, padding, dt = ctx.geom
        dx = dkernel = None
        if ctx.needs_input_grad[2]:
            dw = (stem_dw_reference if ctx.plain else stem_conv_dw)(
                x, g, tuple(kernel.shape[:3]), strides, padding, dt)
            dkernel = dw.to(kernel.dtype)
        if ctx.needs_input_grad[1]:
            dx = _dx_reference(x, kernel, g.to(dt), strides, padding,
                               dt).to(x.dtype)
        return None, dx, dkernel, None, None, None


def stem_conv_im2col(x, kernel, strides, padding, dtype=None):
    """conv(x, kernel) for a single-channel x [B, D, H, W, 1] and kernel
    [kd, kh, kw, 1, C_out] (odd, SAME padding, strides 1 or 2): K5f forward
    and K5w weight gradient on a CUDA device, the plain versions on the
    CPU. Returns [B, Do, Ho, Wo, C_out] in ``dtype`` (default x.dtype).
    Gate with ``should_im2col`` first, as ``UnfoldedConv`` does."""
    dt = dtype or x.dtype
    strides = tuple(int(s) for s in strides)
    padding = tuple(int(p) for p in padding)
    _geometry(x, kernel.shape[:3], strides, padding)
    return _StemConv.apply(x.device.type == "cpu", x, kernel, strides,
                           padding, dt)
