"""The channels-last convs of the CNN backbones (port of
vsn_tpu/ops/conv_unfold.py ``UnfoldedConv`` and ``DepthwiseConv``).

``UnfoldedConv``: a bias-free conv with the parameter of a plain one
(``weight`` [C_out, C_in, kd, kh, kw], the torch layout of the JAX
``kernel``). Where ``should_im2col`` holds (the ResNet 7^3 stem on one input
channel) it runs ``ops/stem_im2col.stem_conv_im2col``, K5f/K5w on the card;
otherwise a plain conv (``conv3d_channels_last``), as MedViT's 3^3 stem
takes (27 taps, under the gate's 64). There is no environment switch: the
JAX package's VSN_STEM_IM2COL exists to pick a platform, and the port's
wrappers pick by device.

``DepthwiseConv``: the bias-free depthwise conv of MedViT's
LocalityFeedForward (JAX param DHWIO [k, k, k, 1, C]; here ``weight`` [C,
1, k, k, k], feature groups C, SAME padding), a plain grouped conv, the
JAX package's default. Not carried: its shift-FMA form (VSN_DW_SHIFT,
refuted on the TPU, conv_unfold.py:222-231) and ``tap_unfolded_conv`` (XLA
code, opt-in only, compile-OOM at production size, :26-32).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from vsn_tpu_torch.ops.stem_im2col import should_im2col, stem_conv_im2col


def conv3d_channels_last(x, weight, stride=1, padding=0, groups: int = 1,
                         dtype: torch.dtype = torch.float32):
    """A bias-free conv on [B, D, H, W, C_in] -> [B, Do, Ho, Wo, C_out] in
    ``dtype`` (flax nn.Conv(dtype=...): x and the f32 kernel cast to it).
    On the card cuDNN convolves in ``dtype`` on the channels-last view (its
    accumulation is f32), but a depthwise conv (groups = C_in = C_out) on a
    contiguous [B, C, D, H, W] copy: cuDNN ran the channels-last one a
    launch per group (bf16, MedViT-S's stage-1 LFF, [8, 288, 36, 42, 36]:
    398.3 ms forward and backward against 11.2 ms on the copy on an H100,
    ``python -m vsn_tpu_torch.probes.conv_layouts``). On
    the CPU the ``dtype``-rounded operands are convolved in (at least) f32
    and rounded once, since PyTorch's CPU bf16 conv3d returned NaN from
    finite inputs at small extents (models/resnet3d.py Conv3d)."""
    x, w = x.to(dtype).permute(0, 4, 1, 2, 3), weight.to(dtype)
    if x.is_cuda:
        if groups == x.shape[1] == w.shape[0]:
            y = F.conv3d(x.contiguous(), w, stride=stride, padding=padding,
                         groups=groups)
            return y.permute(0, 2, 3, 4, 1).contiguous()
        w = w.contiguous(memory_format=torch.channels_last_3d)
        y = F.conv3d(x, w, stride=stride, padding=padding, groups=groups)
    else:
        acc = torch.promote_types(dtype, torch.float32)
        y = F.conv3d(x.to(acc), w.to(acc), stride=stride, padding=padding,
                     groups=groups).to(dtype)
    return y.permute(0, 2, 3, 4, 1)


class UnfoldedConv(nn.Conv3d):
    """Bias-free conv on [B, D, H, W, C_in] -> [B, Do, Ho, Wo, C_out] (the
    JAX layout), computed in ``dtype`` with f32 parameters."""

    def __init__(self, in_channels: int, features: int, kernel_size,
                 strides, padding, dtype: torch.dtype = torch.float32):
        super().__init__(in_channels, features, tuple(kernel_size),
                         stride=tuple(strides), padding=tuple(padding),
                         bias=False)
        self.dtype = dtype

    def forward(self, x):
        if should_im2col(self.stride, self.kernel_size, self.padding,
                         x.shape[-1]):
            return stem_conv_im2col(x, self.weight.permute(2, 3, 4, 1, 0),
                                    self.stride, self.padding, self.dtype)
        return conv3d_channels_last(x, self.weight, self.stride,
                                    self.padding, dtype=self.dtype)


class DepthwiseConv(nn.Conv3d):
    """Bias-free depthwise conv (feature groups = C, stride 1, SAME
    padding) on [B, D, H, W, C] in ``dtype`` with f32 parameters."""

    def __init__(self, channels: int, kernel_size,
                 dtype: torch.dtype = torch.float32):
        kernel_size = tuple(kernel_size)
        super().__init__(channels, channels, kernel_size,
                         padding=tuple(k // 2 for k in kernel_size),
                         groups=channels, bias=False)
        self.dtype = dtype

    def forward(self, x):
        return conv3d_channels_last(x, self.weight, 1, self.padding,
                                    self.groups, self.dtype)
