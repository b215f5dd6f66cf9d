"""``UnfoldedConv``: the stem conv of the CNN backbones (port of
vsn_tpu/ops/conv_unfold.py UnfoldedConv).

A bias-free conv with the parameter of a plain one (``weight``
[C_out, C_in, kd, kh, kw], the torch layout of the JAX ``kernel``). Where
``should_im2col`` holds (the ResNet 7^3 stem on one input channel) it runs
``ops/stem_im2col.stem_conv_im2col``, K5f/K5w on the card; otherwise a plain
conv. There is no environment switch: the JAX package's VSN_STEM_IM2COL
exists to pick a platform, and the port's wrappers pick by device.

Not carried: ``tap_unfolded_conv`` (XLA code, opt-in only, compile-OOM at
production size, conv_unfold.py:26-32) and ``DepthwiseConv`` (with MedViT).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from vsn_tpu_torch.ops.stem_im2col import should_im2col, stem_conv_im2col


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
        # the dtype-rounded operands convolved in (at least) f32 and rounded
        # once, as the models' Conv3d does on the CPU
        acc = torch.promote_types(self.dtype, torch.float32)
        y = F.conv3d(x.to(self.dtype).to(acc).permute(0, 4, 1, 2, 3),
                     self.weight.to(self.dtype).to(acc), stride=self.stride,
                     padding=self.padding)
        return y.permute(0, 2, 3, 4, 1).to(self.dtype)
