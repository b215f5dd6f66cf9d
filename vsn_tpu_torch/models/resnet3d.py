"""3-D ResNet (port of vsn_tpu/models/resnet3d.py).

The 7^3 stem conv with stride (1, 2, 2) runs through ``UnfoldedConv``, so K5f
forward and K5w weight gradient on the card; then BatchNorm + ReLU, a 3^3
stride-2 max-pool, four stages of BasicBlock3D or Bottleneck3D with shortcut
type A (strided slice + zero channel padding) or B (1^3 conv + BN), a mean
pool over every spatial axis, head dropout and an f32 linear head. The convs
after the stem, the max-pool and the BatchNorm arithmetic are plain PyTorch
(cuDNN), as the JAX package leaves them to XLA.

Layout: the input is [B, D, H, W, C] as in JAX; the stem's output
[B, Do, Ho, Wo, 64] is viewed as [B, 64, Do, Ho, Wo] in channels_last_3d
memory, the layout cuDNN's channels-last kernels take, and stays so.

BatchNorm follows flax's ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)``
(resnet3d.py:40-47), not torch's: training normalizes with the biased batch
variance mean(x^2) - mean^2 (clamped at 0) computed in f32, and updates the
running statistics with that same biased variance, 0.9 * ra + 0.1 * batch;
the normalization is in f32 and cast once to the activation dtype.
``torch.nn.BatchNorm3d`` keeps the unbiased variance, so the statistics are
computed here and the buffers updated in place (they may be views of the
train state's flat statistics buffer).

Names follow the reference state_dict that scripts/golden_parity.py
``port_resnet`` reads: ``resnet.conv1.weight``, ``resnet.bn1.{weight, bias,
running_mean, running_var}``, ``resnet.layer{i}.{j}.conv1.weight``,
``....downsample.{0, 1}``, ``resnet.fc``.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from vsn_tpu_torch.models.layers import trunc_normal_
from vsn_tpu_torch.ops.conv_unfold import UnfoldedConv

BN_MOMENTUM = 0.9
BN_EPS = 1e-5

# layers per stage of each variant (vsn_tpu/models/resnet3d.py:29-37)
RESNET_LAYERS = {
    "resnet10": ("basic", [1, 1, 1, 1]),
    "resnet18": ("basic", [2, 2, 2, 2]),
    "resnet34": ("basic", [3, 4, 6, 3]),
    "resnet50": ("bottleneck", [3, 4, 6, 3]),
    "resnet101": ("bottleneck", [3, 4, 23, 3]),
    "resnet152": ("bottleneck", [3, 8, 36, 3]),
    "resnet200": ("bottleneck", [3, 24, 36, 3]),
}


def _stat_dtype(dtype):
    return torch.promote_types(dtype, torch.float32)


class BatchNorm(nn.Module):
    """flax BatchNorm over dim 1 of [B, C, ...] (module docstring)."""

    def __init__(self, num_features: int, dtype: torch.dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.dtype = dtype

    def forward(self, x):
        x32 = x.to(_stat_dtype(x.dtype))
        if self.training:
            dims = (0, *range(2, x.ndim))
            mean = x32.mean(dims)
            var = torch.clamp((x32 * x32).mean(dims) - mean * mean, min=0.0)
            with torch.no_grad():
                m = BN_MOMENTUM
                self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        shape = (1, -1) + (1,) * (x.ndim - 2)
        mul = torch.rsqrt(var + BN_EPS) * self.weight
        y = (x32 - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)
        return y.to(self.dtype)


class Conv3d(nn.Conv3d):
    """Bias-free conv on [B, C, D, H, W] computed in ``dtype`` (f32
    parameters): on the card by cuDNN in ``dtype``, channels-last as its
    input is; on the CPU on the ``dtype``-rounded operands in (at least)
    f32, rounded once, because PyTorch's CPU bf16 conv returned NaN from
    finite inputs at small extents (a [2, 256, 2, 2, 1] output), varying
    from run to run."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int,
                 stride: int = 1, padding: int = 0,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_channels, out_channels, kernel, stride=stride,
                         padding=padding, bias=False)
        self.dtype = dtype

    def forward(self, x):
        x, w = x.to(self.dtype), self.weight.to(self.dtype)
        if x.is_cuda:
            w = w.contiguous(memory_format=torch.channels_last_3d)
            return F.conv3d(x, w, stride=self.stride, padding=self.padding)
        acc = _stat_dtype(self.dtype)
        return F.conv3d(x.to(acc), w.to(acc), stride=self.stride,
                        padding=self.padding).to(self.dtype)


def shortcut(x, out_planes: int, stride: int, kind: str, downsample=None):
    """Type A: strided identity + zero channel padding (reference
    downsample_basic_block); type B: ``downsample`` (1^3 conv + BN)."""
    if kind == "A":
        y = x[:, :, ::stride, ::stride, ::stride] if stride > 1 else x
        pad = out_planes - y.shape[1]
        return F.pad(y, (0, 0, 0, 0, 0, 0, 0, pad)) if pad > 0 else y
    return downsample(x)


class _Block(nn.Module):
    expansion = 1

    def _shortcut_modules(self, inplanes, out_planes, stride, shortcut_type,
                          needs_projection, dtype):
        self.out_planes, self.stride = out_planes, stride
        self.shortcut_type = shortcut_type
        self.needs_projection = needs_projection
        self.downsample = (
            nn.Sequential(Conv3d(inplanes, out_planes, 1, stride, 0, dtype),
                          BatchNorm(out_planes, dtype))
            if needs_projection and shortcut_type == "B" else None)

    def residual(self, x):
        if not self.needs_projection:
            return x
        return shortcut(x, self.out_planes, self.stride, self.shortcut_type,
                        self.downsample)


class BasicBlock3D(_Block):
    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 shortcut_type: str = "B", needs_projection: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = Conv3d(inplanes, planes, 3, stride, 1, dtype)
        self.bn1 = BatchNorm(planes, dtype)
        self.conv2 = Conv3d(planes, planes, 3, 1, 1, dtype)
        self.bn2 = BatchNorm(planes, dtype)
        self._shortcut_modules(inplanes, planes, stride, shortcut_type,
                               needs_projection, dtype)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        return F.relu(y + self.residual(x))


class Bottleneck3D(_Block):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 shortcut_type: str = "B", needs_projection: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = Conv3d(inplanes, planes, 1, 1, 0, dtype)
        self.bn1 = BatchNorm(planes, dtype)
        self.conv2 = Conv3d(planes, planes, 3, stride, 1, dtype)
        self.bn2 = BatchNorm(planes, dtype)
        self.conv3 = Conv3d(planes, planes * 4, 1, 1, 0, dtype)
        self.bn3 = BatchNorm(planes * 4, dtype)
        self._shortcut_modules(inplanes, planes * 4, stride, shortcut_type,
                               needs_projection, dtype)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return F.relu(y + self.residual(x))


class ResNet3D(nn.Module):
    def __init__(self, block: str, layers: Sequence[int], num_classes: int,
                 shortcut_type: str = "B", in_channels: int = 1,
                 head_dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        block_cls = BasicBlock3D if block == "basic" else Bottleneck3D
        self.dtype, self.head_dropout = dtype, float(head_dropout)
        trunk = {"conv1": UnfoldedConv(in_channels, 64, (7, 7, 7), (1, 2, 2),
                                       (3, 3, 3), dtype),
                 "bn1": BatchNorm(64, dtype)}
        inplanes = 64
        for i, (planes, blocks) in enumerate(zip((64, 128, 256, 512), layers)):
            stride = 1 if i == 0 else 2
            stage = []
            for j in range(blocks):
                s = stride if j == 0 else 1
                needs_proj = j == 0 and (
                    s != 1 or inplanes != planes * block_cls.expansion)
                stage.append(block_cls(inplanes, planes, s, shortcut_type,
                                       needs_proj, dtype))
                inplanes = planes * block_cls.expansion
            trunk[f"layer{i + 1}"] = nn.Sequential(*stage)
        self.num_features = inplanes
        trunk["fc"] = nn.Linear(inplanes, num_classes)
        self.resnet = nn.ModuleDict(trunk)

    def draw(self, b: int, device, generator):
        """The head-dropout keep mask [B, F] (bool) of one training forward,
        the form ``forward(draws=)`` takes."""
        return torch.rand((b, self.num_features), generator=generator,
                          device=device) < 1.0 - self.head_dropout

    def forward(self, x, draws=None, generator=None):
        """Logits of x [B, D, H, W, C]. In training mode (``self.training``)
        BatchNorm uses and updates batch statistics and head dropout keeps
        each feature with p = 1 - DROPOUT, scaling by 1 / p (flax Dropout),
        by the mask ``draws`` or one drawn from ``generator``."""
        r = self.resnet
        x = r.conv1(x.to(self.dtype)).permute(0, 4, 1, 2, 3)
        x = F.relu(r.bn1(x))
        x = F.max_pool3d(x, 3, stride=2, padding=1)
        for i in range(1, 5):
            x = r[f"layer{i}"](x)
        x = x.to(_stat_dtype(x.dtype)).mean(dim=(2, 3, 4)).to(self.dtype)
        if self.training and self.head_dropout > 0.0:
            if draws is None:
                if generator is None:
                    raise ValueError("a training forward with head dropout "
                                     "needs a generator or injected draws")
                draws = self.draw(x.shape[0], x.device, generator)
            keep = 1.0 - self.head_dropout
            x = torch.where(draws, x / keep, torch.zeros((), dtype=x.dtype,
                                                         device=x.device))
        fc = r.fc  # in f32 whatever the parameters' type (flax Dense, f32)
        return F.linear(x.float(), fc.weight.float(), fc.bias.float())


def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Initialize as the JAX package does: conv kernels variance-scaling 2.0
    over fan_out, normal (resnet3d.py:26); BatchNorm scale 1, shift 0,
    statistics 0 and 1; the head LeCun normal (truncated at 2 std) with a
    zero bias (flax Dense's defaults). Draws on the CPU from ``generator``,
    whatever the model's device."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv3d):
                fan_out = m.weight.shape[0] * math.prod(m.weight.shape[2:])
                w = torch.randn(m.weight.shape, generator=generator)
                m.weight.copy_(w * math.sqrt(2.0 / fan_out))
            elif isinstance(m, BatchNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
            elif isinstance(m, nn.Linear):
                std = math.sqrt(1.0 / m.weight.shape[1]) / .87962566103423978
                trunc_normal_(m.weight, std, generator)
                m.bias.zero_()
    return model


def resnet_from_config(cfg, dtype=torch.float32, variant: str | None = None):
    """ResNet3DMedical equivalent (resnet3d.py:180-198): the variant from
    RESNET_VARIANT (default resnet18), shortcut B, head dropout DROPOUT."""
    variant = variant or cfg.get("RESNET_VARIANT", "resnet18")
    block, layers = RESNET_LAYERS[variant]
    return ResNet3D(block=block, layers=layers, num_classes=cfg.num_classes,
                    shortcut_type="B",
                    in_channels=int(cfg.get("IN_CHANNELS", 1)),
                    head_dropout=float(cfg.DROPOUT), dtype=dtype)
