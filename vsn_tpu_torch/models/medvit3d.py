"""MedViT V1 3D (port of vsn_tpu/models/medvit3d.py): a hybrid
conv / transformer classifier.

Channels-last [B, D, H, W, C] end to end, as the JAX package: a 4-conv stem
(ConvBNReLU, strides 2, 1, 1, 2), then stages of ECB (Efficient Convolution
Block: PatchEmbedAvg -> BN -> MHCA -> residual -> BN -> LocalityFeedForward
-> residual) and LTB (Local Transformer Block: PatchEmbedAvg -> BN -> E-MHSA
on the flattened tokens -> residual; a 1x1 projection -> MHCA -> residual;
the channel concat -> BN -> LocalityFeedForward -> residual), BatchNorm,
the spatial mean and an f32 linear head. Stage pattern
(vsn_tpu/models/medvit3d.py:437-451): stage 1 ECB x d0; stage 2 ECB x (d1 -
1) + LTB; stage 3 (ECB x 4 + LTB) x (d2 / 5); stage 4 ECB x (d3 - 1) + LTB.

No TPU kernel lies on this path: the JAX package computes MedViT in XLA
(its 3^3 stem has 27 taps, under the 64 that ``should_im2col`` needs, so
``UnfoldedConv`` takes the plain conv). The port's counterparts are plain
PyTorch: cuDNN convs in the activation dtype on the channels-last views
(``ops/conv_unfold.conv3d_channels_last``; the grouped MHCA conv and the
depthwise conv, ``conv_unfold.DepthwiseConv``, too), the 1x1 convs as
Linears over the channels, and ``layers.softmax_attention`` for E-MHSA.

BatchNorm is the ResNet slice's (``resnet3d.BatchNorm``, flax semantics:
momentum 0.9, the biased variance in f32, one cast, eps 1e-5) over the last
dim, the channels, here, and over the tokens' channels [B, M, C] in
E-MHSA's ``sr_norm``. E-MHSA flattens the tokens in (d, h, w) row-major
order; its KV reduction averages consecutive groups of r = sr^2 tokens and
drops the last n mod r (:279-281). ``avg_pool_ceil`` is ceil mode and
averages only the valid voxels.

The residual decorations are ``layers.ResidualBranch``'s (:237-279):
LayerScale, then ShakeDrop or DropPath gains (per sample, broadcast over
the channels last), then lam * x + beta * branch under DeepScaleLM
(``compute_residual_gains`` of the total depth; beta folded into the gains,
as the other models fold it) or x + branch; LTB's E-MHSA and MHCA residuals
take the block's rate times mix_block_ratio and times 1 - mix_block_ratio.
In training the gains and the E-MHSA dropouts' keep masks are drawn from a
``torch.Generator`` or injected (``draw_plan``, ``draw``), as the other
models' are.

Parameters carry the names of the reference state_dict as
scripts/golden_parity_medvit.py ``port_medvit_full`` reads them:
``stem.{i}.conv`` / ``.norm``; ``features.{f}.patch_embed.{conv, norm}``,
``norm1``, ``norm2``, ``mhca.{group_conv3x3, norm, projection}``, the
LocalityFeedForward as ``conv.conv.{0, 1, 3, 4, 6.fc.0, 6.fc.2, 7, 8}``
(expand, BN, depthwise, BN, SE, project, BN), and in an LTB ``e_mhsa.{q,
k, v, proj, norm}`` and ``projection.{conv, norm}``; ``norm`` and
``proj_head.0``; LayerScale gammas as ``features.{f}.{res1, res2,
res_mhsa, res_mhca, res_ffn}.gamma`` (the JAX tree's
``.../LayerScale_0/gamma``). They stay f32; with FP16 the activations are
bf16.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from vsn_tpu_torch.models.layers import (
    LayerScale,
    RandomDraws,
    dropout,
    gated_residual,
    linear,
    residual_branch_gains,
    softmax_attention,
    stochastic_depth_rates,
    trunc_normal_,
)
from vsn_tpu_torch.models.resnet3d import BatchNorm
from vsn_tpu_torch.ops.conv_unfold import (
    DepthwiseConv,
    UnfoldedConv,
    conv3d_channels_last,
)
from vsn_tpu_torch.ops.stable_init import compute_residual_gains

def make_divisible(v: float, divisor: int, min_value: int | None = None) -> int:
    """Round to a multiple of divisor without dropping below 90% of v
    (reference medvit_utils.py:91-110)."""
    if min_value is None:
        min_value = divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


def h_sigmoid(x):
    return torch.clamp(x + 3.0, 0.0, 6.0) / 6.0


def h_swish(x):
    return x * h_sigmoid(x)


class HSwish(nn.Module):
    def forward(self, x):
        return h_swish(x)


def batch_norm(channels: int, dtype: torch.dtype) -> BatchNorm:
    """flax nn.BatchNorm(momentum=0.9, epsilon=1e-5) over the last dim."""
    return BatchNorm(channels, dtype, axis=-1)


def avg_pool_ceil(x, strides):
    """AvgPool3d(kernel = stride, ceil_mode=True, count_include_pad=False)
    on [B, D, H, W, C]: the spatial dims zero-padded up to a stride
    multiple, each window's sum over the count of its valid voxels
    (vsn_tpu/models/medvit3d.py:74-96)."""
    b, d, h, w, c = x.shape
    sd, sh, sw = strides
    pads = [(s - n % s) % s for n, s in zip((d, h, w), strides)]
    ones = None
    if any(pads):
        pad = (0, 0, 0, pads[2], 0, pads[1], 0, pads[0])
        x = F.pad(x, pad)
        ones = F.pad(torch.ones((1, d, h, w, 1), dtype=x.dtype,
                                device=x.device), pad)
    dp, hp, wp = x.shape[1:4]
    grid = (dp // sd, sd, hp // sh, sh, wp // sw, sw)
    summed = x.reshape(b, *grid, c).sum(dim=(2, 4, 6))
    if ones is None:
        return summed / (sd * sh * sw)
    return summed / ones.reshape(1, *grid, 1).sum(dim=(2, 4, 6))


class Conv(nn.Conv3d):
    """flax nn.Conv(use_bias=False, padding k // 2) on [B, D, H, W, C] in
    ``dtype`` with f32 parameters (``conv3d_channels_last``); a 1x1x1 conv
    is the Linear over the channels that it equals."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int = 1,
                 stride: int = 1, groups: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_channels, out_channels, kernel, stride=stride,
                         padding=kernel // 2, groups=groups, bias=False)
        self.dtype = dtype

    def forward(self, x):
        if self.kernel_size == (1, 1, 1) and self.stride == (1, 1, 1):
            return F.linear(x.to(self.dtype),
                            self.weight.to(self.dtype).flatten(1))
        return conv3d_channels_last(x, self.weight, self.stride,
                                    self.padding, self.groups, self.dtype)


class ConvBNReLU(nn.Module):
    """Conv3d + BN + ReLU (medvit3d.py:99-131): ``UnfoldedConv`` (the plain
    conv at MedViT's 3^3 stem) where groups is 1, a grouped conv else."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 3,
                 stride: int = 1, groups: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        k = kernel_size
        self.conv = (UnfoldedConv(in_channels, features, (k,) * 3,
                                  (stride,) * 3, (k // 2,) * 3, dtype)
                     if groups == 1 else
                     Conv(in_channels, features, k, stride, groups, dtype))
        self.norm = batch_norm(features, dtype)

    def forward(self, x):
        return F.relu(self.norm(self.conv(x)))


class PatchEmbedAvg(nn.Module):
    """Ceil-mode average-pool downsample + 1x1 conv + BN where the stride or
    the width changes, else the identity (medvit3d.py:134-153)."""

    def __init__(self, in_channels: int, features: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.stride = stride
        self.conv = self.norm = None
        if stride > 1 or in_channels != features:
            self.conv = Conv(in_channels, features, 1, dtype=dtype)
            self.norm = batch_norm(features, dtype)

    def forward(self, x):
        if self.stride > 1:
            x = avg_pool_ceil(x, (self.stride,) * 3)
        if self.conv is not None:
            x = self.norm(self.conv(x))
        return x


class MHCA(nn.Module):
    """Multi-Head Convolutional Attention (medvit3d.py:156-177): a 3^3 conv
    in C // head_dim groups + BN + ReLU + 1x1 projection."""

    def __init__(self, channels: int, head_dim: int = 32,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.group_conv3x3 = Conv(channels, channels, 3,
                                  groups=channels // head_dim, dtype=dtype)
        self.norm = batch_norm(channels, dtype)
        self.projection = Conv(channels, channels, 1, dtype=dtype)

    def forward(self, x):
        return self.projection(F.relu(self.norm(self.group_conv3x3(x))))


class SELayer(nn.Module):
    """Squeeze-excitation with a hard-sigmoid gate (medvit3d.py:180-194):
    the spatial mean, ``fc`` (Linear, ReLU, Linear; the reference's fc.0
    and fc.2), h_sigmoid, times x."""

    def __init__(self, channels: int, reduction: int = 4):
        super().__init__()
        hidden = max(1, channels // reduction)
        self.fc = nn.Sequential(nn.Linear(channels, hidden), nn.ReLU(),
                                nn.Linear(hidden, channels))

    def forward(self, x):
        fc1, _, fc2 = self.fc
        y = x.mean(dim=(1, 2, 3))
        y = h_sigmoid(linear(F.relu(linear(y, fc1)), fc2))
        return x * y[:, None, None, None, :]


class ECALayer(nn.Module):
    """Efficient channel attention (medvit3d.py:197-216): a 1-D conv of
    width k (from the channel count) over the pooled channel descriptor,
    then a sigmoid (or hard-sigmoid) gate. ``conv.weight`` [1, 1, k] is the
    torch layout of the JAX kernel [k, 1, 1]. MedViT3D does not call it."""

    def __init__(self, channels: int, gamma: int = 2, b: int = 1,
                 sigmoid_type: str = "sigmoid",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        t = int(abs((math.log2(channels) + b) / gamma))
        k = t if t % 2 else t + 1
        self.conv = nn.Conv1d(1, 1, k, padding=k // 2, bias=False)
        self.sigmoid_type, self.dtype = sigmoid_type, dtype

    def forward(self, x):
        y = x.mean(dim=(1, 2, 3)).to(self.dtype)[:, None, :]   # [B, 1, C]
        y = F.conv1d(y, self.conv.weight.to(self.dtype),
                     padding=self.conv.padding)[:, 0]
        gate = torch.sigmoid(y) if self.sigmoid_type == "sigmoid" \
            else h_sigmoid(y)
        return x * gate[:, None, None, None, :]


class LocalityFeedForward(nn.Module):
    """Inverted-residual FFN (medvit3d.py:219-250): ``conv`` = 1x1 expand
    -> BN -> h_swish -> depthwise 3^3 -> BN -> h_swish -> SE -> 1x1 project
    -> BN, added to its input."""

    def __init__(self, channels: int, expand_ratio: float = 4.0,
                 reduction: int = 4, dtype: torch.dtype = torch.float32):
        super().__init__()
        hidden = int(channels * expand_ratio)
        self.conv = nn.Sequential(
            Conv(channels, hidden, 1, dtype=dtype), batch_norm(hidden, dtype),
            HSwish(), DepthwiseConv(hidden, (3, 3, 3), dtype),
            batch_norm(hidden, dtype), HSwish(),
            SELayer(hidden, reduction),
            Conv(hidden, channels, 1, dtype=dtype),
            batch_norm(channels, dtype))

    def forward(self, x):
        return x + self.conv(x)


class EMHSA(nn.Module):
    """Efficient multi-head self-attention on tokens [B, N, C]
    (medvit3d.py:253-307): q from every token, k and v from the tokens
    averaged in consecutive groups of r = sr_ratio^2 (the last n mod r
    dropped) and batch-normed (``norm``, the JAX ``sr_norm``) where sr_ratio
    > 1; ``softmax_attention`` with dropout on the probabilities; proj and
    its dropout."""

    def __init__(self, dim: int, head_dim: int = 32, sr_ratio: int = 1,
                 qkv_bias: bool = True, attention_dropout: float = 0.0,
                 proj_drop: float = 0.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.head_dim, self.sr_ratio = head_dim, sr_ratio
        self.num_heads = dim // head_dim
        self.scale = head_dim ** -0.5
        self.attention_dropout, self.proj_drop = attention_dropout, proj_drop
        self.q = nn.Linear(dim, dim, bias=qkv_bias)
        self.k = nn.Linear(dim, dim, bias=qkv_bias)
        self.v = nn.Linear(dim, dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)
        self.norm = batch_norm(dim, dtype) if sr_ratio > 1 else None

    def reduced(self, n: int) -> int:
        """The number of key / value tokens of n tokens."""
        return n // self.sr_ratio ** 2 if self.sr_ratio > 1 else n

    def forward(self, x, masks=(None, None)):
        b, n, c = x.shape
        heads, d = self.num_heads, self.head_dim

        def split(t):
            return t.reshape(b, -1, heads, d).transpose(1, 2)

        kv = x
        if self.sr_ratio > 1:
            r = self.sr_ratio ** 2
            m = n // r
            kv = self.norm(x[:, :m * r].reshape(b, m, r, c).mean(dim=2))
        out = softmax_attention(split(linear(x, self.q)),
                                split(linear(kv, self.k)),
                                split(linear(kv, self.v)), self.scale,
                                rate=self.attention_dropout, mask=masks[0])
        out = out.transpose(1, 2).reshape(b, n, c).to(x.dtype)
        return dropout(linear(out, self.proj), self.proj_drop, masks[1])


class _Block(nn.Module):
    """The residual of an ECB / LTB (``layers.ResidualBranch``'s order):
    branch -> [LayerScale] -> lam * x + gains * branch."""

    def _residual(self, x, branch, name, gains):
        scale = getattr(self, name)
        if scale is not None:
            branch = scale(branch)
        gf, gb = gains[name]
        return gated_residual(x, branch, gf, gb, self.lam)

    def _scales(self, names_dims, layer_scale, init_value):
        for name, dim in names_dims:
            setattr(self, name, LayerScale(dim, init_value) if layer_scale
                    else None)


class ECB(_Block):
    """Efficient Convolution Block (medvit3d.py:310-348). ``residuals``
    names its residuals and their stochastic-depth rates."""

    def __init__(self, in_channels: int, out_channels: int, stride: int = 1,
                 drop_path_rate: float = 0.0, head_dim: int = 32,
                 mlp_ratio: float = 3.0, layer_scale: bool = False,
                 layer_scale_init_value: float = 1e-5, lam: float = 1.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.lam = lam
        self.patch_embed = PatchEmbedAvg(in_channels, out_channels, stride,
                                         dtype)
        self.norm1 = batch_norm(out_channels, dtype)
        self.mhca = MHCA(out_channels, head_dim, dtype)
        self.norm2 = batch_norm(out_channels, dtype)
        # the reference feeds norm2(x) to the LFF, whose own residual adds
        # norm2(x); the block's residual then adds x (medvit3d.py:337-346)
        self.conv = LocalityFeedForward(out_channels, mlp_ratio, out_channels,
                                        dtype)
        self._scales((("res1", out_channels), ("res2", out_channels)),
                     layer_scale, layer_scale_init_value)
        self.residuals = {"res1": drop_path_rate, "res2": drop_path_rate}

    def forward(self, x, gains, masks=None):
        x = self.patch_embed(x)
        x = self._residual(x, self.mhca(self.norm1(x)), "res1", gains)
        return self._residual(x, self.conv(self.norm2(x)), "res2", gains)


class LTB(_Block):
    """Local Transformer Block (medvit3d.py:351-418): E-MHSA on
    make_divisible(out * mix_block_ratio, 32) channels, MHCA on the rest,
    concatenated, then the LFF."""

    def __init__(self, in_channels: int, out_channels: int, stride: int = 1,
                 sr_ratio: int = 1, drop_path_rate: float = 0.0,
                 head_dim: int = 32, mlp_ratio: float = 2.0,
                 mix_block_ratio: float = 0.75,
                 attention_dropout: float = 0.0, dropout: float = 0.0,
                 layer_scale: bool = False,
                 layer_scale_init_value: float = 1e-5, lam: float = 1.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        mhsa = make_divisible(int(out_channels * mix_block_ratio), 32)
        mhca = out_channels - mhsa
        if mhca <= 0:
            raise ValueError(
                f"LTB out_channels={out_channels} leaves no MHCA branch "
                f"(mhsa={mhsa}); pick channels whose "
                f"make_divisible(c*{mix_block_ratio}, 32) < c")
        self.lam, self.mhsa_channels = lam, mhsa
        self.patch_embed = PatchEmbedAvg(in_channels, mhsa, stride, dtype)
        self.norm1 = batch_norm(mhsa, dtype)
        self.e_mhsa = EMHSA(mhsa, head_dim, sr_ratio,
                            attention_dropout=attention_dropout,
                            proj_drop=dropout, dtype=dtype)
        self.projection = PatchEmbedAvg(mhsa, mhca, 1, dtype)
        self.mhca = MHCA(mhca, head_dim, dtype)
        self.norm2 = batch_norm(out_channels, dtype)
        self.conv = LocalityFeedForward(out_channels, mlp_ratio, out_channels,
                                        dtype)
        self._scales((("res_mhsa", mhsa), ("res_mhca", mhca),
                      ("res_ffn", out_channels)), layer_scale,
                     layer_scale_init_value)
        self.residuals = {"res_mhsa": drop_path_rate * mix_block_ratio,
                          "res_mhca": drop_path_rate * (1 - mix_block_ratio),
                          "res_ffn": drop_path_rate}

    def forward(self, x, gains, masks=(None, None)):
        x = self.patch_embed(x)
        b, d, h, w, c = x.shape
        tokens = self.norm1(x).reshape(b, d * h * w, c)
        mhsa = self.e_mhsa(tokens, masks).reshape(b, d, h, w, c)
        x = self._residual(x, mhsa, "res_mhsa", gains)
        out = self.projection(x)
        out = self._residual(out, self.mhca(out), "res_mhca", gains)
        x = torch.cat([x, out], dim=-1)
        return self._residual(x, self.conv(self.norm2(x)), "res_ffn", gains)


def stage_plan(depths: Sequence[int], dims: Sequence[int]):
    """[(stage, block, kind, out_channels)] of every block in order
    (medvit3d.py:437-451)."""
    if depths[2] % 5 != 0:
        raise ValueError("depths[2] must be a multiple of 5 (stage-3 pattern)")
    channels = [
        [dims[0]] * depths[0],
        [dims[1]] * (depths[1] - 1) + [dims[2]],
        [dims[3], dims[3], dims[3], dims[3], dims[4]] * (depths[2] // 5),
        [dims[5]] * depths[3],
    ]
    kinds = [
        ["ECB"] * depths[0],
        ["ECB"] * (depths[1] - 1) + ["LTB"],
        ["ECB", "ECB", "ECB", "ECB", "LTB"] * (depths[2] // 5),
        ["ECB"] * (depths[3] - 1) + ["LTB"],
    ]
    return [(s, j, kinds[s][j], channels[s][j])
            for s, depth in enumerate(depths) for j in range(depth)]


def block_names(depths: Sequence[int]) -> list[str]:
    """The JAX tree's block names in order, ``s{stage}_b{block}_{ecb|ltb}``
    (the reference's ``features.{f}`` is the f-th)."""
    return [f"s{s}_b{j}_{kind.lower()}"
            for s, j, kind, _ in stage_plan(depths, [0, 0, 0, 0, 0, 0])]


class MedViT3D(RandomDraws, nn.Module):
    """MedViT V1 classifier (medvit3d.py:421-528). Input [B, D, H, W, C_in];
    output f32 logits [B, num_classes]. ``img_size``, the input's spatial
    size, is needed only to shape E-MHSA's dropout keep masks (training
    with ATTENTION_DROPOUT or DROPOUT > 0); a model given one checks its
    input against it."""

    def __init__(self, num_classes: int, stem_chs=(64, 32, 64),
                 depths=(3, 4, 10, 3), dims=(96, 192, 256, 384, 512, 768),
                 strides=(1, 2, 2, 2), sr_ratios=(8, 4, 2, 1),
                 head_dim: int = 32, mlp_ratio: float = 3.0,
                 mix_block_ratio: float = 0.75,
                 stochastic_depth_prob: float = 0.1,
                 attention_dropout: float = 0.0, dropout: float = 0.0,
                 enable_stable: bool = False, stable_k: float = 2.0,
                 stable_alpha: float = 1.0, use_shakedrop: bool = False,
                 shakedrop_alpha_range=(-1.0, 1.0), layer_scale: bool = False,
                 layer_scale_init_value: float = 1e-5, in_channels: int = 1,
                 img_size=None, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype, self.depths = dtype, tuple(depths)
        self.img_size = None if img_size is None else tuple(img_size)
        self.dropout, self.attention_dropout = dropout, attention_dropout
        self.use_shakedrop = use_shakedrop
        self.alpha_range = tuple(shakedrop_alpha_range)
        # DeepScaleLM (medvit3d.py:456-468): (lam, beta) from the total depth
        self.enable_stable = enable_stable
        self.lam, self.beta = (compute_residual_gains(
            sum(depths), stable_k, stable_alpha) if enable_stable
            else (1.0, 1.0))
        stem = [stem_chs[0], stem_chs[1], stem_chs[2], stem_chs[2]]
        self.stem = nn.Sequential(*(
            ConvBNReLU(c_in, c_out, 3, s, dtype=dtype) for c_in, c_out, s in
            zip([in_channels] + stem[:3], stem, (2, 1, 1, 2))))
        rates = stochastic_depth_rates(stochastic_depth_prob, depths)
        residual = dict(layer_scale=layer_scale,
                        layer_scale_init_value=layer_scale_init_value,
                        lam=self.lam, dtype=dtype)
        self.features = nn.ModuleList()
        c_in = stem_chs[2]
        for idx, (s, j, kind, out) in enumerate(stage_plan(depths, dims)):
            stride = 2 if strides[s] == 2 and j == 0 else 1
            common = dict(stride=stride, drop_path_rate=rates[idx],
                          head_dim=head_dim, mlp_ratio=mlp_ratio, **residual)
            if kind == "ECB":
                block = ECB(c_in, out, **common)
            else:
                block = LTB(c_in, out, sr_ratio=sr_ratios[s],
                            mix_block_ratio=mix_block_ratio,
                            attention_dropout=attention_dropout,
                            dropout=dropout, **common)
            self.features.append(block)
            c_in = out
        self.norm = batch_norm(c_in, dtype)
        self.proj_head = nn.Sequential(nn.Linear(c_in, num_classes))

    def grids(self):
        """The token grid each block works on, from ``img_size``: ceil(img /
        4) after the stem, halved (ceil) at each stride-2 block."""
        if self.img_size is None:
            raise ValueError("MedViT3D: E-MHSA's dropout keep masks need the "
                             "input size (img_size)")
        grid = tuple(-(-n // 4) for n in self.img_size)
        out = []
        for blk in self.features:
            stride = blk.patch_embed.stride
            if stride > 1:
                grid = tuple(-(-n // stride) for n in grid)
            out.append(grid)
        return out

    def draw_plan(self, b: int):
        """The random draws of one training forward at batch ``b``, in draw
        order: [(key, shape)]. For each block f as it runs them: an LTB's
        (f, "attn") E-MHSA attention dropout's keep mask [B, heads, N, M]
        (ATTENTION_DROPOUT > 0) and (f, "proj") its proj dropout's [B, N,
        C] (DROPOUT > 0), then the (gf, gb) pair (shape None) of each of the
        block's residuals (ECB: res1, res2; LTB: res_mhsa, res_mhca,
        res_ffn) whose rate is > 0."""
        plan = []
        attn, drop = self.attention_dropout > 0.0, self.dropout > 0.0
        grids = self.grids() if attn or drop else None
        for f, blk in enumerate(self.features):
            if isinstance(blk, LTB) and (attn or drop):
                n = math.prod(grids[f])
                e = blk.e_mhsa
                if attn:
                    plan.append(((f, "attn"), (b, e.num_heads, n,
                                               e.reduced(n))))
                if drop:
                    plan.append(((f, "proj"), (b, n, blk.mhsa_channels)))
            plan += [((f, name), None) for name, rate in blk.residuals.items()
                     if rate > 0.0]
        return plan

    def mask_rate(self, key) -> float:
        return (self.attention_dropout if key[1:] == ("attn",)
                else self.dropout)

    def draw_gains(self, b: int, key, device, generator):
        """``residual_branch_gains`` of residual key[1] of block key[0]
        (ShakeDrop or DropPath at its rate)."""
        return residual_branch_gains(
            b, self.features[key[0]].residuals[key[1]], self.use_shakedrop,
            self.alpha_range, False, generator, device)

    def block_gains(self, f: int, b: int, device, taken):
        """name -> (gf, gb) of block f's residuals, each times DeepScaleLM's
        beta: drawn ones from ``taken``, else the eval gains (ShakeDrop
        scales by 1 - p)."""
        out = {}
        for name, rate in self.features[f].residuals.items():
            pair = taken.get((f, name))
            if pair is None:
                pair = residual_branch_gains(b, rate, self.use_shakedrop,
                                             device=device)
            out[name] = tuple(g * self.beta if self.enable_stable else g
                              for g in pair)
        return out

    def forward(self, x, generator=None, draws=None):
        """Logits of x. In training mode (``self.training``) BatchNorm uses
        and updates batch statistics, and the residual gains and dropout
        keep masks are drawn from ``generator`` or taken from ``draws``."""
        if self.img_size is not None and tuple(x.shape[1:4]) != self.img_size:
            raise ValueError(f"MedViT3D built for {self.img_size}, got "
                             f"{tuple(x.shape[1:4])}")
        b = x.shape[0]
        taken = self.taken_draws(b, x.device, generator, draws)
        x = self.stem(x.to(self.dtype))
        for f, blk in enumerate(self.features):
            x = blk(x, self.block_gains(f, b, x.device, taken),
                    (taken.get((f, "attn")), taken.get((f, "proj"))))
        x = self.norm(x).mean(dim=(1, 2, 3))
        head = self.proj_head[0]  # in f32 whatever the parameters' type
        return F.linear(x.float(), head.weight.float(), head.bias.float())


def _lecun_normal_(t: torch.Tensor, generator: torch.Generator):
    """flax's default kernel init (lecun_normal: truncated normal at 2 std,
    variance 1 / fan_in after the truncation's correction)."""
    fan_in = t.shape[1] * math.prod(t.shape[2:])
    trunc_normal_(t, math.sqrt(1.0 / fan_in) / .87962566103423978, generator)


def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Initialize as the JAX package does: every conv kernel and every
    Dense but the SE layers' trunc-normal(0.02), the SE layers' and ECA's
    kernels flax's lecun_normal, zero biases, BatchNorm scale 1, shift 0,
    statistics 0 and 1, LayerScale gamma at its init value; drawn on the CPU
    from ``generator``."""
    with torch.no_grad():
        se = {id(lin) for m in model.modules() if isinstance(m, SELayer)
              for lin in (m.fc[0], m.fc[2])}
        for m in model.modules():
            if isinstance(m, nn.Conv1d) or id(m) in se:
                _lecun_normal_(m.weight, generator)
            elif isinstance(m, (nn.Conv3d, nn.Linear)):
                trunc_normal_(m.weight, 0.02, generator)
            elif isinstance(m, BatchNorm):
                m.weight.fill_(1.0)
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
            elif isinstance(m, LayerScale):
                m.gamma.fill_(m.init_value)
            if isinstance(m, (nn.Linear, BatchNorm)) and m.bias is not None:
                m.bias.zero_()
    return model


def medvit_from_config(cfg, dtype=torch.float32) -> MedViT3D:
    """Build from public config keys (vsn_tpu/models/medvit3d.py:531-551):
    DEPTH [3,4,10,3], HEADS -> head_dim, MLP_RATIO 3; the input size from
    the config (for the dropouts' keep masks)."""
    return MedViT3D(
        num_classes=cfg.num_classes,
        depths=tuple(cfg.DEPTH),
        head_dim=int(cfg.HEADS),
        mlp_ratio=float(cfg.MLP_RATIO),
        stochastic_depth_prob=float(cfg.STOCHASTIC_DEPTH_PROB),
        attention_dropout=float(cfg.ATTENTION_DROPOUT),
        dropout=float(cfg.DROPOUT),
        enable_stable=bool(cfg.ENABLE_STABLE),
        stable_k=float(cfg.STABLE_K),
        stable_alpha=float(cfg.STABLE_ALPHA),
        use_shakedrop=bool(cfg.USE_SHAKEDROP),
        shakedrop_alpha_range=tuple(cfg.SHAKEDROP_ALPHA_RANGE),
        layer_scale=bool(cfg.LAYER_SCALE),
        layer_scale_init_value=float(cfg.LAYER_SCALE_INIT_VALUE),
        in_channels=int(cfg.get("IN_CHANNELS", 1)),
        img_size=cfg.input_size,
        dtype=dtype,
    )
