"""3D Swin Transformer (port of vsn_tpu/models/swin3d.py).

Channels-last [B, D, H, W, C] end to end, as the JAX package. Every block
runs the two hand-written block kernels (``ops/swin_block_kernels.py``):
K1 ``attn_half`` (LN1 + qkv + window attention + proj + residual) and K2
``ln_mlp`` (LN2 + MLP + residual), the forward of the TPU's fused path
(vsn_tpu/models/swin3d.py SwinBlock3D._fused_call).

Stages whose token grid divides by the window keep a window-resident
residual stream, as BasicLayer3D does on the TPU: partition once at entry,
one window-to-window permutation per shifted junction, reverse once at exit,
all through the K3 movers (``ops/window_relayout.py``) exactly where the JAX
package calls its movers. A stage whose grid does not divide (Swin-T stage
3) is zero-padded to window multiples, with the pad tokens masked out of
attention in every block through ``padded_window_region_ids`` (DEVIATIONS
#1); the TPU's packed layout of such stages is a later optional layout.

Parameters carry the reference state_dict's names (``backbone.layers.{i}.
blocks.{j}.attn.qkv``, ``.mlp.0``, ``.mlp.3``, ...; ``convert.py`` maps a
JAX parameter tree onto them). They stay f32; with FP16 the activations are
bf16 (``dtype``).

The training forward (``model.train()``) runs the same kernels, which
carry their own VJPs (K1b, K2b, the movers' adjoints); the residual gains
of every block are drawn from a ``torch.Generator`` passed in, or injected
(ShakeDrop / DropPath, vsn_tpu/models/swin3d.py:864-891). Everything else
on the path (patch embed, patch merging, the padded stage's pad and slice,
the bias-table gather, final norm, pool, head) is plain PyTorch, which
autograd differentiates.

POST_NORM, LAYER_SCALE, ENABLE_STABLE and non-LayerNorm NORM_LAYER raise
NotImplementedError, and so does training with DROPOUT or
ATTENTION_DROPOUT > 0 (ROADMAP).
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from vsn_tpu_torch.models.layers import (
    LN_NAMES,
    LayerNorm,
    Mlp,
    make_norm,
    residual_branch_gains,
    stochastic_depth_rates,
    trunc_normal_,
)
from vsn_tpu_torch.ops.swin_block_kernels import attn_half, ln_mlp
from vsn_tpu_torch.ops.window_relayout import (
    spatial_to_windows,
    windows_to_spatial,
    windows_to_windows,
)

# ---------------------------------------------------------------------------
# Static geometry (numpy, computed once at construction)
# ---------------------------------------------------------------------------


def clamp_window(x_size, window_size, shift_size):
    """Shrink the window to the axis size and zero its shift where the input
    is not larger than the window."""
    w, s = list(window_size), list(shift_size)
    for i in range(3):
        if x_size[i] <= window_size[i]:
            w[i] = x_size[i]
            s[i] = 0
    return tuple(w), tuple(s)


@functools.lru_cache(maxsize=None)
def relative_position_index(window: Tuple[int, int, int]) -> np.ndarray:
    """Static [N, N] lookup into the (2wd-1)(2wh-1)(2ww-1) bias table."""
    wd, wh, ww = window
    coords = np.stack(
        np.meshgrid(np.arange(wd), np.arange(wh), np.arange(ww), indexing="ij")
    ).reshape(3, -1)
    rel = coords[:, :, None] - coords[:, None, :]  # [3, N, N]
    rel = rel.transpose(1, 2, 0)
    rel[:, :, 0] += wd - 1
    rel[:, :, 1] += wh - 1
    rel[:, :, 2] += ww - 1
    rel[:, :, 0] *= (2 * wh - 1) * (2 * ww - 1)
    rel[:, :, 1] *= 2 * ww - 1
    return rel.sum(-1).astype(np.int32)


def _axis_region_labels(size: int, win: int, sh: int) -> np.ndarray:
    """Per-axis region label in rolled space: 0 untouched, 1 wrapped window
    tail, 2 wrapped shift tail."""
    r = np.zeros(size, np.int64)
    if sh > 0:
        r[size - win: size - sh] = 1
        r[size - sh:] = 2
    return r


def shifted_window_region_ids(dims, window, shift) -> np.ndarray:
    """Per-window voxel region ids [nW, N]: only same-id pairs may attend."""
    rd = _axis_region_labels(dims[0], window[0], shift[0])
    rh = _axis_region_labels(dims[1], window[1], shift[1])
    rw = _axis_region_labels(dims[2], window[2], shift[2])
    region = rd[:, None, None] * 9 + rh[None, :, None] * 3 + rw[None, None, :]
    wd, wh, ww = window
    d, h, w = dims
    region = region.reshape(d // wd, wd, h // wh, wh, w // ww, ww)
    region = region.transpose(0, 2, 4, 1, 3, 5).reshape(-1, wd * wh * ww)
    return region.astype(np.int32)


def _rolled_grid(dims, window, shift):
    """Geometry of the rolled, window-padded grid: position p holds source
    voxel (p + shift) mod padded, real iff inside ``dims``. Returns (real,
    flat_src, region, win_id, winpos), each [Dp, Hp, Wp]."""
    d, h, w = dims
    wd, wh, ww = window
    dp, hp, wp = (-(-s // ws) * ws for s, ws in zip(dims, window))
    pz, py, px = np.arange(dp), np.arange(hp), np.arange(wp)
    zc, yc, xc = (pz + shift[0]) % dp, (py + shift[1]) % hp, (px + shift[2]) % wp
    real = (
        (zc < d)[:, None, None]
        & (yc < h)[None, :, None]
        & (xc < w)[None, None, :]
    )
    flat_src = zc[:, None, None] * (h * w) + yc[None, :, None] * w + xc[None, None, :]
    region = (
        _axis_region_labels(dp, wd, shift[0])[pz][:, None, None] * 9
        + _axis_region_labels(hp, wh, shift[1])[py][None, :, None] * 3
        + _axis_region_labels(wp, ww, shift[2])[px][None, None, :]
    )
    nwy, nwx = hp // wh, wp // ww
    win_id = (
        (pz // wd)[:, None, None] * (nwy * nwx)
        + (py // wh)[None, :, None] * nwx
        + (px // ww)[None, None, :]
    )
    winpos = (
        (pz % wd)[:, None, None] * (wh * ww)
        + (py % wh)[None, :, None] * ww
        + (px % ww)[None, None, :]
    )
    return real, flat_src, region, win_id, winpos


def padded_window_region_ids(dims, window, shift) -> np.ndarray:
    """[nW, N] region ids on the window-padded grid, -1 at slots whose source
    voxel is padding (``dims`` are the real token dims)."""
    real, _, region, _, _ = _rolled_grid(dims, window, shift)
    grid = np.where(real, region, -1)
    wd, wh, ww = window
    dp, hp, wp = grid.shape
    grid = grid.reshape(dp // wd, wd, hp // wh, wh, wp // ww, ww)
    grid = grid.transpose(0, 2, 4, 1, 3, 5).reshape(-1, wd * wh * ww)
    return grid.astype(np.int32)


# ---------------------------------------------------------------------------
# Layout ops (plain torch; the K3 movers are their one-pass forms)
# ---------------------------------------------------------------------------


def roll3d(x: torch.Tensor, shift) -> torch.Tensor:
    """Roll the spatial dims of [B, D, H, W, C]: out[p] = x[(p - shift) mod
    dims], the sign of jnp.roll and of the JAX package's pad+slice form."""
    if not any(int(s) % d for s, d in zip(shift, x.shape[1:4])):
        return x
    return torch.roll(x, shifts=tuple(int(s) for s in shift), dims=(1, 2, 3))


def window_partition(x: torch.Tensor, window) -> torch.Tensor:
    """[B, D, H, W, C] -> [B*nW, wd*wh*ww, C]."""
    b, d, h, w, c = x.shape
    wd, wh, ww = window
    x = x.reshape(b, d // wd, wd, h // wh, wh, w // ww, ww, c)
    x = x.permute(0, 1, 3, 5, 2, 4, 6, 7)
    return x.reshape(-1, wd * wh * ww, c)


def window_reverse(windows: torch.Tensor, window, dims) -> torch.Tensor:
    """[B*nW, wd*wh*ww, C] -> [B, D, H, W, C]."""
    d, h, w = dims
    wd, wh, ww = window
    c = windows.shape[-1]
    b = windows.shape[0] // (d // wd * (h // wh) * (w // ww))
    x = windows.reshape(b, d // wd, h // wh, w // ww, wd, wh, ww, c)
    x = x.permute(0, 1, 4, 2, 5, 3, 6, 7)
    return x.reshape(b, d, h, w, c)


def window_glue(wins: torch.Tensor, window, dims, tshift) -> torch.Tensor:
    """Window layout -> window layout rolled by ``-tshift`` (chain form)."""
    x = roll3d(window_reverse(wins, window, dims), tuple(-t for t in tshift))
    return window_partition(x, window)


def expand_bias_table(table: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """Relative-position bias [H, N, N] (f32) from the [(2wd-1)(2wh-1)(2ww-1),
    H] table and ``index`` = relative_position_index(window) as a tensor."""
    return table.float()[index.long()].permute(2, 0, 1).contiguous()


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------


class WindowAttention3D(nn.Module):
    """Attention parameters of one block: qkv, proj and the relative-position
    bias table. The block's K1 call computes the attention itself."""

    def __init__(self, dim: int, num_heads: int, window, qkv_bias: bool = True):
        super().__init__()
        table = (2 * window[0] - 1) * (2 * window[1] - 1) * (2 * window[2] - 1)
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros(table, num_heads))
        self.register_buffer(
            "relative_position_index",
            torch.from_numpy(relative_position_index(tuple(window))).long(),
            persistent=False)

    def bias(self) -> torch.Tensor:
        return expand_bias_table(self.relative_position_bias_table,
                                 self.relative_position_index)


class SwinBlock3D(nn.Module):
    """One (shifted-)window block as two kernel calls: K1 on the window
    tokens, K2 on the flat token rows. ``gains`` is (gf1, gb1, gf2, gb2),
    the per-sample branch gains of its two residuals (SwinTransformer3D.
    residual_gains)."""

    def __init__(self, dim: int, num_heads: int, window, shift,
                 mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 dropout: float = 0.0, drop_path_rate: float = 0.0):
        super().__init__()
        self.window, self.shift = tuple(window), tuple(shift)
        self.num_heads = num_heads
        self.scale = (dim // num_heads) ** -0.5
        self.drop_path_rate = drop_path_rate
        self.norm1 = LayerNorm(dim)
        self.attn = WindowAttention3D(dim, num_heads, window, qkv_bias)
        self.norm2 = LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dropout)

    def attn_half(self, windows, ids, gf, gb):
        return attn_half(windows, self.norm1.weight, self.norm1.bias,
                         self.attn.qkv.weight, self.attn.qkv.bias,
                         self.attn.bias(), ids, self.attn.proj.weight,
                         self.attn.proj.bias, gf, gb, self.scale,
                         self.num_heads)

    def mlp_half(self, rows, gf, gb):
        fc1, fc2 = self.mlp[0], self.mlp[3]
        return ln_mlp(rows, self.norm2.weight, self.norm2.bias, fc1.weight,
                      fc1.bias, fc2.weight, fc2.bias, gf, gb)

    def forward_windows(self, x, ids, gains):
        """Window-resident IO: x is [B*nW, N, C] in this block's (rolled)
        layout and is returned in it; the MLP half is token-pointwise."""
        gf1, gb1, gf2, gb2 = gains
        x = self.attn_half(x, ids, gf1, gb1)
        bw, n, c = x.shape
        return self.mlp_half(x.reshape(bw * n, c), gf2, gb2).reshape(bw, n, c)

    def forward(self, x, ids, gains):
        """Spatial IO: x is [B, D, H, W, C] with dims divisible by the window.
        The residual commutes with the roll and the partition (both
        permutations), so K1 adds its own rolled, partitioned input."""
        b, d, h, w, c = x.shape
        gf1, gb1, gf2, gb2 = gains
        h_in = roll3d(x, tuple(-s for s in self.shift))
        out = self.attn_half(window_partition(h_in, self.window), ids, gf1,
                             gb1)
        x = roll3d(window_reverse(out, self.window, (d, h, w)), self.shift)
        return self.mlp_half(x.reshape(-1, c), gf2, gb2).reshape(b, d, h, w, c)


# Reference part order for the 8-neighbour concat: x0..x7 as (dz, dy, dx).
_MERGE_PARTS = (
    (0, 0, 0), (1, 0, 0), (0, 1, 0), (0, 0, 1),
    (1, 1, 0), (1, 0, 1), (0, 1, 1), (1, 1, 1),
)


def merge_concat(x: torch.Tensor) -> torch.Tensor:
    """The reference's 8-part channel concat: [B, D, H, W, C] (even dims) ->
    [B, D/2, H/2, W/2, 8C]."""
    b, d, h, w, c = x.shape
    x = x.reshape(b, d // 2, 2, h // 2, 2, w // 2, 2, c)
    x = x.permute(0, 1, 3, 5, 2, 4, 6, 7)  # [b, d2, h2, w2, 2, 2, 2, c]
    return torch.cat([x[:, :, :, :, dz, dy, dx, :] for dz, dy, dx in _MERGE_PARTS],
                     dim=-1)


class PatchMerging3D(nn.Module):
    """Odd-dim zero pad -> 8-neighbour concat -> LN(8C) -> Linear(8C -> 2C)."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = LayerNorm(8 * dim)
        self.reduction = nn.Linear(8 * dim, 2 * dim, bias=False)

    def forward(self, x):
        d, h, w = x.shape[1:4]
        if d % 2 or h % 2 or w % 2:
            x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2, 0, d % 2))
        x = self.norm(merge_concat(x))
        return F.linear(x, self.reduction.weight.to(x.dtype))


class BasicLayer3D(nn.Module):
    """One stage: ``depth`` blocks with alternating shift, then an optional
    PatchMerging3D. ``dims`` is the stage's token grid, fixed at
    construction (the bias-table size follows the clamped window)."""

    def __init__(self, dim: int, dims, depth: int, num_heads: int, window,
                 rates: Sequence[float], downsample: bool,
                 mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 dropout: float = 0.0):
        super().__init__()
        self.dims = tuple(dims)
        self.window, self.shift = clamp_window(
            self.dims, window, tuple(ws // 2 for ws in window))
        self.pad = tuple((ws - d % ws) % ws
                         for d, ws in zip(self.dims, self.window))
        self.blocks = nn.ModuleList(
            SwinBlock3D(dim, num_heads, self.window,
                        (0, 0, 0) if i % 2 == 0 else self.shift, mlp_ratio,
                        qkv_bias, dropout, rates[i])
            for i in range(depth))
        self.downsample = PatchMerging3D(dim) if downsample else None
        shifted = any(self.shift)
        ids_noshift = ids_shift = None
        if any(self.pad):
            ids_noshift = padded_window_region_ids(self.dims, self.window,
                                                   (0, 0, 0))
            if shifted:
                ids_shift = padded_window_region_ids(self.dims, self.window,
                                                     self.shift)
        elif shifted:
            ids_shift = shifted_window_region_ids(self.dims, self.window,
                                                  self.shift)
        for name, ids in (("ids_noshift", ids_noshift),
                          ("ids_shift", ids_shift)):
            self.register_buffer(
                name, None if ids is None else torch.from_numpy(ids),
                persistent=False)

    def _ids(self, i):
        return self.ids_noshift if i % 2 == 0 else self.ids_shift

    def forward(self, x, gains):
        """x [B, D, H, W, C]; ``gains`` holds one (gf1, gb1, gf2, gb2) per
        block."""
        b, d, h, w, c = x.shape
        if (d, h, w) != self.dims:
            raise ValueError(f"stage built for grid {self.dims}, got {(d, h, w)}")
        if any(self.pad):
            x = F.pad(x, (0, 0, 0, self.pad[2], 0, self.pad[1], 0, self.pad[0]))
            for i, blk in enumerate(self.blocks):
                x = blk(x, self._ids(i), gains[i])
            x = x[:, :d, :h, :w, :]
        else:
            x = self._window_resident(x, gains)
        if self.downsample is not None:
            x = self.downsample(x)
        return x

    def _window_resident(self, x, gains):
        """Partition once, glue at shifted junctions, reverse once."""
        dims, window = self.dims, self.window
        x = spatial_to_windows(x.contiguous(), window, (0, 0, 0))
        cur = (0, 0, 0)
        for i, blk in enumerate(self.blocks):
            if blk.shift != cur:
                # from the layout rolled by -cur to the one rolled by
                # -blk.shift; the delta is taken mod the full dims, not the
                # window (vsn_tpu/models/swin3d.py:1257-1266)
                t = tuple((ns - cs) % dim
                          for ns, cs, dim in zip(blk.shift, cur, dims))
                x = windows_to_windows(x, window, dims, tuple(-v for v in t))
                cur = blk.shift
            x = blk.forward_windows(x, self._ids(i), gains[i])
        if any(cur):
            return windows_to_spatial(x, window, dims, cur)
        return window_reverse(x, window, dims)


class PatchEmbed3D(nn.Module):
    """Conv3d(kernel = stride = patch) plus optional LayerNorm, channels-last.
    The convolution is PyTorch's, as the JAX package leaves it to XLA."""

    def __init__(self, patch_size, in_channels: int, embed_dim: int,
                 patch_norm: bool = True):
        super().__init__()
        self.patch_size = tuple(patch_size)
        self.proj = nn.Conv3d(in_channels, embed_dim, self.patch_size,
                              self.patch_size)
        self.norm = LayerNorm(embed_dim) if patch_norm else None

    def forward(self, x):
        pad = [(p - s % p) % p for s, p in zip(x.shape[1:4], self.patch_size)]
        if any(pad):
            x = F.pad(x, (0, 0, 0, pad[2], 0, pad[1], 0, pad[0]))
        y = F.conv3d(x.permute(0, 4, 1, 2, 3), self.proj.weight.to(x.dtype),
                     self.proj.bias.to(x.dtype), stride=self.patch_size)
        y = y.permute(0, 2, 3, 4, 1).contiguous()
        return self.norm(y) if self.norm is not None else y


def stage_dims(img_size, patch_size, n_stages: int):
    """Token grid of every stage: ceil(img / patch), then ceil(dims / 2)."""
    dims = tuple(-(-s // p) for s, p in zip(img_size, patch_size))
    out = []
    for _ in range(n_stages):
        out.append(dims)
        dims = tuple(-(-d // 2) for d in dims)
    return out


class SwinBackbone3D(nn.Module):
    """patch_embed -> stages -> final norm -> mean-pool: [B, C_last]."""

    def __init__(self, img_size, patch_size, in_channels, embed_dim, depths,
                 num_heads, window_size, mlp_ratio, qkv_bias, dropout,
                 patch_norm, rates):
        super().__init__()
        self.patch_embed = PatchEmbed3D(patch_size, in_channels, embed_dim,
                                        patch_norm)
        n = len(depths)
        grids = stage_dims(img_size, patch_size, n)
        self.layers = nn.ModuleList()
        for i in range(n):
            off = sum(depths[:i])
            self.layers.append(BasicLayer3D(
                embed_dim * 2 ** i, grids[i], depths[i], num_heads[i],
                tuple(window_size), rates[off:off + depths[i]],
                downsample=i < n - 1, mlp_ratio=mlp_ratio, qkv_bias=qkv_bias,
                dropout=dropout))
        self.num_features = embed_dim * 2 ** (n - 1)
        self.norm = LayerNorm(self.num_features)

    def forward(self, x, gains):
        """``gains``: one (gf1, gb1, gf2, gb2) per block, in stage order."""
        x = self.patch_embed(x)
        off = 0
        for layer in self.layers:
            x = layer(x, gains[off:off + len(layer.blocks)])
            off += len(layer.blocks)
        return self.norm(x).mean(dim=(1, 2, 3))  # AdaptiveAvgPool3d(1)


class SwinTransformer3D(nn.Module):
    """Swin-3D classifier. Input [B, D, H, W, C_in] of the size it was built
    for; output f32 logits [B, num_classes]."""

    def __init__(self, img_size, patch_size, num_classes: int, embed_dim: int,
                 depths, num_heads, window_size, in_channels: int = 1,
                 mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 dropout: float = 0.0, attention_dropout: float = 0.0,
                 stochastic_depth_prob: float = 0.1,
                 patch_norm: bool = True, use_shakedrop: bool = False,
                 shakedrop_alpha_range=(-1.0, 1.0),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.dropout, self.attention_dropout = dropout, attention_dropout
        self.use_shakedrop = use_shakedrop
        self.alpha_range = tuple(shakedrop_alpha_range)
        rates = stochastic_depth_rates(stochastic_depth_prob, depths)
        self.backbone = SwinBackbone3D(
            img_size, patch_size, in_channels, embed_dim, depths, num_heads,
            window_size, mlp_ratio, qkv_bias, dropout, patch_norm, rates)
        self.head = nn.Linear(self.backbone.num_features, num_classes)

    def blocks(self):
        return [blk for layer in self.backbone.layers for blk in layer.blocks]

    def num_draws(self) -> int:
        """Residuals that draw their gains in training (rate > 0)."""
        return 2 * sum(blk.drop_path_rate > 0.0 for blk in self.blocks())

    def draw(self, b: int, device, generator):
        """The random draws of one training forward, in the form
        ``forward(draws=)`` takes: the (gf, gb) pair of every residual that
        draws, in the order ``residual_gains`` draws them from
        ``generator``."""
        return [residual_branch_gains(b, blk.drop_path_rate,
                                      self.use_shakedrop, self.alpha_range,
                                      False, generator, device)
                for blk in self.blocks() if blk.drop_path_rate > 0.0
                for _ in range(2)]

    def residual_gains(self, b: int, device, generator=None, draws=None):
        """(gf1, gb1, gf2, gb2) of every block, in stage order.

        Eval: the deterministic gains. Training: a block with rate > 0 draws
        res1 then res2 (vsn_tpu/models/swin3d.py _residual_gains order) from
        ``generator``, or takes them from ``draws``, a list of ``num_draws()``
        (gf, gb) pairs in that order; a block with rate 0 draws nothing."""
        training = self.training
        if training and draws is not None and len(draws) != self.num_draws():
            raise ValueError(f"{len(draws)} injected (gf, gb) pairs, the "
                             f"model draws {self.num_draws()}")
        if (training and draws is None and generator is None
                and self.num_draws()):
            raise ValueError("a training forward with stochastic depth needs "
                             "a generator or injected draws")
        taken = iter(draws or ())
        out = []
        for blk in self.blocks():
            gains = []
            for _ in range(2):
                if training and blk.drop_path_rate > 0.0:
                    pair = next(taken) if draws is not None else (
                        residual_branch_gains(
                            b, blk.drop_path_rate, self.use_shakedrop,
                            self.alpha_range, False, generator, device))
                else:
                    pair = residual_branch_gains(b, blk.drop_path_rate,
                                                 self.use_shakedrop,
                                                 device=device)
                gains.extend(pair)
            out.append(tuple(gains))
        return out

    def forward(self, x, generator=None, draws=None):
        """Logits of x. In training mode (``self.training``) the residual
        gains are drawn from ``generator`` or taken from ``draws``
        (``residual_gains``)."""
        if self.training and (self.dropout > 0 or self.attention_dropout > 0):
            raise NotImplementedError(
                "training with DROPOUT or ATTENTION_DROPOUT > 0 takes the "
                "unfused attention path of the K4 kernel, not ported yet "
                "(ROADMAP Queue 2.2)")
        gains = self.residual_gains(x.shape[0], x.device, generator, draws)
        feats = self.backbone(x.to(self.dtype), gains)
        return self.head(feats.float())


def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Initialize as the JAX package's initializers do: trunc-normal(0.02)
    for every Linear/Conv kernel and relative-position bias table, zero
    biases, LayerNorm scale 1 and shift 0."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Linear, nn.Conv3d)):
                trunc_normal_(m.weight, 0.02, generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, WindowAttention3D):
                trunc_normal_(m.relative_position_bias_table, 0.02, generator)
    return model


def swin_from_config(cfg, dtype=torch.float32) -> SwinTransformer3D:
    """Build from the public config keys; refuses what the slice does not
    carry yet."""
    for key, why in (("POST_NORM", "post-norm blocks"),
                     ("LAYER_SCALE", "LayerScale"),
                     ("ENABLE_STABLE", "DeepScaleLM stable residuals")):
        if cfg.get(key, False):
            raise NotImplementedError(f"{key}: {why} are not ported yet "
                                      "(ROADMAP)")
    if cfg.NORM_LAYER not in LN_NAMES:
        make_norm(cfg.NORM_LAYER, 1)  # raises, naming the norm
    return SwinTransformer3D(
        img_size=cfg.input_size,
        patch_size=tuple(cfg.PATCH_SHAPE),
        num_classes=cfg.num_classes,
        embed_dim=int(cfg.EMBED_DIM),
        depths=tuple(cfg.DEPTH),
        num_heads=tuple(cfg.HEADS),
        window_size=tuple(cfg.WINDOW_SIZE),
        in_channels=int(cfg.get("IN_CHANNELS", 1)),
        mlp_ratio=float(cfg.MLP_RATIO),
        qkv_bias=bool(cfg.QKV_BIAS),
        dropout=float(cfg.DROPOUT),
        attention_dropout=float(cfg.ATTENTION_DROPOUT),
        stochastic_depth_prob=float(cfg.STOCHASTIC_DEPTH_PROB),
        patch_norm=bool(cfg.PATCH_NORM),
        use_shakedrop=bool(cfg.USE_SHAKEDROP),
        shakedrop_alpha_range=tuple(cfg.SHAKEDROP_ALPHA_RANGE),
        dtype=dtype,
    )
