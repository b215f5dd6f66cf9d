"""3D Swin Transformer (port of vsn_tpu/models/swin3d.py).

Channels-last [B, D, H, W, C] end to end, as the JAX package. Every block
takes one of the JAX package's two block paths, chosen per forward by
``fused_block_gate`` (the card's version of the JAX gate):

* fused, with LayerNorm in eval, and in training without dropout: the two
  hand-written block kernels (``ops/swin_block_kernels.py``) K1
  ``attn_half`` (LN1 + qkv + window attention + proj + residual) and K2
  ``ln_mlp`` (LN2 + MLP + residual), the TPU's fused path
  (vsn_tpu/models/swin3d.py SwinBlock3D._fused_call). Stages whose token
  grid divides by the window keep a window-resident residual stream, as
  BasicLayer3D does on the TPU: partition once at entry, one
  window-to-window permutation per shifted junction, reverse once at exit,
  all through the K3 movers (``ops/window_relayout.py``);
* unfused, with a RMSNorm or DynamicTanh NORM_LAYER, with
  USE_PALLAS_ATTENTION off, or in training with DROPOUT or
  ATTENTION_DROPOUT > 0: norm1 -> roll -> window partition ->
  qkv Linear -> attention -> proj -> dropout -> window reverse -> unroll ->
  gated residual -> norm2 -> Mlp (dropout after GELU and after fc2) ->
  gated residual (vsn_tpu/models/swin3d.py:788-849). Roll, partition and
  reverse are plain PyTorch here, as they are plain XLA there. The
  attention is K4 ``window_attention_qkv`` (``ops/window_attention.py``),
  except with USE_PALLAS_ATTENTION off (every forward, no kernel at all)
  and in a training forward with ATTENTION_DROPOUT > 0: there it is the
  JAX package's XLA branch (:677-712), which no kernel computes on either
  side, in plain PyTorch (``layers.softmax_attention``): f32 scores from
  the split heads, the relative-position bias, the region mask at -100
  (not K4's -1e9), the f32 softmax, dropout on the probabilities with a
  drawn or injected keep mask [B*nW, heads, N, N], the product with v.

A stage whose grid does not divide by the window (Swin-T stage 3) is
zero-padded to window multiples, with the pad tokens masked out of
attention in every block through ``padded_window_region_ids`` (DEVIATIONS
#1); the TPU's packed layout of such stages is a later optional layout.

Parameters carry the reference state_dict's names (``backbone.layers.{i}.
blocks.{j}.attn.qkv``, ``.mlp.0``, ``.mlp.3``, ...; ``convert.py`` maps a
JAX parameter tree onto them); both block paths hold the same ones. They
stay f32; with FP16 the activations are bf16 (``dtype``).

The training forward (``model.train()``) runs the same kernels, which carry
their own VJPs (K1b, K2b, K4b, the movers' adjoints). Its random draws, the
residual gains of every block (ShakeDrop / DropPath) and the dropout keep
masks, come from a ``torch.Generator`` passed in, or are injected
(``SwinTransformer3D.draw``). Everything else on the path (patch embed,
norms, Linears of the unfused block, patch merging, the padded stage's pad
and slice, the bias-table gather, pool, head) is plain PyTorch, which
autograd differentiates.

The residual options ride both block paths, as in the JAX package:
POST_NORM moves norm1 / norm2 from the block input to the branch output,
LAYER_SCALE scales each branch by a learned per-channel gamma (``res1`` /
``res2``, named after the JAX tree's ``res*/LayerScale_0``), and
ENABLE_STABLE (DeepScaleLM) gives every residual lam * x + beta * branch
with (lam, beta) from the total depth and the stable inits. The fused path
passes gamma and post-norm to K1/K2, which carry them in band, and lam, with
beta folded into the gains; the unfused path applies them in plain
PyTorch.
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
    DynamicTanh,
    LayerScale,
    Mlp,
    RMSNorm,
    RandomDraws,
    dropout,
    gated_residual,
    make_norm,
    residual_branch_gains,
    softmax_attention,
    stochastic_depth_rates,
    trunc_normal_,
)
from vsn_tpu_torch.ops.stable_init import (
    compute_residual_gains,
    normal_,
    stable_embedding_std,
    stable_qkv_init_,
    stable_vproj_std,
)
from vsn_tpu_torch.ops.swin_block_kernels import attn_half, ln_mlp
from vsn_tpu_torch.ops.window_attention import window_attention_qkv
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


def fused_block_gate(use_pallas: bool, norm_layer, dropout_rate: float,
                     attention_dropout: float, training: bool) -> bool:
    """Whether the blocks run the fused kernels K1/K2 (else the unfused
    block): USE_PALLAS_ATTENTION, LayerNorm, and no dropout unless in eval.
    The card's version of vsn_tpu/models/swin3d.py fused_block_gate
    (:726-749), whose VMEM budget and platform clauses are the TPU's."""
    return use_pallas and norm_layer in LN_NAMES and (
        not training or (dropout_rate == 0.0 and attention_dropout == 0.0))


class WindowAttention3D(nn.Module):
    """Attention of one block: qkv, proj and the relative-position bias
    table. On the fused path the block's K1 call reads these parameters;
    ``forward`` is the unfused path's attention: qkv Linear -> K4 -> proj ->
    dropout (vsn_tpu/models/swin3d.py:625-723). The TPU gates K4 on a 10 MB
    VMEM budget for bias and dbias (:656-665); the card runs K4 in every
    block, whatever the heads and window. A training forward with
    ``attn_drop`` > 0 fails that gate's dropout clause on every platform and
    takes the XLA branch instead (``softmax_attention``), and so does every
    forward with ``use_pallas`` off (USE_PALLAS_ATTENTION, set by the
    model)."""

    def __init__(self, dim: int, num_heads: int, window, qkv_bias: bool = True,
                 proj_drop: float = 0.0, attn_drop: float = 0.0):
        super().__init__()
        table = (2 * window[0] - 1) * (2 * window[1] - 1) * (2 * window[2] - 1)
        self.num_heads = num_heads
        self.scale = (dim // num_heads) ** -0.5
        self.proj_drop, self.attn_drop = proj_drop, attn_drop
        self.use_pallas = True
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

    def xla_branch(self) -> bool:
        """Whether ``forward`` takes the XLA branch: USE_PALLAS_ATTENTION
        off, or training with attention dropout (vsn_tpu/models/swin3d.py
        :660-665's use_pallas and deterministic clauses)."""
        return not self.use_pallas or (self.training and self.attn_drop > 0.0)

    def attention(self, qkv, ids, mask=None):
        """The XLA branch on qkv [BW, N, 3C]: ``softmax_attention`` on the
        split heads with the bias, the region mask of ``ids`` [W, N] (None:
        no mask) at -100 and dropout on the probabilities by ``mask`` [BW,
        heads, N, N]; merged heads [BW, N, C] in qkv's dtype."""
        bw, n, c3 = qkv.shape
        q, k, v = qkv.reshape(bw, n, 3, self.num_heads,
                              c3 // (3 * self.num_heads)).permute(2, 0, 3, 1, 4)
        out = softmax_attention(q, k, v, self.scale, self.bias(), ids,
                                self.attn_drop, mask)
        return out.transpose(1, 2).reshape(bw, n, c3 // 3).to(qkv.dtype)

    def forward(self, windows, ids, masks=(None, None)):
        """windows [BW, N, C] -> [BW, N, C] in their dtype; ``ids`` [W, N]
        region ids (None: no mask), ``masks`` the keep masks of the
        attention dropout (XLA branch) and of the proj dropout."""
        dt = windows.dtype
        qkv_b = None if self.qkv.bias is None else self.qkv.bias.to(dt)
        qkv = F.linear(windows, self.qkv.weight.to(dt), qkv_b)
        if self.xla_branch():
            out = self.attention(qkv, ids, masks[0])
        else:
            if ids is None:
                ids = torch.zeros((1, qkv.shape[1]), dtype=torch.int32,
                                  device=qkv.device)
            out = window_attention_qkv(qkv, self.bias(), ids, self.scale,
                                       self.num_heads)
        out = F.linear(out, self.proj.weight.to(dt), self.proj.bias.to(dt))
        return dropout(out, self.proj_drop, masks[1])


class SwinBlock3D(nn.Module):
    """One (shifted-)window block. Fused: two kernel calls, K1 on the window
    tokens and K2 on the flat token rows (``forward``, ``forward_windows``).
    Unfused: ``forward_unfused``. ``gains`` is (gf1, gb1, gf2, gb2), the
    per-sample branch gains of its two residuals (SwinTransformer3D.
    residual_gains, DeepScaleLM's beta folded in). ``post_norm`` moves
    norm1 / norm2 onto the branch outputs; ``layer_scale`` adds a gamma per
    residual (``res1``, ``res2``); ``lam`` is the residual x-gain."""

    def __init__(self, dim: int, num_heads: int, window, shift,
                 mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 dropout_rate: float = 0.0, drop_path_rate: float = 0.0,
                 norm_layer=None, post_norm: bool = False,
                 layer_scale: bool = False,
                 layer_scale_init_value: float = 1e-5, lam: float = 1.0,
                 attention_dropout: float = 0.0):
        super().__init__()
        self.window, self.shift = tuple(window), tuple(shift)
        self.num_heads = num_heads
        self.scale = (dim // num_heads) ** -0.5
        self.drop_path_rate = drop_path_rate
        self.post_norm, self.lam = post_norm, lam
        self.norm1 = make_norm(norm_layer, dim)
        self.attn = WindowAttention3D(dim, num_heads, window, qkv_bias,
                                      dropout_rate, attention_dropout)
        self.norm2 = make_norm(norm_layer, dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dropout_rate)
        self.res1 = self.res2 = None
        if layer_scale:
            self.res1 = LayerScale(dim, layer_scale_init_value)
            self.res2 = LayerScale(dim, layer_scale_init_value)

    def attn_half(self, windows, ids, gf, gb):
        return attn_half(windows, self.norm1.weight, self.norm1.bias,
                         self.attn.qkv.weight, self.attn.qkv.bias,
                         self.attn.bias(), ids, self.attn.proj.weight,
                         self.attn.proj.bias, gf, gb, self.scale,
                         self.num_heads, lam=self.lam,
                         gamma=None if self.res1 is None else self.res1.gamma,
                         post_norm=self.post_norm)

    def mlp_half(self, rows, gf, gb):
        fc1, fc2 = self.mlp[0], self.mlp[3]
        return ln_mlp(rows, self.norm2.weight, self.norm2.bias, fc1.weight,
                      fc1.bias, fc2.weight, fc2.bias, gf, gb, lam=self.lam,
                      gamma=None if self.res2 is None else self.res2.gamma,
                      post_norm=self.post_norm)

    def _residual(self, x, branch, norm, scale, gf, gb):
        """The unfused residual: branch -> [post-norm] -> [LayerScale] ->
        lam * x + gains * branch (layers.py ResidualBranch order)."""
        if self.post_norm:
            branch = norm(branch)
        if scale is not None:
            branch = scale(branch)
        return gated_residual(x, branch, gf, gb, self.lam)

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

    def forward_unfused(self, x, ids, gains, masks):
        """The unfused block on spatial x [B, D, H, W, C] (dims divisible by
        the window): ``ids`` [W, N] (None: no mask), ``masks`` the keep
        masks (attn, proj, fc1, fc2) of its dropouts, or Nones."""
        b, d, h, w, c = x.shape
        gf1, gb1, gf2, gb2 = gains
        attn_mask, proj_mask, fc1_mask, fc2_mask = masks
        h_in = x if self.post_norm else self.norm1(x)
        h_in = roll3d(h_in, tuple(-s for s in self.shift))
        out = self.attn(window_partition(h_in, self.window), ids,
                        (attn_mask, proj_mask))
        out = roll3d(window_reverse(out, self.window, (d, h, w)), self.shift)
        x = self._residual(x, out, self.norm1, self.res1, gf1, gb1)
        out = self.mlp(x if self.post_norm else self.norm2(x),
                       (fc1_mask, fc2_mask))
        return self._residual(x, out, self.norm2, self.res2, gf2, gb2)


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
    """Odd-dim zero pad -> 8-neighbour concat -> norm(8C) -> Linear(8C ->
    2C)."""

    def __init__(self, dim: int, norm_layer=None):
        super().__init__()
        self.norm = make_norm(norm_layer, 8 * dim)
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
                 dropout_rate: float = 0.0, norm_layer=None,
                 attention_dropout: float = 0.0, **residual):
        super().__init__()
        self.dim, self.hidden = dim, int(dim * mlp_ratio)
        self.dims = tuple(dims)
        self.window, self.shift = clamp_window(
            self.dims, window, tuple(ws // 2 for ws in window))
        self.pad = tuple((ws - d % ws) % ws
                         for d, ws in zip(self.dims, self.window))
        self.padded_dims = tuple(d + p for d, p in zip(self.dims, self.pad))
        self.n_tokens = int(np.prod(self.window))
        self.n_windows = int(np.prod([d // ws for d, ws in
                                      zip(self.padded_dims, self.window)]))
        self.blocks = nn.ModuleList(
            SwinBlock3D(dim, num_heads, self.window,
                        (0, 0, 0) if i % 2 == 0 else self.shift, mlp_ratio,
                        qkv_bias, dropout_rate, rates[i], norm_layer,
                        attention_dropout=attention_dropout, **residual)
            for i in range(depth))
        self.downsample = (PatchMerging3D(dim, norm_layer) if downsample
                           else None)
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

    def forward(self, x, gains, masks=None, fused=True):
        """x [B, D, H, W, C]; ``gains`` holds one (gf1, gb1, gf2, gb2) per
        block, ``masks`` one (attn, proj, fc1, fc2) keep-mask tuple per
        block (unfused path); ``fused`` picks the block path."""
        b, d, h, w, c = x.shape
        if (d, h, w) != self.dims:
            raise ValueError(f"stage built for grid {self.dims}, got {(d, h, w)}")
        if fused and not any(self.pad):
            x = self._window_resident(x, gains)
        else:
            if any(self.pad):
                x = F.pad(x, (0, 0, 0, self.pad[2], 0, self.pad[1], 0,
                              self.pad[0]))
            for i, blk in enumerate(self.blocks):
                if fused:
                    x = blk(x, self._ids(i), gains[i])
                else:
                    x = blk.forward_unfused(
                        x, self._ids(i), gains[i],
                        masks[i] if masks else (None,) * 4)
            x = x[:, :d, :h, :w, :]
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
    """Conv3d(kernel = stride = patch) plus optional norm, channels-last.
    The convolution is PyTorch's, as the JAX package leaves it to XLA."""

    def __init__(self, patch_size, in_channels: int, embed_dim: int,
                 patch_norm: bool = True, norm_layer=None):
        super().__init__()
        self.patch_size = tuple(patch_size)
        self.proj = nn.Conv3d(in_channels, embed_dim, self.patch_size,
                              self.patch_size)
        self.norm = make_norm(norm_layer, embed_dim) if patch_norm else None

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
    """patch_embed -> dropout -> stages -> final norm -> mean-pool:
    [B, C_last]."""

    def __init__(self, img_size, patch_size, in_channels, embed_dim, depths,
                 num_heads, window_size, mlp_ratio, qkv_bias, dropout_rate,
                 patch_norm, rates, norm_layer=None, attention_dropout=0.0,
                 **residual):
        """``residual``: the blocks' post_norm, layer_scale,
        layer_scale_init_value and lam (SwinBlock3D)."""
        super().__init__()
        self.dropout = dropout_rate
        self.patch_embed = PatchEmbed3D(patch_size, in_channels, embed_dim,
                                        patch_norm, norm_layer)
        n = len(depths)
        grids = stage_dims(img_size, patch_size, n)
        self.layers = nn.ModuleList()
        for i in range(n):
            off = sum(depths[:i])
            self.layers.append(BasicLayer3D(
                embed_dim * 2 ** i, grids[i], depths[i], num_heads[i],
                tuple(window_size), rates[off:off + depths[i]],
                downsample=i < n - 1, mlp_ratio=mlp_ratio, qkv_bias=qkv_bias,
                dropout_rate=dropout_rate, norm_layer=norm_layer,
                attention_dropout=attention_dropout, **residual))
        self.num_features = embed_dim * 2 ** (n - 1)
        self.norm = make_norm(norm_layer, self.num_features)

    def forward(self, x, gains, masks=None, embed_mask=None, fused=True):
        """``gains``: one (gf1, gb1, gf2, gb2) per block, in stage order;
        ``masks``: one (attn, proj, fc1, fc2) keep-mask tuple per block and
        ``embed_mask`` the patch-embed dropout's (unfused path)."""
        x = dropout(self.patch_embed(x), self.dropout, embed_mask)
        off = 0
        for layer in self.layers:
            k = len(layer.blocks)
            x = layer(x, gains[off:off + k],
                      masks[off:off + k] if masks else None, fused)
            off += k
        return self.norm(x).mean(dim=(1, 2, 3))  # AdaptiveAvgPool3d(1)


class SwinTransformer3D(RandomDraws, nn.Module):
    """Swin-3D classifier. Input [B, D, H, W, C_in] of the size it was built
    for; output f32 logits [B, num_classes]."""

    def __init__(self, img_size, patch_size, num_classes: int, embed_dim: int,
                 depths, num_heads, window_size, in_channels: int = 1,
                 mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 dropout: float = 0.0, attention_dropout: float = 0.0,
                 stochastic_depth_prob: float = 0.1,
                 patch_norm: bool = True, use_shakedrop: bool = False,
                 shakedrop_alpha_range=(-1.0, 1.0), norm_layer=None,
                 post_norm: bool = False, layer_scale: bool = False,
                 layer_scale_init_value: float = 1e-5,
                 enable_stable: bool = False, stable_k: float = 2.0,
                 stable_alpha: float = 1.0, use_pallas: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.dropout, self.attention_dropout = dropout, attention_dropout
        self.norm_layer = norm_layer
        self.use_shakedrop = use_shakedrop
        self.alpha_range = tuple(shakedrop_alpha_range)
        self.in_channels, self.patch_size = in_channels, tuple(patch_size)
        # DeepScaleLM (vsn_tpu/models/swin3d.py:1505-1511): (lam, beta) from
        # the total depth; beta scales the gains (``residual_gains``)
        self.enable_stable = enable_stable
        self.lam, self.beta = (compute_residual_gains(
            sum(depths), stable_k, stable_alpha) if enable_stable
            else (1.0, 1.0))
        rates = stochastic_depth_rates(stochastic_depth_prob, depths)
        self.backbone = SwinBackbone3D(
            img_size, patch_size, in_channels, embed_dim, depths, num_heads,
            window_size, mlp_ratio, qkv_bias, dropout, patch_norm, rates,
            norm_layer, attention_dropout, post_norm=post_norm,
            layer_scale=layer_scale,
            layer_scale_init_value=layer_scale_init_value, lam=self.lam)
        self.head = nn.Linear(self.backbone.num_features, num_classes)
        # USE_PALLAS_ATTENTION (vsn_tpu/models/swin3d.py:1581): off, every
        # block runs unfused on the XLA branch, in eval and in training
        self.use_pallas = use_pallas
        for blk in self.blocks():
            blk.attn.use_pallas = use_pallas

    def blocks(self):
        return [blk for layer in self.backbone.layers for blk in layer.blocks]

    def fused(self) -> bool:
        """The block path of a forward in the current mode
        (``fused_block_gate``)."""
        return fused_block_gate(self.use_pallas, self.norm_layer,
                                self.dropout, self.attention_dropout,
                                self.training)

    def draw_plan(self, b: int):
        """The random draws of one training forward at batch ``b``, in draw
        order: [(key, shape)]. First the patch-embed dropout's keep mask
        (key "embed"), then for each block i in stage order, as the block
        runs them: (i, "attn") the attention dropout's keep mask [B*nW,
        heads, N, N] over the probabilities, (i, "proj") the proj dropout's
        [B*nW, N, C], (i, "res1") the first residual's (gf, gb), (i, "fc1")
        and (i, "fc2") the Mlp dropouts' [B, D, H, W, hidden] and [B, D, H,
        W, C] on the stage's padded grid, (i, "res2"). The attention mask
        exists with ATTENTION_DROPOUT > 0, the others with DROPOUT > 0, gains
        for a block with stochastic-depth rate > 0; a gain pair's shape is
        None."""
        plan = []
        drop, attn = self.dropout > 0.0, self.attention_dropout > 0.0
        first = self.backbone.layers[0]
        if drop:
            plan.append(("embed", (b, *first.dims, first.dim)))
        i = 0
        for layer in self.backbone.layers:
            grid = (b, *layer.padded_dims)
            wins = (b * layer.n_windows, layer.n_tokens)
            for blk in layer.blocks:
                gains = blk.drop_path_rate > 0.0
                if attn:
                    plan.append(((i, "attn"), (wins[0], blk.num_heads,
                                               wins[1], wins[1])))
                if drop:
                    plan.append(((i, "proj"), (*wins, layer.dim)))
                if gains:
                    plan.append(((i, "res1"), None))
                if drop:
                    plan += [((i, "fc1"), (*grid, layer.hidden)),
                             ((i, "fc2"), (*grid, layer.dim))]
                if gains:
                    plan.append(((i, "res2"), None))
                i += 1
        return plan

    def mask_rate(self, key) -> float:
        return (self.attention_dropout if key[1:] == ("attn",)
                else self.dropout)

    def draw_gains(self, b: int, key, device, generator):
        """``residual_branch_gains`` of block key[0] (ShakeDrop or
        DropPath)."""
        return residual_branch_gains(
            b, self.blocks()[key[0]].drop_path_rate, self.use_shakedrop,
            self.alpha_range, False, generator, device)

    def residual_gains(self, b: int, device, generator=None, draws=None,
                       taken=None):
        """(gf1, gb1, gf2, gb2) of every block, in stage order, each times
        DeepScaleLM's beta under ENABLE_STABLE.

        Eval: the deterministic gains. Training: a block with rate > 0 takes
        res1 and res2 from ``taken`` (``taken_draws``), or from ``draws`` or
        ``generator`` as ``taken_draws`` gives them; a block with rate 0
        draws nothing."""
        if taken is None:
            taken = self.taken_draws(b, device, generator, draws)
        out = []
        for i, blk in enumerate(self.blocks()):
            gains = []
            for res in ("res1", "res2"):
                pair = taken.get((i, res))
                if pair is None:
                    pair = residual_branch_gains(b, blk.drop_path_rate,
                                                 self.use_shakedrop,
                                                 device=device)
                gains.extend(g * self.beta if self.enable_stable else g
                             for g in pair)
            out.append(tuple(gains))
        return out

    def forward(self, x, generator=None, draws=None):
        """Logits of x. In training mode (``self.training``) the residual
        gains and dropout keep masks are drawn from ``generator`` or taken
        from ``draws`` (``draw``)."""
        b = x.shape[0]
        taken = self.taken_draws(b, x.device, generator, draws)
        gains = self.residual_gains(b, x.device, taken=taken)
        masks = [tuple(taken.get((i, k)) for k in ("attn", "proj", "fc1",
                                                   "fc2"))
                 for i in range(len(gains))]
        feats = self.backbone(x.to(self.dtype), gains, masks,
                              taken.get("embed"), self.fused())
        return self.head(feats.float())


def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Initialize as the JAX package's initializers do: trunc-normal(0.02)
    for every Linear/Conv kernel and relative-position bias table, zero
    biases, LayerNorm and RMSNorm scale 1 and LayerNorm shift 0,
    DynamicTanh alpha 0.5, gamma 1, beta 0, LayerScale gamma at its init
    value. Under ENABLE_STABLE (DeepScaleLM, vsn_tpu/models/swin3d.py
    :565-577, :835, :1453-1457) the patch embed, qkv, proj and MLP kernels
    are normal instead: the embed at ``stable_embedding_std``, qkv column-
    wise (``stable_qkv_init_``), proj and both MLP layers at
    ``stable_vproj_std`` of the block width."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Linear, nn.Conv3d)):
                trunc_normal_(m.weight, 0.02, generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, RMSNorm):
                m.weight.fill_(1.0)
            elif isinstance(m, DynamicTanh):
                m.alpha.fill_(m.alpha_init)
                m.gamma.fill_(1.0)
                m.beta.zero_()
            elif isinstance(m, LayerScale):
                m.gamma.fill_(m.init_value)
            elif isinstance(m, WindowAttention3D):
                trunc_normal_(m.relative_position_bias_table, 0.02, generator)
        if getattr(model, "enable_stable", False):
            _stable_init(model, generator)
    return model


def _stable_init(model: SwinTransformer3D, generator: torch.Generator):
    """The DeepScaleLM kernels of ``init_weights`` (biases stay zero)."""
    fan_in = model.in_channels * int(np.prod(model.patch_size))
    normal_(model.backbone.patch_embed.proj.weight,
            stable_embedding_std(fan_in, model.dropout), generator)
    for blk in model.blocks():
        c = blk.attn.proj.weight.shape[0]
        stable_qkv_init_(blk.attn.qkv.weight, c, model.attention_dropout,
                         generator)
        std = stable_vproj_std(c, model.dropout)
        for layer in (blk.attn.proj, blk.mlp[0], blk.mlp[3]):
            normal_(layer.weight, std, generator)


def swin_from_config(cfg, dtype=torch.float32) -> SwinTransformer3D:
    """Build from the public config keys."""
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
        norm_layer=cfg.NORM_LAYER,
        post_norm=bool(cfg.POST_NORM),
        layer_scale=bool(cfg.LAYER_SCALE),
        layer_scale_init_value=float(cfg.LAYER_SCALE_INIT_VALUE),
        enable_stable=bool(cfg.ENABLE_STABLE),
        stable_k=float(cfg.STABLE_K),
        stable_alpha=float(cfg.STABLE_ALPHA),
        use_pallas=bool(cfg.get("USE_PALLAS_ATTENTION", True)),
        dtype=dtype,
    )
