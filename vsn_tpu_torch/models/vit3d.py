"""3D Vision Transformer (port of vsn_tpu/models/vit3d.py), fused path.

Channels-last [B, D, H, W, C] in, f32 logits out, as the JAX package:

  patchify (reshape + transpose, patch dims in (pd, ph, pw, C) order) ->
  LayerNorm -> Linear -> LayerNorm -> CLS token + position embedding ->
  ``depth`` blocks -> the CLS row (or the token mean) -> LayerNorm -> Linear

Every block runs the JAX package's fused path (vsn_tpu/models/vit3d.py
ViTBlock._fused_attn_half / _fused_mlp_half) on the port's two hand-written
block kernels (``ops/swin_block_kernels.py``): K1 ``attn_half`` (LN + qkv,
no qkv bias, + softmax attention over all N tokens of a sample + proj + gated
residual) on [B, N, C] as B windows of N tokens with no bias and no region
mask, and K2 ``ln_mlp`` (LN + MLP + gated residual) on the flat [B * N, C]
rows. At ViT's head dim of 64 K1 takes its key-tiled attention body. The
TPU's pad of the rows to a multiple of 8 for its MLP tiling is not needed:
the card's GEMMs take any row count.

The residual gains are DropPath's: ViT ignores USE_SHAKEDROP on both JAX
paths (``residual_branch_gains(b, rate, False, ...)``). In training they
are drawn from a ``torch.Generator`` or injected (``ViT3D.draw``), as
Swin's are.

Parameters carry the names of the reference's state_dict, as
scripts/golden_parity.py ``port_vit`` reads them: ``to_patch_embedding.
{1,2,3}``, ``pos_embedding``, ``cls_token``, ``transformer.layers.{i}.0.
{norm, to_qkv, to_out.0}``, ``transformer.layers.{i}.1.net.{0,1,4}``,
``mlp_head.{0,1}``. They stay f32; with FP16 the activations are bf16.

The residual options ride the kernels in band, as on the JAX fused path:
POST_NORM moves each half's LayerNorm onto its branch output, where it is
the block's ``attn_norm`` / ``ff_norm`` (the attention half then has no
``norm`` and the MLP half's ``net.0`` is the identity, as the JAX tree has
no ``attn/norm`` and no ``ff_prenorm``); LAYER_SCALE adds a gamma per
residual (``res1``, ``res2``, the JAX tree's ``res*/LayerScale_0``); and
ENABLE_STABLE (DeepScaleLM) gives every residual lam * x + beta * branch
with (lam, beta) from ``depth`` (beta folded into the gains) and the stable
inits (``init_weights``).

Not ported, and raising NotImplementedError: a norm other than LayerNorm
(ROADMAP Queue 1 item 1), and training with DROPOUT or ATTENTION_DROPOUT >
0, where the JAX package takes its unfused XLA blocks (dropout on the
probabilities and after the projections). In eval those rates are the
identity, as the JAX gate's deterministic clause has it.
"""

from __future__ import annotations

from typing import Literal

import torch
import torch.nn.functional as F
from torch import nn

from vsn_tpu_torch.models.layers import (
    LN_NAMES,
    LayerNorm,
    LayerScale,
    residual_branch_gains,
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


class Patchify(nn.Module):
    """[B, D, H, W, C] -> [B, n, pd * ph * pw * C] (no parameters): a
    reshape to [B, gd, pd, gh, ph, gw, pw, C] and a transpose to (0, 1, 3,
    5, 2, 4, 6, 7), as vsn_tpu/models/vit3d.py:432-436."""

    def __init__(self, patch_size):
        super().__init__()
        self.patch_size = tuple(patch_size)

    def forward(self, x):
        b, d, h, w, c = x.shape
        pd, ph, pw = self.patch_size
        x = x.reshape(b, d // pd, pd, h // ph, ph, w // pw, pw, c)
        x = x.permute(0, 1, 3, 5, 2, 4, 6, 7)
        return x.reshape(b, -1, pd * ph * pw * c)


def _linear(x, layer):
    """A Linear in x's dtype (flax nn.Dense(dtype=...): f32 parameters cast
    to the activation type)."""
    bias = None if layer.bias is None else layer.bias.to(x.dtype)
    return F.linear(x, layer.weight.to(x.dtype), bias)


class Attention(nn.Module):
    """The parameters of one block's attention half (reference
    ``transformer.layers.{i}.0``): pre-norm (none under post-norm), qkv
    without bias, output projection. The block's K1 call reads them."""

    def __init__(self, dim: int, heads: int, dim_head: int,
                 post_norm: bool = False):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        self.scale = dim_head ** -0.5
        self.norm = None if post_norm else LayerNorm(dim)
        self.to_qkv = nn.Linear(dim, 3 * heads * dim_head, bias=False)
        self.to_out = nn.Sequential(nn.Linear(heads * dim_head, dim))


class FeedForward(nn.Module):
    """The parameters of one block's MLP half (reference
    ``transformer.layers.{i}.1.net``): LayerNorm (the identity under
    post-norm), fc1, GELU, dropout, fc2; the block's K2 call reads net.0,
    net.1 and net.4."""

    def __init__(self, dim: int, hidden: int, post_norm: bool = False):
        super().__init__()
        self.net = nn.Sequential(
            nn.Identity() if post_norm else LayerNorm(dim),
            nn.Linear(dim, hidden), nn.GELU(), nn.Identity(),
            nn.Linear(hidden, dim))


class ViTBlock(nn.Module):
    """One block: ``0`` the attention half, ``1`` the MLP half, each one
    kernel call on the whole sequence; under post-norm ``attn_norm`` and
    ``ff_norm`` are the LayerNorms of the branch outputs, and with
    LayerScale ``res1`` / ``res2`` hold the gammas. ``gains`` is (gf1, gb1,
    gf2, gb2), the per-sample branch gains of its two residuals, and
    ``lam`` the residual x-gain."""

    def __init__(self, dim: int, heads: int, dim_head: int, mlp_dim: int,
                 drop_path_rate: float = 0.0, post_norm: bool = False,
                 layer_scale: bool = False,
                 layer_scale_init_value: float = 1e-5, lam: float = 1.0):
        super().__init__()
        self.add_module("0", Attention(dim, heads, dim_head, post_norm))
        self.add_module("1", FeedForward(dim, mlp_dim, post_norm))
        self.drop_path_rate = drop_path_rate
        self.post_norm, self.lam = post_norm, lam
        self.attn_norm = self.ff_norm = self.res1 = self.res2 = None
        if post_norm:
            self.attn_norm, self.ff_norm = LayerNorm(dim), LayerNorm(dim)
        if layer_scale:
            self.res1 = LayerScale(dim, layer_scale_init_value)
            self.res2 = LayerScale(dim, layer_scale_init_value)

    def __getitem__(self, i: int) -> nn.Module:
        """The attention half (0) or the MLP half (1)."""
        return self._modules[str(i)]

    def forward(self, x, gains):
        """x [B, N, C] -> [B, N, C] in x's dtype."""
        attn, ff = self[0], self[1]
        gf1, gb1, gf2, gb2 = gains
        norm1 = self.attn_norm if self.post_norm else attn.norm
        x = attn_half(x, norm1.weight, norm1.bias, attn.to_qkv.weight, None,
                      None, None, attn.to_out[0].weight, attn.to_out[0].bias,
                      gf1, gb1, attn.scale, attn.heads, lam=self.lam,
                      gamma=None if self.res1 is None else self.res1.gamma,
                      post_norm=self.post_norm)
        b, n, c = x.shape
        norm2 = self.ff_norm if self.post_norm else ff.net[0]
        fc1, fc2 = ff.net[1], ff.net[4]
        x = ln_mlp(x.reshape(b * n, c), norm2.weight, norm2.bias, fc1.weight,
                   fc1.bias, fc2.weight, fc2.bias, gf2, gb2, lam=self.lam,
                   gamma=None if self.res2 is None else self.res2.gamma,
                   post_norm=self.post_norm)
        return x.reshape(b, n, c)


class Transformer(nn.Module):
    def __init__(self, dim, depth, heads, dim_head, mlp_dim, rates,
                 **residual):
        super().__init__()
        self.layers = nn.ModuleList(
            ViTBlock(dim, heads, dim_head, mlp_dim, rates[i], **residual)
            for i in range(depth))


class ViT3D(nn.Module):
    """Plain 3D ViT classifier. Input [B, D, H, W, C_in] of ``img_size``;
    output f32 logits [B, num_classes]."""

    def __init__(self, img_size, patch_size, num_classes: int, embed_dim: int,
                 depth: int, num_heads: int, mlp_dim: int,
                 pool: Literal["cls", "mean"] = "cls", in_channels: int = 1,
                 dim_head: int = 64, dropout: float = 0.0,
                 attention_dropout: float = 0.0,
                 stochastic_depth_prob: float = 0.0,
                 post_norm: bool = False, layer_scale: bool = False,
                 layer_scale_init_value: float = 1e-5,
                 enable_stable: bool = False, stable_k: float = 2.0,
                 stable_alpha: float = 1.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        for i, p in zip(img_size, patch_size):
            if i % p:
                raise ValueError(f"img_size {tuple(img_size)} not divisible "
                                 f"by patch {tuple(patch_size)}")
        if num_heads * dim_head != embed_dim or (
                num_heads == 1 and dim_head == embed_dim):
            raise NotImplementedError(
                f"heads {num_heads} x dim_head {dim_head} against embed_dim "
                f"{embed_dim}: the fused blocks need heads * dim_head == "
                "embed_dim with an output projection (the JAX package takes "
                "its unfused XLA blocks there; not ported, ROADMAP Queue 1 "
                "item 1)")
        if pool not in ("cls", "mean"):
            raise ValueError(f"pool {pool!r}: 'cls' or 'mean'")
        self.dtype, self.pool = dtype, pool
        self.dropout, self.attention_dropout = dropout, attention_dropout
        self.img_size = tuple(img_size)
        n = 1
        for i, p in zip(img_size, patch_size):
            n *= i // p
        patch_dim = in_channels * patch_size[0] * patch_size[1] * patch_size[2]
        self.to_patch_embedding = nn.Sequential(
            Patchify(patch_size), LayerNorm(patch_dim),
            nn.Linear(patch_dim, embed_dim), LayerNorm(embed_dim))
        self.pos_embedding = nn.Parameter(torch.zeros(1, n + 1, embed_dim))
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.patch_dim = patch_dim
        # DeepScaleLM (vsn_tpu/models/vit3d.py:464-470): (lam, beta) from
        # the depth; beta scales the gains (``residual_gains``)
        self.enable_stable = enable_stable
        self.lam, self.beta = (compute_residual_gains(
            depth, stable_k, stable_alpha) if enable_stable else (1.0, 1.0))
        rates = stochastic_depth_rates(stochastic_depth_prob, [depth])
        self.transformer = Transformer(
            embed_dim, depth, num_heads, dim_head, mlp_dim, rates,
            post_norm=post_norm, layer_scale=layer_scale,
            layer_scale_init_value=layer_scale_init_value, lam=self.lam)
        self.mlp_head = nn.Sequential(LayerNorm(embed_dim),
                                      nn.Linear(embed_dim, num_classes))

    def blocks(self):
        return list(self.transformer.layers)

    def draw_plan(self, b: int):
        """The random draws of one training forward at batch ``b``, in draw
        order: [(key, None)], the (gf, gb) pair of (i, "res1") and then (i,
        "res2") of every block i with stochastic-depth rate > 0."""
        return [((i, res), None) for i, blk in enumerate(self.blocks())
                if blk.drop_path_rate > 0.0 for res in ("res1", "res2")]

    def num_draws(self) -> int:
        return len(self.draw_plan(1))

    def draw(self, b: int, device, generator):
        """The random draws of one training forward in ``draw_plan`` order,
        drawn from ``generator`` on ``device``: DropPath's (gf, gb) pair of
        every residual that draws (``residual_branch_gains`` without
        ShakeDrop)."""
        blocks = self.blocks()
        return [residual_branch_gains(b, blocks[key[0]].drop_path_rate, False,
                                      deterministic=False,
                                      generator=generator, device=device)
                for key, _ in self.draw_plan(b)]

    def residual_gains(self, b: int, device, generator=None, draws=None):
        """(gf1, gb1, gf2, gb2) of every block, each times DeepScaleLM's
        beta under ENABLE_STABLE. Eval: ones. Training: a block with rate
        > 0 takes its pairs from ``draws`` (a list in ``draw_plan`` order)
        or from ``generator``; a block with rate 0 draws nothing."""
        taken = {}
        if self.training:
            plan = self.draw_plan(b)
            if draws is None:
                if plan and generator is None:
                    raise ValueError("a training forward with stochastic "
                                     "depth needs a generator or injected "
                                     "draws")
                draws = self.draw(b, device, generator)
            if len(draws) != len(plan):
                raise ValueError(f"{len(draws)} injected draws, the model "
                                 f"draws {len(plan)}")
            for (key, _), got in zip(plan, draws):
                if not (isinstance(got, (tuple, list)) and len(got) == 2):
                    raise ValueError(f"draw {key}: expected a (gf, gb) pair")
                taken[key] = got
        out = []
        for i in range(len(self.blocks())):
            gains = []
            for res in ("res1", "res2"):
                pair = taken.get((i, res))
                if pair is None:
                    pair = residual_branch_gains(b, 0.0, False, device=device)
                gains.extend(g * self.beta if self.enable_stable else g
                             for g in pair)
            out.append(tuple(gains))
        return out

    def forward(self, x, generator=None, draws=None):
        """Logits of x. In training mode (``self.training``) the residual
        gains are drawn from ``generator`` or taken from ``draws``."""
        if self.training and (self.dropout > 0 or self.attention_dropout > 0):
            raise NotImplementedError(
                "training with DROPOUT or ATTENTION_DROPOUT > 0 takes the JAX "
                "package's unfused XLA ViT blocks, which have no kernel; not "
                "ported (ROADMAP Queue 1 item 1)")
        b = x.shape[0]
        if tuple(x.shape[1:4]) != self.img_size:
            raise ValueError(f"ViT3D built for {self.img_size}, got "
                             f"{tuple(x.shape[1:4])}")
        gains = self.residual_gains(b, x.device, generator, draws)
        patchify, norm1, proj, norm2 = self.to_patch_embedding
        x = norm2(_linear(norm1(patchify(x.to(self.dtype))), proj))
        cls = self.cls_token.expand(b, 1, -1).to(self.dtype)
        x = torch.cat([cls, x], dim=1) + self.pos_embedding.to(self.dtype)
        for blk, g in zip(self.blocks(), gains):
            x = blk(x, g)
        x = x.mean(dim=1) if self.pool == "mean" else x[:, 0]
        norm, head = self.mlp_head
        return F.linear(norm(x).float(), head.weight, head.bias)


def init_weights(model: ViT3D, generator: torch.Generator) -> ViT3D:
    """Initialize as the JAX package does (vsn_tpu/models/vit3d.py:450-459):
    trunc-normal(0.02) for every Linear kernel, zero biases, LayerNorm scale
    1 and shift 0, LayerScale gamma at its init value, normal(1.0) for the
    CLS token and the position embedding; drawn on the CPU from
    ``generator``. Under ENABLE_STABLE (DeepScaleLM, vit3d.py:146-163,
    :338-346, :439-443) the patch projection, qkv, proj and MLP kernels are
    normal instead: the projection at ``stable_embedding_std`` of the patch
    dim, qkv column-wise (``stable_qkv_init_``) and proj at
    ``stable_vproj_std`` with ATTENTION_DROPOUT, the MLP at
    ``stable_vproj_std`` with DROPOUT."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Linear):
                trunc_normal_(m.weight, 0.02, generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, LayerScale):
                m.gamma.fill_(m.init_value)
        for p in (model.cls_token, model.pos_embedding):
            p.copy_(torch.randn(p.shape, generator=generator))
        if model.enable_stable:
            normal_(model.to_patch_embedding[2].weight,
                    stable_embedding_std(model.patch_dim, model.dropout),
                    generator)
            for blk in model.blocks():
                attn, ff = blk[0], blk[1]
                c = attn.to_out[0].weight.shape[0]
                stable_qkv_init_(attn.to_qkv.weight, c,
                                 model.attention_dropout, generator)
                normal_(attn.to_out[0].weight,
                        stable_vproj_std(c, model.attention_dropout),
                        generator)
                for layer in (ff.net[1], ff.net[4]):
                    normal_(layer.weight, stable_vproj_std(c, model.dropout),
                            generator)
    return model


def vit_from_config(cfg, dtype=torch.float32) -> ViT3D:
    """Build from the public config keys (vsn_tpu/models/vit3d.py
    vit_from_config: mlp_dim = EMBED_DIM * MLP_RATIO, dim_head 64, CLS
    pooling); refuses what the slice does not carry."""
    if cfg.NORM_LAYER not in LN_NAMES:
        raise NotImplementedError(
            f"NORM_LAYER={cfg.NORM_LAYER!r}: ViT's unfused blocks are not "
            "ported (ROADMAP Queue 1 item 1)")
    return ViT3D(
        img_size=cfg.input_size,
        patch_size=tuple(cfg.PATCH_SHAPE),
        num_classes=cfg.num_classes,
        embed_dim=int(cfg.EMBED_DIM),
        depth=int(cfg.DEPTH),
        num_heads=int(cfg.HEADS),
        mlp_dim=int(cfg.EMBED_DIM * cfg.MLP_RATIO),
        in_channels=int(cfg.get("IN_CHANNELS", 1)),
        dropout=float(cfg.DROPOUT),
        attention_dropout=float(cfg.ATTENTION_DROPOUT),
        stochastic_depth_prob=float(cfg.STOCHASTIC_DEPTH_PROB),
        post_norm=bool(cfg.POST_NORM),
        layer_scale=bool(cfg.LAYER_SCALE),
        layer_scale_init_value=float(cfg.LAYER_SCALE_INIT_VALUE),
        enable_stable=bool(cfg.ENABLE_STABLE),
        stable_k=float(cfg.STABLE_K),
        stable_alpha=float(cfg.STABLE_ALPHA),
        dtype=dtype,
    )
