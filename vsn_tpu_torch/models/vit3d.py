"""3D Vision Transformer (port of vsn_tpu/models/vit3d.py).

Channels-last [B, D, H, W, C] in, f32 logits out, as the JAX package:

  patchify (reshape + transpose, patch dims in (pd, ph, pw, C) order) ->
  norm -> Linear -> norm -> CLS token + position embedding -> dropout ->
  ``depth`` blocks -> the CLS row (or the token mean) -> norm -> Linear

Every norm is ``make_norm(NORM_LAYER)``: LayerNorm, RMSNorm or
DynamicTanh. Each half of a block takes one of the JAX package's two
paths, gated on its own as JAX gates it (``fused_attn_gate`` for the
attention half, vsn_tpu/models/vit3d.py:238-257, and ``fused_mlp_gate`` for
the MLP half, :305-318, less their platform and VMEM clauses):

* fused, on the port's hand-written block kernels
  (``ops/swin_block_kernels.py``): K1 ``attn_half`` (LN + qkv, no qkv bias,
  + softmax attention over all N tokens of a sample + proj + gated
  residual) on [B, N, C] as B windows of N tokens with no bias and no
  region mask, and K2 ``ln_mlp`` (LN + MLP + gated residual) on the flat
  [B * N, C] rows. Neither half is fused with USE_PALLAS_ATTENTION off.
  The attention half is fused with a LayerNorm, in eval or
  with both dropouts 0, where heads * dim_head = C and not (heads = 1 and
  dim_head = C); the MLP half with a LayerNorm, in eval or with DROPOUT 0.
  At ViT's head dim of 64 K1 takes its key-tiled attention body. The TPU's
  pad of the rows to a multiple of 8 for its MLP tiling is not needed: the
  card's GEMMs take any row count;
* unfused, elsewhere (``ViTAttention`` :52-123 and ``ViTBlock.__call__``
  :198-236, XLA there and plain PyTorch here, which no kernel computes on
  either side): the attention half is the norm (pre-norm only), a bias-free
  qkv Linear of width 3 * heads * dim_head, ``layers.softmax_attention``
  (f32 scores and softmax, dropout on the probabilities at
  ATTENTION_DROPOUT), the proj Linear and its dropout (ATTENTION_DROPOUT)
  where ``project_out`` (not where heads = 1 and dim_head = C), then under
  post-norm ``attn_norm``, and the gated residual; the MLP half is the norm
  (``ff_prenorm``, pre-norm only), fc1, GELU, dropout, fc2, dropout
  (DROPOUT), under post-norm ``ff_norm``, and the gated residual.
  A LayerNorm model at HEADS 2 (2 x 64 != 384), or training with only
  ATTENTION_DROPOUT > 0, mixes the two: an unfused attention half and the
  fused K2 MLP half.

The residual gains are DropPath's: ViT ignores USE_SHAKEDROP on both JAX
paths (``residual_branch_gains(b, rate, False, ...)``). In training they,
and the dropout keep masks, are drawn from a ``torch.Generator`` or
injected (``ViT3D.draw``, ``draw_plan``), as Swin's are.

Parameters carry the names of the reference's state_dict, as
scripts/golden_parity.py ``port_vit`` reads them: ``to_patch_embedding.
{1,2,3}``, ``pos_embedding``, ``cls_token``, ``transformer.layers.{i}.0.
{norm, to_qkv, to_out.0}`` (no ``to_out`` without ``project_out``),
``transformer.layers.{i}.1.net.{0,1,4}``, ``mlp_head.{0,1}``. Both paths
hold the same ones. They stay f32; with FP16 the activations are bf16.

The residual options ride both paths, as in the JAX package: POST_NORM
moves each half's norm onto its branch output, where it is the block's
``attn_norm`` / ``ff_norm`` (the attention half then has no ``norm`` and
the MLP half's ``net.0`` is the identity, as the JAX tree has no
``attn/norm`` and no ``ff_prenorm``); LAYER_SCALE adds a gamma per residual
(``res1``, ``res2``, the JAX tree's ``res*/LayerScale_0``); and
ENABLE_STABLE (DeepScaleLM) gives every residual lam * x + beta * branch
with (lam, beta) from ``depth`` (beta folded into the gains) and the stable
inits (``init_weights``). The fused halves carry them in band in K1 / K2,
the unfused ones in plain PyTorch.
"""

from __future__ import annotations

from typing import Literal

import torch
import torch.nn.functional as F
from torch import nn

from vsn_tpu_torch.models.layers import (
    LN_NAMES,
    DynamicTanh,
    LayerScale,
    RandomDraws,
    RMSNorm,
    dropout,
    gated_residual,
    linear,
    make_norm,
    mlp,
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


def fused_attn_gate(use_pallas: bool, norm_layer, dropout_rate: float,
                    attention_dropout: float, heads: int, dim_head: int,
                    dim: int, training: bool) -> bool:
    """Whether a block's attention half runs K1 (else unfused):
    USE_PALLAS_ATTENTION, a LayerNorm, no dropout unless in eval, and
    heads * dim_head = dim with an
    output projection. The card's version of vsn_tpu/models/vit3d.py
    ViTBlock._fused_attn_ok (:238-257), whose VMEM budget and platform
    clauses are the TPU's."""
    return (use_pallas and norm_layer in LN_NAMES
            and (not training
                 or (dropout_rate == 0.0 and attention_dropout == 0.0))
            and heads * dim_head == dim
            and not (heads == 1 and dim_head == dim))


def fused_mlp_gate(use_pallas: bool, norm_layer, dropout_rate: float,
                   training: bool) -> bool:
    """Whether a block's MLP half runs K2 (else unfused):
    USE_PALLAS_ATTENTION, a LayerNorm, and no dropout unless in eval
    (vsn_tpu/models/vit3d.py _fused_mlp_ok, :305-318, less its platform
    clause)."""
    return use_pallas and norm_layer in LN_NAMES and (
        not training or dropout_rate == 0.0)


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


class Attention(nn.Module):
    """The parameters of one block's attention half (reference
    ``transformer.layers.{i}.0``): pre-norm (none under post-norm), qkv
    without bias of width 3 * heads * dim_head, and the output projection
    ``to_out.0`` where ``project_out`` (vsn_tpu/models/vit3d.py:73: not
    where heads = 1 and dim_head = dim; ``to_out`` is None there). The
    block's K1 call or its unfused half reads them."""

    def __init__(self, dim: int, heads: int, dim_head: int,
                 post_norm: bool = False, norm_layer=None):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        self.scale = dim_head ** -0.5
        inner = heads * dim_head
        self.norm = None if post_norm else make_norm(norm_layer, dim)
        self.to_qkv = nn.Linear(dim, 3 * inner, bias=False)
        self.project_out = not (heads == 1 and dim_head == dim)
        self.to_out = (nn.Sequential(nn.Linear(inner, dim))
                       if self.project_out else None)


class FeedForward(nn.Module):
    """The parameters of one block's MLP half (reference
    ``transformer.layers.{i}.1.net``): the norm (the identity under
    post-norm), fc1, GELU, dropout, fc2; the block's K2 call or its unfused
    half reads net.0, net.1 and net.4."""

    def __init__(self, dim: int, hidden: int, post_norm: bool = False,
                 norm_layer=None):
        super().__init__()
        self.net = nn.Sequential(
            nn.Identity() if post_norm else make_norm(norm_layer, dim),
            nn.Linear(dim, hidden), nn.GELU(), nn.Identity(),
            nn.Linear(hidden, dim))


class ViTBlock(nn.Module):
    """One block: ``0`` the attention half, ``1`` the MLP half, each one
    kernel call on the whole sequence or its unfused form, as the half's
    gate decides; under post-norm ``attn_norm`` and ``ff_norm`` are the
    norms of the branch outputs, and with LayerScale ``res1`` / ``res2``
    hold the gammas. ``gains`` is (gf1, gb1, gf2, gb2), the per-sample
    branch gains of its two residuals, ``masks`` the keep masks (attn,
    proj, fc1, fc2) of its dropouts (None: none), and ``lam`` the residual
    x-gain."""

    def __init__(self, dim: int, heads: int, dim_head: int, mlp_dim: int,
                 drop_path_rate: float = 0.0, post_norm: bool = False,
                 layer_scale: bool = False,
                 layer_scale_init_value: float = 1e-5, lam: float = 1.0,
                 norm_layer=None, dropout: float = 0.0,
                 attention_dropout: float = 0.0):
        super().__init__()
        self.add_module("0", Attention(dim, heads, dim_head, post_norm,
                                       norm_layer))
        self.add_module("1", FeedForward(dim, mlp_dim, post_norm, norm_layer))
        self.drop_path_rate = drop_path_rate
        self.post_norm, self.lam = post_norm, lam
        self.norm_layer, self.dim = norm_layer, dim
        self.dropout, self.attention_dropout = dropout, attention_dropout
        self.use_pallas = True  # USE_PALLAS_ATTENTION, set by the model
        self.attn_norm = self.ff_norm = self.res1 = self.res2 = None
        if post_norm:
            self.attn_norm = make_norm(norm_layer, dim)
            self.ff_norm = make_norm(norm_layer, dim)
        if layer_scale:
            self.res1 = LayerScale(dim, layer_scale_init_value)
            self.res2 = LayerScale(dim, layer_scale_init_value)

    def __getitem__(self, i: int) -> nn.Module:
        """The attention half (0) or the MLP half (1)."""
        return self._modules[str(i)]

    def fused_attn(self) -> bool:
        """The attention half's path in the current mode."""
        attn = self[0]
        return fused_attn_gate(self.use_pallas, self.norm_layer,
                               self.dropout, self.attention_dropout,
                               attn.heads, attn.dim_head, self.dim,
                               self.training)

    def fused_mlp(self) -> bool:
        """The MLP half's path in the current mode."""
        return fused_mlp_gate(self.use_pallas, self.norm_layer, self.dropout,
                              self.training)

    def _residual(self, x, branch, norm, scale, gf, gb):
        """The unfused residual: branch -> [post-norm] -> [LayerScale] ->
        lam * x + gains * branch (layers.py ResidualBranch order)."""
        if self.post_norm:
            branch = norm(branch)
        if scale is not None:
            branch = scale(branch)
        return gated_residual(x, branch, gf, gb, self.lam)

    def attn_unfused(self, x, gf, gb, masks=(None, None)):
        """The unfused attention half on x [B, N, C] (vsn_tpu/models/
        vit3d.py:52-123, :201-215); ``masks`` the attention and proj
        dropouts' keep masks."""
        attn = self[0]
        b, n, _ = x.shape
        h = x if self.post_norm else attn.norm(x)
        q, k, v = linear(h, attn.to_qkv).reshape(
            b, n, 3, attn.heads, attn.dim_head).permute(2, 0, 3, 1, 4)
        out = softmax_attention(q, k, v, attn.scale,
                                rate=self.attention_dropout, mask=masks[0])
        out = out.transpose(1, 2).reshape(b, n, -1).to(x.dtype)
        if attn.project_out:
            out = dropout(linear(out, attn.to_out[0]),
                          self.attention_dropout, masks[1])
        return self._residual(x, out, self.attn_norm, self.res1, gf, gb)

    def mlp_unfused(self, x, gf, gb, masks=(None, None)):
        """The unfused MLP half (:220-235); ``masks`` the keep masks after
        GELU and after fc2."""
        ff = self[1]
        h = x if self.post_norm else ff.net[0](x)
        out = mlp(h, ff.net[1], ff.net[4], self.dropout, masks)
        return self._residual(x, out, self.ff_norm, self.res2, gf, gb)

    def forward(self, x, gains, masks=(None,) * 4):
        """x [B, N, C] -> [B, N, C] in x's dtype."""
        attn, ff = self[0], self[1]
        gf1, gb1, gf2, gb2 = gains
        if self.fused_attn():
            norm1 = self.attn_norm if self.post_norm else attn.norm
            x = attn_half(x, norm1.weight, norm1.bias, attn.to_qkv.weight,
                          None, None, None, attn.to_out[0].weight,
                          attn.to_out[0].bias, gf1, gb1, attn.scale,
                          attn.heads, lam=self.lam,
                          gamma=None if self.res1 is None else self.res1.gamma,
                          post_norm=self.post_norm)
        else:
            x = self.attn_unfused(x, gf1, gb1, masks[:2])
        if not self.fused_mlp():
            return self.mlp_unfused(x, gf2, gb2, masks[2:])
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
                 **block):
        super().__init__()
        self.layers = nn.ModuleList(
            ViTBlock(dim, heads, dim_head, mlp_dim, rates[i], **block)
            for i in range(depth))


class ViT3D(RandomDraws, nn.Module):
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
                 stable_alpha: float = 1.0, norm_layer=None,
                 use_pallas: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        for i, p in zip(img_size, patch_size):
            if i % p:
                raise ValueError(f"img_size {tuple(img_size)} not divisible "
                                 f"by patch {tuple(patch_size)}")
        if pool not in ("cls", "mean"):
            raise ValueError(f"pool {pool!r}: 'cls' or 'mean'")
        self.dtype, self.pool = dtype, pool
        self.dropout, self.attention_dropout = dropout, attention_dropout
        self.img_size = tuple(img_size)
        n = 1
        for i, p in zip(img_size, patch_size):
            n *= i // p
        self.n_tokens, self.embed_dim = n + 1, embed_dim
        patch_dim = in_channels * patch_size[0] * patch_size[1] * patch_size[2]
        self.to_patch_embedding = nn.Sequential(
            Patchify(patch_size), make_norm(norm_layer, patch_dim),
            nn.Linear(patch_dim, embed_dim), make_norm(norm_layer, embed_dim))
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
            layer_scale_init_value=layer_scale_init_value, lam=self.lam,
            norm_layer=norm_layer, dropout=dropout,
            attention_dropout=attention_dropout)
        self.mlp_head = nn.Sequential(make_norm(norm_layer, embed_dim),
                                      nn.Linear(embed_dim, num_classes))
        # USE_PALLAS_ATTENTION (vsn_tpu/models/vit3d.py:535): off, both
        # halves of every block run unfused, in eval and in training
        for blk in self.blocks():
            blk.use_pallas = use_pallas

    def blocks(self):
        return list(self.transformer.layers)

    def draw_plan(self, b: int):
        """The random draws of one training forward at batch ``b``, in draw
        order: [(key, shape)]. First the embedding dropout's keep mask
        (key "embed", [B, N, C]), then for each block i as it runs them:
        (i, "attn") the attention dropout's keep mask [B, heads, N, N] over
        the probabilities, (i, "proj") the proj dropout's [B, N, C] (where
        the block projects), (i, "res1") the first residual's (gf, gb), (i,
        "fc1") and (i, "fc2") the MLP dropouts' [B, N, mlp_dim] and [B, N,
        C], (i, "res2"). The embed and MLP masks exist with DROPOUT > 0, the
        attn and proj ones with ATTENTION_DROPOUT > 0 (the rate of both, as
        in ViTAttention), gains for a block with stochastic-depth rate > 0;
        a gain pair's shape is None."""
        n, c = self.n_tokens, self.embed_dim
        drop, attn = self.dropout > 0.0, self.attention_dropout > 0.0
        plan = [("embed", (b, n, c))] if drop else []
        for i, blk in enumerate(self.blocks()):
            gains = blk.drop_path_rate > 0.0
            if attn:
                plan.append(((i, "attn"), (b, blk[0].heads, n, n)))
                if blk[0].project_out:
                    plan.append(((i, "proj"), (b, n, c)))
            if gains:
                plan.append(((i, "res1"), None))
            if drop:
                hidden = blk[1].net[1].out_features
                plan += [((i, "fc1"), (b, n, hidden)), ((i, "fc2"), (b, n, c))]
            if gains:
                plan.append(((i, "res2"), None))
        return plan

    def mask_rate(self, key) -> float:
        return (self.attention_dropout if key[1:] in (("attn",), ("proj",))
                else self.dropout)

    def draw_gains(self, b: int, key, device, generator):
        """DropPath's (gf, gb) of block key[0] (``residual_branch_gains``
        without ShakeDrop)."""
        return residual_branch_gains(b, self.blocks()[key[0]].drop_path_rate,
                                     False, deterministic=False,
                                     generator=generator, device=device)

    def residual_gains(self, b: int, device, taken):
        """(gf1, gb1, gf2, gb2) of every block, each times DeepScaleLM's
        beta under ENABLE_STABLE: a block's pairs from ``taken``
        (``taken_draws``) where it draws, else ones."""
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
        gains and dropout keep masks are drawn from ``generator`` or taken
        from ``draws`` (``draw``)."""
        b = x.shape[0]
        if tuple(x.shape[1:4]) != self.img_size:
            raise ValueError(f"ViT3D built for {self.img_size}, got "
                             f"{tuple(x.shape[1:4])}")
        taken = self.taken_draws(b, x.device, generator, draws)
        gains = self.residual_gains(b, x.device, taken)
        patchify, norm1, proj, norm2 = self.to_patch_embedding
        x = norm2(linear(norm1(patchify(x.to(self.dtype))), proj))
        cls = self.cls_token.expand(b, 1, -1).to(self.dtype)
        x = torch.cat([cls, x], dim=1) + self.pos_embedding.to(self.dtype)
        x = dropout(x, self.dropout, taken.get("embed"))
        for i, (blk, g) in enumerate(zip(self.blocks(), gains)):
            x = blk(x, g, tuple(taken.get((i, k)) for k in
                                ("attn", "proj", "fc1", "fc2")))
        x = x.mean(dim=1) if self.pool == "mean" else x[:, 0]
        norm, head = self.mlp_head
        return F.linear(norm(x).float(), head.weight, head.bias)


def init_weights(model: ViT3D, generator: torch.Generator) -> ViT3D:
    """Initialize as the JAX package does (vsn_tpu/models/vit3d.py:450-459):
    trunc-normal(0.02) for every Linear kernel, zero biases, LayerNorm and
    RMSNorm scale 1, LayerNorm shift 0, DynamicTanh alpha 0.5, gamma 1,
    beta 0, LayerScale gamma at its init value, normal(1.0) for the CLS
    token and the position embedding; drawn on the CPU from ``generator``.
    Under ENABLE_STABLE (DeepScaleLM, vit3d.py:79-81, :113-117, :146-163,
    :338-346, :439-443) the patch projection, qkv, proj and MLP kernels are
    normal instead: the projection at ``stable_embedding_std`` of the patch
    dim, qkv column-wise (``stable_qkv_init_``) and proj at
    ``stable_vproj_std`` of its input width (heads * dim_head) with
    ATTENTION_DROPOUT, the MLP at ``stable_vproj_std`` with DROPOUT."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Linear):
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
        for p in (model.cls_token, model.pos_embedding):
            p.copy_(torch.randn(p.shape, generator=generator))
        if model.enable_stable:
            normal_(model.to_patch_embedding[2].weight,
                    stable_embedding_std(model.patch_dim, model.dropout),
                    generator)
            c = model.embed_dim
            for blk in model.blocks():
                attn, ff = blk[0], blk[1]
                stable_qkv_init_(attn.to_qkv.weight, c,
                                 model.attention_dropout, generator)
                if attn.project_out:
                    proj = attn.to_out[0].weight
                    normal_(proj, stable_vproj_std(proj.shape[1],
                                                   model.attention_dropout),
                            generator)
                for layer in (ff.net[1], ff.net[4]):
                    normal_(layer.weight, stable_vproj_std(c, model.dropout),
                            generator)
    return model


def vit_from_config(cfg, dtype=torch.float32) -> ViT3D:
    """Build from the public config keys (vsn_tpu/models/vit3d.py
    vit_from_config: mlp_dim = EMBED_DIM * MLP_RATIO, dim_head 64, CLS
    pooling, every norm ``make_norm(NORM_LAYER)``)."""
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
        norm_layer=cfg.NORM_LAYER,
        use_pallas=bool(cfg.get("USE_PALLAS_ATTENTION", True)),
        dtype=dtype,
    )
