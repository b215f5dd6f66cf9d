"""Shared building blocks (port of vsn_tpu/models/layers.py).

LayerNorm with f32 statistics, the residual branch gains (eval, and the
training draws of DropPath and ShakeDrop), the gated residual and the MLP.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

LN_NAMES = (None, False, "nn.LayerNorm", "LayerNorm")
NORMS_NOT_PORTED = ("RMSNorm", "DynamicTanh")


class LayerNorm(nn.LayerNorm):
    """LayerNorm (eps 1e-5) with f32 statistics; output in the input dtype.
    Parameters stay f32, as flax's nn.LayerNorm(dtype=...) keeps them."""

    def __init__(self, dim: int):
        super().__init__(dim, eps=1e-5)

    def forward(self, x):
        y = F.layer_norm(x.float(), self.normalized_shape, self.weight,
                         self.bias, self.eps)
        return y.to(x.dtype)


def make_norm(norm_name, dim: int) -> nn.Module:
    """Map the NORM_LAYER config string to a norm module."""
    if norm_name in LN_NAMES:
        return LayerNorm(dim)
    if norm_name in NORMS_NOT_PORTED:
        raise NotImplementedError(
            f"NORM_LAYER={norm_name!r} is not ported yet (ROADMAP: non-LN "
            "norms)")
    raise ValueError(f"Unknown NORM_LAYER: {norm_name!r}")


def shakedrop_gains(gate, alpha, beta):
    """ShakeDrop's (gf, gb) from its draws: the branch passes (1) when the
    scalar ``gate`` is set, else it is scaled by per-sample ``alpha``
    forward and its cotangent by ``beta`` backward."""
    ones = torch.ones_like(alpha)
    return torch.where(gate, ones, alpha), torch.where(gate, ones, beta)


def drop_path_gains(mask, keep: float):
    """DropPath's (gf, gb) from its per-sample keep ``mask``."""
    g = mask.float() / keep
    return g, g


def residual_branch_gains(n: int, drop_path_rate: float, use_shakedrop: bool,
                          alpha_range=(-1.0, 1.0), deterministic: bool = True,
                          generator: torch.Generator | None = None,
                          device=None):
    """Per-sample (forward, backward) branch gains [n] f32 of one residual
    (vsn_tpu/models/layers.py:170-201).

    Eval: DropPath is the identity (ones); ShakeDrop scales the branch by
    its expectation, 1 - p. Training, with rate p > 0, draws from
    ``generator`` (on ``device``, so a CUDA generator makes no host round
    trip): ShakeDrop one scalar gate ~ Bernoulli(1 - p), then alpha ~
    U(alpha_range) and beta ~ U(0, 1) per sample; DropPath a per-sample
    mask ~ Bernoulli(1 - p). JAX's threefry streams are not reproduced:
    the distributions are."""
    ones = torch.ones((n,), dtype=torch.float32, device=device)
    if use_shakedrop and drop_path_rate > 0.0:
        if deterministic:
            g = torch.full((n,), 1.0 - drop_path_rate, dtype=torch.float32,
                           device=device)
            return g, g
        gate = torch.rand((), generator=generator, device=device) < (
            1.0 - drop_path_rate)
        a0, a1 = alpha_range
        alpha = torch.rand((n,), generator=generator, device=device) * (
            a1 - a0) + a0
        beta = torch.rand((n,), generator=generator, device=device)
        return shakedrop_gains(gate, alpha, beta)
    if drop_path_rate > 0.0 and not deterministic:
        keep = 1.0 - drop_path_rate
        mask = torch.rand((n,), generator=generator, device=device) < keep
        return drop_path_gains(mask, keep)
    return ones, ones


class _GatedResidual(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, branch, gf, gb, lam):
        ctx.save_for_backward(gb)
        ctx.lam, ctx.branch_dtype = lam, branch.dtype
        shape = (x.shape[0],) + (1,) * (x.ndim - 1)
        return (lam * x.float() + gf.float().reshape(shape) * branch.float()
                ).to(x.dtype)

    @staticmethod
    def backward(ctx, do):
        (gb,) = ctx.saved_tensors
        shape = (do.shape[0],) + (1,) * (do.ndim - 1)
        dbranch = (gb.float().reshape(shape) * do.float()).to(ctx.branch_dtype)
        return ctx.lam * do, dbranch, None, None, None


def gated_residual(x, branch, gf, gb, lam: float = 1.0):
    """lam * x + gf[s] * branch, formed in f32 and cast to x's dtype, with
    the backward dbranch = gb[s] * do, dx = lam * do; the gains are per
    sample along axis 0 and get no gradient (layers.py:204-230)."""
    return _GatedResidual.apply(x, branch, gf, gb, lam)


class Mlp(nn.Sequential):
    """Linear -> exact-erf GELU -> Dropout -> Linear -> Dropout; children
    0 and 3 are the reference state_dict's ``mlp.0`` / ``mlp.3``."""

    def __init__(self, dim: int, hidden: int, dropout: float = 0.0):
        super().__init__(nn.Linear(dim, hidden), nn.GELU(),
                         nn.Dropout(dropout), nn.Linear(hidden, dim),
                         nn.Dropout(dropout))


def stochastic_depth_rates(total_rate: float,
                           depths: Sequence[int]) -> list[float]:
    """Linearly increasing per-block rates (torch.linspace(0, rate, n))."""
    n = sum(depths)
    if n <= 1:
        return [0.0] * n
    return [total_rate * i / (n - 1) for i in range(n)]


def trunc_normal_(t: torch.Tensor, std: float, generator: torch.Generator):
    """Truncated normal at +-2 std, as jax.nn.initializers.truncated_normal
    (no variance correction). Drawn on the CPU from ``generator`` and copied
    into ``t``, so the values do not depend on t's device."""
    draw = nn.init.trunc_normal_(torch.empty(t.shape), std=std, a=-2.0 * std,
                                 b=2.0 * std, generator=generator)
    with torch.no_grad():
        return t.copy_(draw)
