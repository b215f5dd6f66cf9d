"""Shared building blocks (port of vsn_tpu/models/layers.py).

The norms (LayerNorm, RMSNorm, DynamicTanh, all with f32 statistics),
LayerScale, the residual branch gains (eval, and the training draws of
DropPath and ShakeDrop), the gated residual, dropout on an explicit keep
mask, the MLP, the JAX package's XLA attention (``softmax_attention``:
Swin's attention-dropout branch, ViT's unfused half, MedViT's E-MHSA) and
the models' random draws (``RandomDraws``: drawn from a generator or
injected, in one plan order).

A residual branch takes its decorations in the JAX ``ResidualBranch``
order (layers.py:237-275): branch -> [post-norm] -> LayerScale -> the gains
of ShakeDrop / DropPath -> ``lam * x + beta * branch`` with DeepScaleLM's
stable residuals (else ``x + branch``). The models fold beta into the
per-sample gains (gf, gb) and pass lam to ``gated_residual``, as the JAX
fused path does (vsn_tpu/models/swin3d.py:864-891).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

LN_NAMES = (None, False, "nn.LayerNorm", "LayerNorm")


class LayerNorm(nn.LayerNorm):
    """LayerNorm (eps 1e-5) with f32 statistics; output in the input dtype.
    Parameters stay f32, as flax's nn.LayerNorm(dtype=...) keeps them."""

    def __init__(self, dim: int):
        super().__init__(dim, eps=1e-5)

    def forward(self, x):
        y = F.layer_norm(x.float(), self.normalized_shape, self.weight,
                         self.bias, self.eps)
        return y.to(x.dtype)


class RMSNorm(nn.Module):
    """Root-mean-square norm (layers.py:27-40): x * rsqrt(mean(x^2) + 1e-6)
    in f32, times ``weight`` (the JAX ``scale``), cast to x's dtype."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        x32 = x.float()
        var = (x32 * x32).mean(dim=-1, keepdim=True)
        return (x32 * torch.rsqrt(var + self.eps) * self.weight).to(x.dtype)


class DynamicTanh(nn.Module):
    """DyT(x) = gamma * tanh(alpha * x) + beta (layers.py:43-60), the
    normalization-free option of NORM_LAYER: tanh in f32, cast to x's
    dtype; ``alpha`` is one scalar (a 0-d parameter) initialized to 0.5."""

    def __init__(self, dim: int, alpha_init: float = 0.5):
        super().__init__()
        self.alpha_init = alpha_init
        self.alpha = nn.Parameter(torch.tensor(alpha_init))
        self.gamma = nn.Parameter(torch.ones(dim))
        self.beta = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        y = torch.tanh(self.alpha * x.float())
        return (self.gamma * y + self.beta).to(x.dtype)


def make_norm(norm_name, dim: int) -> nn.Module:
    """Map the NORM_LAYER config string to a norm module."""
    if norm_name in LN_NAMES:
        return LayerNorm(dim)
    if norm_name == "RMSNorm":
        return RMSNorm(dim)
    if norm_name == "DynamicTanh":
        return DynamicTanh(dim)
    raise ValueError(f"Unknown NORM_LAYER: {norm_name!r}")


class LayerScale(nn.Module):
    """Learnable per-channel scale of a residual branch (CaiT; layers.py:
    78-95): ``gamma`` [C] f32, initialized to ``init_value``; the branch is
    scaled in f32 and cast back to its dtype. The fused blocks pass
    ``gamma`` to their kernels, which scale in band."""

    def __init__(self, dim: int, init_value: float = 1e-5):
        super().__init__()
        self.init_value = init_value
        self.gamma = nn.Parameter(torch.full((dim,), float(init_value)))

    def forward(self, x):
        return (x.float() * self.gamma).to(x.dtype)


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


def dropout_mask(shape, rate: float, generator: torch.Generator, device):
    """A keep mask (bool) of ``shape``: each element kept with p = 1 - rate,
    drawn from ``generator`` on ``device``."""
    return torch.rand(shape, generator=generator, device=device) < 1.0 - rate


def dropout(x, rate: float, mask):
    """flax nn.Dropout on an explicit keep mask: where(mask, x / (1 - rate),
    0) in x's dtype (layers.py:302, 306). ``mask`` None is the identity
    (eval, or rate 0)."""
    if mask is None:
        return x
    return torch.where(mask, x / (1.0 - rate),
                       torch.zeros((), dtype=x.dtype, device=x.device))


class Dropout(nn.Module):
    """``dropout`` as a module: the mask is passed in with x, never drawn
    from torch's global generator."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x, mask=None):
        return dropout(x, self.rate, mask)


def linear(x, layer: nn.Linear):
    """A Linear in x's dtype (flax nn.Dense(dtype=...): f32 parameters cast
    to the activation type)."""
    bias = None if layer.bias is None else layer.bias.to(x.dtype)
    return F.linear(x, layer.weight.to(x.dtype), bias)


def mlp(x, fc1: nn.Linear, fc2: nn.Linear, rate: float, masks=(None, None)):
    """fc1 -> exact-erf GELU -> dropout -> fc2 -> dropout in x's dtype
    (layers.py:282-307); ``masks`` the two keep masks (None: none)."""
    x = dropout(F.gelu(linear(x, fc1)), rate, masks[0])
    return dropout(linear(x, fc2), rate, masks[1])


class Mlp(nn.Sequential):
    """Linear -> exact-erf GELU -> Dropout -> Linear -> Dropout
    (layers.py:282-307); children 0 and 3 are the reference state_dict's
    ``mlp.0`` / ``mlp.3``. The products run in x's dtype; ``masks`` are the
    two dropouts' keep masks (None: no dropout)."""

    def __init__(self, dim: int, hidden: int, dropout: float = 0.0):
        super().__init__(nn.Linear(dim, hidden), nn.GELU(), Dropout(dropout),
                         nn.Linear(hidden, dim), Dropout(dropout))

    def forward(self, x, masks=(None, None)):
        return mlp(x, self[0], self[3], self[2].rate, masks)


REGION_MASK = -100.0


def region_mask(ids: torch.Tensor) -> torch.Tensor:
    """[W, N] region ids -> the additive [W, N, N] f32 mask of the JAX XLA
    attention branch: -100 where the ids differ (vsn_tpu/models/swin3d.py
    :689-697; the kernels mask with -1e9)."""
    diff = ids[:, :, None] != ids[:, None, :]
    return torch.where(diff, REGION_MASK, 0.0).to(torch.float32)


def softmax_attention(q, k, v, scale: float, bias=None, ids=None,
                      rate: float = 0.0, mask=None):
    """Multi-head attention as the JAX package's XLA branches compute it
    (WindowAttention3D :677-712, ViTAttention :89-109, EMHSA): q [B, H, N,
    d], k and v [B, H, M, d] in the activation dtype. The scores q . k,
    formed in (at least) f32 from the operands' values and taken as f32 (the
    einsum's preferred_element_type), times ``scale``; plus ``bias`` [H, N,
    M] f32 and the region mask of ``ids`` [W, N] (B = b W, window w of
    sample s at row s W + w); the softmax in f32; dropout on the
    probabilities with the keep mask ``mask`` [B, H, N, M] at ``rate``; the
    probabilities cast to v's dtype and their product with v taken as f32.
    Returns [B, H, N, d] f32. Plain PyTorch: the branch has no kernel on
    either side. In bf16 the f32 products are exact, TF32 or not (a bf16
    value is a TF32 value)."""
    acc = torch.promote_types(q.dtype, torch.float32)
    s = torch.matmul(q.to(acc), k.to(acc).transpose(-1, -2)).float() * scale
    if bias is not None:
        s = s + bias.float()
    if ids is not None:
        shape = s.shape
        s = (s.view(-1, ids.shape[0], *shape[1:])
             + region_mask(ids)[None, :, None]).view(shape)
    p = dropout(torch.softmax(s, dim=-1), rate, mask)
    return torch.matmul(p.to(v.dtype).to(acc), v.to(acc)).float()


class RandomDraws:
    """The random draws of a model's training forward, drawn or injected
    (a mixin of the models). A model names its draws in ``draw_plan(b)``:
    [(key, shape)] in the order its forward consumes them, a bool keep
    mask of ``shape`` or, where shape is None, a residual's (gf, gb) gain
    pair; ``mask_rate(key)`` is a mask's dropout rate and ``draw_gains(b,
    key, device, generator)`` draws a gain pair."""

    def draw_plan(self, b: int):
        raise NotImplementedError

    def mask_rate(self, key) -> float:
        raise NotImplementedError

    def draw_gains(self, b: int, key, device, generator):
        raise NotImplementedError

    def num_draws(self) -> int:
        """Entries of ``draw()``: keep masks and residual gain pairs."""
        return len(self.draw_plan(1))

    def draw(self, b: int, device, generator):
        """The random draws of one training forward, in ``draw_plan`` order
        and the form ``forward(draws=)`` takes, drawn from ``generator`` on
        ``device``: bool keep masks (each element kept with p = 1 - its
        rate) and gain pairs."""
        return [self.draw_gains(b, key, device, generator) if shape is None
                else dropout_mask(shape, self.mask_rate(key), generator,
                                  device)
                for key, shape in self.draw_plan(b)]

    def taken_draws(self, b: int, device, generator=None, draws=None):
        """key -> draw of one forward: nothing in eval; in training the
        ``draws`` given (a list in ``draw_plan`` order), else drawn from
        ``generator``."""
        if not self.training:
            return {}
        plan = self.draw_plan(b)
        if draws is None:
            if plan and generator is None:
                raise ValueError("a training forward with stochastic depth or "
                                 "dropout needs a generator or injected draws")
            draws = self.draw(b, device, generator)
        if len(draws) != len(plan):
            raise ValueError(f"{len(draws)} injected draws, the model draws "
                             f"{len(plan)}")
        for (key, shape), got in zip(plan, draws):
            if shape is None:
                ok, want = isinstance(got, (tuple, list)) and len(got) == 2, \
                    "a (gf, gb) pair"
            else:
                ok = (isinstance(got, torch.Tensor) and got.dtype == torch.bool
                      and tuple(got.shape) == tuple(shape))
                want = f"a bool keep mask {tuple(shape)}"
            if not ok:
                raise ValueError(f"draw {key}: expected {want}")
        return {key: got for (key, _), got in zip(plan, draws)}


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
