"""AdamW with per-step LR/WD, decay masking, clipping and SAM (port of
vsn_tpu/train/optim.py).

The JAX package maps these over parameter trees. The port's train step
holds every parameter in one flat f32 buffer (train/step.py FlatParams), so
each function here is a handful of elementwise passes over flat tensors,
not a loop of small kernels per leaf; any tensor works, leaf or flat. The
functions are pure: they return new tensors and leave their inputs alone,
so the step can keep or drop an update on a device flag.
"""

from __future__ import annotations

from typing import Mapping, NamedTuple, Sequence

import torch


def wd_mask(shapes: Mapping[str, Sequence[int]]) -> dict[str, bool]:
    """True where decoupled weight decay applies: ndim >= 2 (not a bias nor
    a norm scale; the relative-position bias table [T, H] is decayed)."""
    return {name: len(shape) >= 2 for name, shape in shapes.items()}


class AdamWState(NamedTuple):
    mu: torch.Tensor
    nu: torch.Tensor
    count: torch.Tensor   # updates applied, int32 on the params' device


def adamw_init(params: torch.Tensor) -> AdamWState:
    return AdamWState(mu=torch.zeros_like(params),
                      nu=torch.zeros_like(params),
                      count=torch.zeros((), dtype=torch.int32,
                                        device=params.device))


def adamw_update(grads, state: AdamWState, params, lr: float,
                 weight_decay: float, decay_mask, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
    """One decoupled-AdamW step:
    p <- p - lr * (m_hat / (sqrt(v_hat) + eps) + wd * p * decay_mask).
    ``decay_mask`` is a bool tensor shaped like ``params``."""
    count = state.count + 1
    mu = b1 * state.mu + (1 - b1) * grads
    nu = b2 * state.nu + (1 - b2) * (grads * grads)
    t = count.float()
    c1 = 1 - torch.full_like(t, b1) ** t
    c2 = 1 - torch.full_like(t, b2) ** t
    step = (mu / c1) / (torch.sqrt(nu / c2) + eps)
    step = torch.where(decay_mask, step + weight_decay * params, step)
    return params - lr * step, AdamWState(mu=mu, nu=nu, count=count)


def global_norm(t: torch.Tensor) -> torch.Tensor:
    """sqrt(sum of squares) over every element, f32."""
    return torch.sqrt((t.float() * t.float()).sum())


def clip_by_global_norm(grads, max_norm: float):
    """Scale grads so their global norm is at most max_norm; returns
    (clipped, norm before clipping)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    return grads * scale, norm


def sam_perturbation(params, grads, rho: float, adaptive: bool):
    """e(w) = rho * g / ||g|| (adaptive: rho * w^2 g / || |w| g ||), and the
    norm. A non-finite or zero norm gives an exactly-zero perturbation."""
    gnorm = global_norm(params.abs() * grads if adaptive else grads)
    safe = torch.isfinite(gnorm) & (gnorm > 0)
    scale = torch.where(safe, rho / (gnorm + 1e-12), torch.zeros_like(gnorm))
    e = grads * scale
    if adaptive:
        e = (params * params) * e
    return torch.where(safe, e, torch.zeros_like(e)), gnorm


def all_finite(t: torch.Tensor) -> torch.Tensor:
    """0-d bool tensor: every element is finite."""
    return torch.isfinite(t).all()
