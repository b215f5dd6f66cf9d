"""DeepScaleLM stable residual gains and depth-aware initializers (port of
vsn_tpu/ops/stable_init.py, "Transformers Get Stable", ICML 2024).

  * gains: beta^2 = k / N^alpha (clamped to [0, 1]), lam^2 = 1 - beta^2;
  * embedding / patch-projection init: std = sqrt(((1 - p) / num_tables) /
    fan_in);
  * Q / K init: std = 1 / sqrt(d_in);
  * V / attention-out / FFN init: std = sqrt((sqrt(1 - p) / 2) / d_in).

``stable_qkv_init_`` is the torch-layout form of the JAX ``stable_qkv_init``:
a fused qkv Linear weight [3 C_inner, d_in] whose q and k rows get the Q/K
std and whose v rows get the V std (the JAX kernel [d_in, 3 C_inner] scales
its columns the same way). Draws come from a CPU ``torch.Generator``, so the
values do not depend on the weight's device; JAX's threefry streams are not
reproduced, the distributions are.
"""

from __future__ import annotations

import math

import torch


def compute_residual_gains(n: int, k: float = 2.0, alpha: float = 1.0):
    """(lam, beta) with beta^2 = k / n^alpha clamped to [0, 1] and lam^2 =
    1 - beta^2."""
    beta2 = min(max(k / (n ** alpha), 0.0), 1.0)
    return math.sqrt(1.0 - beta2), math.sqrt(beta2)


def stable_embedding_std(fan_in: int, dropout_prob: float = 0.0,
                         num_tables: int = 1) -> float:
    return math.sqrt(((1.0 - dropout_prob) / num_tables) / fan_in)


def stable_qk_std(d_in: int) -> float:
    return 1.0 / math.sqrt(d_in)


def stable_vproj_std(d_in: int, dropout_prob: float = 0.0) -> float:
    """V / attention-out / FFN std: sqrt((sqrt(1 - p) / 2) / d_in)."""
    return math.sqrt((math.sqrt(1.0 - dropout_prob) / 2.0) / d_in)


def normal_(t: torch.Tensor, std: float, generator: torch.Generator):
    """Fill ``t`` with N(0, std^2) drawn on the CPU from ``generator``."""
    draw = torch.randn(t.shape, generator=generator) * std
    with torch.no_grad():
        return t.copy_(draw)


def stable_qkv_init_(weight: torch.Tensor, d_in: int, dropout_prob: float,
                     generator: torch.Generator):
    """Fill a fused qkv weight [3 C_inner, d_in]: rows [0, 2 C_inner) (q and
    k) with std ``stable_qk_std(d_in)``, rows [2 C_inner, 3 C_inner) (v)
    with ``stable_vproj_std(d_in, dropout_prob)``."""
    rows, cols = weight.shape
    if cols != d_in or rows % 3:
        raise ValueError(f"qkv weight {tuple(weight.shape)} for d_in {d_in}")
    inner = rows // 3
    scale = torch.full((rows, 1), stable_qk_std(d_in))
    scale[2 * inner:] = stable_vproj_std(d_in, dropout_prob)
    draw = torch.randn(weight.shape, generator=generator) * scale
    with torch.no_grad():
        return weight.copy_(draw)
