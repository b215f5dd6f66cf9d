"""Classification losses (port of vsn_tpu/train/losses.py).

Label-smoothing soft-target cross-entropy: targets arrive as probability
distributions (one-hot or MixUp/CutMix mixtures); smoothing mixes them with
the uniform distribution before the CE.
"""

from __future__ import annotations

import torch


def label_smoothing_loss(logits: torch.Tensor, targets: torch.Tensor,
                         smoothing: float = 0.0,
                         reduction: str = "mean") -> torch.Tensor:
    """Soft-target CE with optional uniform label smoothing, in f32.

    Args:
        logits: [N, C] float logits.
        targets: [N, C] soft target distributions.
        smoothing: epsilon in [0, 1); 0 disables.
        reduction: 'mean' | 'sum' | 'none'.
    """
    num_classes = logits.shape[-1]
    if num_classes < 2:
        raise ValueError(f"need >= 2 classes, got {num_classes}")
    if not 0.0 <= smoothing < 1.0:
        raise ValueError("smoothing must be in [0, 1)")
    t = targets.float()
    if smoothing > 0.0:
        t = t * (1.0 - smoothing) + smoothing / num_classes
    loss = -(t * torch.log_softmax(logits.float(), dim=-1)).sum(dim=-1)
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    if reduction == "none":
        return loss
    raise ValueError(f"unknown reduction {reduction!r}")


def smoothing_from_config(cfg) -> float:
    """LABEL_SMOOTHING accepts False or a float."""
    ls = cfg.get("LABEL_SMOOTHING", False)
    return 0.0 if ls is False or ls is None else float(ls)
