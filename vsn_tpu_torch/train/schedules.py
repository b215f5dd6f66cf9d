"""Precomputed per-step LR/WD schedules (port of
vsn_tpu/train/schedules.py, the same numpy; the tables are bit-equal).

The step reads ``table[min(step, len - 1)]`` on the host, so the values
reach the optimizer as Python floats.
"""

from __future__ import annotations

import numpy as np


def cosine_schedule_steps(base_value: float, final_value: float,
                          total_steps: int, warmup_steps: int = 0,
                          start_warmup_value: float = 0.0) -> np.ndarray:
    """Linear warmup to ``base_value`` (``np.linspace``, ending exactly at
    it) then cosine decay to ``final_value``; ``total_steps`` values."""
    if total_steps < 0:
        raise ValueError("total_steps must be non-negative")
    if warmup_steps > total_steps:
        raise ValueError("warmup_steps cannot exceed total_steps")
    warmup = (np.linspace(start_warmup_value, base_value, warmup_steps)
              if warmup_steps > 0 else np.array([]))
    remaining = total_steps - warmup_steps
    if remaining > 0:
        steps = np.arange(remaining)
        decay = final_value + 0.5 * (base_value - final_value) * (
            1 + np.cos(np.pi * steps / remaining))
        schedule = np.concatenate([warmup, decay])
    else:
        schedule = warmup
    return schedule.astype(np.float64)


def lr_wd_schedules(cfg) -> tuple[np.ndarray, np.ndarray]:
    """The (LR, WD) step tables of a Config."""
    lr = cosine_schedule_steps(cfg.LR_BASE, cfg.LR_FINAL, cfg.STEPS,
                               warmup_steps=cfg.LR_WARMUP)
    wd = cosine_schedule_steps(cfg.WD_BASE, cfg.WD_FINAL, cfg.STEPS,
                               warmup_steps=cfg.WD_WARMUP)
    return lr, wd
