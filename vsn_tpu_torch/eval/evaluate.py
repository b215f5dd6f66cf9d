"""Batched inference (port of vsn_tpu/eval/evaluate.py Evaluator, no TTA).

The model runs on its own device (``build_model`` puts it on the card unless
asked for the CPU).

TTA, the checkpoint loop and the prediction CSVs come with later slices.
"""

from __future__ import annotations

import numpy as np
import torch

from vsn_tpu_torch.data.augment import build_eval_transform
from vsn_tpu_torch.train.step import make_eval_step


class Evaluator:
    """EVAL_BATCH_SIZE-batched plain inference of a model on one device.

    The last batch is padded to full size with copies of the first volume
    (as vsn_tpu/data/pipeline.py EvalPipeline does) and its pad rows are
    dropped from the output, so every launch sees one batch shape."""

    def __init__(self, cfg, model, batch_size=None, device=None):
        self.batch_size = int(batch_size or cfg.get("EVAL_BATCH_SIZE", 0)
                              or cfg.BATCH_SIZE)
        self.device = torch.device(
            device if device is not None else next(model.parameters()).device)
        self.transform = build_eval_transform(cfg)
        self.eval_step = make_eval_step(model)

    def predict(self, images: np.ndarray, variables=None) -> np.ndarray:
        """images [N, D, H, W, C] (e.g. the float16 cache) -> probs [N, K],
        in eval mode (BatchNorm on its running statistics). ``variables``,
        a state dict such as ``eval_params(state, use_ema=True)``, replaces
        the model's parameters and statistics (the EMA's, when asked)."""
        n = len(images)
        bs = max(1, min(self.batch_size, n))  # no pad rows past the cohort
        probs = []
        for start in range(0, n, bs):
            idx = np.arange(start, min(start + bs, n))
            pad = np.concatenate([idx, np.zeros(bs - len(idx), np.int64)])
            x = torch.from_numpy(images[pad]).to(self.device)
            p = self.eval_step(self.transform(x), variables)
            probs.append(p[: len(idx)].cpu().numpy())
        return np.concatenate(probs)
