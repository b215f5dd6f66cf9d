"""EMA over the N most recent weight snapshots (port of
vsn_tpu/train/ema.py).

A ring buffer of the last ``n_models`` snapshots; after every optimizer
step the EMA weights are their renormalized decay-weighted average, newest
heaviest:

    w_i = decay^age_i / sum_j decay^age_j  (age 0 = newest, live slots only)
    ema = sum_i w_i * queue_i

Here a snapshot is the train step's flat parameter buffer followed by its
flat model state (BatchNorm running statistics, when the model has any), as
the JAX EMA covers params and model_state; the queue is one [n_models, P]
tensor. The EMA is its own buffer, never an
alias of the live parameters.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class EMAState(NamedTuple):
    queue: torch.Tensor   # [n_models, ...] ring buffer
    count: torch.Tensor   # snapshots ever pushed (>= 1), int32 on device
    ema: torch.Tensor     # the weighted average, shaped like the params


def ema_init(params: torch.Tensor, n_models: int) -> EMAState:
    """The queue holds the current params in slot 0."""
    queue = torch.zeros((n_models, *params.shape), dtype=params.dtype,
                        device=params.device)
    queue[0] = params
    return EMAState(queue=queue,
                    count=torch.ones((), dtype=torch.int32,
                                     device=params.device),
                    ema=params.clone())


def ema_update(state: EMAState, params: torch.Tensor, decay: float,
               n_models: int) -> EMAState:
    """Push ``params`` and recompute the weighted average."""
    pos = (state.count % n_models).long().reshape(1)
    queue = state.queue.index_copy(0, pos, params[None])
    count = state.count + 1
    size = torch.clamp(count, max=n_models)
    newest = (count - 1) % n_models
    slots = torch.arange(n_models, device=params.device)
    age = (newest - slots) % n_models
    w = torch.where(age < size,
                    torch.full((n_models,), decay, dtype=torch.float32,
                               device=params.device) ** age.float(),
                    torch.zeros((), device=params.device))
    w = w / w.sum()
    wr = w.reshape((n_models,) + (1,) * (queue.ndim - 1))
    ema = (queue.float() * wr).sum(dim=0).to(queue.dtype)
    return EMAState(queue=queue, count=count, ema=ema)
