"""Train and eval steps (port of vsn_tpu/train/step.py).

One ``train_step`` call consumes the A micro-batches of a step and makes one
optimizer update, as the JAX step does:

  * gradient accumulation is a loop over the micro-batches; every gradient
    lands in one flat f32 buffer (``FlatParams.grad``), whose views are the
    parameters' ``.grad``, and is averaged over A;
  * the NaN/Inf guard skips the whole update (parameters, optimizer, EMA)
    when the loss or a gradient is not finite, decided on the device
    (``torch.where`` on a flag, as ``lax.cond``), and counts ``skipped``;
  * SAM is a second accumulation over the same micro-batches at
    params + e(w), whose gradients update the original params; the data
    transform is the same in both passes, the random draws (residual
    gains, dropout keep masks) are not (a generator per (seed, step,
    micro-batch, pass), as JAX folds ``idx * 2 + pass_idx``);
  * optional global-norm clipping before each pass's update;
  * the EMA of the last N snapshots after a successful update;
  * LR/WD from the precomputed tables, indexed by the host's step count.

Parameters stay f32 in one flat buffer (the model's parameters are views of
it); images are cast to bf16 when FP16 is set. With a device store
(PRELOAD_DEVICE, ``data/resident.py``) a batch carries row indices and each
micro-batch gathers its volumes on the card. WATCH_GRADIENTS adds the
gradient norm of each top-level module under its JAX name
(``grad_norm/<name>``) and, with a probe model, the attention-logit probe
(``attn_logit_max``) on logged steps (vsn_tpu/train/step.py:301-343).
USE_CHECKPOINT lives in the models (``layers.remat`` around each block).

The model state (the JAX package's ``batch_stats``: BatchNorm running
statistics, the model's persistent buffers) is a second flat f32 buffer,
``FlatStats``, whose views are the model's buffers. A training forward
updates them in place, so they follow the JAX step: micro-batch after
micro-batch (vsn_tpu/train/step.py:200-230); SAM's second pass starts from
the first pass's statistics and the step keeps those after the second pass
(:240-257); the NaN guard restores the statistics the step started from
(:277-284); the EMA covers parameters and statistics (:66-68, 270-274).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch
from torch.func import functional_call

from vsn_tpu_torch.data.resident import resolve_micro
from vsn_tpu_torch.models.layers import LogitProbe
from vsn_tpu_torch.train import optim
from vsn_tpu_torch.train.ema import EMAState, ema_init, ema_update
from vsn_tpu_torch.train.losses import label_smoothing_loss, smoothing_from_config


ALIGN_BYTES = 256  # where each tensor of a flat buffer starts


class _Flat:
    """Named tensors of fixed shapes in one flat buffer, each starting on an
    ALIGN_BYTES boundary, the gaps zero. A tensor of its own starts on such
    a boundary too, and some library kernels (PyTorch's LayerNorm, cuBLAS's
    choice of GEMM) take another path, whose sums run in another order, on
    a pointer that is not aligned: so a model reads the same numbers from
    the state's views as from a checkpoint's loaded tensors."""

    names: list[str]
    shapes: list[tuple]
    offsets: list[int]
    size: int

    def _layout(self, itemsize: int) -> None:
        unit = max(1, ALIGN_BYTES // itemsize)
        self.offsets, off = [], 0
        for shape in self.shapes:
            self.offsets.append(off)
            off += -(-int(np.prod(shape)) // unit) * unit
        self.size = off

    def views(self, flat: torch.Tensor) -> list[torch.Tensor]:
        return [flat[off:off + int(np.prod(shape))].view(shape)
                for off, shape in zip(self.offsets, self.shapes)]

    def tree(self, flat: torch.Tensor) -> dict[str, torch.Tensor]:
        """name -> view of ``flat`` (e.g. the EMA weights as a state dict)."""
        return dict(zip(self.names, self.views(flat)))

    def pack(self, tensors: dict, dtype=None, device=None) -> torch.Tensor:
        """A flat buffer of this layout holding ``tensors`` (name -> tensor
        of its shape), the gaps zero."""
        first = tensors[self.names[0]] if self.names else None
        flat = torch.zeros(
            self.size, dtype=dtype or (first.dtype if first is not None
                                       else torch.float32),
            device=device or (first.device if first is not None else None))
        for view, name in zip(self.views(flat), self.names):
            view.copy_(tensors[name])
        return flat


class FlatParams(_Flat):
    """A model's parameters as views of one flat buffer ``flat`` (f32, the
    parameters' type; f64 where a test runs the model in f64), their
    ``.grad`` as views of another, ``grad``. Built once per model: the
    model's parameters are re-pointed at the buffer."""

    def __init__(self, model: torch.nn.Module):
        named = list(model.named_parameters())
        self.names = [name for name, _ in named]
        self.shapes = [tuple(p.shape) for _, p in named]
        self._layout(named[0][1].element_size())
        with torch.no_grad():
            self.flat = self.pack({n: p.detach() for n, p in named})
        self.grad = torch.zeros_like(self.flat)
        for (_, p), v, g in zip(named, self.views(self.flat),
                                self.views(self.grad)):
            p.data = v
            p.grad = g
        mask = optim.wd_mask(dict(zip(self.names, self.shapes)))
        self.decay_mask = torch.zeros(self.size, dtype=torch.bool,
                                      device=self.flat.device)
        for v, n in zip(self.views(self.decay_mask), self.names):
            v.fill_(mask[n])


def persistent_buffers(model: torch.nn.Module):
    """(name, module, attribute) of every persistent floating-point buffer of
    ``model``: its model state (BatchNorm running statistics)."""
    out = []
    for prefix, module in model.named_modules():
        for attr, buf in module._buffers.items():
            if (buf is not None and buf.is_floating_point()
                    and attr not in module._non_persistent_buffers_set):
                out.append((f"{prefix}.{attr}" if prefix else attr, module,
                            attr))
    return out


class FlatStats(_Flat):
    """A model's persistent buffers as views of one flat buffer ``flat`` of
    their type, f32 (empty for a model without any). Built once per model:
    the buffers are re-pointed at it, so the model's in-place updates land
    there."""

    def __init__(self, model: torch.nn.Module):
        found = persistent_buffers(model)
        self.names = [name for name, _, _ in found]
        self.shapes = [tuple(getattr(m, a).shape) for _, m, a in found]
        device = next(model.parameters()).device
        self._layout(getattr(found[0][1], found[0][2]).element_size()
                     if found else 4)
        self.flat = self.pack({n: getattr(m, a).detach() for n, m, a in found},
                              device=device)
        for (_, module, attr), v in zip(found, self.views(self.flat)):
            setattr(module, attr, v)


@dataclass
class TrainState:
    params: FlatParams
    opt: optim.AdamWState
    step: int                    # optimizer steps taken (host)
    skipped: torch.Tensor        # NaN-skipped steps, int32 on the device
    ema: Optional[EMAState]      # EMA of [params | model_state]; None if off
    model_state: FlatStats       # BatchNorm running statistics (may be empty)


def _ema_vector(params: torch.Tensor, stats: FlatStats) -> torch.Tensor:
    """One EMA snapshot: the flat parameters, then the flat statistics."""
    return torch.cat([params, stats.flat]) if stats.flat.numel() else params


def init_train_state(cfg, model: torch.nn.Module) -> TrainState:
    """State for training ``model`` (its parameters and persistent buffers
    become views of the state's flat buffers)."""
    params = FlatParams(model)
    stats = FlatStats(model)
    ema = (ema_init(_ema_vector(params.flat, stats), int(cfg.EMA_N_MODELS))
           if cfg.USE_EMA else None)
    return TrainState(params=params, opt=optim.adamw_init(params.flat),
                      step=0,
                      skipped=torch.zeros((), dtype=torch.int32,
                                          device=params.flat.device),
                      ema=ema, model_state=stats)


def eval_params(state: TrainState, use_ema: bool) -> dict[str, torch.Tensor]:
    """Parameters and statistics for validation/eval, name -> tensor (a
    state dict): the EMA's when EMA is on (vsn_tpu/train/step.py:82-88)."""
    stats = state.model_state
    if use_ema and state.ema is not None:
        p = state.params.flat.numel()
        return {**state.params.tree(state.ema.ema[:p]),
                **stats.tree(state.ema.ema[p:])}
    return {**state.params.tree(state.params.flat), **stats.tree(stats.flat)}


def make_batch_transform(cfg):
    """Per-micro-batch device transform: MixUp/CutMix, then augmentation
    (the reference applies the MONAI transform after mixing)."""
    from vsn_tpu_torch.data.augment import build_train_augment
    from vsn_tpu_torch.data.mixers import build_mix_fn

    mix_fn = build_mix_fn(cfg)
    aug_fn = build_train_augment(cfg)

    def transform(micro: dict, generator=None):
        if mix_fn is not None:
            images, labels = mix_fn(micro)
        else:
            images, labels = micro["image"], micro["label"]
        return aug_fn(images, generator), labels

    return transform


def draw_seed(seed: int, step: int, micro: int, pass_idx: int) -> int:
    """The draw generator's seed of one (step, micro-batch, pass)."""
    return int(np.random.SeedSequence(
        [int(seed), step, micro, pass_idx]).generate_state(1)[0])


def make_grad_fn(model, cfg, batch_transform=None,
                 draws: Optional[Callable] = None):
    """``accumulate(state, batch, pass_idx, resident=None) -> mean loss``:
    the gradient accumulation of one pass over the micro-batches of
    ``batch``, at the parameters as they stand; their mean gradient is
    left in ``state.params.grad`` (arguments as ``make_train_step``;
    ``resident`` the device store a batch of row indices reads)."""
    if batch_transform is None:
        batch_transform = lambda micro, gen: (micro["image"], micro["label"])
    smoothing = smoothing_from_config(cfg)
    seed = int(cfg.get("SEED") or 0)
    compute_dtype = torch.bfloat16 if cfg.get("FP16", True) else torch.float32

    def accumulate(state, batch, pass_idx, resident=None):
        model.train()
        grad = state.params.grad
        grad.zero_()
        a = batch["label"].shape[0]
        total = torch.zeros((), dtype=torch.float32, device=grad.device)
        for idx in range(a):
            micro = resolve_micro({k: v[idx] for k, v in batch.items()},
                                  resident)
            images, labels = batch_transform(micro, None)
            images = images.to(compute_dtype)
            if draws is not None:
                logits = model(images, draws=draws(state.step, idx, pass_idx))
            else:
                gen = torch.Generator(device=grad.device)
                gen.manual_seed(draw_seed(seed, state.step, idx, pass_idx))
                logits = model(images, generator=gen)
            loss = label_smoothing_loss(logits, labels, smoothing)
            loss.backward()
            total = total + loss.detach()
        inv = 1.0 / a
        grad.mul_(inv)
        return total * inv

    return accumulate


def watch_groups(params: FlatParams,
                 cfg) -> list[tuple[str, list[tuple[int, int]]]]:
    """WATCH_GRADIENTS' groups: (JAX top-level module name, [(start, end)
    spans of the flat parameter buffer ``params``]) in first-seen order,
    each parameter named by ``convert.jax_path`` (the JAX package takes the
    norm of each top-level subtree of its gradient tree); a span runs over
    the zero gaps between neighbours of one group."""
    from vsn_tpu_torch.convert import jax_path

    depths = cfg.DEPTH if cfg.ARCHITECTURE == "MedViT" else None
    groups: dict[str, list] = {}
    last = None
    for name, off, shape in zip(params.names, params.offsets, params.shapes):
        top = jax_path(name, depths).split("/")[0]
        spans = groups.setdefault(top, [])
        end = off + int(np.prod(shape))
        if top == last:
            spans[-1] = (spans[-1][0], end)
        else:
            spans.append((off, end))
        last = top
    return list(groups.items())


def make_probe(probe_model, compute_dtype=torch.float32):
    """``probe(variables, images) -> attn_logit_max``: one
    eval-mode forward of ``probe_model`` (the model built with
    USE_PALLAS_ATTENTION off: every attention on the branch that records
    its scores' max, ``layers.LogitProbe``) on ``variables`` (a state dict
    of the trained model's parameters and statistics) under no_grad; a 0-d
    f32 tensor on the card, no host synchronization."""

    def probe(variables, images):
        probe_model.eval()
        with torch.no_grad(), LogitProbe() as rec:
            functional_call(probe_model, variables,
                            (images.to(compute_dtype),))
        return rec.value()

    return probe


def make_train_step(model, cfg, lr_table, wd_table, batch_transform=None,
                    draws: Optional[Callable] = None, probe_model=None):
    """Build ``train_step(state, batch, resident=None) -> metrics`` for
    ``model`` (whose parameters are the views of ``state.params``).

    ``batch`` is a dict of device tensors with a leading micro-batch axis
    A: ``image`` [A, B, D, H, W, C] and ``label`` [A, B, K], plus image2,
    label2, mix_lam, mix_apply and mix_bounds when MixUp/CutMix is on.
    ``batch_transform(micro, generator)`` maps one micro-batch to (images,
    labels) (``make_batch_transform``); None passes (image, label) through.
    ``draws(step, micro, pass_idx)``, if given, returns the random draws
    to inject (the list ``model.draw`` makes: Swin's residual gain pairs
    and dropout keep masks, ViT's DropPath gain pairs, the ResNet's
    head-dropout mask); else the
    model draws them from a generator seeded by ``draw_seed``. ``resident``
    is the device store (``data/resident.py``) of a batch that carries
    ``image_idx`` / ``partner_idx`` row indices.

    Metrics (device tensors, or floats for lr/wd): loss, grad_norm, lr, wd,
    skipped; with WATCH_GRADIENTS, ``grad_norm/<module>`` of the first
    pass's (clipped) gradients and, with ``probe_model``, attn_logit_max:
    the probe (``make_probe``) on micro-batch 0 at the step's starting
    parameters and statistics on steps whose count after the step is a
    multiple of VALIDATION_FREQUENCY (the logged ones), else -inf. The
    state is updated in place.
    """
    accumulate = make_grad_fn(model, cfg, batch_transform, draws)
    use_sam, sam_rho = bool(cfg.USE_SAM), float(cfg.SAM_RHO)
    sam_adaptive = bool(cfg.SAM_ADAPTIVE)
    clip = cfg.get("GRADIENT_CLIP", False)
    clip = float(clip) if clip else None
    use_ema, ema_decay = bool(cfg.USE_EMA), float(cfg.EMA_DECAY)
    ema_n = int(cfg.EMA_N_MODELS)
    lr_table = np.asarray(lr_table, np.float32)
    wd_table = np.asarray(wd_table, np.float32)
    watch = bool(cfg.get("WATCH_GRADIENTS", False))
    probe = None
    if watch and probe_model is not None:
        probe = make_probe(probe_model, compute_dtype=torch.bfloat16
                           if cfg.get("FP16", True) else torch.float32)
        transform = batch_transform or (lambda micro, gen: (micro["image"],
                                                            micro["label"]))
        log_every = max(1, int(cfg.get("VALIDATION_FREQUENCY", 1)))

    def train_step(state: TrainState, batch, resident=None) -> dict:
        flat, stats = state.params.flat, state.model_state.flat
        start_stats = stats.clone()
        lr = float(lr_table[min(state.step, len(lr_table) - 1)])
        wd = float(wd_table[min(state.step, len(wd_table) - 1)])
        logit_max = None
        if probe is not None:
            if (state.step + 1) % log_every == 0:
                micro0 = resolve_micro({k: v[0] for k, v in batch.items()},
                                       resident)
                logit_max = probe({**state.params.tree(flat),
                                   **state.model_state.tree(stats)},
                                  transform(micro0, None)[0])
            else:
                logit_max = torch.tensor(float("-inf"))
        loss = accumulate(state, batch, 0, resident)
        grads = state.params.grad
        finite = optim.all_finite(grads) & torch.isfinite(loss)
        if clip is not None:
            grads, grad_norm = optim.clip_by_global_norm(grads, clip)
        else:
            grad_norm = optim.global_norm(grads)
        watched = {f"grad_norm/{name}": torch.sqrt(sum(
            grads[a:b].float().square().sum() for a, b in spans))
            for name, spans in (watch_groups(state.params, cfg) if watch
                                else [])}
        if logit_max is not None:
            watched["attn_logit_max"] = logit_max
        if use_sam:
            e_w, _ = optim.sam_perturbation(flat, grads, sam_rho,
                                            sam_adaptive)
            original = flat.clone()
            with torch.no_grad():
                flat.add_(e_w)
            loss2 = accumulate(state, batch, 1, resident)
            with torch.no_grad():
                flat.copy_(original)
            grads = state.params.grad
            finite = finite & optim.all_finite(grads) & torch.isfinite(loss2)
            if clip is not None:
                grads, _ = optim.clip_by_global_norm(grads, clip)
        with torch.no_grad():
            new_params, opt = optim.adamw_update(
                grads, state.opt, flat, lr, wd, state.params.decay_mask)
            if use_ema:
                ema = ema_update(state.ema,
                                 _ema_vector(new_params, state.model_state),
                                 ema_decay, ema_n)
                state.ema = EMAState(*(torch.where(finite, new, old)
                                       for new, old in zip(ema, state.ema)))
            state.opt = optim.AdamWState(*(torch.where(finite, new, old)
                                           for new, old in zip(opt,
                                                               state.opt)))
            flat.copy_(torch.where(finite, new_params, flat))
            stats.copy_(torch.where(finite, stats, start_stats))
        was_skipped = (~finite).to(torch.int32)
        state.skipped = state.skipped + was_skipped
        state.step += 1
        return {"loss": loss, "grad_norm": grad_norm, "lr": lr, "wd": wd,
                "skipped": was_skipped, **watched}

    return train_step


def make_eval_step(model):
    """(images, variables=None) -> probs [B, K]: eval-mode forward, then
    softmax in f32. ``variables`` (a state dict such as ``eval_params(state,
    use_ema=True)``) replaces the model's parameters and buffers for the
    call; the model keeps its own."""

    def eval_step(images: torch.Tensor, variables=None) -> torch.Tensor:
        model.eval()
        with torch.inference_mode():
            logits = (model(images) if variables is None
                      else functional_call(model, variables, (images,)))
            return torch.softmax(logits.float(), dim=-1)

    return eval_step


def make_bn_refresh_step(model, cfg, batch_transform=None):
    """``refresh(variables, batch, resident=None, index=0) -> statistics``:
    re-estimate the BatchNorm
    running statistics of the weights in ``variables`` (a state dict such as
    ``eval_params(state, use_ema=True)``) by train-mode forwards over the
    micro-batches of ``batch`` that only update the statistics, one after
    another (vsn_tpu/train/step.py:358-387, reference EMAModel.
    update_bn_stats). Returns name -> new statistic; the model and
    ``variables`` are left as they were. The forwards' random draws come
    from a generator seeded per (``index``, micro-batch), ``index`` the
    batch's place in the refresh; a batch of row indices reads
    ``resident``."""
    if batch_transform is None:
        batch_transform = lambda micro, gen: (micro["image"], micro["label"])
    seed = int(cfg.get("SEED") or 0)
    names = [name for name, _, _ in persistent_buffers(model)]

    def refresh(variables, batch, resident=None, index=0):
        stats = {name: variables[name].clone() for name in names}
        merged = {**variables, **stats}
        was_training = model.training
        model.train()
        try:
            with torch.no_grad():
                for idx in range(batch["label"].shape[0]):
                    micro = resolve_micro({k: v[idx] for k, v in
                                           batch.items()}, resident)
                    images, _ = batch_transform(micro, None)
                    gen = torch.Generator(device=images.device)
                    gen.manual_seed(draw_seed(seed, index, idx, 0))
                    functional_call(model, merged, (images,),
                                    {"generator": gen})
        finally:
            model.train(was_training)
        return stats

    return refresh
