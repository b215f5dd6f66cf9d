"""Per-fold training driver (port of vsn_tpu/train/trainer.py).

  fold CSVs -> preprocessing cache -> datasets / pipelines -> model -> train
  step (grad accumulation, SAM, EMA, NaN guard) -> periodic EMA-applied
  validation -> best-N checkpoints + early stopping -> history,

with the JAX trainer's run directory, file names, history rows,
checkpoint meta, best-N rotation and ordering. One process on one device
(the CUDA card unless the caller names another): the host loop feeds step
batches prefetched to the card by a background thread (pinned memory, a
side stream) and reads the step's scalars back only at validation.

Checkpoints are the JAX package's files with the JAX ``TrainState`` tree
(``convert.jax_train_state``), so a ``_last.ckpt`` either package writes
resumes in the other. Where the JAX trainer reads its pipeline's epoch
while its prefetch thread may have pulled batches ahead, the port saves
the epoch of the last batch a step consumed (``sampler_epoch``); a resumed
run restarts that epoch, as the JAX one does. The BatchNorm refresh under
the EMA weights runs over one epoch of a fresh pipeline at the next
sampler epoch (the JAX refresh continues its pipeline wherever its
prefetch thread left it).
"""

from __future__ import annotations

import logging
import os
import time
import uuid
from pathlib import Path

import numpy as np
import torch

from vsn_tpu_torch.config import save_config
from vsn_tpu_torch.convert import (
    jax_params_from_state_dict,
    jax_train_state,
    load_train_state,
)
from vsn_tpu_torch.data.augment import build_eval_transform
from vsn_tpu_torch.data.folds import get_train_val_test
from vsn_tpu_torch.data.pipeline import (
    DeviceBatch,
    InMemoryDataset,
    TrainPipeline,
    prefetch,
)
from vsn_tpu_torch.data.preprocessing import DataPrepa
from vsn_tpu_torch.data.resident import (
    build_resident,
    gather_volumes,
    resident_pretransform,
)
from vsn_tpu_torch.eval.evaluate import Evaluator
from vsn_tpu_torch.models import build_model
from vsn_tpu_torch.models.factory import card_or, init_model
from vsn_tpu_torch.train import checkpoint as ckpt
from vsn_tpu_torch.train import metrics as M
from vsn_tpu_torch.train.losses import smoothing_from_config
from vsn_tpu_torch.train.schedules import lr_wd_schedules
from vsn_tpu_torch.train.step import (
    eval_params,
    init_train_state,
    make_batch_transform,
    make_bn_refresh_step,
    make_probe,
    make_train_step,
)
from vsn_tpu_torch.utils.profiling import StepTimer, StepTrace
from vsn_tpu_torch.utils.rng import component_seed
from vsn_tpu_torch.utils.tracking import Tracker

log = logging.getLogger("vsn_tpu_torch.train")

ATTENTION_ARCHITECTURES = ("Swin", "ViT")


def new_run_id() -> str:
    """8-char run id (the reference uses the W&B run id in filenames)."""
    return uuid.uuid4().hex[:8]


def _env_flag(name: str) -> bool:
    """VSN_* gates: unset, '', '0', 'false', 'off', 'no' are off."""
    return os.environ.get(name, "").strip().lower() not in ("", "0", "false",
                                                            "off", "no")


def probe_twin(cfg, device):
    """The attention-logit probe's model: ``cfg``'s model built with
    USE_PALLAS_ATTENTION off (every attention on the branch that records
    its scores), called with the trained model's parameters through
    ``functional_call``."""
    return build_model(cfg.replace(USE_PALLAS_ATTENTION=False), device)


class Validator:
    """EMA-aware validation of a dataset (vsn_tpu/train/trainer.py:57-214).

    The batches are ``Evaluator.predict``'s (its one batch loop and pad
    rule) at EVAL_BATCH_SIZE, else BATCH_SIZE, clamped to the cohort; with
    ``resident`` (PRELOAD_DEVICE) they are gathered from the device store.
    ``probe_model`` (``probe_twin``) enables the saturation guard: one
    probe forward per validation on the first VSN_PROBE_BATCH (8) rows of
    the first batch gives ``attn_logit_max``. The loss is recomputed on the
    host in f64 from the gathered probabilities, as trainer.py:201-214
    describes it (its numpy arithmetic runs in the probabilities' f32)."""

    def __init__(self, model, cfg, dataset, resident=None,
                 resident_pretransformed=False, probe_model=None):
        self.dataset = dataset
        eval_batch = int(cfg.get("EVAL_BATCH_SIZE", 0) or cfg.BATCH_SIZE)
        eval_batch = max(1, min(eval_batch, len(dataset)))
        self.evaluator = Evaluator(
            cfg, model, batch_size=eval_batch,
            resident_pretransformed=resident_pretransformed)
        self.resident = resident
        self.smoothing = smoothing_from_config(cfg)
        self._probe = None
        if probe_model is not None:
            want = int(os.environ.get("VSN_PROBE_BATCH", "8") or 8)
            self._probe_batch = min(max(1, want), eval_batch)
            self._probe = make_probe(
                probe_model, compute_dtype=torch.bfloat16
                if cfg.get("FP16", True) else torch.float32)

    def _probe_images(self) -> torch.Tensor:
        """The first rows of the first batch, transformed, on the card."""
        ev = self.evaluator
        rows = np.arange(self._probe_batch)
        if self.resident is not None:
            x = gather_volumes(self.resident, torch.from_numpy(rows))
            return x if ev.resident_pretransformed else ev.transform(x)
        return ev.transform(torch.from_numpy(
            self.dataset.gather(rows)).to(ev.device))

    def __call__(self, variables) -> tuple[dict, np.ndarray, np.ndarray]:
        attn_max = None
        if self._probe is not None:
            attn_max = self._probe(variables, self._probe_images())
        source = self.resident if self.resident is not None else (
            self.dataset.images if self.dataset.images is not None
            else self.dataset)
        probs = self.evaluator.predict(source, variables)
        gt_onehot = self.dataset.labels
        gt = gt_onehot.argmax(1)
        # the validation loss from the gathered probabilities in f64 (not
        # the device loss, which runs from bf16 logits); the clip floor only
        # guards log(0)
        logp = np.log(np.clip(probs.astype(np.float64), 1e-12, 1.0))
        k = probs.shape[1]
        targets = gt_onehot * (1 - self.smoothing) + self.smoothing / k
        loss = float(-(targets * logp).sum(1).mean())
        out = M.compute_metrics(gt, probs, k)
        out["loss"] = loss
        if attn_max is not None:
            out["attn_logit_max"] = float(attn_max)
        return out, probs, gt


def _stores(cfg, ds_train, ds_val, device):
    """PRELOAD_DEVICE's train and val stores and their pre-transforms (None
    each when off or raw)."""
    mode = cfg.get("PRELOAD_DEVICE", False)
    if not mode:
        return None, None, None, None
    pre_train = resident_pretransform(cfg, train=True)
    pre_val = resident_pretransform(cfg, train=False)
    res_train = build_resident(ds_train.all_volumes(), mode, device,
                               pre_train)
    res_val = build_resident(ds_val.all_volumes(), mode, device, pre_val)
    log.info("device-resident cache: train %.2f GB%s + val %.2f GB%s (%s)",
             res_train.nbytes / 1e9,
             " pre-transformed" if pre_train is not None else "",
             res_val.nbytes / 1e9,
             " pre-transformed" if pre_val is not None else "", mode)
    return res_train, res_val, pre_train, pre_val


def train_fold(cfg, csv_dir: str, save_dir: str, cache_dir: str,
               run_id: str | None = None, resume_from: str | None = None,
               max_steps: int | None = None, profile_dir: str | None = None,
               profile_steps: int = 5, device=None) -> dict:
    """Train one fold on ``device`` (the CUDA card unless the caller names
    another); returns a summary dict (history, best metric, paths).

    With ``profile_dir`` set, a ``torch.profiler`` trace of
    ``profile_steps`` steps (after a 2-step warm-up) is written there
    (``utils/profiling.py``); step-time percentiles always go into the
    metrics.jsonl summary."""
    t_start = time.time()
    device = card_or(device, "train_fold")
    run_id = run_id or new_run_id()
    fold = int(cfg.FOLD)
    save_dir = Path(save_dir)
    run_dir = save_dir / f"run_{run_id}_{fold}"
    run_dir.mkdir(parents=True, exist_ok=True)
    save_config(cfg, run_dir)
    grad_accum = cfg.gradient_accumulation_steps(1)
    seed = cfg.seed_or_none
    # the step's draws and the weights' init need an integer seed; an
    # unseeded run takes one from fresh entropy, as the JAX base key does
    draw_seed = seed if seed is not None else int(
        np.random.SeedSequence().generate_state(1)[0])
    run_cfg = cfg.replace(SEED=draw_seed)
    depths = cfg.DEPTH if cfg.ARCHITECTURE == "MedViT" else None

    # ----- data ------------------------------------------------------------
    meta_train, meta_val, _, meta_all = get_train_val_test(
        csv_dir, fold=fold, kfold=int(cfg.KFOLD), split=tuple(cfg.SPLIT))
    DataPrepa(meta_all, cache_dir).preprocess_data(crop=tuple(cfg.IMG_SIZE))
    diseases = list(cfg.DISEASES)
    meta_train = [r for r in meta_train if r["Diagnosis"] in diseases]
    meta_val = [r for r in meta_val if r["Diagnosis"] in diseases]
    preload = bool(cfg.PRELOAD_DATA)
    ds_train = InMemoryDataset(cache_dir, meta_train, diseases, preload)
    ds_val = InMemoryDataset(cache_dir, meta_val, diseases, preload)
    resident_train, resident_val, pre_train, pre_val = _stores(
        cfg, ds_train, ds_val, device)

    def pipeline(epoch=0):
        pipe = TrainPipeline(ds_train, cfg, grad_accum,
                             int(cfg.BATCH_SIZE), seed,
                             index_mode=resident_train is not None)
        pipe.epoch = epoch
        return pipe

    pipe = pipeline()

    # ----- model / state ---------------------------------------------------
    model = init_model(build_model(cfg, device), cfg, torch.Generator(
    ).manual_seed(component_seed(draw_seed, "init")))
    n_params = sum(p.numel() for p in model.parameters())
    log.info("run %s fold %d: %s with %.2fM params on %s, accum %d", run_id,
             fold, cfg.ARCHITECTURE, n_params / 1e6, device, grad_accum)
    state = init_train_state(cfg, model)
    lr_table, wd_table = lr_wd_schedules(cfg)
    attention = str(cfg.ARCHITECTURE) in ATTENTION_ARCHITECTURES
    probe_model = (probe_twin(cfg, device)
                   if cfg.get("WATCH_GRADIENTS", False) and attention
                   else None)
    # a pre-transformed train store carries resize + z-score already
    batch_tfm = None if pre_train is not None else make_batch_transform(cfg)
    train_step = make_train_step(model, run_cfg, lr_table, wd_table,
                                 batch_tfm, probe_model=probe_model)
    val_probe = ((probe_model or probe_twin(cfg, device))
                 if attention and cfg.get("VAL_ATTN_WATCH", True) else None)
    validator = Validator(model, cfg, ds_val, resident=resident_val,
                          resident_pretransformed=pre_val is not None,
                          probe_model=val_probe)

    # ----- bookkeeping -----------------------------------------------------
    # VSN_CKPT_LAST_EVERY=N saves the 'last' checkpoint every Nth validation;
    # VSN_BESTN_EVAL_ONLY=1 keeps only the eval weights in best-N files
    ckpt_last_every = max(1, int(os.environ.get("VSN_CKPT_LAST_EVERY", 1)))
    bestn_eval_only = _env_flag("VSN_BESTN_EVAL_ONLY")
    history: dict[str, list] = {}
    saver = ckpt.AsyncCheckpointSaver(max_queue=3)
    keep_n = cfg.KEEP_BEST_N if cfg.KEEP_BEST_N else 1
    best_tracker = ckpt.BestNTracker(save_dir, run_id, fold, keep_n,
                                     str(cfg.METRIC_BEST_MODEL))
    es_metric = str(cfg.EARLY_STOPPING_METRIC)
    es_patience = cfg.EARLY_STOPPING_PATIENCE
    es_min_delta = float(cfg.EARLY_STOPPING_MIN_DELTA)
    es_best, es_best_step = None, 0

    start_step = 0
    if resume_from:
        payload, meta = ckpt.load_checkpoint(resume_from)
        if meta.get("fold") is not None and int(meta["fold"]) != fold:
            raise ValueError(f"checkpoint was trained on fold {meta['fold']}"
                             f", requested {fold}")  # reference 2416-2425
        restored, _, dropped = ckpt.filter_compatible(
            payload["state"], jax_train_state(state, depths))
        load_train_state(state, restored)
        start_step = int(meta.get("step", 0))
        history = meta.get("history", {})
        pipe.epoch = int(meta.get("sampler_epoch", 0))
        es_best = meta.get("es_best")
        es_best_step = int(meta.get("es_best_step", 0))
        if dropped:
            log.info("resume: dropped %d incompatible keys", len(dropped))

    total_steps = int(cfg.STEPS) if max_steps is None else min(
        int(cfg.STEPS), max_steps)
    val_freq = int(cfg.VALIDATION_FREQUENCY)
    tracker = Tracker(run_dir, run_id, filename="metrics.jsonl")
    sampler_epoch = pipe.epoch

    def checkpoint_meta(step, val_metrics=None):
        return {
            "run_id": run_id,
            "fold": fold,
            "step": step,
            "sampler_epoch": sampler_epoch,
            # a snapshot: the saver may hold this meta past the next append
            "history": {k: list(v) for k, v in history.items()},
            "es_best": es_best,
            "es_best_step": es_best_step,
            "val_metrics": val_metrics,
            "architecture": cfg.ARCHITECTURE,
            "config": cfg.to_dict(),
        }

    def eval_weights():
        return eval_params(state, bool(cfg.USE_EMA))

    def eval_tree(tree):
        """``eval_weights`` as a JAX variables tree, from the state's."""
        node = tree["ema"]["ema"] if cfg.USE_EMA and tree["ema"] else tree
        return {"params": node["params"], **node["model_state"]}

    # ----- loop ------------------------------------------------------------
    stopped_early = False
    step = start_step
    # at most 2 step batches in flight (PREFETCH_FACTOR in the reference is
    # host batches per worker); each batch is tagged with its epoch
    copy_stream = (torch.cuda.Stream(device) if device.type == "cuda"
                   else None)
    batches = prefetch(((b, pipe.epoch) for b in pipe),
                       min(2, int(cfg.PREFETCH_FACTOR)),
                       device_put=lambda item: (DeviceBatch(
                           item[0], device, copy_stream), item[1]))
    timer = StepTimer(device)
    tracer = StepTrace(profile_dir, start=2, n_steps=profile_steps)
    loop_i = 0
    try:
        for dbatch, epoch in batches:
            if step >= total_steps or stopped_early:
                break
            batch = dbatch.get()
            tracer.before_step(loop_i)
            timer.start()
            train_m = train_step(state, batch, resident_train)
            timer.stop()
            tracer.after_step(loop_i)
            loop_i += 1
            step, sampler_epoch = state.step, epoch

            if step % val_freq == 0 or step == total_steps:
                t_val0 = time.perf_counter()
                val_metrics, _, _ = validator(eval_weights())
                t_val = time.perf_counter() - t_val0
                val_count = step // val_freq
                row = {
                    "step": step,
                    "train_loss": float(train_m["loss"]),
                    "lr": float(train_m["lr"]),
                    "wd": float(train_m["wd"]),
                    "grad_norm": float(train_m["grad_norm"]),
                    "skipped_steps": int(state.skipped),
                    # WATCH_GRADIENTS: per-module norms and the probe (-inf
                    # on a step that did not run it, dropped)
                    **{k: float(v) for k, v in train_m.items()
                       if k.startswith("grad_norm/")
                       or (k == "attn_logit_max"
                           and np.isfinite(float(v)))},
                    **{f"val_{k}": v for k, v in val_metrics.items()},
                }
                # the history and the early-stopping best reflect THIS
                # validation before the 'last' checkpoint snapshots them
                row["val_wall_s"] = round(t_val, 3)
                for k, v in row.items():
                    history.setdefault(k, []).append(v)
                es_val = val_metrics[es_metric]
                if es_best is None or M.is_improvement(
                        es_metric, es_val, es_best, es_min_delta):
                    es_best, es_best_step = es_val, step

                # the saver copies the state to the host before submit
                # returns (the next step updates it in place): its time is
                # the checkpoint's cost to the loop, recorded per event
                t_ckpt = 0.0
                state_tree = None
                if step == total_steps or val_count % ckpt_last_every == 0:
                    t_c0 = time.perf_counter()
                    state_tree = jax_train_state(state, depths)
                    saver.submit(
                        save_dir / f"model_{run_id}_{fold}_last.ckpt",
                        {"state": state_tree},
                        checkpoint_meta(step, val_metrics))
                    t_ckpt += time.perf_counter() - t_c0
                best_metric_val = val_metrics[best_tracker.metric_name]
                idx = best_tracker.consider(best_metric_val, step)
                if idx is not None:
                    t_c0 = time.perf_counter()
                    if bestn_eval_only:
                        payload = {"variables": jax_params_from_state_dict(
                            eval_weights(), depths)}
                    else:
                        if state_tree is None:
                            state_tree = jax_train_state(state, depths)
                        payload = {"state": state_tree,
                                   "variables": eval_tree(state_tree)}
                    best_tracker.insert(idx, best_metric_val, step, saver,
                                        payload,
                                        checkpoint_meta(step, val_metrics))
                    t_ckpt += time.perf_counter() - t_c0
                if t_ckpt:
                    row["ckpt_wall_s"] = round(t_ckpt, 3)
                    history.setdefault("ckpt_wall_s", []).append(
                        row["ckpt_wall_s"])
                tracker.log(row, step=step)
                log.info("step %d/%d loss %.4f val_loss %.4f val_bacc %.4f",
                         step, total_steps, row["train_loss"],
                         row["val_loss"], row["val_bacc"])
                if (es_patience and es_best_step != step
                        and (step - es_best_step) >= int(es_patience)):
                    log.info("early stopping at step %d (best %s=%.4f @ %d)",
                             step, es_metric, es_best, es_best_step)
                    stopped_early = True
    finally:
        batches.close()

    # EMA + BatchNorm: re-estimate the running statistics under the EMA
    # weights with train-mode forwards over one epoch of training batches
    # (reference EMAModel.update_bn_stats, utils/ema.py:144-178)
    if (cfg.USE_EMA and cfg.get("UPDATE_BN_STATS", True)
            and state.ema is not None and state.model_state.flat.numel()):
        log.info("refreshing BN statistics under EMA weights")
        refresh = make_bn_refresh_step(model, run_cfg, batch_tfm)
        variables = eval_params(state, use_ema=True)
        rpipe = pipeline(sampler_epoch + 1)
        for i, b in zip(range(rpipe.steps_per_epoch()), rpipe):
            variables.update(refresh(variables, DeviceBatch(b, device).get(),
                                     resident_train, index=i))
        stats = state.model_state
        with torch.no_grad():
            state.ema.ema[state.params.size:].copy_(stats.pack(variables))
        saver.submit(save_dir / f"model_{run_id}_{fold}_last.ckpt",
                     {"state": jax_train_state(state, depths)},
                     checkpoint_meta(step))

    tracer.close()
    # extremum summaries (reference train_transformer.py:2388-2396: val
    # metrics tracked as max, losses as min)
    extrema = {}
    for k, vals in history.items():
        if k.startswith("val_") and vals:
            if "loss" in k:
                extrema[f"{k}_min"] = float(np.min(vals))
            else:
                extrema[f"{k}_max"] = float(np.max(vals))
    tracker.set_summary(
        steps=step, stopped_early=stopped_early, skipped=int(state.skipped),
        best_metric=best_tracker.best[0] if best_tracker.best else None,
        step_time=timer.summary(skip_warmup=2), **extrema)
    tracker.finish()
    saver.close()
    return {
        "run_id": run_id,
        "fold": fold,
        "history": history,
        "steps": step,
        "stopped_early": stopped_early,
        "best": best_tracker.best,
        "run_dir": str(run_dir),
        "wall_time_s": time.time() - t_start,
        "n_params": n_params,
    }
