"""Evaluation entry point: checkpoints -> prediction CSVs + bootstrap metrics
(port of vsn_tpu/eval/evaluate.py).

Functional parity with reference eval/eval_transformer.py: per checkpoint,
rebuild the model from its stored config, load weights, evaluate the fold's
validation and test (in-domain) splits plus an optional out-of-domain CSV,
with plain or TTA inference; compute bootstrap CIs; write
``prediction_{checkpoint_stem}_{id,od}.csv`` with per-class ``pred_{disease}``
columns (eval_transformer.py:457-467, 619-620, 731-773), a metrics JSON and
a log; skip work when prediction CSVs already exist (622-632).

The checkpoints are the JAX package's files (``train/checkpoint.py`` reads
and writes its format). The model runs on its own device: the CUDA card
unless the caller passes ``device="cpu"``. Tables are lists of row dicts
(``data/folds.py``). PRELOAD_DEVICE (the device-resident cohort store)
is not ported yet and raises.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import time
from pathlib import Path

import numpy as np
import torch

from vsn_tpu_torch.config import load_config
from vsn_tpu_torch.data.augment import build_eval_transform
from vsn_tpu_torch.data.folds import (
    get_train_val_test,
    load_metadata,
    write_csv,
)
from vsn_tpu_torch.data.pipeline import EvalPipeline, InMemoryDataset
from vsn_tpu_torch.data.preprocessing import DataPrepa
from vsn_tpu_torch.eval.bootstrap import compute_bootstrap_metrics
from vsn_tpu_torch.eval.tta import make_tta_predictor
from vsn_tpu_torch.train.step import make_eval_step

log = logging.getLogger("vsn_tpu_torch.eval")


def filter_synthetic(metadata):
    """Drop synthetic/augmented subjects (names containing 'factor') from
    eval cohorts unless USE_SYNTHETIC_DATA — reference
    eval_transformer.py:471-475, applied at 659-661."""
    if not metadata or "Subject" not in metadata[0]:
        return metadata
    return [row for row in metadata
            if "factor" not in str(row["Subject"]).lower()]


def remove_duplicates(metadata):
    """Dedup eval cohorts by Subject, first row kept (reference
    eval_transformer.py:478-496)."""
    if not metadata or "Subject" not in metadata[0]:
        return metadata
    seen, out = set(), []
    for row in metadata:
        if row["Subject"] not in seen:
            seen.add(row["Subject"])
            out.append(row)
    return out


def load_model_from_checkpoint(path, device=None):
    """Returns (cfg, model, variables, meta): the model of the checkpoint's
    stored config on ``device`` (the card by default) with its weights
    loaded, and those weights as a state dict. The payload's
    ``"variables"`` are the eval weights; a 'last' checkpoint carries the
    raw train state instead, whose params and model_state are taken."""
    from vsn_tpu_torch.convert import state_dict_from_jax
    from vsn_tpu_torch.models import build_model
    from vsn_tpu_torch.train import checkpoint as ckpt

    payload, meta = ckpt.load_checkpoint(path)
    if "config" not in meta:
        raise ValueError(f"{path}: checkpoint meta carries no config")
    cfg = load_config(meta["config"])
    model = build_model(cfg, device)
    if "variables" in payload:
        variables = payload["variables"]
    else:  # 'last' checkpoints carry the raw train state
        st = payload["state"]
        variables = {"params": st["params"], **st["model_state"]}
    state_dict = state_dict_from_jax(variables)
    model.load_state_dict(state_dict, strict=True)
    return cfg, model, state_dict, meta


def _batch_generator(seed: int, i: int) -> torch.Generator:
    """The TTA draws' generator of batch ``i`` (as JAX folds the batch
    index into its key)."""
    state = np.random.SeedSequence([seed, i]).generate_state(2, np.uint32)
    return torch.Generator().manual_seed(int(state[0]) << 32 | int(state[1]))


class Evaluator:
    """Batched (optionally TTA) inference of a model on its device.

    Batches are EVAL_BATCH_SIZE (or ``batch_size``) volumes; the last is
    padded to full size with copies of the first volume (``EvalPipeline``)
    and its pad rows are dropped from the output, so every launch sees one
    batch shape. With TTA the batch is capped at ``VSN_TTA_BATCH`` (8)
    unless ``batch_size`` is given: each volume becomes 8 views, and 8
    volumes already make 64 rows. ``tta_draws(i, v)``, when given, returns
    batch i's affine view v's (angles [B, 3], translation [B, 3]) in place
    of draws from the batch's generator (seeded by ``seed`` and i)."""

    def __init__(self, cfg, model, use_tta: bool = False, batch_size=None,
                 device=None, tta_kwargs=None, seed: int = 0,
                 tta_draws=None):
        self.batch_size = int(batch_size or cfg.get("EVAL_BATCH_SIZE", 0)
                              or cfg.BATCH_SIZE)
        if use_tta and batch_size is None:
            # JAX sweep (BASELINE round 5): TTA throughput is flat in the
            # batch from 8 volumes (64 rows) up; larger batches only cost
            # memory. Cap unless the batch is explicit.
            self.batch_size = min(
                self.batch_size,
                int(os.environ.get("VSN_TTA_BATCH", "8") or 8))
        self.device = torch.device(
            device if device is not None else next(model.parameters()).device)
        self.transform = build_eval_transform(cfg)
        self.eval_step = make_eval_step(model)
        self.use_tta, self.seed, self.tta_draws = use_tta, seed, tta_draws
        self.n_views = 1
        if use_tta:
            self._tta, self.n_views = make_tta_predictor(
                model, eval_transform=self.transform, **(tta_kwargs or {}))

    def run(self, x: torch.Tensor, i: int = 0, variables=None):
        """Probs [B, K] of one batch x on the device (batch index ``i``
        picks the TTA draws)."""
        if not self.use_tta:
            return self.eval_step(self.transform(x), variables)
        draws = (None if self.tta_draws is None
                 else lambda v: self.tta_draws(i, v))
        return self._tta(x, _batch_generator(self.seed, i), draws, variables)

    def predict(self, images: np.ndarray, variables=None) -> np.ndarray:
        """images [N, D, H, W, C] (e.g. the float16 cache) -> probs [N, K],
        in eval mode (BatchNorm on its running statistics). ``variables``,
        a state dict such as ``eval_params(state, use_ema=True)``, replaces
        the model's parameters and statistics (the EMA's, when asked).

        One batch deep (as train.trainer.Validator): batch i is dispatched
        before the host waits for batch i-1's probabilities, whose copy to
        the host was queued behind batch i-1's forward, so the host gathers
        batch i+1 while the card computes batch i."""
        # Clamp to the cohort so small datasets don't pay for pad rows.
        bs = max(1, min(self.batch_size, len(images)))
        cuda = self.device.type == "cuda"
        probs, pending = [], None
        for i, (x, valid) in enumerate(EvalPipeline(images, bs)):
            dev = self.run(torch.from_numpy(x).to(self.device), i, variables)
            host = dev.to("cpu", non_blocking=cuda)
            done = torch.cuda.Event() if cuda else None
            if done is not None:
                done.record()
            if pending is not None:
                probs.append(self._drain(pending))
            pending = (host, done, valid)
        probs.append(self._drain(pending))
        return np.concatenate(probs)

    def predict_dataset(self, dataset, variables=None):
        """Returns (probs [N, K], gt_onehot [N, K]) over an
        ``InMemoryDataset`` (``predict`` of its images)."""
        return self.predict(dataset.images, variables), dataset.labels

    @staticmethod
    def _drain(pending) -> np.ndarray:
        host, done, valid = pending
        if done is not None:
            done.synchronize()
        return host.numpy()[valid]


def attach_predictions(metadata, probs: np.ndarray, diseases):
    """metadata + pred_{disease} columns (reference 457-467)."""
    return [{**row, **{f"pred_{d}": probs[r, i] for i, d in enumerate(diseases)}}
            for r, row in enumerate(metadata)]


def _bootstrap_summary(probs, gt_onehot, n_bootstrap, seed=42):
    gt = gt_onehot.argmax(1)
    results = compute_bootstrap_metrics(
        gt, probs, n_bootstrap=n_bootstrap, random_state=seed, keep_samples=False
    )

    def strip(node):
        if isinstance(node, dict) and "mean" in node:
            return {k: v for k, v in node.items() if k != "samples"}
        if isinstance(node, dict):
            return {str(k): strip(v) for k, v in node.items()}
        return node

    return strip(results)


def evaluate_checkpoint(
    checkpoint_path,
    csv_dir: str,
    cache_dir: str,
    output_dir: str,
    eval_csv: str | None = None,
    use_tta: bool = False,
    batch_size: int | None = None,
    n_bootstrap: int = 10000,
    skip_if_exists: bool = True,
    model_index: int | None = None,
    seed: int = 42,
    device=None,
    tta_draws=None,
) -> dict:
    """Evaluate one checkpoint (see the module docstring). The returned
    dict is the metrics JSON's content plus ``id_csv`` and ``seconds``,
    each stage's wall time (preprocess, load, predict, bootstrap), which
    the JSON does not carry."""
    checkpoint_path = Path(checkpoint_path)
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    stem = checkpoint_path.stem
    out_id = output_dir / f"prediction_{stem}_id.csv"
    out_od = output_dir / f"prediction_{stem}_od.csv"
    out_metrics = output_dir / f"metrics_{stem}.json"

    # per-checkpoint file log handler (reference eval_transformer.py:159-188)
    handler = logging.FileHandler(output_dir / f"eval_{stem}.log")
    handler.setFormatter(
        logging.Formatter("%(asctime)s %(name)s %(levelname)s %(message)s")
    )
    log.addHandler(handler)
    try:
        return _evaluate_checkpoint_inner(
            checkpoint_path, csv_dir, cache_dir, eval_csv, use_tta,
            batch_size, n_bootstrap, skip_if_exists, model_index, seed,
            device, tta_draws, stem, out_id, out_od, out_metrics,
        )
    finally:
        log.removeHandler(handler)
        handler.close()


class _Stages(dict):
    """Seconds per stage, synchronizing the card at each stage's end."""

    def __init__(self, device):
        super().__init__()
        self.cuda = torch.device(device).type == "cuda"

    def add(self, stage: str, t0: float) -> float:
        if self.cuda:
            torch.cuda.synchronize()
        t = time.perf_counter()
        self[stage] = self.get(stage, 0.0) + t - t0
        return t


def _evaluate_checkpoint_inner(
    checkpoint_path, csv_dir, cache_dir, eval_csv, use_tta, batch_size,
    n_bootstrap, skip_if_exists, model_index, seed, device, tta_draws, stem,
    out_id, out_od, out_metrics,
):
    if skip_if_exists and out_id.exists() and (
        eval_csv is None or out_od.exists()
    ):
        log.info("skip %s: predictions exist", stem)
        return {"skipped": True, "id_csv": str(out_id)}

    t = time.perf_counter()
    cfg, model, _, meta = load_model_from_checkpoint(checkpoint_path, device)
    stages = _Stages(next(model.parameters()).device)
    t = stages.add("load", t)
    if cfg.get("PRELOAD_DEVICE", False):
        raise NotImplementedError(
            "PRELOAD_DEVICE (the device-resident cohort store) is not ported "
            "yet (ROADMAP Queue 1, item 3)")
    diseases = list(cfg.DISEASES)
    fold = int(meta["fold"] if "fold" in meta else cfg.FOLD)

    _, meta_val, meta_test, meta_all = get_train_val_test(
        csv_dir, fold=fold, kfold=int(cfg.KFOLD), split=tuple(cfg.SPLIT)
    )
    DataPrepa(meta_all, cache_dir).preprocess_data(crop=tuple(cfg.IMG_SIZE))
    t = stages.add("preprocess", t)

    evaluator = Evaluator(cfg, model, use_tta=use_tta, batch_size=batch_size,
                          seed=seed, tta_draws=tta_draws)
    results = {"checkpoint": str(checkpoint_path), "fold": fold,
               "use_tta": use_tta, "model_index": model_index}

    if not cfg.get("USE_SYNTHETIC_DATA", False):
        meta_val = filter_synthetic(meta_val)
        meta_test = filter_synthetic(meta_test)
    meta_val = remove_duplicates(
        [row for row in meta_val if row["Diagnosis"] in diseases])
    meta_test = remove_duplicates(
        [row for row in meta_test if row["Diagnosis"] in diseases])
    ds_val = InMemoryDataset(cache_dir, meta_val, diseases)
    ds_test = InMemoryDataset(cache_dir, meta_test, diseases)
    t = stages.add("load", t)

    val_probs, val_gt = evaluator.predict_dataset(ds_val)
    t = stages.add("predict", t)
    results["val"] = _bootstrap_summary(val_probs, val_gt, n_bootstrap, seed)
    t = stages.add("bootstrap", t)

    test_probs, test_gt = evaluator.predict_dataset(ds_test)
    t = stages.add("predict", t)
    results["test_id"] = _bootstrap_summary(test_probs, test_gt, n_bootstrap,
                                            seed)
    t = stages.add("bootstrap", t)
    write_csv(attach_predictions(meta_test, test_probs, diseases), out_id)

    if eval_csv is not None:
        meta_od = load_metadata(eval_csv)
        DataPrepa(meta_od, cache_dir).preprocess_data(crop=tuple(cfg.IMG_SIZE))
        t = stages.add("preprocess", t)
        meta_od_known = [row for row in meta_od if row["Diagnosis"] in diseases]
        ds_od = InMemoryDataset(cache_dir, meta_od_known, diseases)
        t = stages.add("load", t)
        od_probs, od_gt = evaluator.predict_dataset(ds_od)
        t = stages.add("predict", t)
        results["test_od"] = _bootstrap_summary(od_probs, od_gt, n_bootstrap,
                                                seed)
        t = stages.add("bootstrap", t)
        write_csv(attach_predictions(meta_od_known, od_probs, diseases),
                  out_od)

    with open(out_metrics, "w") as f:
        json.dump(results, f, indent=2, default=float)
    results["id_csv"] = str(out_id)
    results["seconds"] = dict(stages)
    return results


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser(description="vsn_tpu_torch evaluator")
    p.add_argument("--checkpoints", nargs="+", required=True)
    p.add_argument("--training-csv-dir", required=True)
    p.add_argument("--intermediate-dir", required=True)
    p.add_argument("--output-dir", required=True)
    p.add_argument("--eval-csv", default=None, help="out-of-domain cohort CSV")
    p.add_argument("--use-tta", action="store_true")
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--num-bootstrap", type=int, default=10000)
    p.add_argument("--no-skip", action="store_true")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    args = p.parse_args(argv)

    out = []
    for i, c in enumerate(args.checkpoints):
        out.append(
            evaluate_checkpoint(
                c,
                csv_dir=args.training_csv_dir,
                cache_dir=args.intermediate_dir,
                output_dir=args.output_dir,
                eval_csv=args.eval_csv,
                use_tta=args.use_tta,
                batch_size=args.batch_size,
                n_bootstrap=args.num_bootstrap,
                skip_if_exists=not args.no_skip,
                model_index=i,
                device=args.device,
            )
        )
    print(json.dumps([
        {k: v for k, v in r.items() if not isinstance(v, dict)} for r in out
    ], default=float))
    return out


if __name__ == "__main__":
    main()
