"""Host input pipeline: in-memory cache -> epoch sampling -> step batches ->
prefetched copies to the card (port of vsn_tpu/data/pipeline.py, one
process).

The float16 cache is preloaded into one contiguous numpy array
(PRELOAD_DATA, reference dataset/dataset.py:81-101), or read per batch; per
epoch the index order comes from the shuffled or class-balanced sampler and
MixUp / CutMix partners are planned (``MixPlanner``), from numpy Generators
keyed by (seed, component, epoch) as the JAX pipeline keys them, so both
packages assemble the same batches; a background thread keeps step batches
in flight to the card (``prefetch``, ``DeviceBatch``). All voxel math
(mixing, augmentation, normalization) happens on the device. Metadata is a
table of row dicts (``data/folds.py``).
"""

from __future__ import annotations

import queue
import threading
from pathlib import Path

import numpy as np

from vsn_tpu_torch.data.mixers import MixPlanner
from vsn_tpu_torch.data.sampler import (
    compute_sample_weights,
    shuffled_epoch_indices,
    weighted_epoch_indices,
)
from vsn_tpu_torch.utils.rng import epoch_rng


class InMemoryDataset:
    """The float16 cache ``images`` [N, D, H, W, 1] (preloaded; None with
    ``preload=False``, when ``gather`` reads the files) + one-hot
    ``labels`` [N, K].

    One-hot rule matches reference dataset.py:64-70: diagnoses outside
    ``diseases`` get an all-zero label (they are normally filtered upstream).
    """

    def __init__(self, cache_dir, metadata, diseases, preload: bool = True):
        self.cache_dir = Path(cache_dir)
        self.metadata = list(metadata)
        self.diseases = list(diseases)
        self.subjects = [row["Subject"] for row in self.metadata]
        self.labels_str = np.asarray([row["Diagnosis"]
                                      for row in self.metadata])
        idx = {d: i for i, d in enumerate(self.diseases)}
        self.labels = np.zeros((len(self.metadata), len(idx)), np.float32)
        for i, diag in enumerate(self.labels_str):
            if diag in idx:
                self.labels[i, idx[diag]] = 1.0
        self.images = None
        if preload:
            first = self._load_file(0)
            self.images = np.empty((len(self.subjects),) + first.shape,
                                   np.float16)
            self.images[0] = first
            for i in range(1, len(self.subjects)):
                self.images[i] = self._load_file(i)

    def _load_file(self, i: int) -> np.ndarray:
        return np.load(self.cache_dir / f"{self.subjects[i]}.npy")

    def __len__(self):
        return len(self.subjects)

    @property
    def spatial_shape(self):
        if self.images is not None:
            return self.images.shape[1:4]
        return self._load_file(0).shape[:3]

    def gather(self, indices) -> np.ndarray:
        """[n, D, H, W, 1] float16 for the given sample indices."""
        if self.images is not None:
            return self.images[indices]
        return np.stack([self._load_file(i) for i in indices])

    def all_volumes(self) -> np.ndarray:
        """The full [N, D, H, W, 1] float16 cache (for the device store)."""
        if self.images is not None:
            return self.images
        return self.gather(np.arange(len(self.subjects)))


class TrainPipeline:
    """Infinite step-batch iterator.

    Yields dicts of numpy arrays: label [A, B, K] f32 and image [A, B, D, H,
    W, 1] f16 (index mode: ``image_idx`` [A, B] int32 rows of the device
    store instead) and, when mixing is enabled, image2 (``partner_idx``),
    label2, mix_lam, mix_apply, mix_bounds. A = gradient accumulation
    factor, B = micro-batch.

    A new epoch re-draws the sampler order and the mix plan (reference
    train_transformer.py:1077-1099); an epoch shorter than one step is
    tiled. ``epoch`` is the epoch of the last batch made; set it before the
    first batch to start at that epoch (resume).
    """

    def __init__(self, dataset: InMemoryDataset, cfg, grad_accum: int,
                 micro_batch: int, seed: int | None = None,
                 index_mode: bool = False):
        self.ds = dataset
        self.index_mode = bool(index_mode)
        self.grad_accum = int(grad_accum)
        self.micro_batch = int(micro_batch)
        self.per_step = self.grad_accum * self.micro_batch
        self.seed = seed
        self.balanced = bool(cfg.get("USE_BALANCED_SAMPLER", False))
        self.planner = MixPlanner(dataset.labels_str, dataset.diseases, cfg,
                                  dataset.spatial_shape, seed=seed)
        if self.balanced:
            self.sample_weights = compute_sample_weights(dataset.labels_str,
                                                         dataset.diseases)
        self.epoch = 0
        self._epoch_indices = None
        self._epoch_plan = None
        self._pos = 0

    def _start_epoch(self):
        rng = epoch_rng(self.seed, "sampler", self.epoch)
        if self.balanced:
            indices = weighted_epoch_indices(self.sample_weights, None, rng)
        else:
            indices = shuffled_epoch_indices(len(self.ds), rng)
        if len(indices) < self.per_step:
            # tiny datasets: tile the epoch so one step is always possible
            indices = np.tile(indices, -(-self.per_step // len(indices)))
        mix_rng = epoch_rng(self.seed, "mixup", self.epoch)
        self._epoch_plan = self.planner.plan(indices, self.epoch, mix_rng)
        self._epoch_indices = indices
        self._pos = 0

    def steps_per_epoch(self) -> int:
        return max(1, len(self.ds) // self.per_step)

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        if self._epoch_indices is None or self._pos + self.per_step > len(
                self._epoch_indices):
            if self._epoch_indices is not None:
                self.epoch += 1
            self._start_epoch()
        sl = slice(self._pos, self._pos + self.per_step)
        self._pos += self.per_step
        a, b = self.grad_accum, self.micro_batch
        shape = (a, b, *self.ds.spatial_shape, 1)
        idx = self._epoch_indices[sl]
        batch = {"label": self.ds.labels[idx].reshape(a, b, -1)}
        if self.index_mode:
            batch["image_idx"] = idx.astype(np.int32).reshape(a, b)
        else:
            batch["image"] = self.ds.gather(idx).reshape(shape)
        if self.planner.mode is not None:
            plan = {k: v[sl] for k, v in self._epoch_plan.items()}
            partner = plan["partner"]
            if self.index_mode:
                batch["partner_idx"] = partner.astype(np.int32).reshape(a, b)
            else:
                batch["image2"] = self.ds.gather(partner).reshape(shape)
            batch["label2"] = self.ds.labels[partner].reshape(a, b, -1)
            batch["mix_lam"] = plan["mix_lam"].reshape(a, b)
            batch["mix_apply"] = plan["mix_apply"].reshape(a, b)
            batch["mix_bounds"] = plan["mix_bounds"].reshape(a, b, 6)
        return batch


class EvalPipeline:
    """Fixed-order batches of ``batch_size`` rows of ``source`` (an array
    such as a dataset's ``images``, or an ``InMemoryDataset``, whose
    ``gather`` reads them), the last padded to full size with copies of
    row 0.

    ``indices()`` yields (padded row indices [B], valid_mask [B]) and
    iteration (batch [B, ...], valid_mask [B]): a full batch keeps every
    launch at one shape; the mask drops pad rows on the host (the
    reference's all_gather pad/trim, train_transformer.py:550-568, on one
    process). A device store (``data/resident.py``) is read by the same
    indices on the card."""

    def __init__(self, source, batch_size: int):
        self.source = source
        self.batch_size = int(batch_size)

    def indices(self):
        n, b = len(self.source), self.batch_size
        for start in range(0, n, b):
            idx = np.arange(start, min(start + b, n))
            valid = np.zeros(b, bool)
            valid[: len(idx)] = True
            yield np.concatenate([idx, np.zeros(b - len(idx), np.int64)]), \
                valid

    def __iter__(self):
        gather = getattr(self.source, "gather", None)
        for pad, valid in self.indices():
            yield (gather(pad) if gather else self.source[pad]), valid


class DeviceBatch:
    """A step batch of numpy arrays copied to ``device``. On a CUDA device
    the arrays go to pinned host memory and are copied on ``stream`` (a
    side stream) behind an event; ``get()``, called on the stream that
    uses the batch, makes that stream wait for the event and marks each
    tensor as used there, so the caching allocator does not hand its
    memory to another tensor before that stream is done with it."""

    def __init__(self, batch: dict, device, stream=None):
        import torch

        self.device = torch.device(device)
        self.event = None
        if self.device.type != "cuda":
            self.tensors = {k: torch.from_numpy(np.ascontiguousarray(v)).to(
                self.device) for k, v in batch.items()}
            return
        with torch.cuda.stream(stream or torch.cuda.current_stream(
                self.device)):
            self.tensors = {
                k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory().to(
                    self.device, non_blocking=True)
                for k, v in batch.items()}
            self.event = torch.cuda.Event()
            self.event.record()

    def get(self) -> dict:
        import torch

        if self.event is not None:
            current = torch.cuda.current_stream(self.device)
            current.wait_event(self.event)
            for t in self.tensors.values():
                t.record_stream(current)
        return self.tensors


def prefetch(iterator, size: int, device_put=None):
    """Background-thread prefetcher; optionally ``device_put``s each item.

    The queue bounds memory like the reference's bounded saver queue
    (train_transformer.py:197-276) and overlaps the host gather and the
    copy to the card with device compute. Items come out in order; an
    error in the worker is raised in the consumer, after the items before
    it. Closing the generator (or dropping it) stops the worker."""
    q: queue.Queue = queue.Queue(maxsize=max(1, size))
    sentinel = object()
    err: list[BaseException] = []
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in iterator:
                if device_put is not None:
                    item = device_put(item)
                if not put(item):
                    return
        except BaseException as e:  # propagate to consumer
            err.append(e)
        finally:
            put(sentinel)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                if err:
                    raise err[0]
                return
            yield item
    finally:
        stop.set()
        t.join()
