"""The trainer's parts in the port against the JAX package's, on the CPU:
the epoch RNG and the samplers' draws, the training pipeline's batches
(host and index modes, preloaded or read per batch, across an epoch
boundary and after a resume at a saved epoch), the prefetcher's order and
errors, the validation metrics, the best-N rotation and the async saver's
files, ``filter_compatible``, the YAML reader on every config file, the
config writer's round trip through PyYAML, the defaults' key set, and the
trainer's BatchNorm refresh under the EMA weights."""

import threading
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import yaml

from vsn_tpu import config as jconfig
from vsn_tpu.data import pipeline as jpipe
from vsn_tpu.data import sampler as jsampler
from vsn_tpu.train import checkpoint as jck
from vsn_tpu.train import metrics as jmetrics
from vsn_tpu.utils import rng as jrng
from vsn_tpu_torch import config as tconfig
from vsn_tpu_torch.data import pipeline as tpipe
from vsn_tpu_torch.data import sampler as tsampler
from vsn_tpu_torch.train import checkpoint as tck
from vsn_tpu_torch.train import metrics as tmetrics
from vsn_tpu_torch.utils import rng as trng

DISEASES = ["CN", "AD", "FTD"]
CONFIGS = sorted((Path(jconfig.__file__).parent / "configs").glob("*.yaml"))


def test_epoch_rng_and_component_offsets_match_jax():
    assert trng.COMPONENT_OFFSETS == jrng.COMPONENT_OFFSETS
    for comp in ("sampler", "mixup", "val"):
        for epoch in (0, 3):
            a = trng.epoch_rng(42, comp, epoch).random(5)
            b = jrng.epoch_rng(42, comp, epoch).random(5)
            np.testing.assert_array_equal(a, b)


def test_sampler_draws_match_jax():
    labels = np.array(["CN"] * 5 + ["AD"] * 2 + ["FTD"] * 3)
    assert tsampler.compute_class_weights(labels, DISEASES) == \
        jsampler.compute_class_weights(labels, DISEASES)
    w = tsampler.compute_sample_weights(labels, DISEASES)
    np.testing.assert_array_equal(
        w, jsampler.compute_sample_weights(labels, DISEASES))
    for total in (None, 17):
        np.testing.assert_array_equal(
            tsampler.weighted_epoch_indices(w, total,
                                            np.random.default_rng(3)),
            jsampler.weighted_epoch_indices(w, total,
                                            np.random.default_rng(3)))
    np.testing.assert_array_equal(
        tsampler.shuffled_epoch_indices(10, np.random.default_rng(4)),
        jsampler.shuffled_epoch_indices(10, np.random.default_rng(4)))
    with pytest.raises(ValueError, match="zero samples"):
        tsampler.compute_class_weights(labels[:5], DISEASES)


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    """Eleven subjects' float16 cache files [5, 6, 4, 1] and their rows."""
    root = tmp_path_factory.mktemp("cache")
    rng = np.random.default_rng(0)
    rows = []
    for i in range(11):
        subject = f"s{i:02d}"
        np.save(root / f"{subject}.npy", rng.standard_normal(
            (5, 6, 4, 1)).astype(np.float16))
        rows.append({"Subject": subject, "Diagnosis": DISEASES[i % 3]})
    return root, rows


def _cfg(**kw):
    return tconfig.load_config(dict(DISEASES=DISEASES, **kw))


@pytest.mark.parametrize("over", [
    dict(USE_MIXUP=True), dict(USE_CUTMIX=True), dict(),
    dict(USE_BALANCED_SAMPLER=True, USE_MIXUP=True)])
@pytest.mark.parametrize("index_mode", [False, True])
@pytest.mark.parametrize("preload", [True, False])
def test_train_pipeline_batches_match_jax(cohort, over, index_mode, preload):
    """Nine steps of 2 x 2 over 11 subjects cross two epoch boundaries; a
    pipeline resumed at epoch 1 starts that epoch afresh in both."""
    root, rows = cohort
    cfg = _cfg(**over)
    jcfg = jconfig.load_config(extra_overrides=dict(DISEASES=DISEASES,
                                                    **over))
    tds = tpipe.InMemoryDataset(root, rows, DISEASES, preload=preload)
    jds = jpipe.InMemoryDataset(root, pd.DataFrame(rows), DISEASES,
                                preload=preload)
    assert tds.spatial_shape == jds.spatial_shape
    np.testing.assert_array_equal(tds.all_volumes(), jds.all_volumes())
    np.testing.assert_array_equal(tds.labels_str, jds.labels_str)
    for start in (0, 1):
        tp = tpipe.TrainPipeline(tds, cfg, 2, 2, seed=7,
                                 index_mode=index_mode)
        jp = jpipe.TrainPipeline(jds, jcfg, grad_accum=2, micro_batch=2,
                                 seed=7, index_mode=index_mode)
        tp.epoch = jp.epoch = start
        assert tp.steps_per_epoch() == jp.steps_per_epoch() == 2
        for _ in range(9):
            got, want = next(tp), next(jp)
            assert set(got) == set(want)
            for k in want:
                assert got[k].dtype == want[k].dtype, k
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            assert tp.epoch == jp.epoch
        assert tp.epoch == start + 4


def test_tiny_epochs_are_tiled(cohort):
    root, rows = cohort
    ds = tpipe.InMemoryDataset(root, rows[:3], DISEASES)
    pipe = tpipe.TrainPipeline(ds, _cfg(), 2, 4, seed=1)
    b = next(pipe)
    assert b["image"].shape == (2, 4, 5, 6, 4, 1)
    assert pipe.steps_per_epoch() == 1
    next(pipe)
    assert pipe.epoch == 1


def test_eval_pipeline_pads_with_row_zero(cohort):
    root, rows = cohort
    ds = tpipe.InMemoryDataset(root, rows, DISEASES, preload=False)
    batches = list(tpipe.EvalPipeline(ds, 4))
    jbatches = list(jpipe.EvalPipeline(
        jpipe.InMemoryDataset(root, pd.DataFrame(rows), DISEASES), 4))
    assert len(batches) == len(jbatches) == 3
    for (x, valid), (jx, _, jvalid) in zip(batches, jbatches):
        np.testing.assert_array_equal(x, jx)
        np.testing.assert_array_equal(valid, jvalid)
    pads = [pad for pad, _ in tpipe.EvalPipeline(ds, 4).indices()]
    np.testing.assert_array_equal(pads[-1], [8, 9, 10, 0])


def test_prefetch_keeps_order_and_passes_errors_on():
    assert list(tpipe.prefetch(iter(range(20)), 2,
                               device_put=lambda v: v * 10)) == \
        [10 * v for v in range(20)]

    def failing():
        yield 1
        yield 2
        raise RuntimeError("broken batch")

    got = []
    with pytest.raises(RuntimeError, match="broken batch"):
        for item in tpipe.prefetch(failing(), 1):
            got.append(item)
    assert got == [1, 2]
    # closing the consumer stops the worker (an endless source)
    gen = tpipe.prefetch(iter(int, 1), 2)
    assert next(gen) == 0
    before = threading.active_count()
    gen.close()
    assert threading.active_count() <= before - 1


def test_metrics_match_jax():
    rng = np.random.default_rng(5)
    for n, k in ((40, 3), (12, 5)):
        probs = rng.dirichlet(np.ones(k), n)
        gt = rng.integers(0, k, n)
        probs[3] = np.nan  # the uniform fallback
        got = tmetrics.compute_metrics(gt, probs, k)
        want = jmetrics.compute_metrics(gt, probs, k)
        assert got.keys() == want.keys()
        for key in want:
            np.testing.assert_equal(got[key], want[key])
    for name in ("loss", "bacc"):
        for new, best, delta in ((0.5, 0.6, 0.05), (0.5, 0.6, 0.2),
                                 (0.7, 0.6, 0.05)):
            assert tmetrics.is_improvement(name, new, best, delta) == \
                jmetrics.is_improvement(name, new, best, delta)


def _files(d):
    return sorted(p.name for p in Path(d).iterdir())


@pytest.mark.parametrize("metric", ["loss", "bacc"])
def test_best_n_rotation_and_saver_files_match_jax(tmp_path, metric):
    values = [0.9, 0.5, 0.7, 0.3, 0.8, 0.3, 0.1]
    dirs = {}
    for name, mod in (("jax", jck), ("port", tck)):
        d = tmp_path / name
        d.mkdir()
        saver = mod.AsyncCheckpointSaver(max_queue=2)
        tracker = mod.BestNTracker(d, "r", 0, 3, metric)
        for step, v in enumerate(values):
            idx = tracker.consider(v, step)
            if idx is not None:
                tracker.insert(idx, v, step, saver,
                               {"w": np.full(2, v, np.float32)},
                               {"step": step})
        saver.submit(d / "model_r_0_last.ckpt",
                     {"w": np.zeros(2, np.float32)}, {"step": 99})
        saver.close()
        dirs[name] = (d, tracker.entries, tracker.best)
    (jd, jentries, jbest), (td, tentries, tbest) = dirs["jax"], dirs["port"]
    assert tentries == jentries and tbest == jbest
    assert _files(td) == _files(jd)
    for f in _files(jd):
        jpayload, jmeta = jck.load_checkpoint(jd / f)
        tpayload, tmeta = tck.load_checkpoint(td / f)
        assert tmeta == jmeta
        np.testing.assert_array_equal(tpayload["w"], jpayload["w"])
        assert (td / f).read_bytes() == (jd / f).read_bytes()


def test_saver_snapshots_before_submit_returns(tmp_path):
    """The payload is copied to the host inside ``submit``: changing the
    tensor in place afterwards does not reach the file."""
    import torch

    t = torch.ones(4)
    saver = tck.AsyncCheckpointSaver()
    saver.submit(tmp_path / "a.ckpt", {"w": t}, {})
    t.add_(1)
    saver.close()
    np.testing.assert_array_equal(tck.load_checkpoint(tmp_path / "a.ckpt")[0]
                                  ["w"], np.ones(4, np.float32))


def test_filter_compatible_matches_jax():
    rng = np.random.default_rng(1)
    target = {"params": {"a": {"kernel": np.zeros((3, 2), np.float32),
                               "bias": np.zeros(2, np.float32)},
                         "b": np.zeros(4, np.float32)},
              "step": np.zeros((), np.int32), "ema": None}
    restored = {"params": {"a": {"kernel": rng.standard_normal((3, 2)),
                                 "bias": rng.standard_normal(5)}},
                "step": np.asarray(7, np.int64), "extra": np.ones(3)}
    got, kept, dropped = tck.filter_compatible(restored, target)
    jgot, jkept, jdropped = jck.filter_compatible(restored, target)
    assert (kept, dropped) == (jkept, jdropped)
    assert dropped == ["['params']['a']['bias']", "['params']['b']"]
    jflat = dict(tck._leaves(jgot))
    assert set(dict(tck._leaves(got))) == set(jflat)
    for path, value in tck._leaves(got):
        assert value.dtype == jflat[path].dtype
        np.testing.assert_array_equal(value, jflat[path])
    assert got["ema"] is None


@pytest.mark.parametrize("path", CONFIGS, ids=[p.name for p in CONFIGS])
def test_yaml_reader_matches_load_yaml_values(path):
    assert tconfig.load_yaml_values(path) == jconfig.load_yaml_values(path)


def test_load_config_from_files_matches_jax(tmp_path):
    override = tmp_path / "over.yaml"
    override.write_text("ARCHITECTURE: ViT  # a comment\nDEPTH: 3\n"
                        "DISEASES:\n- CN\n- 'AD'\nSEED: none\n"
                        "LR_BASE: 1.0e-4\n")
    for fold, seed in ((None, "__unset__"), (2, "false"), (1, "7")):
        got = tconfig.load_config(str(override), fold=fold, seed=seed)
        want = jconfig.load_config(str(override), fold=fold, seed=seed)
        assert dict(got) == {**tconfig.READ_DEFAULTS, **dict(want)}
    for path in CONFIGS:
        name = path.stem
        if name in tconfig.PRESETS:
            assert tconfig.load_config(path) == tconfig.load_config(
                preset=name)


def test_config_writer_round_trips_through_pyyaml(tmp_path):
    cfg = tconfig.load_config(dict(
        LR_FINAL=1e-05, EXTRA=[1, 2.5, "a: b", None, True, -3e20],
        NAME="yes", INF=float("inf"), NEG=-0.0))
    path = tconfig.save_config(cfg, tmp_path)
    assert path.name == "config.yaml"
    assert yaml.safe_load(path.read_text()) == dict(cfg)
    assert tconfig.load_yaml_values(path) == dict(cfg)


def test_defaults_key_set_equals_load_config():
    assert set(tconfig.DEFAULTS) == set(jconfig.load_config())
    cfg = tconfig.load_config(fold=3, seed="none")
    assert cfg.FOLD == 3 and cfg.SEED is None and cfg.seed_or_none is None
    assert tconfig.normalize_seed("12") == 12
    with pytest.raises(ValueError):
        tconfig.normalize_seed(True)


def test_bn_refresh_writes_the_ema_statistics(tmp_path, monkeypatch):
    """A BatchNorm model with EMA: after the loop the trainer re-estimates
    the statistics under the EMA weights over one epoch of a fresh
    pipeline and saves them as the last checkpoint's EMA statistics."""
    import torch
    from vsn_tpu_torch.data.synthetic import generate_synthetic_dataset
    from vsn_tpu_torch.train import step, trainer

    _, csvs = generate_synthetic_dataset(tmp_path / "cohort", 12,
                                         (18, 18, 18), DISEASES, 3, 0)
    cfg = tconfig.load_config(dict(
        ARCHITECTURE="ResNet", RESNET_VARIANT="resnet10",
        IMG_SIZE=[16, 16, 16], PATCH_SHAPE=[8, 8, 8], DISEASES=DISEASES,
        KFOLD=3, SPLIT=[1, 1, 1], BATCH_SIZE=2, EFFECTIVE_BATCH_SIZE=4,
        STEPS=2, LR_WARMUP=0, WD_WARMUP=0, VALIDATION_FREQUENCY=2,
        USE_EMA=True, FP16=False, DROPOUT=0.0))
    monkeypatch.setenv("VSN_BESTN_EVAL_ONLY", "1")
    refreshed = []
    real = step.make_bn_refresh_step

    def recording(*args, **kw):
        refresh = real(*args, **kw)

        def call(variables, batch, resident=None, index=0):
            out = refresh(variables, batch, resident, index)
            refreshed.append({k: v.clone() for k, v in out.items()})
            return out
        return call

    monkeypatch.setattr(trainer, "make_bn_refresh_step", recording)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        trainer.train_fold(cfg, str(csvs), tmp_path / "runs",
                           tmp_path / "cache", run_id="r", device="cpu")
    finally:
        torch.set_num_threads(threads)
    assert len(refreshed) == 1   # one epoch: 4 train subjects, 1 batch
    payload, meta = tck.load_checkpoint(tmp_path / "runs" /
                                        "model_r_0_last.ckpt")
    from vsn_tpu_torch.convert import state_dict_from_jax

    saved = state_dict_from_jax(
        {"params": payload["state"]["ema"]["ema"]["params"],
         **payload["state"]["ema"]["ema"]["model_state"]})
    for name, value in refreshed[-1].items():
        np.testing.assert_array_equal(saved[name].numpy(), value.numpy())
    assert meta["step"] == 2


def test_train_fold_needs_a_card_or_a_device(monkeypatch, tmp_path):
    import torch
    from vsn_tpu_torch.train.trainer import train_fold

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="train_fold: .*device='cpu'"):
        train_fold(_cfg(), tmp_path, tmp_path / "runs", tmp_path / "cache")
    assert not (tmp_path / "runs").exists()
