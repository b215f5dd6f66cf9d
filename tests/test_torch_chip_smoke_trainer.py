"""chip_smoke.py's phase 20c (the trainer through its CLI: the host
pipeline, a resume, the float16 device store, WATCH_GRADIENTS with
USE_CHECKPOINT, best0 through the eval path) rehearsed on the CPU at a
tiny size with one torch thread.

On the CPU every kernel wrapper runs its plain version and counts
nothing, so the launch checks expect no launch, and peak memory is not
read. The phase must pass the port as it is and fail on source mutants: a
history row written after the 'last' save, a resume that drops the saved
sampler epoch, a device-store gather one row off, and an attention probe
that reads the fused model.
"""

import inspect
import types

import numpy as np
import pytest

import chip_smoke
from tests.test_torch_chip_smoke import one_thread  # noqa: F401
from vsn_tpu_torch.config import load_config
from vsn_tpu_torch.data import resident
from vsn_tpu_torch.models import build_model
from vsn_tpu_torch.train import cli, trainer

TRAIN_TINY = dict(IMG_SIZE=[12, 18, 12], PATCH_SHAPE=[2, 2, 2],
                  WINDOW_SIZE=[2, 3, 2], EMBED_DIM=8, DEPTH=[2, 2, 2],
                  HEADS=[1, 2, 4], FP16=False, SEED=0, USE_SAM=True,
                  USE_EMA=True, USE_MIXUP=True, MIXUP_PROB=0.5,
                  USE_SHAKEDROP=True, LABEL_SMOOTHING=0.1, BATCH_SIZE=8,
                  EFFECTIVE_BATCH_SIZE=16)
NONE = dict(per_pass={}, per_forward={}, remat_pass={}, n_bootstrap=50)


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    root = tmp_path_factory.mktemp("trainer_cohort")
    cfg = chip_smoke.trainer_config(load_config(TRAIN_TINY))
    csv_dir, _ = chip_smoke.chain_cohort(root, cfg)
    return csv_dir, root / "cache"


def _phase(cohort, tmp_path):
    csv_dir, cache = cohort
    return chip_smoke.trainer_phase(load_config(TRAIN_TINY), csv_dir, cache,
                                    tmp_path / "trainer", "cpu", "cpu",
                                    **NONE)


def test_trainer_phase_passes(cohort, tmp_path, capsys):
    out = _phase(cohort, tmp_path)
    assert set(out) == {"a", "b", "c", "d"}
    assert out["a"]["summary"]["history"]["step"] == [2, 4]
    assert out["b"]["summary"]["history"]["step"] == [2, 4, 6]
    assert out["d"]["summary"]["steps"] == 2
    log = capsys.readouterr().out
    for text in ("trainer b: loaded state equals (a)'s saved state bit for "
                 "bit", "step batches equal the host pipeline's bit for "
                 "bit", "trainer best0 (step", "module norms"):
        assert text in log, text
    assert out["a"]["rate"] > 0


def _mutate(monkeypatch, old, new):
    """Run the phase on ``train_fold`` with ``old`` replaced by ``new`` in
    its source (compiled into a function of the trainer module's globals,
    so the phase's hooks on that module still apply; the CLI calls it)."""
    src = inspect.getsource(trainer)
    for o, n in zip(old, new):
        assert src.count(o) == 1, o
        src = src.replace(o, n)
    ns = dict(vars(trainer))
    exec(compile(src, trainer.__file__, "exec"), ns)
    fn = types.FunctionType(ns["train_fold"].__code__, vars(trainer),
                            "train_fold", ns["train_fold"].__defaults__)
    monkeypatch.setattr(trainer, "train_fold", fn)
    monkeypatch.setattr(cli, "train_fold", fn)


def test_rejects_a_history_row_written_after_the_last_save(
        cohort, tmp_path, monkeypatch):
    append = ("                for k, v in row.items():\n"
              "                    history.setdefault(k, []).append(v)\n")
    log_line = "                tracker.log(row, step=step)\n"
    _mutate(monkeypatch, (append, log_line), ("", append + log_line))
    with pytest.raises(AssertionError, match="does not begin"):
        _phase(cohort, tmp_path)


def test_rejects_a_resume_that_drops_the_sampler_epoch(
        cohort, tmp_path, monkeypatch):
    _mutate(monkeypatch,
            ['pipe.epoch = int(meta.get("sampler_epoch", 0))'], ["pass"])
    with pytest.raises(AssertionError, match="trainer b: sampler epoch"):
        _phase(cohort, tmp_path)


def test_rejects_a_store_gather_one_row_off(cohort, tmp_path, monkeypatch):
    real = resident.gather_volumes
    monkeypatch.setattr(resident, "gather_volumes",
                        lambda res, idx: real(res, (idx + 1) % len(res)))
    with pytest.raises(AssertionError, match="rows differ from the host"):
        _phase(cohort, tmp_path)


def test_rejects_a_probe_that_reads_the_fused_model(cohort, tmp_path,
                                                    monkeypatch):
    monkeypatch.setattr(trainer, "probe_twin",
                        lambda cfg, device: build_model(cfg, device))
    with pytest.raises(AssertionError, match="probe read no attention"):
        _phase(cohort, tmp_path)


def test_k1_kept_bytes_of_swin_t():
    """K1f's kept state of Swin-T 5c at micro 8 (ao, row statistics, f32
    o): 896.9 MB, as phase 17 logs it."""
    model = build_model(load_config(), device="cpu")
    assert np.isclose(chip_smoke.k1_kept_bytes(model, 8) / 1e6, 896.9,
                      atol=0.1)
