"""chip_smoke.py's phases 20a (the uncertainty eval chain), 20b
(USE_PALLAS_ATTENTION off) and MedViT's stem.0 weight gradient in f64,
rehearsed on the CPU at a tiny size with one torch thread.

On the CPU every kernel wrapper runs its plain version and the "card" is
the CPU, so the phases must pass the port as it is and reject mutants: a
checkpoint that does not load the saved weights (the bit-for-bit logits
gate), prediction rows that do not sum to 1 (the CSV gate), a "kernel
route" that differs from the plain route (the TTA gate), and a model that
ignores the flag (phase 20b). The launch checks see no launch here.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from tests.test_torch_chip_smoke import one_thread  # noqa: F401
from tests.test_torch_chip_smoke_unfused import MEDVIT_TINY
from vsn_tpu_torch.config import load_config
from vsn_tpu_torch.models import swin3d

SWIN_TINY = dict(IMG_SIZE=[12, 18, 12], PATCH_SHAPE=[2, 2, 2],
                 WINDOW_SIZE=[2, 3, 2], EMBED_DIM=8, DEPTH=[2, 2, 2],
                 HEADS=[1, 2, 4], FP16=False, SEED=0,
                 **chip_smoke.CHAIN_CONFIG)


def _volumes(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, 12, 18, 12, 1), np.float32) * 50
            + 100).astype(np.float16)


@pytest.fixture
def tiny(monkeypatch):
    monkeypatch.setattr(chip_smoke, "volumes", _volumes)
    return load_config(SWIN_TINY)


def test_eval_chain_phase_passes(tiny, tmp_path, capsys):
    n = chip_smoke.eval_chain_phase(tiny, tmp_path / "chain", "cpu", "cpu",
                                    per_forward={}, n_bootstrap=100)
    assert n == {"plain": 16, "tta": 16}   # val 4, test 4, OD 8
    out = capsys.readouterr().out
    assert "TTA batch at the cap: 8 volumes x 8 views = 64 rows" in out
    assert "bit for bit" in out and "eval chain TTA vs plain path" in out
    assert "eval chain warp, card vs CPU: max|d| 0.000e+00" in out
    for label in ("plain", "tta"):
        names = {p.name for p in (tmp_path / "chain" / label).iterdir()}
        assert names == {f"{p}model_chip_0_best0{s}" for p, s in (
            ("prediction_", "_id.csv"), ("prediction_", "_od.csv"),
            ("metrics_", ".json"), ("eval_", ".log"))}


def test_eval_chain_phase_rejects_a_checkpoint_that_moves_the_weights(
        tiny, tmp_path, monkeypatch):
    from vsn_tpu_torch import convert

    real = convert.state_dict_from_jax

    def nudged(variables, *a, **kw):
        sd = real(variables, *a, **kw)
        key = next(k for k in sd if k.endswith("qkv.weight"))
        sd[key] = sd[key] * (1 + 2 ** -20)
        return sd
    monkeypatch.setattr(convert, "state_dict_from_jax", nudged)
    with pytest.raises(AssertionError, match="differ from the saved"):
        chip_smoke.eval_chain_phase(tiny, tmp_path / "chain", "cpu", "cpu",
                                    per_forward={}, n_bootstrap=100)


def test_eval_chain_phase_rejects_rows_that_do_not_sum_to_one(
        tiny, tmp_path, monkeypatch):
    from vsn_tpu_torch.eval import evaluate

    real = evaluate.attach_predictions
    monkeypatch.setattr(evaluate, "attach_predictions",
                        lambda meta, probs, d: real(meta, probs * 1.0005, d))
    with pytest.raises(AssertionError, match="sum to 1 within"):
        chip_smoke.eval_chain_phase(tiny, tmp_path / "chain", "cpu", "cpu",
                                    per_forward={}, n_bootstrap=100)


def test_eval_chain_phase_rejects_a_kernel_route_off_the_plain_one(
        tiny, tmp_path, monkeypatch):
    real = swin3d.ln_mlp
    monkeypatch.setattr(swin3d, "ln_mlp",
                        lambda x, *a, **kw: real(x, *a, **kw) * 1.5)
    with pytest.raises(AssertionError, match="eval chain TTA views: kernel"):
        chip_smoke.eval_chain_phase(tiny, tmp_path / "chain", "cpu", "cpu",
                                    per_forward={}, n_bootstrap=100)


def test_flag_off_phase_passes_and_rejects_an_ignored_flag(tiny, monkeypatch):
    images = _volumes(4, 1)
    worst = chip_smoke.flag_off_phase(tiny, images, "cpu", "cpu")
    assert 0 <= worst < 1
    real = swin3d.fused_block_gate
    monkeypatch.setattr(swin3d, "fused_block_gate",
                        lambda use_pallas, *a: real(True, *a))
    with pytest.raises(AssertionError, match="a block is fused"):
        chip_smoke.flag_off_phase(tiny, images, "cpu", "cpu")


def test_medvit_stem_f64_reading():
    cfg = load_config(dict(MEDVIT_TINY, FP16=False))
    model = chip_smoke.seeded_model(cfg, device="cpu")
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((2, 36, 40, 20, 1)).astype(
        np.float32))
    labels = torch.eye(cfg.num_classes)[[0, 1]]
    draws = model.draw(2, torch.device("cpu"), torch.Generator().manual_seed(3))
    got = chip_smoke.medvit_stem_f64(model, x, labels, draws, "cpu")
    assert got["f64_rel_gap"] == 0.0   # the same f64 conv twice
    assert 0 < got["f32_ulps_max"] < np.inf
    assert got["terms"] == 2 * 18 * 20 * 10   # stride 2, padding 1
    assert 0 < got["f32_of_scale"] < np.log2(got["terms"])
