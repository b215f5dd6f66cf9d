"""The port's per-fold trainer (vsn_tpu_torch/train/trainer.py, cli.py)
against the JAX package's (vsn_tpu/train/trainer.py, cli.py) on the CPU.

A tiny ViT (EMBED_DIM 48, depth 2, 16x20x16, f32, no DropPath, the
minimal transform, MixUp and EMA on) starts from one JAX
``init_train_state`` written as a JAX checkpoint; both ``train_fold``s
resume from it on the same synthetic cohort (7 train folds of 8 subjects:
7 steps an epoch at micro 4 x accumulation 2, so no prefetch reaches a new
epoch and both save sampler epoch 0), the JAX one on a one-device mesh so
that its micro-batch is BATCH_SIZE. Early stopping (patience 2, an
impossible min delta) stops both at step 4 of 8, validating every 2.

* the histories' floats (train_loss, grad_norm, lr, wd, every val_*
  metric, val_loss and val_attn_logit_max; not the wall times) agree
  within 1e-4 relative; their integer fields, the stop, the best-N
  entries and files are equal; the final ``_last.ckpt`` states agree;
* a ``_last.ckpt`` the port wrote resumes in JAX and JAX's resumes in the
  port (no leaf dropped), each to step 6, and the two resumed histories
  agree as above, each starting with the rows of the run it resumed;
* the port's CLI writes the JAX trainer's file set (and its summary file).
"""

import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vsn_tpu.config import load_config as jax_load_config
from vsn_tpu.models import build_model as jax_build_model
from vsn_tpu.parallel.mesh import make_mesh
from vsn_tpu.train import checkpoint as jck
from vsn_tpu.train.step import init_train_state as jax_init_train_state
from vsn_tpu.train.trainer import train_fold as jax_train_fold
from vsn_tpu_torch.config import load_config, save_config
from vsn_tpu_torch.data.synthetic import generate_synthetic_dataset
from vsn_tpu_torch.train import checkpoint as tck
from vsn_tpu_torch.train.cli import main as cli_main
from vsn_tpu_torch.train.trainer import train_fold

RTOL = 1e-4
OVER = dict(ARCHITECTURE="ViT", IMG_SIZE=[16, 20, 16], RESHAPE_SIZE=False,
            PATCH_SHAPE=[4, 4, 4], EMBED_DIM=48, DEPTH=2, HEADS=2,
            DISEASES=["CN", "AD", "FTD"], BATCH_SIZE=4,
            EFFECTIVE_BATCH_SIZE=8, STEPS=8, LR_WARMUP=2, WD_WARMUP=2,
            LR_BASE=1e-3, LR_FINAL=1e-4, VALIDATION_FREQUENCY=2,
            EARLY_STOPPING_PATIENCE=2, EARLY_STOPPING_MIN_DELTA=10.0,
            KEEP_BEST_N=2, SEED=42, FP16=False, STOCHASTIC_DEPTH_PROB=0.0,
            USE_MIXUP=True, USE_EMA=True)
WALL = ("val_wall_s", "ckpt_wall_s")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    root = tmp_path_factory.mktemp("trainer")
    _, csvs = generate_synthetic_dataset(root, 80, (20, 24, 20),
                                         ("CN", "AD", "FTD"), 10, 1)
    jcfg = jax_load_config(extra_overrides=OVER)
    model = jax_build_model(jcfg)
    variables = jax.jit(lambda k, x: model.init(k, x, True))(
        jax.random.key(0), jnp.zeros((1, 16, 20, 16, 1)))
    init = root / "init.ckpt"
    jck.save_checkpoint(init, {"state": jax_init_train_state(jcfg,
                                                              variables)},
                        {"fold": 0, "step": 0})
    mesh = make_mesh(jax.devices()[:1])
    cache = root / "cache"
    cfg = load_config(OVER)
    out = {"root": root, "csvs": csvs, "cfg": cfg, "cache": cache}
    out["jax"] = jax_train_fold(jcfg, str(csvs), root / "jax", cache,
                                run_id="j", resume_from=str(init),
                                mesh=mesh)
    out["port"] = train_fold(cfg, str(csvs), root / "port", cache,
                             run_id="p", resume_from=str(init),
                             device="cpu")
    # each resumes the other's last checkpoint, to step 6
    out["jax_resumed"] = jax_train_fold(
        jcfg, str(csvs), root / "jax2", cache, run_id="j2",
        resume_from=str(root / "port" / "model_p_0_last.ckpt"), mesh=mesh,
        max_steps=6)
    out["port_resumed"] = train_fold(
        cfg, str(csvs), root / "port2", cache, run_id="p2",
        resume_from=str(root / "jax" / "model_j_0_last.ckpt"), max_steps=6,
        device="cpu")
    yield out
    torch.set_num_threads(threads)


def _compare_history(got, want):
    assert set(got) == set(want)
    for key, values in want.items():
        if key in WALL:
            continue
        if key in ("step", "skipped_steps"):
            assert got[key] == values, key
        else:
            np.testing.assert_allclose(got[key], values, rtol=RTOL, atol=0,
                                       err_msg=key)


def test_history_best_n_and_stop_match_jax(runs):
    j, p = runs["jax"], runs["port"]
    _compare_history(p["history"], j["history"])
    assert p["history"]["step"] == [2, 4]
    assert all(np.isfinite(p["history"]["val_attn_logit_max"]))
    assert (p["steps"], p["stopped_early"]) == (j["steps"],
                                                j["stopped_early"]) == (4,
                                                                        True)
    assert p["best"][1] == j["best"][1]
    np.testing.assert_allclose(p["best"][0], j["best"][0], rtol=RTOL)
    for tag, run in (("j", "jax"), ("p", "port")):
        files = sorted(f.name for f in (runs["root"] / run).glob("*.ckpt"))
        assert files == [f"model_{tag}_0_{s}.ckpt"
                         for s in ("best0", "best1", "last")]
    for i in (0, 1):
        _, jmeta = jck.load_checkpoint(runs["root"] / "jax" /
                                       f"model_j_0_best{i}.ckpt")
        _, pmeta = tck.load_checkpoint(runs["root"] / "port" /
                                       f"model_p_0_best{i}.ckpt")
        assert pmeta["step"] == jmeta["step"]
        assert pmeta["sampler_epoch"] == jmeta["sampler_epoch"] == 0


def test_last_checkpoint_states_agree(runs):
    jstate = jck.load_checkpoint(runs["root"] / "jax" /
                                 "model_j_0_last.ckpt")[0]["state"]
    pstate = tck.load_checkpoint(runs["root"] / "port" /
                                 "model_p_0_last.ckpt")[0]["state"]
    jl, pl = dict(tck._leaves(jstate)), dict(tck._leaves(pstate))
    assert set(jl) == set(pl) and len(jl) > 40
    for path, want in jl.items():
        got, want = np.asarray(pl[path]), np.asarray(want)
        assert got.shape == want.shape and got.dtype == want.dtype, path
        scale = float(np.abs(want).max()) or 1.0
        np.testing.assert_allclose(got, want, rtol=0, atol=RTOL * scale,
                                   err_msg=str(path))


def test_last_checkpoints_resume_across_packages(runs):
    root = runs["root"]
    port_payload = tck.load_checkpoint(root / "port" / "model_p_0_last.ckpt")
    jax_payload = jck.load_checkpoint(root / "jax" / "model_j_0_last.ckpt")
    jcfg = jax_load_config(extra_overrides=OVER)
    target = jax_init_train_state(jcfg, jax_build_model(jcfg).init(
        jax.random.key(1), jnp.zeros((1, 16, 20, 16, 1)), True))
    assert jck.filter_compatible(port_payload[0]["state"], target)[2] == []
    assert tck.filter_compatible(jax_payload[0]["state"],
                                 port_payload[0]["state"])[2] == []
    jr, pr = runs["jax_resumed"], runs["port_resumed"]
    assert jr["steps"] == pr["steps"] == 6
    assert jr["history"]["step"] == pr["history"]["step"] == [2, 4, 6]
    _compare_history(pr["history"], jr["history"])
    # each resumed history starts with the rows of the run it resumed (the
    # checkpoint's meta is taken before its own save time is appended)
    for resumed, origin in ((jr, runs["port"]), (pr, runs["jax"])):
        for key, values in origin["history"].items():
            if key not in WALL:
                assert resumed["history"][key][:2] == values, key


def test_cli_writes_the_jax_trainers_file_set(runs, tmp_path):
    cfg_path = save_config(runs["cfg"], tmp_path, "tiny.yaml")
    out = tmp_path / "cli"
    summary = cli_main([
        "--training-csv-dir", str(runs["csvs"]), "--save-dir", str(out),
        "--intermediate-dir", str(runs["cache"]), "--config", str(cfg_path),
        "--runname", "j", "--checkpoint",
        str(runs["root"] / "init.ckpt"), "--device", "cpu"])
    got = sorted(str(p.relative_to(out)) for p in out.rglob("*"))
    jax_dir = runs["root"] / "jax"
    want = sorted([str(p.relative_to(jax_dir)) for p in jax_dir.rglob("*")]
                  + ["summary_j_0.json"])
    assert got == want
    for key, values in runs["port"]["history"].items():
        if key not in WALL:
            assert summary["history"][key] == values, key
    written = json.loads((out / "summary_j_0.json").read_text())
    assert written["steps"] == 4 and written["stopped_early"] is True
    rows = [json.loads(line) for line in
            open(out / "run_j_0" / "metrics.jsonl")]
    assert rows[-1]["kind"] == "summary" and "step_time" in rows[-1]
    assert [r["step"] for r in rows[:-1]] == [2, 4]
    assert os.path.getsize(out / "run_j_0" / "config.yaml") > 0
