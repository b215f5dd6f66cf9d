"""``evaluate_checkpoint`` end to end, the port against the JAX package on
the CPU, on one JAX-written checkpoint of a tiny Swin (``save_checkpoint``
of its initial variables, the head x 50 so that the probabilities are far
from uniform; no training) over a tiny synthetic cohort (12 subjects, 3
folds, split [1, 1, 1]: val and test 4 volumes each):

* plain: the same files (``prediction_{stem}_id.csv``,
  ``metrics_{stem}.json``, ``eval_{stem}.log``), the CSVs' rows and text
  columns equal and their probabilities within 1e-5, the metrics JSON's
  keys equal and its values within 1e-5;
* TTA with an out-of-domain cohort, JAX's draws injected: the same, the OD
  CSV too;
* a 'last' checkpoint (the train state's params) gives the plain
  results; an existing prediction CSV skips the work; the CLI (``main``)
  writes the same files; PRELOAD_DEVICE's device stores give JAX's
  results, and raw stores the host arrays' bit for bit.
"""

import csv
import json
import shutil

import numpy as np
import jax
import pytest
import torch

from vsn_tpu.config import load_config as jax_load_config
from vsn_tpu.data.synthetic import generate_synthetic_dataset
from vsn_tpu.eval import evaluate as jev
from vsn_tpu.models import build_model as jax_build_model
from vsn_tpu.train import checkpoint as jck
from vsn_tpu_torch.eval import evaluate as tev

TINY = dict(IMG_SIZE=[12, 18, 12], PATCH_SHAPE=[2, 2, 2],
            WINDOW_SIZE=[2, 3, 2], EMBED_DIM=8, DEPTH=[2, 2, 2],
            HEADS=[1, 2, 4], FP16=False, DISEASES=["CN", "AD", "FTD"],
            KFOLD=3, SPLIT=[1, 1, 1], FOLD=1, EVAL_BATCH_SIZE=2)
STEM = "model_run_1_best0"
N_BOOT = 300
SEED = 42
ROT = float(np.deg2rad(3.0))
TOL = 1e-5


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("eval")
    cfg = jax_load_config(extra_overrides=TINY)
    jmodel = jax_build_model(cfg)
    variables = jax.jit(lambda k, x: jmodel.init(k, x, True))(
        jax.random.key(0), np.zeros((1, 12, 18, 12, 1), np.float32))
    variables = jax.tree.map(np.asarray, variables)
    variables["params"]["head"]["kernel"] = (
        variables["params"]["head"]["kernel"] * 50.0)
    _, csv_dir = generate_synthetic_dataset(root / "cohort", n_subjects=12,
                                            shape=(14, 20, 14), kfold=3,
                                            seed=0)
    _, od_dir = generate_synthetic_dataset(root / "od", n_subjects=5,
                                           shape=(14, 20, 14), kfold=1,
                                           seed=1, dataset_name="OD")
    meta = {"config": dict(cfg), "fold": 1, "step": 0}
    ckpt = root / f"{STEM}.ckpt"
    jck.save_checkpoint(ckpt, {"variables": variables}, meta)
    last = root / "model_run_1_last.ckpt"
    jck.save_checkpoint(last, {"state": {"params": variables["params"],
                                         "model_state": {}, "step": 3}}, meta)
    return root, ckpt, last, csv_dir, od_dir / "fold_0.csv"


def _read(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def _same_csv(want_path, got_path):
    want, got = _read(want_path), _read(got_path)
    assert len(want) == len(got) > 0 and list(want[0]) == list(got[0])
    for w, g in zip(want, got):
        for key in w:
            if key.startswith("pred_"):
                assert abs(float(w[key]) - float(g[key])) <= TOL, key
            else:
                assert w[key] == g[key], key
    probs = np.array([[float(r[k]) for k in r if k.startswith("pred_")]
                      for r in got])
    np.testing.assert_allclose(probs.sum(1), 1.0, atol=1e-5)
    assert np.ptp(probs, axis=1).min() > 0.05


def _same_json(want, got, path=""):
    if isinstance(want, dict):
        assert set(want) == set(got), path
        for key in want:
            _same_json(want[key], got[key], f"{path}/{key}")
    elif isinstance(want, (int, float)) and not isinstance(want, bool):
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL,
                                   err_msg=path)
    else:
        assert want == got, path


def _jax_draws(i, v, b):
    k = jax.random.fold_in(jax.random.fold_in(jax.random.key(SEED), i), v)
    k_r, k_t = jax.random.split(k)
    return (torch.from_numpy(np.array(jax.random.uniform(
        k_r, (b, 3), minval=-ROT, maxval=ROT))),
        torch.from_numpy(np.array(jax.random.uniform(
            k_t, (b, 3), minval=-5.0, maxval=5.0))))


def _compare(root, jax_out, port_out, od=False):
    names = {f"prediction_{STEM}_id.csv", f"metrics_{STEM}.json",
             f"eval_{STEM}.log"} | ({f"prediction_{STEM}_od.csv"} if od
                                    else set())
    assert {p.name for p in jax_out.iterdir()} == names
    assert {p.name for p in port_out.iterdir()} == names
    for dom in ("id", "od") if od else ("id",):
        _same_csv(jax_out / f"prediction_{STEM}_{dom}.csv",
                  port_out / f"prediction_{STEM}_{dom}.csv")
    want = json.loads((jax_out / f"metrics_{STEM}.json").read_text())
    got = json.loads((port_out / f"metrics_{STEM}.json").read_text())
    _same_json(want, got)
    return got


def test_plain_matches_jax(setup):
    root, ckpt, last, csv_dir, _ = setup
    kw = dict(n_bootstrap=N_BOOT, seed=SEED)
    jev.evaluate_checkpoint(ckpt, csv_dir, root / "jc", root / "jax", **kw)
    res = tev.evaluate_checkpoint(ckpt, csv_dir, root / "tc", root / "port",
                                  device="cpu", **kw)
    got = _compare(root, root / "jax", root / "port")
    assert set(got) == {"checkpoint", "fold", "use_tta", "model_index",
                        "val", "test_id"}
    assert got["fold"] == 1 and got["use_tta"] is False
    assert set(res["seconds"]) == {"load", "preprocess", "predict",
                                   "bootstrap"}
    again = tev.evaluate_checkpoint(ckpt, csv_dir, root / "tc", root / "port",
                                    device="cpu", **kw)
    assert again == {"skipped": True,
                     "id_csv": str(root / "port" / f"prediction_{STEM}_id.csv")}
    # the 'last' checkpoint carries the same params in its train state
    res_last = tev.evaluate_checkpoint(last, csv_dir, root / "tc",
                                       root / "port_last", device="cpu",
                                       batch_size=8, **kw)
    _same_json({k: v for k, v in json.loads(
        (root / "port" / f"metrics_{STEM}.json").read_text()).items()
        if k in ("val", "test_id")},
        {k: res_last[k] for k in ("val", "test_id")})


def test_tta_with_od_matches_jax(setup):
    """Batch 8: JAX pads its batches to its 8 CPU devices (tests/
    conftest.py), so each cohort is one batch there, drawn at 8 rows; the
    port's batch is the cohort's size and takes the first rows of those
    draws."""
    root, ckpt, _, csv_dir, od_csv = setup
    kw = dict(n_bootstrap=N_BOOT, seed=SEED, use_tta=True, batch_size=8,
              eval_csv=str(od_csv))
    jev.evaluate_checkpoint(ckpt, csv_dir, root / "jtc", root / "jax_tta",
                            **kw)
    tev.evaluate_checkpoint(ckpt, csv_dir, root / "ttc", root / "port_tta",
                            device="cpu", tta_draws=lambda i, v: _jax_draws(
                                i, v, 8), **kw)
    got = _compare(root, root / "jax_tta", root / "port_tta", od=True)
    assert got["use_tta"] is True and "test_od" in got
    assert len(_read(root / "port_tta" / f"prediction_{STEM}_od.csv")) == 5


def test_cli_writes_the_same_files(setup, capsys):
    root, ckpt, _, csv_dir, _ = setup
    out = root / "cli"
    args = ["--checkpoints", str(ckpt), "--training-csv-dir", str(csv_dir),
            "--intermediate-dir", str(root / "clic"), "--output-dir",
            str(out), "--num-bootstrap", str(N_BOOT), "--batch-size", "2"]
    if not (root / "jax").exists():
        jev.evaluate_checkpoint(ckpt, csv_dir, root / "jc", root / "jax",
                                n_bootstrap=N_BOOT, seed=SEED)
    tev.main(args + ["--device", "cpu"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed[0]["model_index"] == 0 and printed[0]["fold"] == 1
    want = root / "jax_cli"   # the direct call's files, as the CLI numbers
    shutil.copytree(root / "jax", want, dirs_exist_ok=True)
    metrics = json.loads((want / f"metrics_{STEM}.json").read_text())
    (want / f"metrics_{STEM}.json").write_text(json.dumps(
        {**metrics, "model_index": 0}))
    _compare(root, want, out)


def test_preload_device_matches_jax_and_the_host(setup, tmp_path):
    """PRELOAD_DEVICE float16: the port's evaluate_checkpoint on its device
    stores (pre-transformed for plain eval) against JAX's on its stores,
    within TOL; with PRELOAD_PRETRANSFORM off (raw stores) the port's
    predictions equal its host arrays' bit for bit."""
    root, _, _, csv_dir, _ = setup
    src = jck.load_checkpoint(root / f"{STEM}.ckpt")[0]
    kw = dict(n_bootstrap=N_BOOT, seed=SEED)
    outs = {}
    for name, over in (("host", {}), ("f16", dict(PRELOAD_DEVICE="f16")),
                       ("raw", dict(PRELOAD_DEVICE="float16",
                                    PRELOAD_PRETRANSFORM=False))):
        cfg = dict(jax_load_config(extra_overrides=dict(TINY, **over)))
        path = tmp_path / name / f"{STEM}.ckpt"
        jck.save_checkpoint(path, src, {"config": cfg, "fold": 1})
        outs[name] = tmp_path / f"port_{name}"
        tev.evaluate_checkpoint(path, csv_dir, tmp_path / "c", outs[name],
                                device="cpu", **kw)
        if name == "f16":
            jev.evaluate_checkpoint(path, csv_dir, tmp_path / "jc",
                                    tmp_path / "jax_f16", **kw)
    _compare(root, tmp_path / "jax_f16", outs["f16"])
    assert _read(outs["raw"] / f"prediction_{STEM}_id.csv") == _read(
        outs["host"] / f"prediction_{STEM}_id.csv")
