"""The port's eval data modules against the JAX package's (pandas there, the
``csv`` module here), on a tiny synthetic cohort:

* ``data/synthetic.py`` writes the same NIfTI bytes (gzip's time stamp
  aside) and the same fold CSVs;
* ``utils/nifti.py`` (a copy) loads and saves as the original;
* ``data/folds.py``: get_train_val_test's splits for every fold (``all``
  sorted by Subject) and its invariants, load_metadata with a Dataset
  filter;
* ``data/preprocessing.py``: center_crop, DataPrepa's cache (crop, with and
  without a downsample: the port resizes by ``resize_batch``, JAX by
  ``jax.image.resize``; f16 within 1 ulp of f16 at the volume's scale), its
  incremental diff and stray GC;
* ``data/pipeline.py``: InMemoryDataset's one-hot labels and cache,
  EvalPipeline's batches padded with the first volume and their masks.
"""

import gzip

import numpy as np
import pandas as pd
import pytest

from vsn_tpu.data import folds as jf
from vsn_tpu.data import pipeline as jp
from vsn_tpu.data import preprocessing as jpre
from vsn_tpu.data.synthetic import generate_synthetic_dataset as jgen
from vsn_tpu.utils import nifti as jn
from vsn_tpu_torch.data import folds as tf
from vsn_tpu_torch.data import pipeline as tp
from vsn_tpu_torch.data import preprocessing as tpre
from vsn_tpu_torch.data.synthetic import generate_synthetic_dataset as tgen
from vsn_tpu_torch.utils import nifti as tn

SHAPE = (14, 20, 12)
CROP = (12, 16, 12)


@pytest.fixture(scope="module")
def cohorts(tmp_path_factory):
    root = tmp_path_factory.mktemp("cohorts")
    kw = dict(n_subjects=10, shape=SHAPE, kfold=5, seed=3,
              diseases=("CN", "AD", "FTD"))
    return jgen(root / "jax", **kw), tgen(root / "port", **kw)


def _rows(df):
    return [{k: str(v) for k, v in r.items()} for r in df.to_dict("records")]


def test_synthetic_cohort_is_the_jax_cohort(cohorts):
    (jraw, jcsv), (traw, tcsv) = cohorts
    names = sorted(p.name for p in jraw.iterdir())
    assert names == sorted(p.name for p in traw.iterdir()) and len(names) == 20
    for name in names:  # the gzip headers differ by their time stamps
        assert gzip.decompress((jraw / name).read_bytes()) == gzip.decompress(
            (traw / name).read_bytes()), name
    for k in range(5):
        want = pd.read_csv(jcsv / f"fold_{k}.csv")
        got = tf.read_csv(tcsv / f"fold_{k}.csv")
        for row in got:  # the paths differ by the root only
            row["T1_path"] = row["T1_path"].replace("/port/", "/jax/")
            row["Mask_path"] = row["Mask_path"].replace("/port/", "/jax/")
        assert got == _rows(want)


def test_nifti_copy_loads_and_saves_as_the_original(cohorts, tmp_path):
    (jraw, _), _ = cohorts
    path = jraw / "synth-0003_T1.nii.gz"
    a, b = jn.load(path), tn.load(path)
    np.testing.assert_array_equal(a.get_fdata(), b.get_fdata())
    np.testing.assert_array_equal(a.affine, b.affine)
    vol = np.arange(24, dtype=np.int16).reshape(2, 3, 4)
    jn.save(vol, tmp_path / "j.nii")
    tn.save(vol, tmp_path / "t.nii")
    assert (tmp_path / "j.nii").read_bytes() == (tmp_path / "t.nii").read_bytes()


@pytest.mark.parametrize("fold", range(5))
def test_folds_match(cohorts, fold):
    (_, jcsv), _ = cohorts
    want = jf.get_train_val_test(str(jcsv), fold, 5, (3, 1, 1))
    got = tf.get_train_val_test(str(jcsv), fold, 5, (3, 1, 1))
    for w, g in zip(want, got):
        assert g == _rows(w)
    subjects = [r["Subject"] for r in got[3]]
    assert subjects == sorted(subjects) and len(subjects) == 10


def test_fold_invariants_and_load_metadata(cohorts):
    (_, jcsv), _ = cohorts
    for bad in [dict(kfold=5, split=(3, 1)), dict(kfold=2, split=(1, 1, 0)),
                dict(kfold=5, split=(2, 1, 1)), dict(kfold=5, split=(3, 1, 1),
                                                     fold=5)]:
        kw = {"fold": 0, **bad}
        with pytest.raises(ValueError):
            tf.get_train_val_test(str(jcsv), **kw)
        with pytest.raises(ValueError):
            jf.get_train_val_test(str(jcsv), **kw)
    with pytest.raises(FileNotFoundError):
        tf.get_train_val_test(str(jcsv), 0, 6, (4, 1, 1))
    paths = [str(jcsv / "fold_0.csv"), str(jcsv / "fold_1.csv")]
    assert tf.load_metadata(paths) == _rows(jf.load_metadata(paths))
    assert tf.load_metadata(paths[0], ["SYNTH"]) == _rows(
        jf.load_metadata(paths[0], ["SYNTH"]))
    assert tf.load_metadata(paths, ["OTHER"]) == []


def test_center_crop_matches():
    vol = np.arange(9 * 10 * 5, dtype=np.float32).reshape(9, 10, 5)
    for crop in [(4, 4, 4), (9, 12, 2), (1, 1, 1)]:
        np.testing.assert_array_equal(tpre.center_crop(vol, crop),
                                      jpre.center_crop(vol, crop))


@pytest.mark.parametrize("downsample", [None, (8, 10, 6)])
def test_dataprepa_cache_matches(cohorts, downsample, tmp_path):
    (_, jcsv), _ = cohorts
    meta = jf.load_metadata([str(jcsv / f"fold_{k}.csv") for k in range(5)])
    assert jpre.DataPrepa(meta, tmp_path / "j").preprocess_data(
        CROP, downsample, n_jobs=2) == 10
    assert tpre.DataPrepa(_rows(meta), tmp_path / "t").preprocess_data(
        CROP, downsample, n_jobs=2) == 10
    for subject in meta.Subject:
        want = np.load(tmp_path / "j" / f"{subject}.npy")
        got = np.load(tmp_path / "t" / f"{subject}.npy")
        assert got.dtype == want.dtype == np.float16
        assert got.shape == want.shape == (*(downsample or CROP), 1)
        if downsample is None:
            np.testing.assert_array_equal(got, want)
        else:  # f32 resizes, both rounded to f16: at most one f16 ulp apart
            ulp = np.spacing(np.abs(want).astype(np.float16)).astype(np.float32)
            assert (np.abs(got.astype(np.float32) - want.astype(np.float32))
                    <= ulp).all()


def test_dataprepa_diff_and_gc(cohorts, tmp_path):
    (_, jcsv), _ = cohorts
    rows = tf.read_csv(jcsv / "fold_0.csv") + tf.read_csv(jcsv / "fold_1.csv")
    cache = tmp_path / "cache"
    cache.mkdir()
    np.save(cache / "stray.npy", np.zeros(1))
    prep = tpre.DataPrepa(rows, cache)
    assert prep.preprocess_data(CROP, n_jobs=1) == 4
    assert not (cache / "stray.npy").exists()
    assert prep.preprocess_data(CROP) == 0  # incremental: nothing left
    assert tpre.DataPrepa(str(jcsv / "fold_0.csv"), cache).preprocess_data(
        CROP) == 0
    assert len(list(cache.glob("*.npy"))) == 2  # fold 1's strays collected


def test_dataset_and_eval_pipeline_match(cohorts, tmp_path):
    (_, jcsv), _ = cohorts
    meta = pd.concat([pd.read_csv(jcsv / f"fold_{k}.csv") for k in range(5)],
                     ignore_index=True)
    meta.loc[3, "Diagnosis"] = "OTHER"   # an all-zero label
    jpre.DataPrepa(meta, tmp_path).preprocess_data(CROP)
    diseases = ["CN", "AD", "FTD"]
    jds = jp.InMemoryDataset(tmp_path, meta, diseases)
    tds = tp.InMemoryDataset(tmp_path, _rows(meta), diseases)
    np.testing.assert_array_equal(tds.labels, jds.labels)
    assert tds.labels[3].sum() == 0 and tds.subjects == jds.subjects
    np.testing.assert_array_equal(tds.images, jds.images)
    assert len(tds) == len(jds) == 10
    for bs in (4, 3, 10):
        want = list(jp.EvalPipeline(jds, bs).iter_with_indices())
        got = list(tp.EvalPipeline(tds.images, bs))
        assert len(got) == len(want) == -(-10 // bs)
        for (w_images, _, w_valid, _), (images, valid) in zip(want, got):
            np.testing.assert_array_equal(images, w_images)
            np.testing.assert_array_equal(valid, w_valid)
        images, valid = got[-1]
        # padded with the first volume
        np.testing.assert_array_equal(images[valid.sum():],
                                      np.broadcast_to(tds.images[0],
                                                      images[valid.sum():].shape))
