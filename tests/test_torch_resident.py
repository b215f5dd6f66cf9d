"""The device-resident volume store (PRELOAD_DEVICE,
vsn_tpu_torch/data/resident.py) against the JAX package's
(vsn_tpu/data/resident.py) on the CPU: the float16 / bfloat16 stores and
their gathers bit for bit, the int8 codes, scales and offsets, the
pre-transformed stores (the eval transform on the device at build time),
the pre-transform gate, a train step on a batch of row indices against the
host batch's, and the Evaluator on a store against the host arrays."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from vsn_tpu.config import load_config as jax_load_config
from vsn_tpu.data import resident as jres
from vsn_tpu.data.augment import build_eval_transform as jax_eval_transform
from vsn_tpu_torch.config import load_config
from vsn_tpu_torch.data import resident as tres
from vsn_tpu_torch.data.augment import build_eval_transform
from vsn_tpu_torch.eval.evaluate import Evaluator
from vsn_tpu_torch.models import build_model
from vsn_tpu_torch.train.schedules import lr_wd_schedules
from vsn_tpu_torch.train.step import (
    init_train_state,
    make_batch_transform,
    make_train_step,
)

IDX = [3, 0, 5, 5, 1]
SWIN = dict(IMG_SIZE=[12, 18, 12], PATCH_SHAPE=[2, 2, 2],
            WINDOW_SIZE=[2, 3, 2], EMBED_DIM=8, DEPTH=[2, 2, 2],
            HEADS=[1, 2, 4], FP16=False, STOCHASTIC_DEPTH_PROB=0.0,
            USE_SAM=True, USE_EMA=True, USE_MIXUP=True, BATCH_SIZE=2,
            EFFECTIVE_BATCH_SIZE=4, LR_WARMUP=0, WD_WARMUP=0, SEED=0)


def _volumes(n=6, shape=(12, 18, 12)):
    rng = np.random.default_rng(0)
    return (rng.standard_normal((n, *shape, 1)) * 40 + 100).astype(
        np.float16)


def _bits(a):
    """The raw bits of an f16 / bf16 array or tensor."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy()
    return np.asarray(a).view(np.int16)


@pytest.mark.parametrize("mode", ["float16", "bfloat16"])
def test_float_stores_and_gathers_are_bit_exact(mode):
    x = _volumes()
    jstore = jres.build_resident(x, mode)
    tstore = tres.build_resident(x, mode, "cpu")
    np.testing.assert_array_equal(_bits(tstore.data), _bits(jstore.data))
    got = tres.gather_volumes(tstore, torch.tensor(IDX, dtype=torch.int32))
    want = jres.gather_volumes(jstore, jnp.asarray(IDX, jnp.int32))
    assert got.dtype == getattr(torch, mode)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert tstore.nbytes == jstore.nbytes and len(tstore) == 6
    if mode == "float16":  # faithful to the host cache
        np.testing.assert_array_equal(got.numpy(), x[IDX])


def test_int8_codes_match_jax():
    x = _volumes()
    for got, want in zip(tres.quantize_volumes_int8(x),
                         jres.quantize_volumes_int8(x)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    jstore = jres.build_resident(x, "int8")
    tstore = tres.build_resident(x, "int8", "cpu")
    for name in ("data", "scale", "offset"):
        np.testing.assert_array_equal(getattr(tstore, name).numpy(),
                                      np.asarray(getattr(jstore, name)))
    got = tres.gather_volumes(tstore, torch.tensor(IDX)).numpy()
    want = np.asarray(jres.gather_volumes(jstore, jnp.asarray(IDX)))
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-4)


@pytest.mark.parametrize("mode", ["float16", "bfloat16", "int8"])
def test_pretransformed_stores_match_jax(mode):
    """Resized (12x18x12 -> 8x10x8) and z-scored at build time in chunks
    of 4 (the last ragged): within one unit of the store's rounding."""
    over = dict(RESHAPE_SIZE=[8, 10, 8])
    x = _volumes()
    tstore = tres.build_resident(x, mode, "cpu", build_eval_transform(
        load_config(over)), chunk=4)
    jstore = jres.build_resident(x, mode, pretransform=jax_eval_transform(
        jax_load_config(extra_overrides=over)), chunk=4)
    assert tuple(tstore.data.shape) == (6, 8, 10, 8, 1)
    got = tres.gather_volumes(tstore, torch.arange(6)).float().numpy()
    want = np.asarray(jres.gather_volumes(jstore, jnp.arange(6)),
                      np.float32)
    unit = {"float16": 2 ** -10, "bfloat16": 2 ** -7}.get(mode)
    if unit is None:   # int8: codes within one step of the volume's range
        np.testing.assert_allclose(tstore.scale.numpy(),
                                   np.asarray(jstore.scale), rtol=1e-5)
        unit = float(np.asarray(jstore.scale).max())
        np.testing.assert_allclose(got, want, atol=1.01 * unit)
    else:
        np.testing.assert_allclose(got, want, rtol=unit,
                                   atol=unit * np.abs(want).max())


@pytest.mark.parametrize("over", [
    {}, dict(USE_MIXUP=True), dict(USE_CUTMIX=True),
    dict(USE_EXTENDED_DATA_AUGMENTATION=True), dict(IS_DUNG_TRANSFORMS=True),
    dict(PRELOAD_PRETRANSFORM=False)])
def test_pretransform_gate_matches_jax(over):
    cfg, jcfg = load_config(over), jax_load_config(extra_overrides=over)
    for train in (True, False):
        assert (tres.resident_pretransform(cfg, train) is None) == \
            (jres.resident_pretransform(jcfg, train) is None)


def _batch():
    rng = np.random.default_rng(1)
    vols = _volumes(8)
    eye = np.eye(5, dtype=np.float32)
    idx = np.array([[0, 3], [5, 6]], np.int32)
    partner = np.array([[7, 1], [2, 4]], np.int32)
    common = {"label": eye[rng.integers(0, 5, (2, 2))],
              "label2": eye[rng.integers(0, 5, (2, 2))],
              "mix_lam": rng.beta(0.3, 0.3, (2, 2)).astype(np.float32),
              "mix_apply": np.array([[True, False], [True, True]]),
              "mix_bounds": np.zeros((2, 2, 6), np.int32)}
    host = dict(common, image=vols[idx], image2=vols[partner])
    index = dict(common, image_idx=idx, partner_idx=partner)
    tt = lambda b: {k: torch.from_numpy(v) for k, v in b.items()}
    return vols, tt(host), tt(index)


@pytest.mark.parametrize("mode", ["float16", "bfloat16"])
def test_resident_train_step_equals_host(mode):
    """Two SAM + EMA + MixUp steps of a tiny Swin: the index batch on a
    float16 store gives the host batch's loss, gradient norm and state bit
    for bit; on a bfloat16 store, the host batch rounded to bfloat16's."""
    vols, host, index = _batch()
    cfg = load_config(SWIN)
    weights = build_model(cfg, device="cpu").state_dict()
    if mode == "bfloat16":
        for k in ("image", "image2"):
            host[k] = host[k].to(torch.bfloat16)
    out = []
    for batch, store in ((host, None),
                         (index, tres.build_resident(vols, mode, "cpu"))):
        model = build_model(cfg, device="cpu")
        model.load_state_dict(weights)
        state = init_train_state(cfg, model)
        step = make_train_step(model, cfg, *lr_wd_schedules(cfg),
                               make_batch_transform(cfg))
        metrics = [step(state, batch, store) for _ in range(2)]
        out.append(([(float(m["loss"]), float(m["grad_norm"]))
                     for m in metrics], state.params.flat, state.ema.ema))
    assert out[0][0] == out[1][0]
    assert torch.equal(out[0][1], out[1][1])
    assert torch.equal(out[0][2], out[1][2])


def test_evaluator_on_a_store_equals_the_host_arrays():
    """Batches of 4 over 6 volumes (the last padded): a raw float16 store
    gives the host arrays' probabilities bit for bit; a pre-transformed
    one (resize + z-score rounded to float16) within 1e-3."""
    cfg = load_config(dict(SWIN, RESHAPE_SIZE=[12, 18, 12]))
    model = build_model(cfg, device="cpu")
    x = _volumes()
    host = Evaluator(cfg, model, batch_size=4).predict(x)
    raw = Evaluator(cfg, model, batch_size=4).predict(
        tres.build_resident(x, "float16", "cpu"))
    np.testing.assert_array_equal(raw, host)
    pre = tres.resident_pretransform(cfg, train=False)
    baked = Evaluator(cfg, model, batch_size=4,
                      resident_pretransformed=True).predict(
        tres.build_resident(x, "float16", "cpu", pre))
    np.testing.assert_allclose(baked, host, atol=1e-3)
    with pytest.raises(ValueError, match="raw resident store"):
        Evaluator(cfg, model, use_tta=True, resident_pretransformed=True)
