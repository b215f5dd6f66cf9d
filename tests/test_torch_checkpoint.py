"""The port's checkpoint codec (vsn_tpu_torch/train/checkpoint.py) against
the JAX package's flax msgpack format (vsn_tpu/train/checkpoint.py):

* a file written by JAX's ``save_checkpoint`` loads in the port, and a file
  written by the port loads in JAX's ``load_checkpoint``, arrays bit-equal
  (dtype and shape included) and meta equal, for an eval payload
  (``{"variables": ...}``) and a 'last'-style ``{"state": ...}`` payload
  (NamedTuples, int and float leaves, None, nested dicts);
* the port's encoder writes flax's bytes for the same tree, its decoder
  reads every msgpack header form flax's packer writes (checked on
  msgpack's own packer output at each size boundary), numpy scalars (ext
  3), bfloat16 arrays (widened to f32 exactly) and flax's chunked form of
  an array above the chunk size; any other ext type raises.
"""

from typing import NamedTuple

import msgpack
import numpy as np
import jax
import jax.numpy as jnp
import pytest
from flax import serialization

from vsn_tpu.train import checkpoint as jck
from vsn_tpu_torch.train import checkpoint as tck


class _Adam(NamedTuple):
    mu: dict
    nu: dict
    count: object


class _State(NamedTuple):
    step: object
    params: dict
    opt: _Adam
    model_state: dict
    ema: object


def _tree(rng):
    params = {"backbone": {"layers_0": {
        "kernel": rng.standard_normal((4, 3)).astype(np.float32),
        "bias": np.arange(3, dtype=np.float32)}},
        "head": {"kernel": rng.standard_normal((3, 5)).astype(np.float32)}}
    return params


def _state(rng):
    params = _tree(rng)
    zeros = jax.tree.map(np.zeros_like, params)
    return _State(step=np.int32(7), params=params,
                  opt=_Adam(mu=zeros, nu=zeros, count=3),
                  model_state={"batch_stats": {"bn": {
                      "mean": np.ones(4, np.float32),
                      "var": np.full(4, 2.0, np.float64)}}},
                  ema=None)


def _assert_equal(a, b, path=""):
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), path
        for k in a:
            _assert_equal(a[k], b[k], f"{path}/{k}")
    elif a is None:
        assert b is None, path
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert a.tobytes() == b.tobytes(), path


PAYLOADS = {
    "variables": lambda rng: {"variables": {"params": _tree(rng)}},
    "last_state": lambda rng: {"state": _state(rng)},
    "state_and_variables": lambda rng: {"state": _state(rng),
                                        "variables": {"params": _tree(rng)}},
    # arrays above 1 MiB, as every card checkpoint holds, beside small ones
    "large_arrays": lambda rng: {"variables": {"params": {
        "qkv": rng.standard_normal((768, 512)).astype(np.float32),
        "fc": rng.standard_normal((1024, 1100)).astype(np.float16),
        "ids": rng.integers(0, 9, (1 << 21,), dtype=np.int8),
        **_tree(rng)}}, "step": np.int64(2500)},
}
META = {"config": {"ARCHITECTURE": "Swin", "IMG_SIZE": [12, 18, 12],
                   "SPLIT": [1, 1, 1], "SEED": None, "LR": 3e-4},
        "fold": 2, "step": 40, "metrics": {"val_bacc": 0.5}}


@pytest.mark.parametrize("kind", sorted(PAYLOADS))
def test_jax_file_loads_in_the_port_and_port_file_in_jax(kind, tmp_path):
    payload = PAYLOADS[kind](np.random.default_rng(0))
    jax_file, port_file = tmp_path / "jax.ckpt", tmp_path / "port.ckpt"
    jck.save_checkpoint(jax_file, payload, META)
    tck.save_checkpoint(port_file, payload, META)
    want, want_meta = jck.load_checkpoint(jax_file)
    got, got_meta = tck.load_checkpoint(jax_file)
    assert got_meta == want_meta == META
    _assert_equal(want, got)
    back, back_meta = jck.load_checkpoint(port_file)
    assert back_meta == META
    _assert_equal(want, back)
    assert jax_file.read_bytes() == port_file.read_bytes()


def test_last_state_reads_as_the_evaluator_reads_it(tmp_path):
    """A 'last' file's state is keyed by field name, as
    load_model_from_checkpoint reads it (params, model_state)."""
    path = tmp_path / "last.ckpt"
    jck.save_checkpoint(path, {"state": _state(np.random.default_rng(1))},
                        META)
    st = tck.load_checkpoint(path)[0]["state"]
    assert set(st) == set(_State._fields)
    assert st["ema"] is None and int(st["step"]) == 7
    assert st["opt"]["count"].dtype == np.asarray(3).dtype
    assert st["model_state"]["batch_stats"]["bn"]["var"].dtype == np.float64


@pytest.mark.parametrize("obj", [
    0, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**64 - 1,
    -1, -32, -33, -128, -129, -32768, -32769, -2**31, -2**31 - 1, -2**63,
    1.5, -0.0, True, False, None, "", "a" * 31, "b" * 32, "c" * 255,
    "d" * 256, "é" * 40000, b"", b"x" * 255, b"y" * 256, b"z" * 70000,
    list(range(15)), list(range(16)), list(range(70000)),
    {str(i): i for i in range(15)}, {str(i): i for i in range(16)},
    {str(i): [i, {"k": None}] for i in range(70000)},
])
def test_packb_and_unpackb_match_msgpack(obj):
    want = msgpack.packb(obj, use_bin_type=True, strict_types=True)
    assert tck.packb(obj) == want
    assert tck.unpackb(want) == msgpack.unpackb(want, raw=False)


@pytest.mark.parametrize("arr", [
    np.zeros((), np.float32), np.arange(6, dtype=np.int8).reshape(2, 3),
    np.arange(300, dtype=np.uint16), np.ones((2, 0, 3), np.float64),
    np.array([True, False]), np.arange(1 << 17, dtype=np.float32),
    np.array([1 + 2j], np.complex64),
], ids=lambda a: f"{a.dtype}{list(a.shape)}")
def test_arrays_and_scalars_as_flax_writes_them(arr):
    """An ndarray (ext 1) and a numpy scalar (ext 3) as flax's
    msgpack_serialize writes them (its keys sorted)."""
    tree = {"a": arr, "s": arr.reshape(-1)[:1].sum()
            if arr.size else np.float32(0)}
    blob = serialization.msgpack_serialize(dict(tree))
    assert tck.packb(tree) == blob
    got = tck.msgpack_restore(blob)
    want = serialization.msgpack_restore(blob)
    _assert_equal({"a": want["a"]}, {"a": got["a"]})
    assert type(got["s"]) is type(want["s"]) and got["s"] == want["s"]


def test_bfloat16_widens_to_f32_exactly():
    x = jnp.asarray(np.random.default_rng(2).standard_normal(37),
                    jnp.bfloat16)
    blob = serialization.msgpack_serialize({"w": np.asarray(x)})
    got = tck.msgpack_restore(blob)["w"]
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, np.asarray(x, np.float32))


def test_chunked_arrays_decode_and_encode_as_flax(monkeypatch):
    """flax's chunked form (above MAX_CHUNK_SIZE bytes), made at a chunk
    size of 64 bytes on both sides."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(tck, "MAX_CHUNK_SIZE", 64)
    tree = {"big": np.arange(50, dtype=np.float32).reshape(5, 10),
            "small": np.arange(4, dtype=np.float32),
            "nested": {"big": np.arange(133, dtype=np.int64)}}
    blob = serialization.msgpack_serialize(dict(tree))
    raw = msgpack.unpackb(blob, ext_hook=lambda c, d: None, raw=False)
    assert "__msgpack_chunked_array__" in raw["big"]
    assert len(raw["nested"]["big"]["chunks"]) == 17  # keys '0'..'16'
    got = tck.msgpack_restore(blob)
    _assert_equal(serialization.msgpack_restore(blob), got)
    assert tck.msgpack_serialize(tree) == blob


def test_not_a_checkpoint_and_unknown_types_raise(tmp_path):
    bad = tmp_path / "bad.ckpt"
    bad.write_bytes(b"NOPE" + b"\0" * 8)
    with pytest.raises(ValueError, match="not a vsn_tpu checkpoint"):
        tck.load_checkpoint(bad)
    with pytest.raises(ValueError, match="unsupported ext type 9"):
        tck.unpackb(msgpack.packb(msgpack.ExtType(9, b"ab")))
    with pytest.raises(ValueError, match="unsupported ext type 2"):
        tck.msgpack_restore(serialization.msgpack_serialize({"c": 1j}))
    with pytest.raises(TypeError):
        tck.packb({"x": object()})
