"""Checkpoints in the JAX package's format (port of
vsn_tpu/train/checkpoint.py's ``save_checkpoint`` / ``load_checkpoint``).

A file is ``VSNC`` magic, an int64 (little-endian) meta length, the JSON
meta, then a flax msgpack blob of the payload's state dict
(``flax.serialization.msgpack_serialize(to_state_dict(...))``). The port
imports neither flax nor msgpack, so it carries its own codec of the subset
that flax writes:

* maps, arrays, str, bin, int, float, bool and nil (msgpack-python's
  packer with ``use_bin_type=True``: the smallest header that fits);
* ext 1, an ndarray: msgpack of (shape, dtype name, C-order raw bytes);
* ext 3, a numpy scalar: the same bytes of its 0-d array;
* arrays above 2^30 bytes as flax chunks them: a map with
  ``__msgpack_chunked_array__``, ``shape`` and ``chunks``, each keyed
  '0', '1', ....

A ``bfloat16`` array (ml_dtypes' dtype in JAX) decodes to float32, exactly.
The encoder writes what flax writes for the same tree, byte for byte:
dict keys as str in sorted order (JAX flattens dicts by sorted key),
lists, tuples and named tuples as maps keyed by
position or field, every number and tensor leaf as an ndarray. So a file
written by either package loads in the other. The async saver, best-N
rotation and ``filter_compatible`` come with the trainer.
"""

from __future__ import annotations

import json
import struct
from pathlib import Path

import numpy as np

_MAGIC = b"VSNC"
_CHUNKED = "__msgpack_chunked_array__"
MAX_CHUNK_SIZE = 2**30  # flax serialization.MAX_CHUNK_SIZE
EXT_NDARRAY, EXT_NPSCALAR = 1, 3


# --- decoder -----------------------------------------------------------------

class _Reader:
    def __init__(self, data, raw: bool = False):
        self.buf = memoryview(data)
        self.pos = 0
        self.raw = raw  # str as bytes (flax's ndarray ext reads raw=True)

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("msgpack: truncated data")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def string(self, n: int):
        b = bytes(self.take(n))
        return b if self.raw else b.decode("utf-8")

    def value(self):
        t = self.take(1)[0]
        if t <= 0x7F:
            return t
        if t >= 0xE0:
            return t - 0x100
        if 0x80 <= t <= 0x8F:
            return self.map(t & 0x0F)
        if 0x90 <= t <= 0x9F:
            return [self.value() for _ in range(t & 0x0F)]
        if 0xA0 <= t <= 0xBF:
            return self.string(t & 0x1F)
        fixed = {0xC0: None, 0xC2: False, 0xC3: True}
        if t in fixed:
            return fixed[t]
        sized = {0xC4: (">B", "bin"), 0xC5: (">H", "bin"), 0xC6: (">I", "bin"),
                 0xD9: (">B", "str"), 0xDA: (">H", "str"), 0xDB: (">I", "str"),
                 0xDC: (">H", "array"), 0xDD: (">I", "array"),
                 0xDE: (">H", "map"), 0xDF: (">I", "map"),
                 0xC7: (">B", "ext"), 0xC8: (">H", "ext"), 0xC9: (">I", "ext")}
        if t in sized:
            fmt, kind = sized[t]
            n = self.unpack(fmt)
            if kind == "bin":
                return bytes(self.take(n))
            if kind == "str":
                return self.string(n)
            if kind == "array":
                return [self.value() for _ in range(n)]
            if kind == "map":
                return self.map(n)
            return self.ext(n)
        if 0xD4 <= t <= 0xD8:
            return self.ext(1 << (t - 0xD4))
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
                   0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if t in numbers:
            return self.unpack(numbers[t])
        raise ValueError(f"msgpack: unsupported type byte 0x{t:02x}")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out

    def ext(self, n: int):
        code = self.unpack(">b")
        data = bytes(self.take(n))
        if code == EXT_NDARRAY:
            return _ndarray_from_bytes(data)
        if code == EXT_NPSCALAR:
            return _ndarray_from_bytes(data)[()]
        raise ValueError(f"msgpack: unsupported ext type {code}")


def unpackb(data, raw: bool = False):
    """One msgpack object from ``data`` (maps as dicts, arrays as lists,
    ext 1 / 3 as numpy arrays / scalars)."""
    r = _Reader(data, raw)
    out = r.value()
    if r.pos != len(r.buf):
        raise ValueError("msgpack: extra bytes after the object")
    return out


def _ndarray_from_bytes(data: bytes) -> np.ndarray:
    shape, name, buffer = unpackb(data, raw=True)
    name = name.decode() if isinstance(name, bytes) else name
    if name == "bfloat16":  # widen exactly: bf16 bits are f32's top half
        bits = np.frombuffer(buffer, "<u2").astype("<u4") << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buffer, dtype=np.dtype(name)).reshape(shape,
                                                                order="C")


def _unchunk(node):
    """flax's chunked-array maps back into arrays, anywhere in the tree."""
    if isinstance(node, dict):
        if _CHUNKED in node:
            shape = tuple(node["shape"][str(i)]
                          for i in range(len(node["shape"])))
            chunks = [node["chunks"][str(i)]
                      for i in range(len(node["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in node.items()}
    return node


def msgpack_restore(blob: bytes):
    """flax ``serialization.msgpack_restore``."""
    return _unchunk(unpackb(blob))


# --- encoder -----------------------------------------------------------------

def _header(out: bytearray, n: int, fix: int | None, fix_max: int,
            codes) -> None:
    if fix is not None and n <= fix_max:
        out.append(fix | n)
        return
    for code, fmt, limit in codes:
        if n <= limit:
            out += struct.pack(fmt, code, n)
            return
    raise ValueError(f"msgpack: length {n} too large")


_STR = ((0xD9, ">BB", 0xFF), (0xDA, ">BH", 0xFFFF), (0xDB, ">BI", 0xFFFFFFFF))
_BIN = ((0xC4, ">BB", 0xFF), (0xC5, ">BH", 0xFFFF), (0xC6, ">BI", 0xFFFFFFFF))
_ARRAY = ((0xDC, ">BH", 0xFFFF), (0xDD, ">BI", 0xFFFFFFFF))
_MAP = ((0xDE, ">BH", 0xFFFF), (0xDF, ">BI", 0xFFFFFFFF))
_INTS = ((0, 0x7F, ">B", None), (-0x20, -1, ">b", None),
         (0x80, 0xFF, ">BB", 0xCC), (-0x80, -1, ">Bb", 0xD0),
         (0x100, 0xFFFF, ">BH", 0xCD), (-0x8000, -0x81, ">Bh", 0xD1),
         (0x10000, 0xFFFFFFFF, ">BI", 0xCE),
         (-0x80000000, -0x8001, ">Bi", 0xD2),
         (0x100000000, 0xFFFFFFFFFFFFFFFF, ">BQ", 0xCF),
         (-0x8000000000000000, -0x80000001, ">Bq", 0xD3))


def _pack_int(out: bytearray, v: int) -> None:
    for lo, hi, fmt, code in _INTS:
        if lo <= v <= hi:
            out += (struct.pack(fmt, v) if code is None
                    else struct.pack(fmt, code, v))
            return
    raise OverflowError("Integer value out of range")


def _pack_ext(out: bytearray, code: int, data: bytes) -> None:
    n = len(data)
    fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixext:
        out.append(fixext[n])
    elif n <= 0xFF:
        out += struct.pack(">BB", 0xC7, n)
    elif n <= 0xFFFF:
        out += struct.pack(">BH", 0xC8, n)
    else:
        out += struct.pack(">BI", 0xC9, n)
    out += struct.pack(">b", code)
    out += data


def _ndarray_to_bytes(arr: np.ndarray) -> bytes:
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("Object and structured dtypes not supported "
                         "for serialization of ndarrays.")
    return packb([list(arr.shape), arr.dtype.name, arr.tobytes("C")])


def _pack(out: bytearray, obj) -> None:
    t = type(obj)
    if obj is None:
        out.append(0xC0)
    elif t is bool:
        out.append(0xC3 if obj else 0xC2)
    elif t is int:
        _pack_int(out, obj)
    elif t in (bytes, bytearray):
        _header(out, len(obj), None, -1, _BIN)
        out += obj
    elif t is str:
        b = obj.encode("utf-8")
        _header(out, len(b), 0xA0, 31, _STR)
        out += b
    elif t is float:
        out += struct.pack(">Bd", 0xCB, obj)
    elif t is list:
        _header(out, len(obj), 0x90, 15, _ARRAY)
        for v in obj:
            _pack(out, v)
    elif t is dict:
        _header(out, len(obj), 0x80, 15, _MAP)
        for k, v in obj.items():
            _pack(out, k)
            _pack(out, v)
    elif isinstance(obj, np.ndarray):
        _pack_ext(out, EXT_NDARRAY, _ndarray_to_bytes(obj))
    elif isinstance(obj, np.generic):
        _pack_ext(out, EXT_NPSCALAR, _ndarray_to_bytes(np.asarray(obj)))
    else:
        raise TypeError(f"can not serialize {t.__name__!r} object")


def packb(obj) -> bytes:
    """msgpack bytes of ``obj`` (dicts, lists, str, bytes, int, float, bool,
    None, numpy arrays and scalars), as msgpack-python's packer with flax's
    ext hook writes them."""
    out = bytearray()
    _pack(out, obj)
    return bytes(out)


def _chunk(arr: np.ndarray) -> dict:
    chunksize = max(1, int(MAX_CHUNK_SIZE / arr.dtype.itemsize))
    flat = arr.reshape(-1)
    chunks = [flat[i:i + chunksize] for i in range(0, flat.size, chunksize)]
    return {_CHUNKED: True,
            "shape": {str(i): d for i, d in enumerate(arr.shape)},
            "chunks": {str(i): c for i, c in enumerate(chunks)}}


def _sorted_map(items) -> dict:
    """A state-dict map in JAX's tree order: keys sorted as strings."""
    out = {}
    for k, v in items:
        if str(k) in out:
            raise ValueError("Dict keys do not have a unique string "
                             f"representation: {k!r}")
        out[str(k)] = to_state_dict(v)
    return dict(sorted(out.items()))


def to_state_dict(tree):
    """flax ``to_state_dict`` after the JAX saver's host copy and flax's
    tree copy: maps keyed by ``str(key)`` in sorted order (JAX flattens
    dicts by sorted key), lists and tuples keyed by position, named tuples
    by field, torch tensors and every other leaf as numpy arrays (None
    stays None); arrays above 2^30 bytes chunked as flax chunks them."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return _sorted_map(tree.items())
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return _sorted_map((k, getattr(tree, k)) for k in tree._fields)
    if isinstance(tree, (list, tuple)):
        return _sorted_map(enumerate(tree))
    if hasattr(tree, "detach") and hasattr(tree, "numpy"):  # a torch tensor
        tree = tree.detach().cpu().numpy()
    arr = np.asarray(tree)
    return _chunk(arr) if arr.size * arr.dtype.itemsize > MAX_CHUNK_SIZE \
        else arr


def msgpack_serialize(tree) -> bytes:
    """flax ``serialization.msgpack_serialize(to_state_dict(tree))``."""
    return packb(to_state_dict(tree))


# --- files -------------------------------------------------------------------

def save_checkpoint(path, payload: dict, meta: dict | None = None):
    """Serialize {tree payload} + {json meta} into one file, written to a
    temporary name and renamed into place."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    blob = msgpack_serialize(payload)
    meta_bytes = json.dumps(meta or {}).encode()
    tmp = path.with_suffix(path.suffix + ".tmp")
    with open(tmp, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<q", len(meta_bytes)))
        f.write(meta_bytes)
        f.write(blob)
    tmp.replace(path)  # atomic publish
    return path


def load_checkpoint(path) -> tuple[dict, dict]:
    """Returns (payload tree of dicts with numpy leaves, meta dict)."""
    with open(path, "rb") as f:
        magic = f.read(4)
        if magic != _MAGIC:
            raise ValueError(f"{path}: not a vsn_tpu checkpoint")
        (mlen,) = struct.unpack("<q", f.read(8))
        meta = json.loads(f.read(mlen).decode())
        payload = msgpack_restore(f.read())
    return payload, meta
