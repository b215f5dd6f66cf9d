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
written by either package loads in the other.

The trainer's parts (vsn_tpu/train/checkpoint.py:71-202): the background
saver with a bounded queue (``AsyncCheckpointSaver``), the best-N rotation
by renames (``BestNTracker``) and the shape-filtered partial load
(``filter_compatible``), on trees of dicts with numpy leaves (the JAX
state's form, ``convert.jax_train_state``).
"""

from __future__ import annotations

import json
import queue
import struct
import threading
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


_FIXEXT = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}


def _pack_ndarray(out: "_Chunks", code: int, arr: np.ndarray) -> None:
    """flax's ext ``code`` of an array (EXT_NDARRAY) or a numpy scalar
    (EXT_NPSCALAR): the ext header, then the msgpack of [shape, dtype name,
    data], the data entering ``out`` as a view of the array's buffer."""
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("Object and structured dtypes not supported "
                         "for serialization of ndarrays.")
    data = np.ascontiguousarray(arr).reshape(-1).view(np.uint8)
    head = bytearray()
    _header(head, 3, 0x90, 15, _ARRAY)
    _pack(head, list(arr.shape))
    _pack(head, arr.dtype.name)
    _header(head, data.nbytes, None, -1, _BIN)
    n = len(head) + data.nbytes
    if n in _FIXEXT:
        out.append(_FIXEXT[n])
    elif n <= 0xFF:
        out += struct.pack(">BB", 0xC7, n)
    elif n <= 0xFFFF:
        out += struct.pack(">BH", 0xC8, n)
    else:
        out += struct.pack(">BI", 0xC9, n)
    out += struct.pack(">b", code)
    out += head
    out.raw(data)


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
        _pack_ndarray(out, EXT_NDARRAY, obj)
    elif isinstance(obj, np.generic):
        _pack_ndarray(out, EXT_NPSCALAR, np.asarray(obj))
    else:
        raise TypeError(f"can not serialize {t.__name__!r} object")


class _Chunks(bytearray):
    """An encoder's output in pieces: the small parts accumulate in the
    bytearray, and each array's data enters as a view of its own buffer
    (``raw``), so a checkpoint's arrays reach the file without being
    copied into one byte string."""

    def __init__(self):
        super().__init__()
        self.chunks: list = []

    def raw(self, view) -> None:
        self.chunks.append(bytes(self))
        self.clear()
        self.chunks.append(view)

    def pieces(self) -> list:
        return [*self.chunks, bytes(self)]


def packb(obj) -> bytes:
    """msgpack bytes of ``obj`` (dicts, lists, str, bytes, int, float, bool,
    None, numpy arrays and scalars), as msgpack-python's packer with flax's
    ext hook writes them."""
    out = _Chunks()
    _pack(out, obj)
    return b"".join(out.pieces())


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
    blob = _Chunks()
    _pack(blob, to_state_dict(payload))
    meta_bytes = json.dumps(meta or {}).encode()
    tmp = path.with_suffix(path.suffix + ".tmp")
    with open(tmp, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<q", len(meta_bytes)))
        f.write(meta_bytes)
        for piece in blob.pieces():
            f.write(piece)
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


# --- the trainer's parts -----------------------------------------------------

def _to_host(tree):
    """A copy of ``tree`` with every torch tensor leaf copied to a numpy
    array on the host (leaves the caller may change in place afterwards)."""
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return type(tree)(_to_host(v) for v in tree)
    if hasattr(tree, "detach") and hasattr(tree, "numpy"):
        return tree.detach().to("cpu", copy=True).numpy()
    return tree


def _leaves(tree, path=()):
    """(path, leaf) of a tree of dicts in sorted key order (JAX's order);
    None is an empty subtree."""
    if isinstance(tree, dict):
        for k in sorted(tree, key=str):
            yield from _leaves(tree[k], path + (k,))
    elif tree is not None:
        yield path, tree


def keystr(path) -> str:
    """``jax.tree_util.keystr`` of a path of dict keys: ``['a']['b']``."""
    return "".join(f"[{k!r}]" for k in path)


def _rebuild(tree, leaves: dict, path=()):
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaves, path + (k,)) for k, v in tree.items()}
    return None if tree is None else leaves[path]


def filter_compatible(restored, target):
    """Keep restored leaves whose path and shape match the target tree (cast
    to the target leaf's dtype); every other target leaf keeps the target's
    value (the shape-filtered partial load, reference
    train_transformer.py:379-414). Returns (merged tree of the target's
    structure, kept count, dropped paths as ``keystr``)."""
    flat_r = dict(_leaves(restored))
    out, kept, dropped = {}, 0, []
    for path, tval in _leaves(target):
        tval = np.asarray(tval)
        rval = flat_r.get(path)
        if rval is not None and np.shape(rval) == tval.shape:
            out[path] = np.asarray(rval, dtype=tval.dtype)
            kept += 1
        else:
            out[path] = tval
            dropped.append(keystr(path))
    return _rebuild(target, out), kept, dropped


class AsyncCheckpointSaver:
    """Background checkpoint writer with a bounded queue and drain-on-close
    (reference train_transformer.py:197-276)."""

    def __init__(self, max_queue: int = 3):
        self._q: queue.Queue = queue.Queue(maxsize=max_queue)
        self._errors: list[BaseException] = []
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        while True:
            item = self._q.get()
            try:
                if item is None:
                    return
                item()
            except BaseException as e:  # surfaced on close()
                self._errors.append(e)
            finally:
                self._q.task_done()

    def submit(self, path, payload: dict, meta: dict | None = None):
        """The copy to the host happens here, before this returns (the
        train step updates the state's buffers in place afterwards), then
        the write is queued."""
        path = Path(path)
        payload = _to_host(payload)
        self._q.put(lambda: save_checkpoint(path, payload, meta))

    def submit_task(self, fn):
        """Queue a filesystem task, ordered with pending writes (best-N
        renames must not overtake queued saves)."""
        self._q.put(fn)

    def close(self):
        self._q.join()
        self._q.put(None)
        self._thread.join()
        if self._errors:
            raise self._errors[0]


class BestNTracker:
    """Best-N checkpoint rotation by metric: files
    ``model_{runid}_{fold}_best{i}.ckpt`` with best0 the best, kept sorted
    by renames as reference save_best_n_models (823-934)."""

    def __init__(self, save_dir, run_id: str, fold: int, n: int,
                 metric_name: str = "loss"):
        self.dir = Path(save_dir)
        self.run_id = run_id
        self.fold = fold
        self.n = max(1, int(n))
        self.metric_name = metric_name
        self.lower_better = metric_name == "loss"
        self.entries: list[tuple[float, int]] = []  # (metric, step), best first

    def _path(self, i: int) -> Path:
        return self.dir / f"model_{self.run_id}_{self.fold}_best{i}.ckpt"

    def consider(self, metric: float, step: int):
        """The insertion index if this metric makes the top N, else None."""
        key = metric if self.lower_better else -metric
        keys = [m if self.lower_better else -m for m, _ in self.entries]
        idx = int(np.searchsorted(keys, key))
        return None if idx >= self.n else idx

    def insert(self, idx: int, metric: float, step: int, saver, payload,
               meta):
        """Shift best{idx..} up by one (dropping the worst) and write
        best{idx}; the unlink and renames are queued on the saver so they
        stay ordered with in-flight writes to the same names."""
        n_entries = len(self.entries)
        if n_entries >= self.n:
            self.entries = self.entries[: self.n - 1]
            n_entries = self.n - 1

        def rotate(n_entries=n_entries, idx=idx):
            worst = self._path(self.n - 1)
            if worst.exists():
                worst.unlink()
            for i in range(n_entries - 1, idx - 1, -1):
                src = self._path(i)
                if src.exists():
                    src.rename(self._path(i + 1))

        saver.submit_task(rotate)
        self.entries.insert(idx, (metric, step))
        saver.submit(self._path(idx), payload, meta)

    @property
    def best(self):
        return self.entries[0] if self.entries else None
