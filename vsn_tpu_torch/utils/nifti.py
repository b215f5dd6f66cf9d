"""Minimal pure-numpy NIfTI-1 IO: a copy of vsn_tpu/utils/nifti.py, which
the port may not import.

The environment has no nibabel; the framework only needs single-file NIfTI-1
(.nii / .nii.gz) volumes — load voxel data + affine, save float volumes —
which this module implements against the NIfTI-1 spec (348-byte header).
Covers what the reference uses nibabel for (dataset/preprocessing.py:218-225:
``nib.load(...).get_fdata()``; mask multiply; plus saving synthetic fixtures).

Supported on load: the common scalar dtypes, scl_slope/scl_inter scaling,
sform or pixdim-diagonal affines, gzip containers. Saving always writes
float32 (or the array's dtype if in the table) with an sform affine.
"""

from __future__ import annotations

import gzip
import struct

import numpy as np

_DTYPES = {
    2: np.uint8,
    4: np.int16,
    8: np.int32,
    16: np.float32,
    64: np.float64,
    256: np.int8,
    512: np.uint16,
    768: np.uint32,
    1024: np.int64,
    1280: np.uint64,
}
_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


class NiftiImage:
    """Tiny stand-in for nibabel's image object (get_fdata + affine)."""

    def __init__(self, data: np.ndarray, affine: np.ndarray):
        self._data = data
        self.affine = affine
        self.shape = data.shape

    def get_fdata(self, dtype=np.float32) -> np.ndarray:
        return self._data.astype(dtype)


def _open(path, mode="rb"):
    path = str(path)
    if path.endswith(".gz"):
        return gzip.open(path, mode)
    return open(path, mode)


def load(path) -> NiftiImage:
    with _open(path) as f:
        hdr = f.read(352)
        if len(hdr) < 348:
            raise ValueError(f"{path}: truncated NIfTI header")
        sizeof_hdr = struct.unpack_from("<i", hdr, 0)[0]
        if sizeof_hdr != 348:
            raise ValueError(f"{path}: not a NIfTI-1 file (sizeof_hdr={sizeof_hdr})")
        magic = hdr[344:348]
        if magic[:2] not in (b"n+", b"ni"):
            raise ValueError(f"{path}: bad NIfTI magic {magic!r}")

        dim = struct.unpack_from("<8h", hdr, 40)
        ndim = dim[0]
        shape = tuple(int(d) for d in dim[1 : 1 + ndim])
        datatype = struct.unpack_from("<h", hdr, 70)[0]
        if datatype not in _DTYPES:
            raise ValueError(f"{path}: unsupported NIfTI datatype {datatype}")
        dtype = np.dtype(_DTYPES[datatype]).newbyteorder("<")
        pixdim = struct.unpack_from("<8f", hdr, 76)
        vox_offset = int(struct.unpack_from("<f", hdr, 108)[0])
        scl_slope = struct.unpack_from("<f", hdr, 112)[0]
        scl_inter = struct.unpack_from("<f", hdr, 116)[0]
        sform_code = struct.unpack_from("<h", hdr, 254)[0]
        srow = np.array(
            [
                struct.unpack_from("<4f", hdr, 280),
                struct.unpack_from("<4f", hdr, 296),
                struct.unpack_from("<4f", hdr, 312),
            ],
            np.float64,
        )

        f.seek(vox_offset)
        count = int(np.prod(shape))
        raw = f.read(count * dtype.itemsize)
        data = np.frombuffer(raw, dtype=dtype, count=count).reshape(shape, order="F")

    if scl_slope not in (0.0, 1.0) or scl_inter != 0.0:
        slope = scl_slope if scl_slope != 0.0 else 1.0
        data = data.astype(np.float32) * slope + scl_inter

    if sform_code > 0:
        affine = np.vstack([srow, [0, 0, 0, 1]])
    else:
        affine = np.diag([pixdim[1] or 1.0, pixdim[2] or 1.0, pixdim[3] or 1.0, 1.0])
    return NiftiImage(np.asarray(data), affine)


def save(data: np.ndarray, path, affine: np.ndarray | None = None):
    data = np.asarray(data)
    if data.dtype not in _CODES:
        data = data.astype(np.float32)
    code = _CODES[np.dtype(data.dtype)]
    affine = np.eye(4) if affine is None else np.asarray(affine, np.float64)

    hdr = bytearray(352)
    struct.pack_into("<i", hdr, 0, 348)
    dim = [data.ndim] + list(data.shape) + [1] * (7 - data.ndim)
    struct.pack_into("<8h", hdr, 40, *dim)
    struct.pack_into("<h", hdr, 70, code)
    struct.pack_into("<h", hdr, 72, data.dtype.itemsize * 8)  # bitpix
    # pixdim from affine column norms
    pix = [0.0] + [float(np.linalg.norm(affine[:3, i])) or 1.0 for i in range(3)]
    pix += [1.0] * 4
    struct.pack_into("<8f", hdr, 76, *pix)
    struct.pack_into("<f", hdr, 108, 352.0)  # vox_offset
    struct.pack_into("<f", hdr, 112, 1.0)    # scl_slope
    struct.pack_into("<f", hdr, 116, 0.0)    # scl_inter
    struct.pack_into("<h", hdr, 252, 1)      # qform_code (unused but valid)
    struct.pack_into("<h", hdr, 254, 1)      # sform_code
    struct.pack_into("<4f", hdr, 280, *affine[0])
    struct.pack_into("<4f", hdr, 296, *affine[1])
    struct.pack_into("<4f", hdr, 312, *affine[2])
    hdr[344:348] = b"n+1\x00"

    with _open(path, "wb") as f:
        f.write(bytes(hdr))
        f.write(np.asfortranarray(data).tobytes(order="F"))
