"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` for ``sm_90a``,
all started together, and the objects are linked into one shared library
with a plain C interface, which ``ctypes`` loads. Nothing here includes
PyTorch's headers, so the build takes seconds, not minutes.
The library goes under ``build/`` at the repository root, named by a hash
of the sources and flags, and is built at first use: the first CUDA call
of any kernel wrapper (or ``library()`` itself) builds it from the
checkout.

``launches`` counts, per kernel wrapper, the calls that launched the CUDA
kernel. A wrapper adds one per call, however many launches the call makes;
the CPU path, which runs the plain PyTorch version, adds nothing. K1 and
K1b count their two attention bodies apart: ``attn_half_tiled`` /
``attn_half_bwd_tiled`` for the key-tiled one, which every preset's calls
take, ``attn_half`` / ``attn_half_bwd`` for the whole-window one (head
dims that the tiled body does not take); K1 and K2 also count their
residual modes apart (``swin_block_kernels.mode_key``: ``..._post``,
``..._ls``, ``..._post_ls``). The key-tiled attention launches called
alone (``swin_block_kernels.attention_tiled_launch`` and its backward,
for the card's launch-level checks) count as ``attention_tiled_launch`` /
``attention_tiled_bwd_launch``; the GEMM and weight-gradient launches of
K1 / K2 called alone (``swin_block_kernels.gemm_launch`` /
``wgrad_launch``) as ``gemm`` / ``wgrad``, and their FMA bodies on bf16
operands, chip_smoke.py's yardstick, as ``gemm_fma`` / ``wgrad_fma``; the
stem's FMA bodies on bf16 (``stem_im2col(..., _fma=True)``) likewise as
``stem_im2col_fma`` / ``stem_im2col_dw_fma``; the row kernels of K1 / K2
called alone (``swin_block_kernels.ln_bwd_launch`` /
``postnorm_bwd_launch``, and the others of ``ROW_KERNELS``) as ``ln_bwd``
/ ``postnorm_bwd``, ``ln_rows`` / ``colsum`` (LN's rows, the column sums)
and ``row_<kernel>`` for the rest (e.g. ``row_postnorm_fwd``). The
attention probes (``ops/attn_probe.py``) count per run instead, under the
run's key, and add the number of CUDA launches the call made (3 for a
whole half-block, 2 without the attention or without the GEMMs, 1 for a
copy), so that a run shows which pieces it launched.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")
LINK_FLAGS = ("-shared",)

launches: collections.Counter = collections.Counter()

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGNATURES = {
    "vsn_attn_half_fwd": [_I, _I, *[_P] * 7, _I, *[_P] * 4, _I, *[_P] * 6,
                          _L, _I, _I, _I, _L, _F, _F, _P],
    "vsn_attention_tiled_fwd": [_I, _P, _P, _P, _I, _P, _P, _P, _L, _I, _I,
                                _I, _F, _P],
    "vsn_attention_tiled_bwd": [_I, *[_P] * 6, _I, *[_P] * 4, _L, _I, _I, _I,
                                _F, _P],
    "vsn_ln_mlp_fwd": [_I, *[_P] * 9, _I, _P, _P, _P, _L, _I, _I, _L, _F,
                       _P],
    "vsn_window_relayout": [_P, _P, _P, _L, _I, _L, _I, _I, _P],
    "vsn_attn_half_bwd": [_I, _I, *[_P] * 8, _I, *[_P] * 3, _I, *[_P] * 22,
                          _L, _L, _I, _I, _I, _L, _F, _F, _P],
    "vsn_ln_mlp_bwd": [_I, *[_P] * 8, _I, *[_P] * 16, _L, _L, _I, _I, _L,
                       _F, _P],
    "vsn_stem_conv_fwd": [_I, _I, _P, _P, _P, *[_I] * 17, _P],
    "vsn_stem_conv_dw": [_I, _I, _P, _P, _P, _P, _I, _I, *[_I] * 17, _P],
    "vsn_window_attention_qkv_tiled_fwd": [_I, _P, _P, _P, _I, _P, _P, _P, _L,
                                           _I, _I, _I, _F, _P],
    "vsn_window_attention_qkv_tiled_bwd": [_I, *[_P] * 6, _I, *[_P] * 3, _L,
                                           _I, _I, _I, _F, _P],
    "vsn_window_attention_fwd": [_I, *[_P] * 5, _I, _P, _P, _P, _L, _I, _I,
                                 _I, _F, _P],
    "vsn_window_attention_bwd": [_I, *[_P] * 8, _I, *[_P] * 5, _L, _I, _I,
                                 _I, _F, _P],
    "vsn_window_attention_windows_fwd": [_I, _P, _P, _P, _I, _P, _P, _P,
                                         *[_I] * 9, _F, _P],
    "vsn_window_attention_windows_bwd": [_I, *[_P] * 6, _I, _P, _P, _P,
                                         *[_I] * 9, _F, _P],
    "vsn_probe_attn_half": [_I, _I, _I, *[_P] * 9, _L, _I, _I, _I, _F, _P],
    "vsn_probe_copy": [_P, _P, _L, _I, _I, _I, _P, _P, _P, _P],
    "vsn_gemm": [*[_I] * 7, _P, _L, _P, _L, *[_P] * 6, _F, _P, _P, _P, _L,
                 _I, _I, _P],
    "vsn_wgrad": [_I, _I, _I, _P, _P, _L, _P, _P, _L, _I, _I, _P],
    "vsn_ln_bwd_blocks": [_L, _I],
    "vsn_colsum_blocks": [_L, _I],
    "vsn_ln_bwd": [_I, *[_P] * 5, _F, *[_P] * 4, _L, _L, _I, _P],
    "vsn_postnorm_bwd": [_I, _P, _P, _P, _L, *[_P] * 7, _L, _L, _I, _P],
    "vsn_ln_rows": [_I, _I, *[_P] * 5, _L, _I, _P],
    "vsn_colsum": [_I, _I, _P, _P, _L, _P, _P, _L, _L, _I, _P],
    "vsn_postnorm_fwd": [_I, *[_P] * 6, _L, _F, _P, _L, _I, _P],
    "vsn_layerscale_grads": [*[_P] * 6, _I, _I, _P],
}

_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: put the CUDA toolkit's bin on PATH "
                       "or set CUDA_HOME")


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libvsn_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources unless the library for them already exists: one
    nvcc process per source, run in parallel, then one link."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), f"{so.stem}.{os.getpid()}"
    jobs = []
    for src in sorted(CSRC.glob("*.cu")):
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        jobs.append((src, obj, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failed = []
    for src, _, proc in jobs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{src.name} ({proc.returncode}):\n{err}")
    objs = [obj for _, obj, _ in jobs]
    try:
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        res = subprocess.run([nvcc, *LINK_FLAGS, "-o", str(tmp),
                              *map(str, objs)], capture_output=True,
                             text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                               f"{res.stderr}")
        os.replace(tmp, so)
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    return so


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def expect(t, name: str, shape, dtype, device) -> None:
    """Validate one kernel argument before its pointer is passed on."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def ptr(t):
    """Device pointer of an optional tensor (None -> NULL)."""
    return None if t is None else t.data_ptr()


def stream_of(t):
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
