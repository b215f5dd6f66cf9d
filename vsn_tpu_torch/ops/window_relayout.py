"""K3: window-layout movers (port of vsn_tpu/ops/window_relayout.py).

  spatial_to_windows(x, window, roll)        == partition(roll3d(x, roll))
  windows_to_windows(w, window, dims, roll)  == partition(roll3d(reverse(w), roll))
  windows_to_spatial(w, window, dims, roll)  == roll3d(reverse(w), roll)

All three launch one CUDA gather kernel (``csrc/window_relayout.cu``) over
a row map, for a tensor on a CUDA device; for a tensor on the CPU they run
the plain reshape/permute/roll forms from ``models/swin3d.py``. Any dtype;
the move is bit-exact. The map (``relayout_map``: for each destination row
of one sample, its source row, int32) is the kernel's plan, built on the
host from the index formulas once per geometry, roll, layouts and device
and cached; ``relayout_launch`` gives the launch's chunk width and threads
a row.

On the CUDA route each mover is a ``torch.autograd.Function`` whose
backward is the JAX adjoint (vsn_tpu/ops/window_relayout.py:141-153,
176-178), launched through the same gather kernel: the adjoint of
spatial_to_windows is windows_to_spatial with the roll negated, and the
other way round; the adjoint of windows_to_windows is itself with the roll
negated. An adjoint launch counts under ``<mover>_adjoint``. The plain
forms are differentiable through autograd as they are.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from vsn_tpu_torch.ops._build import check, expect, launches, library, stream_of


def _grid(dims, window):
    if any(d % w for d, w in zip(dims, window)):
        raise ValueError(f"dims {tuple(dims)} not divisible by window "
                         f"{tuple(window)}")
    return [d // w for d, w in zip(dims, window)]


def _windows_batch(wins, window, dims):
    """Samples in a [B*nW, N, C] window tensor."""
    nw = _grid(dims, window)
    nwin = nw[0] * nw[1] * nw[2]
    n = window[0] * window[1] * window[2]
    if wins.ndim != 3 or wins.shape[1] != n or wins.shape[0] % nwin:
        raise ValueError(f"windows of shape {tuple(wins.shape)} do not tile "
                         f"dims {tuple(dims)} with window {tuple(window)}")
    return wins.shape[0] // nwin


RELAYOUT_THREADS = 256   # csrc/window_relayout.cu kRelayoutThreads
RELAYOUT_ROWS = 4        # kRelayoutRows: rows a thread moves


@functools.lru_cache(maxsize=None)
def relayout_map(dims, window, roll, src_windows, dst_windows):
    """The K3 kernel's row map of one sample (numpy int32 [D*H*W]): entry t
    is the source row of destination row t, for the move from the source
    layout (windows or spatial) to the destination layout that rolls by
    ``roll`` (each 0 <= r < dim). Built from the index formulas:
    destination row -> its spatial position (z, y, x) -> minus the roll ->
    the source layout's row of that position."""
    d, h, w = dims
    wd, wh, ww = window
    nwh, nww = h // wh, w // ww
    n = wd * wh * ww
    t = np.arange(d * h * w, dtype=np.int64)
    if dst_windows:
        win, pos = t // n, t % n
        z = win // (nwh * nww) * wd + pos // (wh * ww)
        y = win // nww % nwh * wh + pos // ww % wh
        x = win % nww * ww + pos % ww
    else:
        z, y, x = t // (h * w), t // w % h, t % w
    z, y, x = (z - roll[0]) % d, (y - roll[1]) % h, (x - roll[2]) % w
    if src_windows:
        win = (z // wd * nwh + y // wh) * nww + x // ww
        src = win * n + (z % wd * wh + y % wh) * ww + x % ww
    else:
        src = (z * h + y) * w + x
    return src.astype(np.int32)


@functools.lru_cache(maxsize=None)
def _device_map(key, device):
    """``relayout_map(*key)`` on ``device``, built once."""
    return torch.from_numpy(relayout_map(*key)).to(device)


class RelayoutLaunch(NamedTuple):
    """How the K3 kernel moves rows of ``row_bytes``: ``chunk`` bytes a
    thread at once (16, 4 or 1: the widest that divides the row and both
    base addresses), ``chunks`` of them a row, ``lanes`` threads on a row
    (threadIdx.x), ``rows_per_step`` rows a block step (threadIdx.y), each
    thread moving one chunk of RELAYOUT_ROWS rows a block."""
    chunk: int
    chunks: int
    lanes: int
    rows_per_step: int


def relayout_launch(row_bytes, src_ptr=0, dst_ptr=0):
    """The K3 launch's shape for rows of ``row_bytes`` bytes."""
    align = row_bytes | src_ptr | dst_ptr
    chunk = 16 if align % 16 == 0 else 4 if align % 4 == 0 else 1
    chunks = row_bytes // chunk
    lanes = min(chunks, RELAYOUT_THREADS)
    return RelayoutLaunch(chunk, chunks, lanes, RELAYOUT_THREADS // lanes)


def _launch(name, src, dst, batch, dims, window, roll, src_windows,
            dst_windows):
    if src.device.type != "cuda":
        raise ValueError(f"{name}: tensor on {src.device}")
    expect(src, "input", src.shape, src.dtype, src.device)
    dims, window = tuple(map(int, dims)), tuple(map(int, window))
    roll = tuple(int(r) % d for r, d in zip(roll, dims))
    rmap = _device_map((dims, window, roll, bool(src_windows),
                        bool(dst_windows)), src.device)
    row_bytes = src.shape[-1] * src.element_size()
    plan = relayout_launch(row_bytes, src.data_ptr(), dst.data_ptr())
    with torch.cuda.device(src.device):
        err = library().vsn_window_relayout(
            src.data_ptr(), dst.data_ptr(), rmap.data_ptr(), batch,
            rmap.numel(), row_bytes, plan.chunk, plan.lanes, stream_of(src))
    check(err, name)
    launches[name] += 1
    return dst


def spatial_to_windows_reference(x, window, roll=(0, 0, 0)):
    from vsn_tpu_torch.models.swin3d import roll3d, window_partition

    return window_partition(roll3d(x, roll), window)


def windows_to_windows_reference(wins, window, dims, roll):
    from vsn_tpu_torch.models.swin3d import window_glue

    return window_glue(wins, window, dims, tuple(-r for r in roll))


def windows_to_spatial_reference(wins, window, dims, roll=(0, 0, 0)):
    from vsn_tpu_torch.models.swin3d import roll3d, window_reverse

    return roll3d(window_reverse(wins, window, dims), roll)


def _s2w_launch(x, window, roll, name="spatial_to_windows"):
    b, d, h, w, c = x.shape
    nw = _grid((d, h, w), window)
    out = torch.empty((b * nw[0] * nw[1] * nw[2],
                       window[0] * window[1] * window[2], c),
                      dtype=x.dtype, device=x.device)
    return _launch(name, x, out, b, (d, h, w), window, roll, False, True)


def _w2w_launch(wins, window, dims, roll, name="windows_to_windows"):
    b = _windows_batch(wins, window, dims)
    return _launch(name, wins, torch.empty_like(wins), b, dims, window, roll,
                   True, True)


def _w2s_launch(wins, window, dims, roll, name="windows_to_spatial"):
    b = _windows_batch(wins, window, dims)
    out = torch.empty((b, *dims, wins.shape[-1]), dtype=wins.dtype,
                      device=wins.device)
    return _launch(name, wins, out, b, dims, window, roll, True, False)


def _negated(roll):
    return tuple(-int(r) for r in roll)


class _SpatialToWindows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, window, roll):
        ctx.window, ctx.roll, ctx.dims = window, roll, tuple(x.shape[1:4])
        return _s2w_launch(x, window, roll)

    @staticmethod
    def backward(ctx, g):
        return (_w2s_launch(g.contiguous(), ctx.window, ctx.dims,
                            _negated(ctx.roll), "spatial_to_windows_adjoint"),
                None, None)


class _WindowsToWindows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, wins, window, dims, roll):
        ctx.window, ctx.dims, ctx.roll = window, dims, roll
        return _w2w_launch(wins, window, dims, roll)

    @staticmethod
    def backward(ctx, g):
        return (_w2w_launch(g.contiguous(), ctx.window, ctx.dims,
                            _negated(ctx.roll), "windows_to_windows_adjoint"),
                None, None, None)


class _WindowsToSpatial(torch.autograd.Function):
    @staticmethod
    def forward(ctx, wins, window, dims, roll):
        ctx.window, ctx.roll = window, roll
        return _w2s_launch(wins, window, dims, roll)

    @staticmethod
    def backward(ctx, g):
        return (_s2w_launch(g.contiguous(), ctx.window, _negated(ctx.roll),
                            "windows_to_spatial_adjoint"),
                None, None, None)


def spatial_to_windows(x, window, roll=(0, 0, 0)):
    """[B, D, H, W, C] -> [B*nW, wd*wh*ww, C] of roll3d(x, roll)."""
    if x.device.type == "cpu":
        return spatial_to_windows_reference(x, window, roll)
    return _SpatialToWindows.apply(x, tuple(window), tuple(roll))


def windows_to_windows(wins, window, dims, roll):
    """[B*nW, N, C] -> [B*nW, N, C]: the shifted-junction glue
    ``window_glue(wins, window, dims, -roll)`` in one pass."""
    if wins.device.type == "cpu":
        return windows_to_windows_reference(wins, window, dims, roll)
    return _WindowsToWindows.apply(wins, tuple(window), tuple(dims),
                                   tuple(roll))


def windows_to_spatial(wins, window, dims, roll=(0, 0, 0)):
    """[B*nW, N, C] -> roll3d([B, D, H, W, C], roll)."""
    if wins.device.type == "cpu":
        return windows_to_spatial_reference(wins, window, dims, roll)
    return _WindowsToSpatial.apply(wins, tuple(window), tuple(dims),
                                   tuple(roll))
