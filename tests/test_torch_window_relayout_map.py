"""The K3 kernel's plan: the host-built row map (``relayout_map``) against
the permutation that the plain movers apply, and a numpy replay of the
kernel's walk over (sample, row, chunk) against the plain movers' output.

For every Swin-T stage geometry of a 144x168x144 volume (stage 1 36x42x36
and stage 2 18x21x18 with windows 6x7x6; stage 3's 9x11x9 grid padded to
12x14x12; stage 4's 5x6x5 grid with its window clamped to 5x6x5), rolls 0
and the shift (3, 3, 3) where the window shifts, their negations (the
adjoints' rolls), at batch 1 and 2, and the tiny test geometries. A move is
a permutation, so equality is exact.
"""

import numpy as np
import pytest
import torch

from vsn_tpu_torch.ops import window_relayout as wr

# (dims, window, rolls)
STAGES = [((36, 42, 36), (6, 7, 6), [(0, 0, 0), (3, 3, 3)]),
          ((18, 21, 18), (6, 7, 6), [(0, 0, 0), (3, 3, 3)]),
          ((12, 14, 12), (6, 7, 6), [(0, 0, 0), (3, 3, 3)]),
          ((5, 6, 5), (5, 6, 5), [(0, 0, 0)])]
TINY = [((12, 14, 12), (6, 7, 6), [(9, 11, 9), (6, 7, 6), (7, 10, 1)]),
        ((4, 6, 4), (2, 3, 2), [(1, 1, 1)])]
CASES = [(dims, window, roll) for dims, window, rolls in STAGES + TINY
         for r in rolls for roll in {r, tuple(-v for v in r)}]
# mover -> (source is windows, destination is windows)
LAYOUTS = {"spatial_to_windows": (False, True),
           "windows_to_windows": (True, True),
           "windows_to_spatial": (True, False)}


def _plain(name, src, dims, window, roll):
    """The plain mover ``name`` on ``src`` (spatial [B, D, H, W, C] or
    windows [B*nW, N, C])."""
    if name == "spatial_to_windows":
        return wr.spatial_to_windows_reference(src, window, roll)
    return getattr(wr, name + "_reference")(src, window, dims, roll)


def _arange_rows(name, batch, dims, window):
    """Source rows numbered 0 .. B*D*H*W - 1 in the mover's source layout."""
    rows = batch * int(np.prod(dims))
    ids = torch.arange(rows, dtype=torch.float64)
    if LAYOUTS[name][0]:
        return ids.reshape(-1, int(np.prod(window)), 1)
    return ids.reshape(batch, *dims, 1)


def _key(name, dims, window, roll):
    src_w, dst_w = LAYOUTS[name]
    return (dims, window, tuple(r % d for r, d in zip(roll, dims)), src_w,
            dst_w)


@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("dims,window,roll", CASES)
def test_the_map_is_the_plain_movers_permutation(dims, window, roll, batch):
    rows = int(np.prod(dims))
    for name in LAYOUTS:
        rmap = wr.relayout_map(*_key(name, dims, window, roll))
        assert rmap.dtype == np.int32 and rmap.shape == (rows,)
        got = _plain(name, _arange_rows(name, batch, dims, window), dims,
                     window, roll).reshape(batch, rows).numpy()
        want = rmap[None].astype(np.int64) + rows * np.arange(batch)[:, None]
        np.testing.assert_array_equal(got, want)


def _replay(src, rmap, batch, row_bytes, plan):
    """The kernel's walk (csrc/window_relayout.cu relayout_map_kernel) in
    numpy over the bytes of ``src``: block (bx, b), thread (tx, ty) moves
    chunk c = tx, tx + lanes, ... of rows r = bx * rows_per_step *
    RELAYOUT_ROWS + ty + i * rows_per_step, i < RELAYOUT_ROWS, from source
    row map[r] of sample b. Returns the destination bytes and how many
    times each destination chunk was written."""
    rows, chunks = rmap.size, plan.chunks
    per_block = plan.rows_per_step * wr.RELAYOUT_ROWS
    bx, b, ty, i = np.meshgrid(np.arange(-(-rows // per_block)),
                               np.arange(batch),
                               np.arange(plan.rows_per_step),
                               np.arange(wr.RELAYOUT_ROWS), indexing="ij")
    r = (bx * per_block + ty + i * plan.rows_per_step).ravel()
    b = b.ravel()
    live = r < rows
    r, b = r[live], b[live]
    tx = np.arange(plan.lanes)
    c = np.concatenate([tx + k * plan.lanes
                        for k in range(-(-chunks // plan.lanes))])
    c = c[c < chunks]
    dst_idx = ((b * rows + r)[:, None] * chunks + c).ravel()
    src_idx = ((b * rows + rmap[r])[:, None] * chunks + c).ravel()
    src_chunks = src.reshape(-1, plan.chunk)
    out = np.zeros_like(src_chunks)
    out[dst_idx] = src_chunks[src_idx]
    return out.reshape(-1), np.bincount(dst_idx, minlength=batch * rows *
                                        chunks)


@pytest.mark.parametrize("c,dtype", [(96, torch.bfloat16), (3, torch.bfloat16),
                                     (6, torch.float32)])
@pytest.mark.parametrize("dims,window,roll", [
    ((36, 42, 36), (6, 7, 6), (3, 3, 3)), ((18, 21, 18), (6, 7, 6),
                                           (-3, -3, -3)),
    ((5, 6, 5), (5, 6, 5), (0, 0, 0)), ((4, 6, 4), (2, 3, 2), (1, 1, 1))])
def test_a_replay_of_the_kernel_walk_moves_as_the_plain_movers(
        dims, window, roll, c, dtype):
    """At 16-byte chunks (C = 96 bf16: 12 a row), 1-byte chunks (C = 3
    bf16: 6-byte rows) and 4-byte chunks (C = 6 f32: 24-byte rows), batch
    2: every destination chunk written once, and the bytes equal the plain
    mover's."""
    batch = 2
    gen = torch.Generator().manual_seed(sum(dims) + c)
    x = torch.randn(batch, *dims, c, generator=gen).to(dtype)
    wins = wr.spatial_to_windows_reference(x, window)
    row_bytes = c * x.element_size()
    plan = wr.relayout_launch(row_bytes)
    assert plan.chunk == {192: 16, 6: 1, 24: 4}[row_bytes]
    for name in LAYOUTS:
        src = wins if LAYOUTS[name][0] else x
        rmap = wr.relayout_map(*_key(name, dims, window, roll))
        want = _plain(name, src, dims, window, roll).contiguous()
        raw = src.contiguous().view(torch.uint8).numpy().reshape(-1)
        got, writes = _replay(raw, rmap, batch, row_bytes, plan)
        assert (writes == 1).all()
        np.testing.assert_array_equal(
            got, want.view(torch.uint8).numpy().reshape(-1))


def test_the_launch_takes_the_widest_chunk_that_divides_row_and_pointers():
    assert wr.relayout_launch(192) == wr.RelayoutLaunch(16, 12, 12, 21)
    assert wr.relayout_launch(192, 8) == wr.RelayoutLaunch(4, 48, 48, 5)
    assert wr.relayout_launch(1536) == wr.RelayoutLaunch(16, 96, 96, 2)
    assert wr.relayout_launch(6) == wr.RelayoutLaunch(1, 6, 6, 42)
    assert wr.relayout_launch(8192).lanes == 256   # a loop over chunks
