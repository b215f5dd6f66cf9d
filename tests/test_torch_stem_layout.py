"""The host-side geometry of K5's tensor-core bodies (csrc/stem_im2col.cu),
on the CPU: K5f's padded tap order (``tap_layout``, ``pad_taps``) and its
inverse, K5w's launch plan (``dw_plan``: rows a group, blocks, the scratch
of partials), and the two bodies' shared-memory addressing replayed in
numpy: each block's run of row groups, the ring of input planes it stages
(slots read before they are staged are NaN), the offsets a lane reads its
operands at, the sums a block owns and the ordered sum of the partials,
against the plain versions. At x-stride 2 every K5f A register is checked to sit at an
even element (one aligned 32-bit load).

Tolerances: the replays sum f32 products in another order than the plain
conv, 1e-5 of the output scale.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from vsn_tpu_torch.ops import stem_im2col as S

GEOMS = [*chip_smoke.STEM_GEOMS,
         ((9, 11, 13), (3, 5, 3), (2, 2, 1), 24)]   # C = 24: 3 n8 tiles


def _up(v, m):
    return -(-v // m) * m


def _case(shape, ks, strides, c_out, seed=0):
    rng = np.random.default_rng(seed)
    pad = tuple(k // 2 for k in ks)
    x = rng.standard_normal((2, *shape)).astype(np.float32)
    kernel = rng.standard_normal((*ks, 1, c_out)).astype(np.float32)
    outs = S.output_shape(shape, ks, strides, pad)
    g = rng.standard_normal((2, *outs, c_out)).astype(np.float32)
    return x, kernel, pad, outs, g


def _runs(groups, blocks):
    """Each block's run of consecutive groups: [g0, g1)."""
    per = -(-groups // blocks)
    return [(i * per, min(groups, (i + 1) * per))
            for i in range(-(-groups // per))]


def _group_slots(index, slot, plane):
    """Every element ``index`` reads lies in a slot of the group's planes."""
    assert index.min() >= 0
    assert set(np.unique(index // plane)) <= set(slot)


def _ring_walk(x, outs, rows, g0, g1, ks, strides, pad, wp, lpad):
    """The groups of one block's run as the tensor-core bodies walk them:
    yield (bi, zo, yo0, ring, slot) per group, the ring of kd + sz input
    planes [slot, slab_rows, wp] staged as the kernels stage it (all kd
    planes at a run's start, the min(sz, kd) new ones ahead of each
    continuing group; NaN until staged), and slot(dz) of the group's plane
    dz, each holding that plane. A replay reads only those slots
    (``_group_slots``): another may hold a stale plane or nothing."""
    (kd, kh, _), (sz, sy, _) = ks, strides
    _, d, h, w = x.shape
    od, oh, _ = outs
    slab, nslot = (rows - 1) * sy + kh, kd + sz
    ygroups = -(-oh // rows)
    ring = np.full((nslot, slab, wp), np.nan, np.float32)
    held = np.full(nslot, -1)   # the padded plane each slot holds

    def decode(grp):
        rest, zo = divmod(grp, od)
        bi, yg = divmod(rest, ygroups)
        return bi, zo, yg * rows

    def stage(bi, yo0, zp0, count):
        for zp in range(zp0, zp0 + count):
            plane = np.zeros((slab, wp), np.float32)
            z = zp - pad[0]
            for r in range(slab):
                yy = yo0 * sy - pad[1] + r
                if 0 <= z < d and 0 <= yy < h:
                    n = min(w, wp - lpad)
                    plane[r, lpad:lpad + n] = x[bi, z, yy, :n]
            ring[zp % nslot] = plane
            held[zp % nslot] = zp

    fresh = min(sz, kd)
    bi, zo, yo0 = decode(g0)
    stage(bi, yo0, zo * sz, kd)
    for grp in range(g0, g1):
        bi, zo, yo0 = decode(grp)
        cont = grp + 1 < g1 and zo + 1 < od
        if cont:
            stage(bi, yo0, (zo + 1) * sz + kd - fresh, fresh)
        slot = [(zo * sz + dz) % nslot for dz in range(kd)]
        assert [held[i] for i in slot] == [zo * sz + dz for dz in range(kd)]
        yield bi, zo, yo0, ring, slot
        if grp + 1 < g1 and not cont:
            nb, nz, ny = decode(grp + 1)
            stage(nb, ny, nz * sz, kd)


@pytest.mark.parametrize("shape,ks,strides,c_out",
                         [*GEOMS, chip_smoke.RESNET_STEM])
def test_pad_taps_round_trip_and_rows(shape, ks, strides, c_out):
    pad = tuple(k // 2 for k in ks)
    kernel = torch.randn(*ks, 1, c_out, generator=torch.Generator()
                         .manual_seed(1))
    f, kw8, rows = S.tap_layout(ks, strides, pad)
    assert rows % 16 == 0 and kw8 % 8 == 0 and kw8 >= ks[2] + f
    w = S.pad_taps(kernel, strides, pad, torch.float32)
    assert w.shape == (rows, c_out)
    assert torch.equal(S.unpad_taps(w, ks, strides, pad), kernel)
    kd, kh, kw = ks
    flat = kernel.reshape(-1, c_out)
    filled = torch.zeros(rows, dtype=torch.bool)
    for dz in range(kd):
        for dy in range(kh):
            for dx in range(kw):
                row = (dz * kh + dy) * kw8 + dx + f
                filled[row] = True
                assert torch.equal(w[row], flat[(dz * kh + dy) * kw + dx])
    assert not w[~filled].any()
    wb = S.pad_taps(kernel, strides, pad, torch.bfloat16)
    assert wb.dtype == torch.bfloat16
    assert torch.equal(S.unpad_taps(wb, ks, strides, pad),
                       kernel.bfloat16())


def test_the_resnet_stem_layout_and_plan():
    """The slice's own stem call: x [12, 144, 168, 144, 1], 7^3, strides
    (1, 2, 2), on a card of 132 multiprocessors."""
    shape, ks, strides, c_out = chip_smoke.RESNET_STEM
    pad = (3, 3, 3)
    assert S.tap_layout(ks, strides, pad) == (1, 8, 400)
    outs = S.output_shape(shape, ks, strides, pad)
    assert outs == (144, 84, 72)
    plan = S.dw_plan(chip_smoke.RESNET_MICRO, outs, ks, strides, pad, c_out,
                     132)
    assert plan == S.DwPlan(6, 12 * 144 * 14, 184, 132, (132, 343, 64))
    assert S.dw_smem(6, 72, ks, strides, pad) == 170784


@pytest.mark.parametrize("groups_shape,sms", [((2, (12, 7, 6)), 132),
                                              ((12, (144, 84, 72)), 7),
                                              ((3, (5, 9, 300)), 4)])
def test_dw_plan_gives_every_block_groups(groups_shape, sms):
    batch, outs = groups_shape
    ks, strides, pad = (3, 3, 3), (1, 2, 2), (1, 1, 1)
    plan = S.dw_plan(batch, outs, ks, strides, pad, 16, sms)
    assert 1 <= plan.rows <= S.DW_ROWS
    assert S.dw_smem(plan.rows, outs[2], ks, strides, pad) <= S.SMEM_BYTES
    assert plan.rows == outs[1] or plan.rows == S.DW_ROWS or S.dw_smem(
        plan.rows + 1, outs[2], ks, strides, pad) > S.SMEM_BYTES
    assert plan.groups == batch * outs[0] * -(-outs[1] // plan.rows)
    assert plan.blocks <= sms and plan.scratch == (plan.blocks, 27, 16)
    # block i sums groups [i * per_block, (i + 1) * per_block): none empty
    assert (plan.blocks - 1) * plan.per_block < plan.groups
    assert plan.blocks * plan.per_block >= plan.groups


def test_dw_plan_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="shared memory"):
        S.dw_plan(1, (4, 4, 1000), (7, 7, 7), (1, 2, 2), (3, 3, 3), 16, 132)
    with pytest.raises(ValueError, match="taps"):
        S.dw_plan(1, (4, 4, 4), (9, 9, 9), (1, 1, 1), (4, 4, 4), 16, 132)


@pytest.mark.parametrize("shape,ks,strides,c_out", GEOMS)
def test_k5f_addressing_replayed(shape, ks, strides, c_out):
    """stem_fwd_mma_kernel's reads on a card of 5 multiprocessors: a group
    of rows output rows, each block's run of groups over the ring of input
    planes, the lane's token base (r sy wp + sx xo + lpad - f - px), the
    depth chunk offsets ((slot(dz) slab + dy) wp + 8 q), the weight rows of
    pad_taps; y = A W on every group."""
    x, kernel, pad, outs, _ = _case(shape, ks, strides, c_out)
    (kd, kh, kw), (sz, sy, sx) = ks, strides
    od, oh, ow = outs
    f, kw8, krows = S.tap_layout(ks, strides, pad)
    w = S.pad_taps(torch.from_numpy(kernel), strides, pad,
                   torch.float32).numpy()
    lpad = _up(f + pad[2], 8)
    wp = _up(lpad + sx * (ow - 1) + kw8 - f - pad[2], 8)
    rows = min(oh, 512 // ow)
    slab = (rows - 1) * sy + kh
    per = kw8 // 8
    tok = np.minimum(np.arange(_up(rows * ow, 16)), rows * ow - 1)
    r, xo = tok // ow, tok % ow
    base = r * sy * wp + sx * xo + lpad - f - pad[2]
    depth = np.arange(krows)
    y = np.zeros((2, *outs, c_out), np.float32)
    groups = 2 * od * -(-oh // rows)
    for g0, g1 in _runs(groups, 5):
        for bi, zo, yo0, ring, slot in _ring_walk(x, outs, rows, g0, g1, ks,
                                                  strides, pad, wp, lpad):
            choff = np.zeros(krows // 8, np.int64)
            for c in range(krows // 8):   # the zero chunk reads chunk 0's
                dzdy, q = divmod(c if c < kd * kh * per else 0, per)
                choff[c] = (slot[dzdy // kh] * slab + dzdy % kh) * wp + 8 * q
            index = base[:, None] + choff[depth // 8][None] + depth % 8
            _group_slots(index, slot, slab * wp)
            if sx == 2:  # each A register: depth slots (2t, 2t + 1), 32 bits
                assert (index[:, ::2] % 2 == 0).all()
            n = min(rows, oh - yo0) * ow
            y[bi, zo].reshape(-1, c_out)[yo0 * ow:yo0 * ow + n] = \
                (ring.reshape(-1)[index] @ w)[:n]
    want = S.stem_conv_reference(torch.from_numpy(x[..., None]),
                                 torch.from_numpy(kernel), strides, pad)
    np.testing.assert_allclose(y, want.numpy(), rtol=0,
                               atol=1e-5 * np.abs(want.numpy()).max())


@pytest.mark.parametrize("shape,ks,strides,c_out", GEOMS)
def test_k5w_addressing_and_partials_replayed(shape, ks, strides, c_out):
    """stem_dw_mma_kernel's reads and sums on a card of 5 multiprocessors:
    dw_plan's groups, each block's run of them over the ring of input
    planes, the lane's tap offsets ((slot(dz) slab + dy) wp + lpad + dx -
    px) and token pairs (r sy wp + sx j), zero cotangent slots past ow;
    the partials summed block by block."""
    x, kernel, pad, outs, g = _case(shape, ks, strides, c_out, seed=2)
    (kd, kh, kw), (sz, sy, sx) = ks, strides
    od, oh, ow = outs
    plan = S.dw_plan(2, outs, ks, strides, pad, c_out, 5)
    rows, owp = plan.rows, _up(ow, 16)
    lpad = _up(pad[2], 8)
    wp = _up(lpad + sx * (owp - 1) + kw - pad[2], 8)
    slab = (rows - 1) * sy + kh
    dz, dy, dx = np.unravel_index(np.arange(kd * kh * kw), ks)
    part = np.zeros(plan.scratch, np.float32)
    runs = _runs(plan.groups, plan.blocks)
    assert len(runs) == plan.blocks
    for blk, (g0, g1) in enumerate(runs):
        for bi, zo, yo0, ring, slot in _ring_walk(x, outs, rows, g0, g1, ks,
                                                  strides, pad, wp, lpad):
            toff = (np.take(slot, dz) * slab + dy) * wp + lpad + dx - pad[2]
            for r in range(min(rows, oh - yo0)):
                gs = np.zeros((owp, c_out), np.float32)
                gs[:ow] = g[bi, zo, yo0 + r]
                index = toff[:, None] + r * sy * wp + sx * np.arange(owp)
                _group_slots(index, slot, slab * wp)
                part[blk] += ring.reshape(-1)[index] @ gs
    dw = part[0].copy()
    for blk in range(1, plan.blocks):
        dw += part[blk]
    want = S.stem_dw_reference(torch.from_numpy(x[..., None]),
                               torch.from_numpy(g), ks, strides, pad)
    np.testing.assert_allclose(dw.reshape(want.shape), want.numpy(), rtol=0,
                               atol=1e-5 * np.abs(want.numpy()).max())


def test_the_fma_route_takes_bf16_only():
    """``_fma`` (the FMA bodies on bf16, chip_smoke.py's yardstick) raises
    for f32, whose route is the FMA bodies already; on the CPU a bf16 call
    runs the plain version either way."""
    x, kernel, pad, outs, g = _case((8, 10, 8), (3, 3, 3), (1, 1, 1), 16)
    xt, kt = torch.from_numpy(x[..., None]), torch.from_numpy(kernel)
    with pytest.raises(ValueError, match="bf16"):
        S.stem_conv_im2col(xt, kt, (1, 1, 1), pad, _fma=True)
    with pytest.raises(ValueError, match="bf16"):
        S.stem_conv_dw(xt, torch.from_numpy(g), (3, 3, 3), (1, 1, 1), pad,
                       _fma=True)
    got = S.stem_conv_im2col(xt, kt, (1, 1, 1), pad, torch.bfloat16,
                             _fma=True)
    assert torch.equal(got, S.stem_conv_reference(xt, kt, (1, 1, 1), pad,
                                                  torch.bfloat16))
