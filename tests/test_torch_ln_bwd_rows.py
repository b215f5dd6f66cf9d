"""The plain versions of the row kernels of K1b / K2b alone against the JAX
package's own arithmetic: the LayerNorm-backward launches
(``ln_backward_rows_reference``, ``postnorm_backward_rows_reference``; on the
CPU ``ln_bwd_launch`` and ``postnorm_bwd_launch`` run them), LN's rows
(``ln_rows_reference`` against ``_ln_fwd`` :75) and the column sums
(``colsum_reference`` against the bias gradients' sums), at the test
widths and at wide rows (C = 1536, and 300, not a multiple of 8). And numpy
replays of the CUDA bodies' plans, their constants read from the source
(csrc/common.cuh ``ln_bwd_plan``, which LN's rows share, and
``colsum_plan``): every row and column covered once, and the order in which
the bodies sum (dw / db and the column sums: block partials, then
``ordered_sum_kernel``; LN's row sums over a group of lanes or of warps).

The JAX side is vsn_tpu/ops/swin_block_kernels.py's ``_ln_bwd`` (:85), as
its Pallas kernels compose it: the pre-norm dx line of _attn_bwd_kernel
(:437-444) and _mlp_bwd_kernel (:971), ``dx = (lam * do_res +
_ln_bwd(dy, ...)[0]).astype(T)`` with LN's xhat and rstd from the forward's
statistics; the post-norm branch backward (:388-397, :917-926), ``do = gb *
do_res``, with gamma ``dgamma = sum(do * bn)`` and ``do * gamma``, then
``_ln_bwd`` on the f32 branch's own ``_ln_fwd`` statistics. The CUDA
launches (csrc/common.cuh ``launch_ln_bwd`` / ``launch_postnorm_bwd``) are
held to these plain versions on the card (tests/test_torch_cuda_kernels.py,
chip_smoke.py's row-kernel phase).

Rows: 3 samples of 37 (111 rows, per-sample gains that differ within a
block's run, a ragged last run of the plan). Tolerances, relative to each
output's largest value: f32 outputs 1e-5 (the same f32 terms summed in
other orders); bf16 dx and y 1e-2 (an f32 value a few ulps apart may round
to the neighbouring bf16 value, 2^-8 of it).
"""

import re
from pathlib import Path
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vsn_tpu.ops import swin_block_kernels as jk
from vsn_tpu_torch.ops import swin_block_kernels as port

RPS, SAMPLES = 37, 3
M = RPS * SAMPLES
WIDTHS = (8, 24, 96, 384, 300, 1536)   # and wide rows: 300 single columns
LAMS = (0.0, 0.9129, 1.0)
TOL = {"float32": 1e-5, "bfloat16": 1e-2}


def _close(got, want, tol):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape
    scale = max(1.0, np.abs(want).max())
    assert np.abs(got - want).max() <= tol * scale


def _rows(c, dtype, seed):
    """Seeded inputs in numpy: x and do_res rounded to ``dtype`` (held as
    f32), dy f32, LN scale 1 + 0.1 z and shift 0.1 z, gamma 0.5 + 0.1 z,
    per-sample gains 0.6 .. 1.4."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(a.astype(np.float32))
    rnd = lambda a: t(a).to(getattr(torch, dtype)).float().numpy()
    z = lambda *s: rng.standard_normal(s).astype(np.float32)
    return dict(x=rnd(3 * z(M, c) + 1), do_res=rnd(z(M, c)), dy=z(M, c),
                branch=2 * z(M, c) - 0.5, w=1 + 0.1 * z(c), b=0.1 * z(c),
                gamma=0.5 + 0.1 * z(c),
                gb=np.linspace(0.6, 1.4, SAMPLES).astype(np.float32))


def _torch(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(dtype)


@pytest.mark.parametrize("lam", LAMS)
@pytest.mark.parametrize("c", WIDTHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pre_norm_rows_match_jax(dtype, c, lam):
    v = _rows(c, dtype, seed=c)
    _, xhat, rstd = jk._ln_fwd(jnp.asarray(v["x"]), jnp.asarray(v["w"]),
                               jnp.asarray(v["b"]))
    mu = jnp.mean(jnp.asarray(v["x"]), axis=-1, keepdims=True)
    dxn, dw, db = jk._ln_bwd(jnp.asarray(v["dy"]), jnp.asarray(v["w"]),
                             xhat, rstd)
    tdt = getattr(torch, dtype)
    want_dx = _torch(np.asarray(lam * v["do_res"] + dxn)).to(tdt).float()
    stats = _torch(np.concatenate([np.asarray(mu), np.asarray(rstd)], -1))
    dx, gw, gb = port.ln_bwd_launch(
        _torch(v["x"], tdt), stats, _torch(v["w"]), _torch(v["dy"]),
        _torch(v["do_res"], tdt), lam)
    assert dx.dtype == tdt and gw.dtype == gb.dtype == torch.float32
    _close(dx.float(), want_dx, TOL[dtype])
    _close(gw, dw, TOL["float32"])
    _close(gb, db, TOL["float32"])


@pytest.mark.parametrize("with_gamma", [False, True])
@pytest.mark.parametrize("c", WIDTHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_post_norm_rows_match_jax(dtype, c, with_gamma):
    v = _rows(c, dtype, seed=100 + c)
    bn, xhat, rstd = jk._ln_fwd(jnp.asarray(v["branch"]),
                                jnp.asarray(v["w"]), jnp.asarray(v["b"]))
    do = jnp.repeat(jnp.asarray(v["gb"]), RPS)[:, None] * v["do_res"]
    dgamma = None
    if with_gamma:
        dgamma = jnp.sum(do * bn, axis=0)
        do = do * v["gamma"]
    dbranch, dw, db = jk._ln_bwd(do, jnp.asarray(v["w"]), xhat, rstd)
    tdt = getattr(torch, dtype)
    got = port.postnorm_bwd_launch(
        _torch(v["branch"]), _torch(v["do_res"], tdt), _torch(v["gb"]), RPS,
        _torch(v["w"]), _torch(v["b"]),
        _torch(v["gamma"]) if with_gamma else None)
    assert got[0].dtype == torch.float32
    for g, want in zip(got, (dbranch, dw, db, dgamma)):
        if want is None:
            assert g is None
        else:
            _close(g, want, TOL["float32"])


COMMON = (Path(__file__).resolve().parents[1] / "vsn_tpu_torch" / "csrc"
          / "common.cuh").read_text()


def _constant(name):
    """An ``int`` constant of common.cuh, e.g. ``kLnBwdMaxBlocks = 2 *
    132``."""
    expr = re.search(rf"constexpr int {name} = ([0-9 *]+);", COMMON).group(1)
    return int(np.prod([int(t) for t in expr.split("*")]))


WARPS, MAX_BLOCKS, MIN_STEPS, ROWS_MAX_BLOCKS, MAX_LANES, MAX_C = (
    _constant(n) for n in ("kLnBwdWarps", "kLnBwdMaxBlocks", "kLnBwdMinSteps",
                           "kLnRowsMaxBlocks", "kRowMaxLanes", "kRowMaxC"))
THREADS = 32 * WARPS


class Plan(NamedTuple):
    vec: int
    lanes: int
    units: int
    run: int
    blocks: int


def _plan(m, c, max_blocks=MAX_BLOCKS):
    """common.cuh ``ln_bwd_plan`` of an [m, c] call, a function of (m, c)
    alone (LN's rows take it with ``max_blocks`` ROWS_MAX_BLOCKS): a lane
    group of a power of two of lanes owns a row: 8-column units, the least
    group with 3 units a lane at most (4 at MAX_LANES lanes), or single
    columns, 32 lanes of up to 8 units (a power of two), then up to
    MAX_LANES lanes of 8 and 16, 32 units; block b takes rows [b * run, (b +
    1) * run), run a multiple of the block's step (THREADS / lanes rows) of
    at least MIN_STEPS steps, with at most ``max_blocks`` blocks. None where
    the body does not take c (above MAX_C)."""
    if m < 1 or c < 1 or c > MAX_C:
        return None
    vec = 8 if c % 8 == 0 else 1
    chunks = c // vec
    if vec == 8:
        lanes = 1
        while lanes < MAX_LANES and 3 * lanes < chunks:
            lanes *= 2
        units = -(-chunks // lanes)
    else:
        lanes = 32
        while lanes < MAX_LANES and 8 * lanes < chunks:
            lanes *= 2
        units = 1
        while units < -(-chunks // lanes):
            units *= 2
    step = THREADS // lanes
    run = max(-(-m // max_blocks), MIN_STEPS * step)
    run = -(-run // step) * step
    return Plan(vec, lanes, units, run, -(-m // run))


def test_the_replayed_plan_reads_the_sources_constants():
    """The replay's constants are common.cuh's (8 warps, 2 x 132 blocks, 4
    x 132 for LN's rows, 2 steps, groups of up to 256 lanes, C up to 8192),
    and the source's plan stops where the replay stops."""
    assert (WARPS, MAX_BLOCKS, MIN_STEPS, ROWS_MAX_BLOCKS, MAX_LANES,
            MAX_C) == (8, 264, 2, 528, 256, 8192)
    assert "if (m < 1 || c < 1 || c > kRowMaxC) return false;" in COMMON
    assert "3 * p->lanes < chunks" in COMMON
    assert "8 * p->lanes < chunks" in COMMON


# (M, C): Swin-T's stage-1 call at micro-batch 8 and its stage-4 one, ViT-S
# at micro-batch 24, the test widths, a width of single columns, a call
# smaller than one block step, and the wide rows: Swin-T's stage 4 at
# EMBED_DIM 192 (1536) and 128 (1024), 1280, 4096, 8192, single columns
# above 256 (300, 3000, 8191)
PLAN_CASES = [(435456, 96), (1200, 768), (19464, 384), (111, 8), (111, 24),
              (4000, 384), (300, 12), (5, 96), (1200, 1536), (1200, 1024),
              (1200, 1280), (300, 4096), (130, 8192), (700, 300),
              (150, 3000), (64, 8191)]


@pytest.mark.parametrize("max_blocks", [MAX_BLOCKS, ROWS_MAX_BLOCKS])
@pytest.mark.parametrize("m,c", PLAN_CASES)
def test_the_row_plan_covers_every_row_once(m, c, max_blocks):
    """Block b runs rows [b * run, min((b + 1) * run, M)): every row in one
    run, no run empty, at most ``max_blocks`` blocks; a run is whole block
    steps (256 / lanes rows); a lane group's units cover C, each column in
    one unit of one lane; the plan is a function of (M, C) alone."""
    plan = _plan(m, c, max_blocks)
    assert plan == _plan(m, c, max_blocks)
    step = THREADS // plan.lanes
    assert plan.run % step == 0 and plan.run >= 2 * step
    assert plan.blocks <= max_blocks and plan.lanes & (plan.lanes - 1) == 0
    assert plan.units * plan.lanes * plan.vec >= c
    assert plan.units <= (4 if plan.vec == 8 else 32) and plan.lanes <= 256
    assert plan.vec == (8 if c % 8 == 0 else 1)
    owner = np.full(m, -1)
    for b in range(plan.blocks):
        rows = np.arange(b * plan.run, min((b + 1) * plan.run, m))
        assert rows.size and (owner[rows] == -1).all()
        owner[rows] = b
    assert (owner >= 0).all()
    # unit u = k * lanes + lane of the group: its VEC columns
    cols = np.concatenate([
        np.arange(u * plan.vec, (u + 1) * plan.vec)
        for k in range(plan.units) for lane in range(plan.lanes)
        for u in [k * plan.lanes + lane] if u * plan.vec < c])
    assert np.array_equal(np.sort(cols), np.arange(c))


def test_the_plan_rejects_widths_the_body_does_not_take():
    """Every C up to 8192 is planned: the wide rows that a plan within a
    warp cannot take (1032: 129 units of 8; 300 single columns) take lane
    groups of 64; 8193 is refused."""
    assert _plan(10, 1032) == Plan(8, 64, 3, 8, 2)
    assert _plan(10, 300) == Plan(1, 64, 8, 8, 2)
    assert _plan(10, 8192).units == 4 and _plan(10, 8191).units == 32
    assert _plan(10, 768) == Plan(8, 32, 3, 16, 1)   # unchanged at C <= 768
    assert _plan(10, 250).units == 8
    assert _plan(10, 8193) is None
    assert all(_plan(10, c) is not None for c in range(1, 8193))


def _block_sums(a, plan):
    """One block's partial sums of the [rows, C] terms ``a`` (f32), in the
    body's order: each lane group adds its rows in turn; the groups of a
    warp meet by the butterfly (xor of 1, 2, ... groups); warps [h, 2h) add
    theirs into warps [0, h), h = 4, 2, 1, down to the warps a group spans
    (a wide group's warps hold different columns)."""
    per_warp = max(1, 32 // plan.lanes)
    gw = max(1, plan.lanes // 32)            # warps a group spans
    groups = WARPS * per_warp // gw
    iters = -(-a.shape[0] // groups)
    t = np.zeros((iters * groups, a.shape[1]), np.float32)
    t[:a.shape[0]] = a
    acc = np.zeros((groups, a.shape[1]), np.float32)
    for i in range(iters):
        acc = acc + t[i * groups:(i + 1) * groups]
    if gw > 1:   # a group's warps hold its columns: a tree over the groups
        return _tree(acc)
    acc = acc.reshape(WARPS, per_warp, -1)
    o = 1
    while o < per_warp:
        acc = acc + acc[:, np.arange(per_warp) ^ o]
        o *= 2
    return _tree(acc[:, 0])


def _tree(rows):
    """Rows [h, 2h) added into rows [0, h), h = len / 2, ..., 1."""
    h = len(rows) // 2
    while h:
        rows = rows[:h] + rows[h:2 * h]
        h //= 2
    return rows[0]


def _ordered(part):
    """``ordered_sum_kernel``'s sum of the blocks' partials [blocks, C]:
    block g in slice g mod 32, each slice in block order, then the slices in
    order."""
    slices = []
    for s in range(32):
        acc = np.zeros(part.shape[1], np.float32)
        for g in range(s, part.shape[0], 32):
            acc = acc + part[g]
        slices.append(acc)
    out = slices[0]
    for s in range(1, 32):
        out = out + slices[s]
    return out


@pytest.mark.parametrize("m,c", [(1200, 768), (19464, 384), (4000, 96),
                                 (111, 24), (1200, 1536), (700, 300),
                                 (300, 4096)])
def test_the_ordered_sum_of_partials_matches_f64(m, c):
    """dw's sum as the body and ``ordered_sum_kernel`` take it (block
    partials, then block g in slice g mod 32, each slice in block order,
    the slices in order) is within 1e-5 of the f64 sum; a second pass gives
    the same bits."""
    rng = np.random.default_rng(m + c)
    terms = (rng.standard_normal((m, c)) * rng.standard_normal((m, 1))
             ).astype(np.float32)
    plan = _plan(m, c)

    def ordered():
        return _ordered(np.stack([
            _block_sums(terms[b * plan.run:(b + 1) * plan.run], plan)
            for b in range(plan.blocks)]))

    got = ordered()
    want = terms.astype(np.float64).sum(0)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(terms).sum(0).max()
    assert np.array_equal(got, ordered())


def _group_sum(values, plan):
    """A row's sum as ``RowSum`` takes it over the row's registers
    ``values`` [units, lanes, vec] (each lane its units in turn): each lane
    adds its units; a butterfly of shuffles over a group within a warp
    (xor 1, 2, ... lanes); a wide group's warps each a butterfly over 32
    lanes, then the warps' sums in warp order."""
    lane = np.zeros(values.shape[1], np.float32)
    for k in range(values.shape[0]):
        for e in range(values.shape[2]):
            lane = lane + values[k, :, e]
    width = min(plan.lanes, 32)
    lane = lane.reshape(-1, width)
    o = 1
    while o < width:
        lane = lane + lane[:, np.arange(width) ^ o]
        o *= 2
    out = lane[0, 0]
    for w in range(1, lane.shape[0]):
        out = np.float32(out + lane[w, 0])
    return out


@pytest.mark.parametrize("c", [96, 384, 768, 1536, 300, 4096, 8191])
def test_ln_rows_group_sums_match_f64_and_cover_the_row(c):
    """LN's rows (``ln_rows_kernel``) on the plan: the units of a row's
    lanes hold each of its columns once, zero past C; the mean and the
    variance about it, as the group sums them (``_group_sum``), are within
    1e-6 of f64."""
    plan = _plan(ROWS_MAX_BLOCKS, c, ROWS_MAX_BLOCKS)
    rng = np.random.default_rng(c)
    x = (3 * rng.standard_normal(c) + 1).astype(np.float32)
    idx = np.arange(plan.units * plan.lanes * plan.vec).reshape(
        plan.units, plan.lanes, plan.vec)   # [k, lane, e] -> column
    live = idx < c
    assert np.array_equal(np.sort(idx[live]), np.arange(c))
    vals = np.where(live, x[np.minimum(idx, c - 1)], 0).astype(np.float32)
    mu = np.float32(_group_sum(vals, plan) / np.float32(c))
    dev = np.where(live, vals - mu, 0).astype(np.float32)
    var = np.float32(_group_sum(dev * dev, plan) / np.float32(c))
    x64 = x.astype(np.float64)
    assert abs(mu - x64.mean()) <= 1e-6 * np.abs(x64).max()
    assert abs(var - x64.var()) <= 1e-6 * x64.var()


COLSUM_UNITS, COLSUM_ROWS, COLSUM_MIN_STEPS = (_constant(n) for n in (
    "kColsumUnits", "kColsumRows", "kColsumMinSteps"))
COLSUM_MAX_BLOCKS = 132 * _constant("kColsumBlocksPerSm")


class ColsumPlan(NamedTuple):
    vec: int
    lanes: int
    units: int
    cols: int
    per: int
    run: int
    blocks: int


def _colsum_plan(m, n):
    """common.cuh ``colsum_plan`` of an [m, n] call, a function of (m, n)
    alone: 8-column units (single columns where n is not a multiple of 8)
    in ``cols`` column groups of ``per`` units (at most 32 x COLSUM_UNITS,
    or 256 single columns), a group of ``lanes`` lanes (<= 32) with
    ``units`` units a lane; row blocks of ``run`` rows, the same in each
    (the last ragged; at least COLSUM_MIN_STEPS block steps of COLSUM_ROWS
    rows a lane group), so that row blocks x column groups come to at most
    COLSUM_MAX_BLOCKS (a wave of the body's blocks an SM)."""
    vec = 8 if n % 8 == 0 else 1
    chunks = n // vec
    most = 32 * COLSUM_UNITS if vec == 8 else 32 * 8
    cols = -(-chunks // most)
    per = -(-chunks // cols)
    if vec == 8:
        lanes = 1
        while lanes < 32 and COLSUM_UNITS * lanes < per:
            lanes *= 2
        units = -(-per // lanes)
    else:
        lanes, units = 32, 1
        while units < -(-per // 32):
            units *= 2
    step = COLSUM_ROWS * THREADS // lanes
    row_blocks = max(1, COLSUM_MAX_BLOCKS // cols)
    run = max(-(-m // row_blocks), COLSUM_MIN_STEPS * step)
    return ColsumPlan(vec, lanes, units, cols, per, run, -(-m // run))


# (M, N): the column sums of Swin-T's stage-1 and stage-4 calls at
# micro-batch 8 (dbproj / dfc2_b over C, dfc1_b over 4C), ViT-S's at
# micro-batch 24, Swin-T's stage 4 at EMBED_DIM 192 (1536, hidden 6144),
# single columns (300, hidden 1200 of units), a call under one block step
COLSUM_CASES = [(435456, 96), (435456, 384), (1200, 768), (1200, 3072),
                (19464, 384), (19464, 1536), (1200, 1536), (1200, 6144),
                (700, 300), (700, 1200), (7, 24), (50, 1001)]


@pytest.mark.parametrize("m,n", COLSUM_CASES)
def test_the_colsum_plan_covers_every_row_and_column_once(m, n):
    """Row block b runs rows [b * run, min((b + 1) * run, M)) and column
    group j the units [j * per, min((j + 1) * per, N / vec)): each row in
    one row block, each column in one unit of one lane of one column group;
    at most COLSUM_MAX_BLOCKS blocks in all (one wave); the plan is a
    function of (M, N) alone."""
    plan = _colsum_plan(m, n)
    assert plan == _colsum_plan(m, n)
    step = COLSUM_ROWS * THREADS // plan.lanes
    assert plan.run >= COLSUM_MIN_STEPS * step
    assert plan.lanes <= 32 and plan.lanes & (plan.lanes - 1) == 0
    assert plan.units <= (COLSUM_UNITS if plan.vec == 8 else 8)
    assert plan.blocks * plan.cols <= COLSUM_MAX_BLOCKS
    owner = np.full(m, -1)
    for b in range(plan.blocks):
        rows = np.arange(b * plan.run, min((b + 1) * plan.run, m))
        assert rows.size and (owner[rows] == -1).all()
        owner[rows] = b
    assert (owner >= 0).all()
    chunks, seen = n // plan.vec, []
    for j in range(plan.cols):
        count = min(plan.per, chunks - j * plan.per)
        assert count > 0
        for k in range(plan.units):
            for lane in range(plan.lanes):
                u = k * plan.lanes + lane
                if u < count:
                    first = (j * plan.per + u) * plan.vec
                    seen.extend(range(first, first + plan.vec))
    assert sorted(seen) == list(range(n))


@pytest.mark.parametrize("m,n", [(19464, 384), (1200, 3072), (700, 300),
                                 (5001, 96)])
def test_the_column_sums_in_block_order_match_f64(m, n):
    """The gated column sums as ``colsum_kernel`` and
    ``ordered_sum_kernel`` take them (each group's rows in turn, gain times
    row; the groups of a warp by the butterfly, the warps' tree; each column
    group's part of the row block's partial; the blocks in order) are within
    1e-5 of the f64 sums; a second pass gives the same bits."""
    rng = np.random.default_rng(m + n)
    rps = -(-m // 3)
    gains = np.linspace(0.6, 1.4, 3).astype(np.float32)
    a = rng.standard_normal((m, n)).astype(np.float32)
    terms = (gains[np.arange(m) // rps][:, None] * a).astype(np.float32)
    plan = _colsum_plan(m, n)
    lanes = Plan(plan.vec, plan.lanes, plan.units, plan.run, plan.blocks)

    def ordered():
        part = np.stack([
            _block_sums(terms[b * plan.run:(b + 1) * plan.run], lanes)
            for b in range(plan.blocks)])
        return _ordered(part)

    got = ordered()
    want = terms.astype(np.float64).sum(0)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(terms).sum(0).max()
    assert np.array_equal(got, ordered())


@pytest.mark.parametrize("c", [96, 300, 1536])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ln_rows_plain_version_matches_jax(dtype, c):
    """``ln_rows_reference`` (on the CPU ``ln_rows_launch``) against JAX
    ``_ln_fwd`` (:75) on the same seeded rows: y rounded to the activation
    type within TOL of its scale (bf16: one rounding step where the f32
    values round apart), the mean and 1 / std within 1e-5."""
    v = _rows(c, dtype, seed=200 + c)
    x = jnp.asarray(v["x"])
    y, _, rstd = jk._ln_fwd(x, jnp.asarray(v["w"]), jnp.asarray(v["b"]))
    tdt = getattr(torch, dtype)
    got_y, got_stats = port.ln_rows_launch(_torch(v["x"], tdt),
                                           _torch(v["w"]), _torch(v["b"]))
    assert got_y.dtype == tdt and got_stats.shape == (M, 2)
    _close(got_y.float(), _torch(np.asarray(y)).to(tdt).float(), TOL[dtype])
    _close(got_stats[:, 0], jnp.mean(x, axis=-1), TOL["float32"])
    _close(got_stats[:, 1], np.asarray(rstd)[:, 0], TOL["float32"])


@pytest.mark.parametrize("c", [96, 300, 1536])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_colsum_plain_version_matches_jax(dtype, c):
    """``colsum_reference`` (on the CPU ``colsum_launch``) against the JAX
    bias gradients on the same seeded rows, within 1e-5 of their scale: the
    gated sum over do_res in the activation type (``jnp.sum(gb * do_res,
    axis=0)``, dbproj :401-418 and db2 :933-950) and the f32 sum over dh1
    at hidden = 4C (``jnp.sum(dh1, axis=0)``, db1 :963)."""
    v = _rows(c, dtype, seed=300 + c)
    do = jnp.repeat(jnp.asarray(v["gb"]), RPS)[:, None] * v["do_res"]
    tdt = getattr(torch, dtype)
    got = port.colsum_launch(_torch(v["do_res"], tdt), _torch(v["gb"]), RPS)
    assert got.dtype == torch.float32 and got.shape == (c,)
    _close(got, jnp.sum(do, axis=0), TOL["float32"])
    dh1 = np.random.default_rng(c).standard_normal((M, 4 * c)).astype(
        np.float32)
    _close(port.colsum_launch(_torch(dh1)), jnp.sum(jnp.asarray(dh1), axis=0),
           TOL["float32"])
