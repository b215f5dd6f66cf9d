"""The plain versions of the LayerNorm-backward launches of K1b / K2b alone
(``ln_backward_rows_reference``, ``postnorm_backward_rows_reference``; on the
CPU ``ln_bwd_launch`` and ``postnorm_bwd_launch`` run them) against the JAX
package's own arithmetic, and a numpy replay of the CUDA body's row plan
(csrc/common.cuh ``ln_bwd_plan``, its constants read from the source) and
of the order in which it sums dw / db.

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
other orders); bf16 dx 1e-2 (an f32 value a few ulps apart may round to the
neighbouring bf16 value, 2^-8 of it).
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
WIDTHS = (8, 24, 96, 384)
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


WARPS, MAX_BLOCKS, MIN_STEPS = (_constant(n) for n in (
    "kLnBwdWarps", "kLnBwdMaxBlocks", "kLnBwdMinSteps"))


class Plan(NamedTuple):
    vec: int
    lanes: int
    units: int
    run: int
    blocks: int


def _plan(m, c):
    """common.cuh ``ln_bwd_plan`` of an [m, c] call, a function of (m, c)
    alone: a lane group (a power of two of lanes, at most 32) owns a row,
    each lane up to 4 units of 8 columns (up to 8 single columns); block b
    takes rows [b * run, (b + 1) * run), run a multiple of the block's step
    (WARPS warps of 32 / lanes rows) of at least MIN_STEPS steps, with at
    most MAX_BLOCKS blocks. None where the body does not take c."""
    if m < 1 or c < 1:
        return None
    vec = 8 if c % 8 == 0 else 1
    chunks = c // vec
    lanes = 32
    if vec == 8:
        lanes = 1
        while lanes < 32 and 3 * lanes < chunks:
            lanes *= 2
    units = -(-chunks // lanes)
    if vec == 1:
        units = next(u for u in (1, 2, 4, 8, units) if u >= units)
    if units > (4 if vec == 8 else 8):
        return None
    step = WARPS * (32 // lanes)
    run = max(-(-m // MAX_BLOCKS), MIN_STEPS * step)
    run = -(-run // step) * step
    return Plan(vec, lanes, units, run, -(-m // run))


def test_the_replayed_plan_reads_the_sources_constants():
    """The replay's constants are common.cuh's (8 warps, 2 x 132 blocks, 2
    steps), and the source's plan rejects what the replay rejects."""
    assert (WARPS, MAX_BLOCKS, MIN_STEPS) == (8, 264, 2)
    assert "if (p->units > (p->vec == 8 ? 4 : 8)) return false;" in COMMON


# (M, C): Swin-T's stage-1 call at micro-batch 8 and its stage-4 one, ViT-S
# at micro-batch 24, the test widths, a width of single columns, and a
# call smaller than one block step
PLAN_CASES = [(435456, 96), (1200, 768), (19464, 384), (111, 8), (111, 24),
              (4000, 384), (300, 12), (5, 96)]


@pytest.mark.parametrize("m,c", PLAN_CASES)
def test_the_row_plan_covers_every_row_once(m, c):
    """Block b runs rows [b * run, min((b + 1) * run, M)): every row in one
    run, no run empty, at most 264 blocks; a run is whole block steps (8
    warps of 32 / lanes rows); a lane group's units cover C; the plan is a
    function of (M, C) alone."""
    plan = _plan(m, c)
    assert plan == _plan(m, c)
    step = 8 * (32 // plan.lanes)
    assert plan.run % step == 0 and plan.run >= 2 * step
    assert plan.blocks <= 264 and plan.lanes & (plan.lanes - 1) == 0
    assert plan.units * plan.lanes * plan.vec >= c
    assert plan.vec == (8 if c % 8 == 0 else 1)
    owner = np.full(m, -1)
    for b in range(plan.blocks):
        rows = np.arange(b * plan.run, min((b + 1) * plan.run, m))
        assert rows.size and (owner[rows] == -1).all()
        owner[rows] = b
    assert (owner >= 0).all()


def test_the_plan_rejects_widths_the_body_does_not_take():
    assert _plan(10, 1032) is None      # 129 chunks of 8
    assert _plan(10, 300) is None       # 300 single columns
    assert _plan(10, 1024).units == 4
    assert _plan(10, 250).units == 8


def _block_sums(a, plan):
    """One block's partial sums of the [rows, C] terms ``a`` (f32), in the
    body's order: each lane group adds its rows in turn; the groups of a
    warp meet by the butterfly (xor of 1, 2, ... groups); warps [h, 2h) add
    theirs into warps [0, h), h = 4, 2, 1."""
    per_warp = 32 // plan.lanes
    groups = 8 * per_warp
    iters = -(-a.shape[0] // groups)
    t = np.zeros((iters * groups, a.shape[1]), np.float32)
    t[:a.shape[0]] = a
    acc = np.zeros((groups, a.shape[1]), np.float32)
    for i in range(iters):
        acc = acc + t[i * groups:(i + 1) * groups]
    acc = acc.reshape(8, per_warp, -1)
    o = 1
    while o < per_warp:
        acc = acc + acc[:, np.arange(per_warp) ^ o]
        o *= 2
    warps = acc[:, 0]
    h = 4
    while h:
        warps = warps[:h] + warps[h:2 * h]
        h //= 2
    return warps[0]


@pytest.mark.parametrize("m,c", [(1200, 768), (19464, 384), (4000, 96),
                                 (111, 24)])
def test_the_ordered_sum_of_partials_matches_f64(m, c):
    """dw's sum as the body and ``ln_bwd_sum_kernel`` take it (block
    partials, then block g in slice g mod 32, each slice in block order,
    the slices in order) is within 1e-5 of the f64 sum; a second pass gives
    the same bits."""
    rng = np.random.default_rng(m + c)
    terms = (rng.standard_normal((m, c)) * rng.standard_normal((m, 1))
             ).astype(np.float32)
    plan = _plan(m, c)

    def ordered():
        part = np.stack([_block_sums(terms[b * plan.run:(b + 1) * plan.run],
                                     plan) for b in range(plan.blocks)])
        slices = []
        for s in range(32):
            acc = np.zeros(c, np.float32)
            for g in range(s, plan.blocks, 32):
                acc = acc + part[g]
            slices.append(acc)
        out = slices[0]
        for s in range(1, 32):
            out = out + slices[s]
        return out

    got = ordered()
    want = terms.astype(np.float64).sum(0)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(terms).sum(0).max()
    assert np.array_equal(got, ordered())
