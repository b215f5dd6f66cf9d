"""The post-norm forward's finish and the pre-norm LayerScale gradients of
K1 / K2 (``postnorm_fwd_reference``, ``layerscale_grads_reference``: the
plain versions of csrc/common.cuh ``postnorm_fwd_kernel`` and
``layerscale_grads_kernel``, which the wrappers run for CPU tensors)
against the JAX package on the CPU, on inputs drawn from a numpy seed:

- the finish against _ln_fwd (vsn_tpu/ops/swin_block_kernels.py:75)
  composed with gamma and the per-sample gains as _attn_fwd_kernel does it
  (:284-288, _apply_gains over one slot a sample), then ``lam * x +``;
- the LayerScale gradients against the expressions of _attn_bwd_kernel
  (:404-415), whose weights are (in, out) where the port's are torch's
  (out, in): dgamma += colsum(W * M) + b * s, dW = M * gamma, db = s *
  gamma.

At C = 96 (Swin-T's stage 1), 300 (not a multiple of 8) and 1536, K = C
and 4C. "bfloat16" is the activations' type: x and out of the finish are
bf16; the LayerScale gradients' operands are f32 in both (parameters and
their gradients), there on values rounded to bf16, as a bf16 pass's
products leave them. Tolerances: the finish's f32 out within 1e-5 of its
scale (the same f32 expressions, rsqrt against 1 / sqrt), its bf16 out
within one bf16 step of its scale (2^-8: an f32 value that rounds the
other way); dW and db equal (one f32 product each), dgamma within 1e-5 of
its scale (the row's sums in another order). Then numpy replays of the
LayerScale gradients' launch plan (csrc/common.cuh ``ls_plan``) and of
its shifted reads of W.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vsn_tpu.ops import swin_block_kernels as jsbk
from vsn_tpu_torch.ops import swin_block_kernels as sbk

WIDTHS = [96, 300, 1536]
SAMPLES, RPS = 3, 70   # rows of three samples
LAM = 0.9129           # DeepScaleLM's lambda at depth 12
OUT_TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -8}


def _scale_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(1.0, np.abs(want).max())


def _as_dtype(a, dtype):
    """``a`` (f32) rounded to ``dtype``, as f32 values."""
    return torch.from_numpy(a).to(getattr(torch, dtype)).float().numpy()


@pytest.mark.parametrize("gamma", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c", WIDTHS)
def test_postnorm_fwd_reference_matches_jax(c, dtype, gamma):
    rng = np.random.default_rng(c)
    m = SAMPLES * RPS
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    branch = 2 * f32(m, c) - 0.5 + f32(m, 1)
    x = _as_dtype(f32(m, c), dtype)
    w, b, gm = 1 + 0.1 * f32(c), 0.1 * f32(c), 0.5 + 0.1 * f32(c)
    gains = np.linspace(0.6, 1.4, SAMPLES).astype(np.float32)

    bn, _, _ = jsbk._ln_fwd(jnp.asarray(branch), jnp.asarray(w),
                            jnp.asarray(b))
    if gamma:
        bn = bn * jnp.asarray(gm)
    want = LAM * jnp.asarray(x) + jsbk._apply_gains(
        [jnp.float32(g) for g in gains], bn, RPS)
    want = np.asarray(want.astype(getattr(jnp, dtype)).astype(jnp.float32))

    t = torch.from_numpy
    got = sbk.postnorm_fwd_reference(
        t(branch), t(x).to(getattr(torch, dtype)), t(w), t(b),
        t(gm) if gamma else None, t(gains), RPS, LAM)
    assert got.dtype == getattr(torch, dtype) and got.shape == (m, c)
    assert _scale_err(got.float().numpy(), want) <= OUT_TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hidden", [1, 4])   # K = C (proj), 4C (fc2)
@pytest.mark.parametrize("c", WIDTHS)
def test_layerscale_grads_reference_matches_jax(c, hidden, dtype):
    rng = np.random.default_rng(7 * c + hidden)
    n, k = c, hidden * c
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    w = _as_dtype(k ** -0.5 * f32(n, k), dtype)     # [out, in]
    m = _as_dtype(f32(n, k), dtype)                 # M = do^T @ a
    bias, gm = 0.1 * f32(n), 0.5 + 0.1 * f32(n)
    s, dgamma0 = f32(n), f32(n)

    # _attn_bwd_kernel :404-415 on the (in, out) layout
    w_io, m_io = jnp.asarray(w.T), jnp.asarray(m.T)
    j_dgamma = jnp.asarray(dgamma0) + (jnp.sum(w_io * m_io, axis=0)
                                       + jnp.asarray(bias) * jnp.asarray(s))
    j_dw = (m_io * jnp.asarray(gm)).T
    j_db = jnp.asarray(s) * jnp.asarray(gm)

    t = torch.from_numpy
    dw, db, dgamma = sbk.layerscale_grads_reference(
        t(w), t(bias), t(gm), t(m), t(s), t(dgamma0))
    assert np.array_equal(dw.numpy(), np.asarray(j_dw))
    assert np.array_equal(db.numpy(), np.asarray(j_db))
    assert _scale_err(dgamma.numpy(), j_dgamma) <= 1e-5


# ---------------------------------------------------------------------------
# A numpy replay of the LayerScale gradients' launch plan (csrc/common.cuh
# ``ls_plan``), its constants read from the source, and of the body's
# shifted W reads (``load_shifted``)
# ---------------------------------------------------------------------------

COMMON = (Path(__file__).resolve().parents[1] / "vsn_tpu_torch" / "csrc"
          / "common.cuh").read_text()


def _constant(name):
    return int(re.search(rf"constexpr int {name} = ([0-9]+);",
                         COMMON).group(1))


LS_THREADS, LS_UNITS, LS_MAX_SLICES, LS_MIN_BLOCKS = (
    _constant(n) for n in ("kLsThreads", "kLsUnits", "kLsMaxSlices",
                           "kLsMinBlocks"))


def _ls_plan(n, k, vec):
    """``ls_plan`` of an [n, k] call whose units are ``vec`` columns (4: k a
    multiple of 4 and dw 16-byte aligned; else 1): (units, lanes, rows,
    slices, per)."""
    units = k // vec
    slices = 1
    while (slices < LS_MAX_SLICES and n * slices < LS_MIN_BLOCKS
           and units >= 16 * slices):
        slices *= 2
    per = -(-units // slices)
    lanes = 32
    while lanes < LS_THREADS and LS_UNITS * lanes < per:
        lanes *= 2
    rows = 1
    while (2 * rows * lanes <= LS_THREADS
           and -(-n // (2 * rows)) * slices >= LS_MIN_BLOCKS):
        rows *= 2
    return units, lanes, rows, slices, per


# (N, K) of every LayerScale-gradient launch of Swin-T (proj C x C and fc2
# C x 4C at C = 96-768) and ViT-S (C = 384)
LS_MAIN_PATH = [(c, h * c) for c in (96, 192, 384, 768) for h in (1, 4)]


def test_the_replayed_ls_plan_reads_the_sources_constants():
    assert (LS_THREADS, LS_UNITS, LS_MAX_SLICES, LS_MIN_BLOCKS) == (
        256, 4, 8, 132)
    assert "p->units >= 16 * p->slices)" in COMMON
    assert "kLsUnits * p->lanes < p->per" in COMMON


@pytest.mark.parametrize("n,k", LS_MAIN_PATH)
def test_every_sm_has_a_block_at_the_main_paths_shapes(n, k):
    """At least 132 blocks of at most 256 threads at every Swin-T / ViT-S
    shape; rows split into slices (a cluster of at most 8 blocks) only
    below 132 rows."""
    units, lanes, rows, slices, per = _ls_plan(n, k, 4)
    assert slices * -(-n // rows) >= LS_MIN_BLOCKS
    assert lanes * rows <= LS_THREADS and rows * lanes >= 32
    assert (slices > 1) == (n < LS_MIN_BLOCKS) and slices <= LS_MAX_SLICES


@pytest.mark.parametrize("n,k,vec", [*[(n, k, 4) for n, k in LS_MAIN_PATH],
                                     (64, 12288, 4), (8, 32768, 4),
                                     (37, 150, 1), (5, 7, 1), (192, 768, 1)])
def test_the_ls_plan_covers_every_unit_of_every_row_once(n, k, vec):
    """Block (slice s, row tile t), lane group g, lane l: the units s * per
    + l + j * lanes (j = 0, 1, ... below the slice's end) of row t * rows +
    g; every unit of every row exactly once, for any K (above 8192 too)."""
    units, lanes, rows, slices, per = _ls_plan(n, k, vec)
    seen = np.zeros((n, units), int)
    for s in range(slices):
        u0, u1 = s * per, min((s + 1) * per, units)
        for t in range(-(-n // rows)):
            for g in range(rows):
                o = t * rows + g
                if o >= n:
                    continue
                for lane in range(lanes):
                    us = np.arange(u0 + lane, u1, lanes)
                    seen[o, us] += 1
    assert (seen == 1).all() and units * vec == k


@pytest.mark.parametrize("shift", [0, 1, 2, 3])
def test_shifted_w_reads_pick_the_units_columns(shift):
    """A row starting ``shift`` floats past a 16-byte boundary: the aligned
    vector u and, shifted, u + 1 give the unit's columns 4u .. 4u + 3."""
    k = 24
    storage = np.arange(k + 8, dtype=np.float32)   # W at [shift:]
    row = storage[shift:shift + k]
    wa = storage.reshape(-1, 4)
    for u in range(k // 4):
        a, b = wa[u], wa[u + 1]
        got = np.concatenate([a, b])[shift:shift + 4]
        assert np.array_equal(got, row[4 * u:4 * u + 4])
