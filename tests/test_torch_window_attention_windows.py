"""V3, the port's ``window_attention_windows`` on the unpartitioned qkv map,
against the JAX package's ``fused_window_attention_windows`` Pallas kernel,
run in interpret mode on the CPU as tests/test_window_attention_kernel.py
runs it, forward and ``jax.vjp`` (dqkv, dbias).

On CPU tensors the port's Function runs its plain forward (partition, K4's
plain forward with the ids expanded to one row per window of a sample,
reverse) and the explicit plain backward, which the CUDA kernels V3f/V3b are
held to on the card. The ids-row rule is the window's flat index within its
sample modulo W (vsn_tpu/ops/window_attention.py:399, :479), not K4's
global bw % W: the case of 3 id rows over 8 windows per sample pins it.

The slice as a whole: a tiny DynamicTanh Swin, weights carried over from
the JAX initializer by ``convert.state_dict_from_jax``, gives a block's
rolled (and padded) qkv map, its expanded bias and its region ids; on them
V3 equals the block's own route (partition -> ``window_attention_qkv`` ->
reverse) and JAX's V3.

Tolerances as tests/test_torch_window_attention_qkv.py: f32 1e-5 (rtol and
atol), sums in another order; bf16 2e-2 of each output's own scale (one
bf16 rounding step of a result both sides compute in f32).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F

from vsn_tpu.config import load_config as jax_load_config
from vsn_tpu.models import build_model as jax_build_model
from vsn_tpu.models.swin3d import (
    padded_window_region_ids,
    shifted_window_region_ids,
)
from vsn_tpu.ops.window_attention import fused_window_attention_windows
from vsn_tpu_torch.config import load_config
from vsn_tpu_torch.convert import state_dict_from_jax
from vsn_tpu_torch.models import build_model
from vsn_tpu_torch.models import swin3d
from vsn_tpu_torch.ops import window_attention as port

TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _ids(kind, rng):
    """(map dims, window, region ids [W, N])."""
    if kind == "shifted":
        dims, window = (4, 4, 4), (2, 2, 2)
        return dims, window, shifted_window_region_ids(dims, window, (1, 1, 1))
    if kind == "rect":      # unshifted, a different number of windows per axis
        return (4, 6, 2), (2, 3, 2), np.zeros((1, 12), np.int32)
    if kind == "padded":    # 3x5x3 padded to 4x6x4; pad slots carry -1
        ids = padded_window_region_ids((3, 5, 3), (2, 3, 2), (1, 1, 1))
        assert (ids == -1).any()
        return (4, 6, 4), (2, 3, 2), ids
    # W = 3 distinct rows over nW = 8 windows per sample: W does not divide nW
    ids = rng.integers(0, 3, (3, 8)).astype(np.int32)
    assert len({tuple(r) for r in ids}) == 3
    return (4, 4, 4), (2, 2, 2), ids


def _case(kind, heads, seed, b=2):
    """(qkv [B, D, H, W, 3C], bias [H, N, N], ids, window, dout [B, D, H, W,
    C]) at head dim 4, O(1) logits."""
    rng = np.random.default_rng(seed)
    dims, window, ids = _ids(kind, rng)
    n, c = int(np.prod(window)), 4 * heads
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return (1.5 * f(b, *dims, 3 * c), f(heads, n, n), ids, window,
            f(b, *dims, c))


def _jax(qkv, bias, ids, window, dout, heads, dtype):
    scale = (qkv.shape[-1] // (3 * heads)) ** -0.5
    fn = lambda a, b: fused_window_attention_windows(
        a, b, jnp.asarray(ids), scale, heads, tuple(window))
    out, vjp = jax.vjp(fn, jnp.asarray(qkv).astype(dtype), jnp.asarray(bias))
    dqkv, dbias = vjp(jnp.asarray(dout).astype(dtype))
    return [np.asarray(t.astype(jnp.float32)) for t in (out, dqkv, dbias)]


def _port(fn, qkv, bias, ids, window, dout, heads, dtype):
    scale = (qkv.shape[-1] // (3 * heads)) ** -0.5
    a = torch.from_numpy(qkv).to(dtype).requires_grad_()
    b = torch.from_numpy(bias).requires_grad_()
    out = fn(a, b, torch.from_numpy(ids), scale, heads, window)
    assert out.dtype == dtype and out.shape == dout.shape
    dqkv, dbias = torch.autograd.grad(out, [a, b],
                                      torch.from_numpy(dout).to(dtype))
    assert dqkv.dtype == dtype and dbias.dtype == torch.float32
    return [t.detach().float().numpy() for t in (out, dqkv, dbias)]


def _close(got, want, dtype):
    for name, g, w in zip(("out", "dqkv", "dbias"), got, want):
        assert np.isfinite(g).all(), name
        if dtype == "float32":
            np.testing.assert_allclose(g, w, rtol=TOL[dtype], atol=TOL[dtype],
                                       err_msg=name)
        else:
            err = np.abs(g - w).max()
            assert err <= TOL[dtype] * np.abs(w).max(), (name, err)


CASES = {  # name -> (ids kind, heads, dtype)
    "shifted": ("shifted", 2, "float32"),
    "unshifted_rect": ("rect", 3, "float32"),
    "padded": ("padded", 2, "float32"),
    "w3_of_8_windows": ("w3", 2, "float32"),
    "bf16_shifted": ("shifted", 2, "bfloat16"),
    "bf16_w3_of_8_windows": ("w3", 3, "bfloat16"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_and_vjp_match_jax(case):
    kind, heads, dtype = CASES[case]
    args = _case(kind, heads, seed=len(case))
    want = _jax(*args, heads, getattr(jnp, dtype))
    got = _port(port.window_attention_windows, *args, heads,
                getattr(torch, dtype))
    _close(got, want, dtype)


def test_ids_row_is_the_flat_index_within_the_sample():
    """With 3 id rows over 8 windows per sample, window r of sample b uses
    row r % 3; K4's rule over the partitioned windows (row (b * 8 + r) % 3)
    gives another result for the second sample."""
    qkv, bias, ids, window, _ = _case("w3", 2, seed=4)
    t = torch.from_numpy
    scale = 0.5
    got = port.window_attention_windows(t(qkv), t(bias), t(ids), scale, 2,
                                        window)
    wins = swin3d.window_partition(t(qkv), window)
    rows = torch.arange(wins.shape[0]) % 3
    local = swin3d.window_reverse(port.window_attention_qkv_math(
        wins, t(bias), port.window_ids(t(ids), 8).repeat(2, 1), scale, 2),
        window, qkv.shape[1:4])
    global_rule = swin3d.window_reverse(port.window_attention_qkv_math(
        wins, t(bias), t(ids)[rows], scale, 2), window, qkv.shape[1:4])
    torch.testing.assert_close(got, local, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(got[0], global_rule[0], rtol=1e-6, atol=1e-6)
    assert (got[1] - global_rule[1]).abs().max() > 0.1


@pytest.mark.parametrize("kind", ["shifted", "w3"])
def test_plain_backward_equals_autograd(kind):
    args = _case(kind, 2, seed=3)
    got = _port(port.window_attention_windows_reference, *args, 2,
                torch.float32)
    want = _port(port.window_attention_windows_math, *args, 2, torch.float32)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)


TINY = dict(IMG_SIZE=[12, 18, 12], PATCH_SHAPE=[2, 2, 2],
            WINDOW_SIZE=[2, 3, 2], EMBED_DIM=8, DEPTH=[2, 2, 2],
            HEADS=[1, 2, 4], FP16=False, STOCHASTIC_DEPTH_PROB=0.0,
            NORM_LAYER="DynamicTanh")


def _perturb(path, leaf, rng):
    """O(1) qkv values and biases (qkv kernels x 8, the relative-position
    tables x 50, as tests/test_torch_swin_unfused.py scales them) and DyT
    parameters away from their init."""
    name = jax.tree_util.keystr(path)
    leaf = np.asarray(leaf)
    if "relative_position_bias_table" in name:
        return leaf * 50.0
    if "qkv" in name and "kernel" in name:
        return leaf * 8.0
    z = rng.standard_normal(leaf.shape).astype(np.float32)
    if name.endswith("'alpha']"):
        return np.float32(1.5) + 0.2 * z
    if name.endswith(("'gamma']", "'beta']")):
        return leaf + 0.2 * z
    return leaf


@pytest.fixture(scope="module")
def dyt_blocks():
    """Every unfused block of a tiny DynamicTanh Swin's eval forward, with
    its input: [(block, x, ids)]; weights from the JAX initializer, made
    non-trivial by ``_perturb``."""
    jmodel = jax_build_model(jax_load_config(extra_overrides=TINY))
    x0 = np.zeros((1, 12, 18, 12, 1), np.float32)
    variables = jax.jit(lambda k, x: jmodel.init(k, x, True))(
        jax.random.key(0), x0)
    rng = np.random.default_rng(1)
    variables = jax.tree_util.tree_map_with_path(
        lambda p, v: _perturb(p, v, rng), variables)
    model = build_model(load_config(TINY), device="cpu")
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    seen = []
    unfused = swin3d.SwinBlock3D.forward_unfused

    def record(blk, x, ids, gains, masks):
        seen.append((blk, x.detach().clone(), ids))
        return unfused(blk, x, ids, gains, masks)

    x = np.random.default_rng(0).standard_normal((2, 12, 18, 12, 1))
    with torch.no_grad(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(swin3d.SwinBlock3D, "forward_unfused", record)
        model(torch.from_numpy(x.astype(np.float32)))
    assert len(seen) == 6
    return seen


@pytest.mark.parametrize("index,kind", [(1, "shifted"), (3, "padded")])
def test_dyt_block_map_matches_the_block_route_and_jax(dyt_blocks, index,
                                                       kind):
    """Block 1 (stage 1, shifted) and block 3 (stage 2, padded 3x5x3 ->
    4x6x4, shifted): on the block's rolled qkv map, V3 equals partition ->
    K4 -> reverse and JAX's V3, forward and VJP."""
    blk, x, ids = dyt_blocks[index]
    assert any(blk.shift) and ((ids < 0).any() == (kind == "padded"))
    with torch.no_grad():
        h_in = swin3d.roll3d(blk.norm1(x), tuple(-s for s in blk.shift))
        qkv = F.linear(h_in, blk.attn.qkv.weight, blk.attn.qkv.bias)
        bias = blk.attn.bias()
    heads, window, dims = blk.attn.num_heads, blk.window, qkv.shape[1:4]

    def route(a, b, ids_, scale, heads_, window_):
        wins = swin3d.window_partition(a, window_)
        out = port.window_attention_qkv(wins, b, ids_, scale, heads_)
        return swin3d.window_reverse(out, window_, dims)

    dout = np.random.default_rng(index).standard_normal(
        (*qkv.shape[:4], qkv.shape[4] // 3)).astype(np.float32)
    args = (qkv.numpy(), bias.numpy(), ids.numpy(), window, dout, heads)
    got = _port(port.window_attention_windows, *args, torch.float32)
    assert np.abs(got[0]).max() > 0.1 and np.abs(got[2]).max() > 0
    _close(got, _port(route, *args, torch.float32), "float32")
    _close(got, _jax(*args, jnp.float32), "float32")


def test_argument_check_rejects_what_the_kernels_do_not_take():
    qkv, bias, ids, window, _ = _case("padded", 2, seed=2)
    t = torch.from_numpy
    assert port._check_windows(t(qkv), t(bias), t(ids), 2, window) == 8
    # head dims 40 (neither up to 32 nor a multiple of 16), 129 and 144
    # (above 128: the slab kernels), taken
    for c, heads in ((80, 2), (258, 2), (144, 1)):
        assert port._check_windows(torch.zeros(2, 4, 6, 4, 3 * c),
                                   t(bias)[:heads], t(ids), heads,
                                   window) == 8
    bad = {  # what the kernels do not take -> (qkv, bias, ids, heads, window)
        "map 4x6x4 over a 3x3x2 window": (t(qkv), t(bias), t(ids), 2,
                                          (3, 3, 2)),
        "head dim 8193": (torch.zeros(2, 4, 6, 4, 3 * 8193), t(bias)[:1],
                          t(ids), 1, window),
        "3C not divisible by 3 heads": (t(qkv), t(bias), t(ids), 3, window),
        "f16 qkv": (t(qkv).half(), t(bias), t(ids), 2, window),
        "f64 bias": (t(qkv), t(bias).double(), t(ids), 2, window),
        "int64 ids": (t(qkv), t(bias), t(ids).long(), 2, window),
        "ids of another N": (t(qkv), t(bias), t(ids)[:, :-1].contiguous(), 2,
                             window),
        "no id rows": (t(qkv), t(bias), t(ids)[:0], 2, window),
        "partitioned qkv": (t(qkv).reshape(-1, 12, qkv.shape[-1]), t(bias),
                            t(ids), 2, window),
    }
    for what, args in bad.items():
        with pytest.raises((TypeError, ValueError)):
            port._check_windows(*args)
            pytest.fail(what)


@pytest.mark.parametrize("d", [48, 64])
def test_argument_check_takes_the_tiled_head_dims(d):
    """Head dims 48 and 64, multiples of 16 past 32, which the tiled body
    takes."""
    _, bias, ids, window, _ = _case("padded", 2, seed=2)
    t = torch.from_numpy
    qkv = torch.zeros(2, 4, 6, 4, 3 * 2 * d)
    assert port._check_windows(qkv, t(bias), t(ids), 2, window) == 8
