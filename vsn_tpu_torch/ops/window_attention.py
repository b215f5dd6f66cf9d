"""Window attention: K4, V1 and V3 (port of vsn_tpu/ops/window_attention.py).

Three entry points compute one function on three operand layouts,

    out[bw, i, h] = sum_j p[bw, h, i, j] v[bw, j, h],
    p = softmax_j(q[bw, i, h] . k[bw, j, h] * scale + bias[h, i, j]
                  + mask(ids[row(bw)])[i, j]):

- ``window_attention_qkv`` (K4, the port of ``fused_window_attention_qkv``):
  the attention core of an unfused Swin block, between its qkv and proj
  Linears, read from the qkv Linear's output [BW, N, 3C] (channels [q_h0..
  q_hH | k_h0..k_hH | v_h0..v_hH], head dim C/H) and written merged-head
  [BW, N, C]; row(bw) = bw % W;
- ``window_attention`` (V1, ``fused_window_attention``): split q, k, v and
  out [BW, H, N, d]; row(bw) = bw % W;
- ``window_attention_windows`` (V3, ``fused_window_attention_windows``):
  qkv read from the unpartitioned (rolled, padded) map [B, D, H, W, 3C]
  and out written to [B, D, H, W, C]; window (i, j, k) of each sample on
  row flat(i, j, k) % W.

Each is a ``torch.autograd.Function``: for a tensor on a CUDA device it
launches its kernels forward and backward; for a tensor on the CPU it runs
the plain forward and the explicit plain backward. It never falls back from
one to the other.

All three launch the key-tiled tensor-core body (``csrc/attn_tiled.cuh``,
bf16 mma.sync; FMA product steps in f32) under K4's softmax policy
(``csrc/window_attention_qkv.cu``): the plain row max, the plain row sum,
the TPU kernel's score (dot * scale + bias) + mask; each on its operand
layout (``Packed``, ``Split``, ``MapRows``), so V1f and V3f give K4f's
output bit for bit on the same values. The forward also writes each row's
statistics (max, 1 / sum) [BW, H, N, 2] and, for bf16, the f32 output o
in the output's layout; autograd keeps them, and the backward reads them
(p = exp(s - max) / sum, s1 = dO . o) instead of recomputing the softmax.
e, p and ds are rounded to the activation type before their products.
Head dims: every d from 1 to 8192 (above 128 on the body's slab kernels,
``kSlab`` channels at a time; above 8192 the wrappers raise).
``window_attention_qkv_launch`` / ``window_attention_launch`` /
``window_attention_windows_launch`` are the forwards with their kept
state, and ``*_backward_launch`` the backwards from it; their plain
versions are ``*_kept_reference`` and ``*_kept_backward_reference``
(V1's and V3's: K4's on the heads merged or the windows partitioned).

Everywhere the mask is additive -1e9 where region ids differ; pad slots
carry id -1. The backward gives the input gradients in the input's dtype
and dbias summed over every window in f32; ids and the static arguments
get no gradient.

``*_reference`` are the plain versions on any device (the plain forward,
and ``*_backward_reference`` as its backward; V1's and V3's are K4's on the
heads merged or the windows partitioned); ``mask_from_ids`` and
``window_attention_reference`` (the softmax on split heads with
``torch.softmax``) are plain helpers that other plain versions share.
"""

from __future__ import annotations

import math

import torch

from vsn_tpu_torch.ops._build import (
    check,
    expect,
    launches,
    library,
    ptr,
    stream_of,
)

NEG_INF = -1e9
MAX_HEAD_DIM = 8192  # the slabs' widest (csrc/attn_tiled.cuh kMaxSlabHeadDim)
TILED_HEAD_DIM = 128  # the body's widest head (kMaxHeadDim); above, its slabs


def mask_from_ids(ids: torch.Tensor) -> torch.Tensor:
    """[..., N] int32 region ids -> additive [..., N, N] f32 mask (different
    region => -1e9)."""
    diff = ids[..., :, None] != ids[..., None, :]
    return torch.where(diff, NEG_INF, 0.0).to(torch.float32)


def window_attention_reference(q, k, v, bias, ids, scale):
    """softmax(q k^T * scale + bias + mask(ids)) v with the standard
    max-subtracted softmax, in f32.

    q, k, v: [BW, H, N, d]; bias: [H, N, N]; ids: [W, N] (window bw uses row
    bw % W). Returns [BW, H, N, d] in q's dtype."""
    bw = q.shape[0]
    mask = mask_from_ids(ids)[torch.arange(bw, device=q.device) % ids.shape[0]]
    s = torch.einsum("bhid,bhjd->bhij", q.float(), k.float()) * scale
    s = s + bias[None] + mask[:, None]
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhij,bhjd->bhid", p, v.float()).to(q.dtype)


def _split_heads(qkv, n_heads):
    """[BW, N, 3C] -> q, k, v as f32 [BW, H, N, d]."""
    bw, n, c3 = qkv.shape
    parts = qkv.float().reshape(bw, n, 3, n_heads, c3 // (3 * n_heads))
    return parts.permute(2, 0, 3, 1, 4)


def _scores(q, k, bias, ids, scale):
    """s [BW, H, N, N] in f32, as _fwd_qkv_kernel forms it: (q k^T scale +
    bias) + mask(ids)."""
    rows = torch.arange(q.shape[0], device=q.device) % ids.shape[0]
    s = (q @ k.transpose(-1, -2)) * scale + bias[None]
    return s + mask_from_ids(ids)[rows][:, None]


def _probs(q, k, bias, ids, scale):
    """p [BW, H, N, N] in f32, as _fwd_qkv_kernel forms it."""
    s = _scores(q, k, bias, ids, scale)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return p / p.sum(dim=-1, keepdim=True)


def _rounded(t, dtype):
    """``t`` rounded to ``dtype`` (a product operand of the kernels), held
    as f32."""
    return t.to(dtype).float() if dtype == torch.bfloat16 else t


def window_attention_qkv_math(qkv, bias, ids, scale, n_heads):
    """The forward of ``window_attention_qkv`` in plain PyTorch ops
    (differentiable by autograd)."""
    bw, n, c3 = qkv.shape
    q, k, v = _split_heads(qkv, n_heads)
    out = _probs(q, k, bias, ids, scale) @ v                # [BW, H, N, d]
    return out.transpose(1, 2).reshape(bw, n, c3 // 3).to(qkv.dtype)


def window_attention_qkv_backward_reference(qkv, bias, ids, dout, scale,
                                            n_heads):
    """Plain VJP of ``window_attention_qkv``, mirroring _bwd_qkv_kernel:
    recompute p, then dv = p^T do, dp = do v^T, ds = p (dp - rowsum(p dp)),
    dq = ds k scale, dk = ds^T q scale. Returns (dqkv in qkv's dtype, dbias
    [H, N, N] f32 summed over every window)."""
    bw, n, c3 = qkv.shape
    q, k, v = _split_heads(qkv, n_heads)
    p = _probs(q, k, bias, ids, scale)
    do = dout.float().reshape(bw, n, n_heads, -1).transpose(1, 2)
    dv = p.transpose(-1, -2) @ do
    dp = do @ v.transpose(-1, -2)
    ds = p * (dp - (p * dp).sum(dim=-1, keepdim=True))
    dq = (ds @ k) * scale
    dk = (ds.transpose(-1, -2) @ q) * scale
    dbias = ds.sum(0)
    dqkv = torch.stack([dq, dk, dv]).permute(1, 3, 0, 2, 4)  # [BW, N, 3, H, d]
    return dqkv.reshape(bw, n, c3).to(qkv.dtype), dbias


def window_attention_qkv_kept_reference(qkv, bias, ids, scale, n_heads):
    """Plain version of K4f with its kept state: qkv [BW, N, 3C] -> (out
    [BW, N, C] in qkv's dtype, the row statistics [BW, H, N, 2] f32 (each
    row's max and 1 / its sum of exp(s - max)), o [BW, N, C] f32: out before
    its rounding). e = exp(s - max) is rounded to qkv's dtype before e v,
    as the kernel rounds it."""
    bw, n, c3 = qkv.shape
    q, k, v = _split_heads(qkv, n_heads)
    s = _scores(q, k, bias, ids, scale)
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    r = 1.0 / e.sum(dim=-1, keepdim=True)
    o = ((_rounded(e, qkv.dtype) @ v) * r).transpose(1, 2).reshape(
        bw, n, c3 // 3)
    return o.to(qkv.dtype), torch.cat([m, r], dim=-1), o


def window_attention_qkv_kept_backward_reference(qkv, dout, o, stats, bias,
                                                 ids, scale, n_heads):
    """Plain version of K4b from K4f's kept state: qkv [BW, N, 3C] and dout
    [BW, N, C] in the activation type, o [BW, N, C] f32 and the row
    statistics [BW, H, N, 2]; p = exp(s - max) / sum, s1 = dO . o, ds = p
    (dp - s1), dq = round(ds) k scale, dk = round(ds)^T q scale, dv =
    round(p)^T dO. Returns (dqkv in qkv's dtype, dbias [H, N, N] f32 summed
    over every window, from the unrounded ds)."""
    bw, n, c3 = qkv.shape
    dt = qkv.dtype
    q, k, v = _split_heads(qkv, n_heads)
    split = lambda t: t.float().reshape(bw, n, n_heads, -1).transpose(1, 2)
    do, oh = split(dout), split(o)
    p = torch.exp(_scores(q, k, bias, ids, scale) - stats[..., :1]) \
        * stats[..., 1:]
    s1 = (do * oh).sum(dim=-1, keepdim=True)
    ds = p * (do @ v.transpose(-1, -2) - s1)
    dsr = _rounded(ds, dt)
    dqkv = torch.stack([(dsr @ k) * scale,
                        (dsr.transpose(-1, -2) @ q) * scale,
                        _rounded(p, dt).transpose(-1, -2) @ do])
    dqkv = dqkv.permute(1, 3, 0, 2, 4).reshape(bw, n, c3)
    return dqkv.to(dt), ds.sum(0)


def body_key(name: str, d: int) -> str:
    """The launch counter of entry ``name`` at head dim ``d``: ``name``
    where the tiled body runs, ``name + "_slabs"`` where its slab kernels
    run (d above TILED_HEAD_DIM)."""
    return name + "_slabs" if d > TILED_HEAD_DIM else name


def takes_head_dim(d: int) -> bool:
    """Whether the tiled CUDA body (K1, K4, V1, V3) takes head dim ``d``:
    every d from 1 to 8192 (above 128 in slabs)."""
    return 0 < d <= MAX_HEAD_DIM


def _check(qkv, bias, ids, n_heads):
    """Validate K4's arguments; returns the number of id rows W."""
    if qkv.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"window_attention_qkv: qkv dtype {qkv.dtype} (f32 "
                        "or bf16)")
    bw, n, c3 = qkv.shape
    if c3 % (3 * n_heads) or not takes_head_dim(c3 // (3 * n_heads)):
        raise ValueError(f"window_attention_qkv: 3C={c3} over {n_heads} "
                         f"heads: K4 takes head dims up to {MAX_HEAD_DIM}")
    dev = qkv.device
    expect(qkv, "qkv", (bw, n, c3), qkv.dtype, dev)
    expect(bias, "bias", (n_heads, n, n), torch.float32, dev)
    w = ids.shape[0]
    expect(ids, "ids", (w, n), torch.int32, dev)
    if w == 0 or bw % w:
        raise ValueError(f"window_attention_qkv: {w} id rows for {bw} windows")
    return w


def window_attention_qkv_launch(qkv, bias, ids, scale, n_heads):
    """K4f with its kept state: (out [BW, N, C] in qkv's dtype, the row
    statistics [BW, H, N, 2] f32, o [BW, N, C] f32: out itself for f32
    qkv). The CUDA kernel (``csrc/window_attention_qkv.cu`` on
    ``csrc/attn_tiled.cuh``) for a CUDA tensor,
    ``window_attention_qkv_kept_reference`` for a CPU one."""
    if qkv.device.type == "cpu":
        return window_attention_qkv_kept_reference(qkv, bias, ids, scale,
                                                   n_heads)
    w = _check(qkv, bias, ids, n_heads)
    bw, n, c3 = qkv.shape
    dev = qkv.device
    out = torch.empty((bw, n, c3 // 3), dtype=qkv.dtype, device=dev)
    stats = torch.empty((bw, n_heads, n, 2), dtype=torch.float32, device=dev)
    o32 = (torch.empty((bw, n, c3 // 3), dtype=torch.float32, device=dev)
           if qkv.dtype == torch.bfloat16 else None)
    with torch.cuda.device(dev):
        err = library().vsn_window_attention_qkv_tiled_fwd(
            int(qkv.dtype == torch.bfloat16), qkv.data_ptr(), bias.data_ptr(),
            ids.data_ptr(), w, out.data_ptr(), ptr(o32), stats.data_ptr(), bw,
            n, c3 // 3, n_heads, float(scale), stream_of(qkv))
    check(err, "window_attention_qkv")
    launches[body_key("attention", c3 // (3 * n_heads))] += 1
    return out, stats, out if o32 is None else o32


def _backward_kernel(qkv, bias, ids, dout, o, stats, scale, n_heads,
                     dbias=True):
    """K4b: launch ``csrc/window_attention_qkv.cu``; returns (dqkv, dbias).
    ``dbias=False`` launches it without dbias's atomics (dbias None): a
    probe of what they cost."""
    w = _check(qkv, bias, ids, n_heads)
    bw, n, c3 = qkv.shape
    dev = qkv.device
    expect(dout, "dout", (bw, n, c3 // 3), qkv.dtype, dev)
    expect(o, "o", (bw, n, c3 // 3), torch.float32, dev)
    expect(stats, "stats", (bw, n_heads, n, 2), torch.float32, dev)
    dqkv = torch.empty_like(qkv)
    s1 = torch.empty((bw, n_heads, n), dtype=torch.float32, device=dev)
    dbias = (torch.zeros((n_heads, n, n), dtype=torch.float32, device=dev)
             if dbias else None)   # K4b adds into it
    with torch.cuda.device(dev):
        err = library().vsn_window_attention_qkv_tiled_bwd(
            int(qkv.dtype == torch.bfloat16), qkv.data_ptr(), dout.data_ptr(),
            o.data_ptr(), stats.data_ptr(), bias.data_ptr(), ids.data_ptr(),
            w, s1.data_ptr(), dqkv.data_ptr(), ptr(dbias), bw, n, c3 // 3,
            n_heads, float(scale), stream_of(qkv))
    check(err, "window_attention_qkv_bwd")
    launches[body_key("attention_bwd", c3 // (3 * n_heads))] += 1
    return dqkv, dbias


def window_attention_qkv_backward_launch(qkv, dout, o, stats, bias, ids,
                                        scale, n_heads):
    """K4b from K4f's kept state alone, for the card's launch-level checks:
    the CUDA kernels for a CUDA tensor,
    ``window_attention_qkv_kept_backward_reference`` for a CPU one; same
    returns."""
    if qkv.device.type == "cpu":
        return window_attention_qkv_kept_backward_reference(
            qkv, dout, o, stats, bias, ids, scale, n_heads)
    return _backward_kernel(qkv, bias, ids, dout, o, stats, scale, n_heads)


def window_attention_qkv_backward(qkv, bias, ids, dout, scale, n_heads, *,
                                  o=None, stats=None):
    """VJP of ``window_attention_qkv``: K4b for a CUDA tensor, which reads
    K4f's kept ``o`` and row ``stats`` (``window_attention_qkv_launch``'s
    third and second returns) and raises without them;
    ``window_attention_qkv_backward_reference`` for a CPU one (which
    recomputes the softmax). Returns (dqkv in qkv's dtype, dbias [H, N, N]
    f32)."""
    if qkv.device.type == "cpu":
        return window_attention_qkv_backward_reference(qkv, bias, ids, dout,
                                                       scale, n_heads)
    if o is None or stats is None:
        raise ValueError("window_attention_qkv_backward: K4b reads K4f's "
                         "kept o and row statistics (o=, stats=)")
    return _backward_kernel(qkv, bias, ids, dout, o, stats, scale, n_heads)


class _WindowAttentionQKV(torch.autograd.Function):
    """K4 with its VJP; ``plain`` selects the plain forward and backward.
    The kernel route keeps K4f's row statistics and o for K4b."""

    @staticmethod
    def forward(ctx, plain, qkv, bias, ids, scale, n_heads):
        ctx.plain, ctx.static = plain, (scale, n_heads)
        if plain:
            ctx.save_for_backward(qkv, bias, ids)
            return window_attention_qkv_math(qkv, bias, ids, scale, n_heads)
        out, stats, o = window_attention_qkv_launch(qkv, bias, ids, scale,
                                                    n_heads)
        ctx.save_for_backward(qkv, bias, ids, stats, o)
        return out

    @staticmethod
    def backward(ctx, dout):
        dout = dout.contiguous()
        if ctx.plain:
            qkv, bias, ids = ctx.saved_tensors
            dqkv, dbias = window_attention_qkv_backward_reference(
                qkv, bias, ids, dout, *ctx.static)
        else:
            qkv, bias, ids, stats, o = ctx.saved_tensors
            dqkv, dbias = window_attention_qkv_backward(
                qkv, bias, ids, dout, *ctx.static, o=o, stats=stats)
        return None, dqkv, dbias, None, None, None


def window_attention_qkv(qkv, bias, ids, scale, n_heads):
    """Multi-head window attention on the qkv Linear's output.

    Args:
        qkv: [BW, N, 3C], f32 or bf16, channels [q heads | k heads | v
            heads], head dim C / n_heads: any from 1 to 8192.
        bias: [H, N, N] f32 relative-position bias.
        ids: [W, N] int32 region ids (window bw uses row bw % W; ids that
            differ are masked with -1e9, pad slots carry -1); an unshifted
            block passes one row of zeros.
        scale, n_heads: attention scale and heads.
    Returns: [BW, N, C] merged-head output in qkv's dtype. Differentiable in
    qkv and bias (K4b on a CUDA device).
    """
    return _WindowAttentionQKV.apply(qkv.device.type == "cpu", qkv, bias, ids,
                                     scale, n_heads)


def window_attention_qkv_reference(qkv, bias, ids, scale, n_heads):
    """Plain version of ``window_attention_qkv`` on any device: the plain
    forward, and ``window_attention_qkv_backward_reference`` as its
    backward."""
    return _WindowAttentionQKV.apply(True, qkv, bias, ids, scale, n_heads)


# ---------------------------------------------------------------------------
# V1: split q, k, v [BW, H, N, d]
# ---------------------------------------------------------------------------


def _packed(*heads):
    """Tensors [BW, H, N, d] -> their heads merged, side by side on the last
    axis: [BW, N, len(heads) H d] (q, k, v -> K4's qkv)."""
    bw, h, n, d = heads[0].shape
    return torch.cat([t.transpose(1, 2).reshape(bw, n, h * d) for t in heads],
                     dim=-1)


def _split(x, n_heads, parts=1):
    """[BW, N, parts C] -> ``parts`` tensors [BW, H, N, d] (K4's qkv -> q,
    k, v; out -> out)."""
    bw, n, c = x.shape
    return x.reshape(bw, n, parts, n_heads, c // (parts * n_heads)).permute(
        2, 0, 3, 1, 4).unbind(0)


def window_attention_math(q, k, v, bias, ids, scale):
    """The forward of ``window_attention`` in plain PyTorch ops: K4's plain
    forward (``window_attention_qkv_math``) on the heads merged, split
    again."""
    out = window_attention_qkv_math(_packed(q, k, v), bias, ids, scale,
                                    q.shape[1])
    return _split(out, q.shape[1])[0].contiguous()


def window_attention_backward_reference(q, k, v, bias, ids, dout, scale):
    """Plain VJP of ``window_attention``: K4's plain backward on the heads
    merged. Returns (dq, dk, dv in q's dtype, dbias [H, N, N] f32 summed
    over every window)."""
    heads = q.shape[1]
    dqkv, dbias = window_attention_qkv_backward_reference(
        _packed(q, k, v), bias, ids, _packed(dout), scale, heads)
    return (*(t.contiguous() for t in _split(dqkv, heads, 3)), dbias)


def window_attention_kept_reference(q, k, v, bias, ids, scale):
    """Plain version of V1f with its kept state: (out [BW, H, N, d] in q's
    dtype, the row statistics [BW, H, N, 2] f32, o [BW, H, N, d] f32), K4's
    (``window_attention_qkv_kept_reference``) on the heads merged."""
    heads = q.shape[1]
    out, stats, o = window_attention_qkv_kept_reference(
        _packed(q, k, v), bias, ids, scale, heads)
    return (_split(out, heads)[0].contiguous(), stats,
            _split(o, heads)[0].contiguous())


def window_attention_kept_backward_reference(q, k, v, dout, o, stats, bias,
                                             ids, scale):
    """Plain version of V1b from V1f's kept state (o [BW, H, N, d] f32 and
    the row statistics): K4b's (``window_attention_qkv_kept_backward_
    reference``) on the heads merged. Returns (dq, dk, dv in q's dtype,
    dbias [H, N, N] f32)."""
    heads = q.shape[1]
    dqkv, dbias = window_attention_qkv_kept_backward_reference(
        _packed(q, k, v), _packed(dout), _packed(o), stats, bias, ids, scale,
        heads)
    return (*(t.contiguous() for t in _split(dqkv, heads, 3)), dbias)


def _check_split(q, k, v, bias, ids):
    """Validate V1's arguments; returns the number of id rows W."""
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"window_attention: q dtype {q.dtype} (f32 or bf16)")
    if q.dim() != 4 or not takes_head_dim(q.shape[-1]):
        raise ValueError(f"window_attention: q {tuple(q.shape)} must be [BW, "
                         f"H, N, d] with a head dim up to {MAX_HEAD_DIM}")
    bw, heads, n, _ = q.shape
    dev = q.device
    for name, t in (("q", q), ("k", k), ("v", v)):
        expect(t, name, q.shape, q.dtype, dev)
    expect(bias, "bias", (heads, n, n), torch.float32, dev)
    w = ids.shape[0]
    expect(ids, "ids", (w, n), torch.int32, dev)
    if w == 0 or bw % w:
        raise ValueError(f"window_attention: {w} id rows for {bw} windows")
    return w


def window_attention_launch(q, k, v, bias, ids, scale):
    """V1f with its kept state: (out [BW, H, N, d] in q's dtype, the row
    statistics [BW, H, N, 2] f32, o [BW, H, N, d] f32: out itself for f32
    q). The CUDA kernel (``csrc/window_attention_qkv.cu``, the tiled body on
    the ``Split`` layout) for a CUDA tensor,
    ``window_attention_kept_reference`` for a CPU one."""
    if q.device.type == "cpu":
        return window_attention_kept_reference(q, k, v, bias, ids, scale)
    w = _check_split(q, k, v, bias, ids)
    bw, heads, n, d = q.shape
    out = torch.empty_like(q)
    stats = torch.empty((bw, heads, n, 2), dtype=torch.float32,
                        device=q.device)
    o32 = (torch.empty(q.shape, dtype=torch.float32, device=q.device)
           if q.dtype == torch.bfloat16 else None)
    with torch.cuda.device(q.device):
        err = library().vsn_window_attention_fwd(
            int(q.dtype == torch.bfloat16), q.data_ptr(), k.data_ptr(),
            v.data_ptr(), bias.data_ptr(), ids.data_ptr(), w, out.data_ptr(),
            ptr(o32), stats.data_ptr(), bw, n, d, heads, float(scale),
            stream_of(q))
    check(err, "window_attention")
    launches[body_key("attention_split", d)] += 1
    return out, stats, out if o32 is None else o32


def _split_backward_kernel(q, k, v, bias, ids, dout, o, stats, scale):
    """V1b: launch ``csrc/window_attention_qkv.cu`` on the ``Split`` layout
    from V1f's kept state; returns (dq, dk, dv, dbias)."""
    w = _check_split(q, k, v, bias, ids)
    bw, heads, n, d = q.shape
    dev = q.device
    expect(dout, "dout", q.shape, q.dtype, dev)
    expect(o, "o", q.shape, torch.float32, dev)
    expect(stats, "stats", (bw, heads, n, 2), torch.float32, dev)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    s1 = torch.empty((bw, heads, n), dtype=torch.float32, device=dev)
    dbias = torch.zeros((heads, n, n), dtype=torch.float32,
                        device=dev)  # V1b adds into it
    with torch.cuda.device(dev):
        err = library().vsn_window_attention_bwd(
            int(q.dtype == torch.bfloat16), q.data_ptr(), k.data_ptr(),
            v.data_ptr(), dout.data_ptr(), o.data_ptr(), stats.data_ptr(),
            bias.data_ptr(), ids.data_ptr(), w, s1.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), dbias.data_ptr(), bw, n, d, heads,
            float(scale), stream_of(q))
    check(err, "window_attention_bwd")
    launches[body_key("attention_split_bwd", d)] += 1
    return dq, dk, dv, dbias


def window_attention_backward_launch(q, k, v, dout, o, stats, bias, ids,
                                     scale):
    """V1b from V1f's kept state alone, for the card's launch-level checks:
    the CUDA kernels for a CUDA tensor,
    ``window_attention_kept_backward_reference`` for a CPU one; returns (dq,
    dk, dv, dbias)."""
    if q.device.type == "cpu":
        return window_attention_kept_backward_reference(
            q, k, v, dout, o, stats, bias, ids, scale)
    return _split_backward_kernel(q, k, v, bias, ids, dout, o, stats, scale)


def window_attention_backward(q, k, v, bias, ids, dout, scale, *, o=None,
                              stats=None):
    """VJP of ``window_attention``: V1b for a CUDA tensor, which reads V1f's
    kept ``o`` and row ``stats`` (``window_attention_launch``'s third and
    second returns) and raises without them;
    ``window_attention_backward_reference`` for a CPU one. Returns (dq, dk,
    dv in q's dtype, dbias [H, N, N] f32)."""
    if q.device.type == "cpu":
        return window_attention_backward_reference(q, k, v, bias, ids, dout,
                                                   scale)
    if o is None or stats is None:
        raise ValueError("window_attention_backward: V1b reads V1f's kept o "
                         "and row statistics (o=, stats=)")
    return _split_backward_kernel(q, k, v, bias, ids, dout, o, stats, scale)


class _WindowAttention(torch.autograd.Function):
    """V1 with its VJP; ``plain`` selects the plain forward and backward.
    The kernel route keeps V1f's row statistics and o for V1b."""

    @staticmethod
    def forward(ctx, plain, q, k, v, bias, ids, scale):
        ctx.plain, ctx.scale = plain, scale
        if plain:
            ctx.save_for_backward(q, k, v, bias, ids)
            return window_attention_math(q, k, v, bias, ids, scale)
        out, stats, o = window_attention_launch(q, k, v, bias, ids, scale)
        ctx.save_for_backward(q, k, v, bias, ids, stats, o)
        return out

    @staticmethod
    def backward(ctx, dout):
        dout = dout.contiguous()
        if ctx.plain:
            q, k, v, bias, ids = ctx.saved_tensors
            grads = window_attention_backward_reference(q, k, v, bias, ids,
                                                        dout, ctx.scale)
        else:
            q, k, v, bias, ids, stats, o = ctx.saved_tensors
            grads = window_attention_backward(q, k, v, bias, ids, dout,
                                              ctx.scale, o=o, stats=stats)
        return None, *grads, None, None


def window_attention(q, k, v, bias, ids, scale):
    """Multi-head window attention on split heads.

    Args:
        q, k, v: [BW, H, N, d], one dtype (f32 or bf16); head dim d any
            from 1 to 8192. Any N: padding N (to 256,
            as the JAX caller does) is the caller's choice; pad slots then
            carry id -1.
        bias: [H, N, N] f32 relative-position bias.
        ids: [W, N] int32 region ids, W dividing BW (window bw uses row bw
            % W; ids that differ are masked with -1e9).
        scale: attention scale.
    Returns: [BW, H, N, d] in q's dtype. Differentiable in q, k, v and bias
    (V1b on a CUDA device).
    """
    return _WindowAttention.apply(q.device.type == "cpu", q, k, v, bias, ids,
                                  scale)


def window_attention_split_reference(q, k, v, bias, ids, scale):
    """Plain version of ``window_attention`` on any device: the plain
    forward (``window_attention_math``), and
    ``window_attention_backward_reference`` as its backward."""
    return _WindowAttention.apply(True, q, k, v, bias, ids, scale)


# ---------------------------------------------------------------------------
# V3: the unpartitioned map [B, D, H, W, 3C]
# ---------------------------------------------------------------------------


def window_ids(ids, n_windows):
    """[W, N] region ids -> [nW, N]: window r of a sample on row r % W, the
    ids-row rule of ``window_attention_windows``."""
    rows = torch.arange(n_windows, device=ids.device) % ids.shape[0]
    return ids[rows]


def _n_windows(qkv, window):
    """Windows per sample of a V3 map qkv [B, D, H, W, 3C]."""
    return math.prod(m // w for m, w in zip(qkv.shape[1:4], window))


def _partitioned(qkv, ids, window):
    """(partition of qkv, ids expanded to one row per window of a sample)
    for the plain versions of V3."""
    from vsn_tpu_torch.models.swin3d import window_partition

    return window_partition(qkv, window), window_ids(ids,
                                                     _n_windows(qkv, window))


def window_attention_windows_math(qkv, bias, ids, scale, n_heads, window):
    """The forward of ``window_attention_windows`` in plain PyTorch ops:
    partition, K4's plain forward, reverse."""
    from vsn_tpu_torch.models.swin3d import window_reverse

    wins, rows = _partitioned(qkv, ids, window)
    out = window_attention_qkv_math(wins, bias, rows, scale, n_heads)
    return window_reverse(out, window, qkv.shape[1:4])


def window_attention_windows_backward_reference(qkv, bias, ids, dout, scale,
                                                n_heads, window):
    """Plain VJP of ``window_attention_windows``: partition qkv and dout,
    K4's plain backward, reverse dqkv. Returns (dqkv [B, D, H, W, 3C] in
    qkv's dtype, dbias [H, N, N] f32)."""
    from vsn_tpu_torch.models.swin3d import window_partition, window_reverse

    wins, rows = _partitioned(qkv, ids, window)
    dwins, dbias = window_attention_qkv_backward_reference(
        wins, bias, rows, window_partition(dout, window), scale, n_heads)
    return window_reverse(dwins, window, qkv.shape[1:4]), dbias


def window_attention_windows_kept_reference(qkv, bias, ids, scale, n_heads,
                                            window):
    """Plain version of V3f with its kept state: (out [B, D, H, W, C] in
    qkv's dtype, the row statistics [B nW, H, N, 2] f32, o [B, D, H, W, C]
    f32): partition, K4f's (``window_attention_qkv_kept_reference``),
    reverse."""
    from vsn_tpu_torch.models.swin3d import window_reverse

    wins, rows = _partitioned(qkv, ids, window)
    out, stats, o = window_attention_qkv_kept_reference(wins, bias, rows,
                                                        scale, n_heads)
    dims = qkv.shape[1:4]
    return (window_reverse(out, window, dims), stats,
            window_reverse(o, window, dims))


def window_attention_windows_kept_backward_reference(qkv, dout, o, stats,
                                                     bias, ids, scale,
                                                     n_heads, window):
    """Plain version of V3b from V3f's kept state (o [B, D, H, W, C] f32 and
    the row statistics): partition, K4b's (``window_attention_qkv_kept_
    backward_reference``), reverse. Returns (dqkv [B, D, H, W, 3C] in qkv's
    dtype, dbias [H, N, N] f32)."""
    from vsn_tpu_torch.models.swin3d import window_partition, window_reverse

    wins, rows = _partitioned(qkv, ids, window)
    dwins, dbias = window_attention_qkv_kept_backward_reference(
        wins, window_partition(dout, window), window_partition(o, window),
        stats, bias, rows, scale, n_heads)
    return window_reverse(dwins, window, qkv.shape[1:4]), dbias


def _check_windows(qkv, bias, ids, n_heads, window):
    """Validate V3's arguments; returns the number of id rows W."""
    if qkv.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"window_attention_windows: qkv dtype {qkv.dtype} "
                        "(f32 or bf16)")
    if qkv.dim() != 5 or len(window) != 3:
        raise ValueError("window_attention_windows: qkv must be [B, D, H, W, "
                         "3C] and the window 3-D")
    dims, c3 = qkv.shape[1:4], qkv.shape[4]
    if any(w <= 0 or m % w for m, w in zip(dims, window)):
        raise ValueError(f"window_attention_windows: map {tuple(dims)} is not "
                         f"a multiple of the window {tuple(window)}")
    if c3 % (3 * n_heads) or not takes_head_dim(c3 // (3 * n_heads)):
        raise ValueError(f"window_attention_windows: 3C={c3} over {n_heads} "
                         f"heads: the head dims are up to {MAX_HEAD_DIM}")
    n = math.prod(window)
    dev = qkv.device
    expect(qkv, "qkv", qkv.shape, qkv.dtype, dev)
    expect(bias, "bias", (n_heads, n, n), torch.float32, dev)
    w = ids.shape[0]
    expect(ids, "ids", (w, n), torch.int32, dev)
    if w == 0:
        raise ValueError("window_attention_windows: no id rows")
    return w


def _geometry(qkv, window):
    """(B, D, H, W, wd, wh, ww, C) as the C entry points take them."""
    return (*qkv.shape[:4], *window, qkv.shape[4] // 3)


def _stats_shape(qkv, n_heads, window):
    """The row statistics' shape of a V3 call: [B nW, H, N, 2]."""
    n = math.prod(window)
    return (qkv.shape[0] * _n_windows(qkv, window), n_heads, n, 2)


def window_attention_windows_launch(qkv, bias, ids, scale, n_heads, window):
    """V3f with its kept state: (out [B, D, H, W, C] in qkv's dtype, the row
    statistics [B nW, H, N, 2] f32, o [B, D, H, W, C] f32: out itself for
    f32 qkv). The CUDA kernel (the tiled body on the ``MapRows`` layout) for
    a CUDA tensor, ``window_attention_windows_kept_reference`` for a CPU
    one."""
    window = tuple(window)
    if qkv.device.type == "cpu":
        return window_attention_windows_kept_reference(qkv, bias, ids, scale,
                                                       n_heads, window)
    w = _check_windows(qkv, bias, ids, n_heads, window)
    dev = qkv.device
    shape = (*qkv.shape[:4], qkv.shape[4] // 3)
    out = torch.empty(shape, dtype=qkv.dtype, device=dev)
    stats = torch.empty(_stats_shape(qkv, n_heads, window),
                        dtype=torch.float32, device=dev)
    o32 = (torch.empty(shape, dtype=torch.float32, device=dev)
           if qkv.dtype == torch.bfloat16 else None)
    with torch.cuda.device(dev):
        err = library().vsn_window_attention_windows_fwd(
            int(qkv.dtype == torch.bfloat16), qkv.data_ptr(), bias.data_ptr(),
            ids.data_ptr(), w, out.data_ptr(), ptr(o32), stats.data_ptr(),
            *_geometry(qkv, window), n_heads, float(scale), stream_of(qkv))
    check(err, "window_attention_windows")
    launches[body_key("attention_windows", qkv.shape[4] // (3 * n_heads))] += 1
    return out, stats, out if o32 is None else o32


def _windows_backward_kernel(qkv, bias, ids, dout, o, stats, scale, n_heads,
                             window):
    """V3b: launch ``csrc/window_attention_qkv.cu`` on the ``MapRows``
    layout from V3f's kept state; returns (dqkv, dbias)."""
    w = _check_windows(qkv, bias, ids, n_heads, window)
    dev = qkv.device
    shape = (*qkv.shape[:4], qkv.shape[4] // 3)
    stats_shape = _stats_shape(qkv, n_heads, window)
    n = stats_shape[2]
    expect(dout, "dout", shape, qkv.dtype, dev)
    expect(o, "o", shape, torch.float32, dev)
    expect(stats, "stats", stats_shape, torch.float32, dev)
    dqkv = torch.empty_like(qkv)
    s1 = torch.empty(stats_shape[:3], dtype=torch.float32, device=dev)
    dbias = torch.zeros((n_heads, n, n), dtype=torch.float32,
                        device=dev)  # V3b adds into it
    with torch.cuda.device(dev):
        err = library().vsn_window_attention_windows_bwd(
            int(qkv.dtype == torch.bfloat16), qkv.data_ptr(), dout.data_ptr(),
            o.data_ptr(), stats.data_ptr(), bias.data_ptr(), ids.data_ptr(),
            w, s1.data_ptr(), dqkv.data_ptr(), dbias.data_ptr(),
            *_geometry(qkv, window), n_heads, float(scale), stream_of(qkv))
    check(err, "window_attention_windows_bwd")
    launches[body_key("attention_windows_bwd",
                      qkv.shape[4] // (3 * n_heads))] += 1
    return dqkv, dbias


def window_attention_windows_backward_launch(qkv, dout, o, stats, bias, ids,
                                             scale, n_heads, window):
    """V3b from V3f's kept state alone, for the card's launch-level checks:
    the CUDA kernels for a CUDA tensor,
    ``window_attention_windows_kept_backward_reference`` for a CPU one;
    returns (dqkv, dbias)."""
    window = tuple(window)
    if qkv.device.type == "cpu":
        return window_attention_windows_kept_backward_reference(
            qkv, dout, o, stats, bias, ids, scale, n_heads, window)
    return _windows_backward_kernel(qkv, bias, ids, dout, o, stats, scale,
                                    n_heads, window)


def window_attention_windows_backward(qkv, bias, ids, dout, scale, n_heads,
                                      window, *, o=None, stats=None):
    """VJP of ``window_attention_windows``: V3b for a CUDA tensor, which
    reads V3f's kept ``o`` and row ``stats``
    (``window_attention_windows_launch``'s third and second returns) and
    raises without them; ``window_attention_windows_backward_reference``
    for a CPU one. Returns (dqkv in qkv's dtype, dbias [H, N, N] f32)."""
    window = tuple(window)
    if qkv.device.type == "cpu":
        return window_attention_windows_backward_reference(
            qkv, bias, ids, dout, scale, n_heads, window)
    if o is None or stats is None:
        raise ValueError("window_attention_windows_backward: V3b reads V3f's "
                         "kept o and row statistics (o=, stats=)")
    return _windows_backward_kernel(qkv, bias, ids, dout, o, stats, scale,
                                    n_heads, window)


class _WindowAttentionWindows(torch.autograd.Function):
    """V3 with its VJP; ``plain`` selects the plain forward and backward.
    The kernel route keeps V3f's row statistics and o for V3b."""

    @staticmethod
    def forward(ctx, plain, qkv, bias, ids, scale, n_heads, window):
        ctx.plain, ctx.static = plain, (scale, n_heads, tuple(window))
        if plain:
            ctx.save_for_backward(qkv, bias, ids)
            return window_attention_windows_math(qkv, bias, ids, *ctx.static)
        out, stats, o = window_attention_windows_launch(qkv, bias, ids,
                                                        *ctx.static)
        ctx.save_for_backward(qkv, bias, ids, stats, o)
        return out

    @staticmethod
    def backward(ctx, dout):
        dout = dout.contiguous()
        if ctx.plain:
            qkv, bias, ids = ctx.saved_tensors
            dqkv, dbias = window_attention_windows_backward_reference(
                qkv, bias, ids, dout, *ctx.static)
        else:
            qkv, bias, ids, stats, o = ctx.saved_tensors
            dqkv, dbias = window_attention_windows_backward(
                qkv, bias, ids, dout, *ctx.static, o=o, stats=stats)
        return None, dqkv, dbias, None, None, None, None


def window_attention_windows(qkv, bias, ids, scale, n_heads, window):
    """Multi-head window attention over the unpartitioned qkv map.

    Args:
        qkv: [B, D, H, W, 3C] (the qkv Linear's output on the rolled, padded
            feature map), f32 or bf16, contiguous; D, H, W multiples of
            ``window``; channels [q heads | k heads | v heads], head dim C /
            n_heads: any from 1 to 8192.
        bias: [H, N, N] f32 relative-position bias, N = prod(window).
        ids: [W, N] int32 region ids; window (i, j, k) of each sample, in
            row-major order, uses row flat(i, j, k) % W (any W). An
            unshifted block passes one row of zeros.
        scale, n_heads, window: attention scale, heads and window.
    Returns: [B, D, H, W, C] merged-head output in qkv's dtype, with no
    partition or reverse copy. Differentiable in qkv and bias (V3b on a
    CUDA device).
    """
    return _WindowAttentionWindows.apply(qkv.device.type == "cpu", qkv, bias,
                                         ids, scale, n_heads, tuple(window))


def window_attention_windows_reference(qkv, bias, ids, scale, n_heads,
                                       window):
    """Plain version of ``window_attention_windows`` on any device: the
    plain forward (partition, K4's plain forward, reverse), and
    ``window_attention_windows_backward_reference`` as its backward."""
    return _WindowAttentionWindows.apply(True, qkv, bias, ids, scale, n_heads,
                                         tuple(window))
