"""Window attention on packed qkv: K4 (port of vsn_tpu/ops/window_attention.py).

``window_attention_qkv`` is the port of ``fused_window_attention_qkv``: the
attention core of an unfused Swin block, between its qkv and proj Linears,

    out[bw, i, h] = sum_j p[bw, h, i, j] v[bw, j, h],
    p = softmax_j(q[bw, i, h] . k[bw, j, h] * scale + bias[h, i, j]
                  + mask(ids[bw % W])[i, j]),

read from the qkv Linear's output [BW, N, 3C] (channels [q_h0..q_hH |
k_h0..k_hH | v_h0..v_hH], head dim C/H) and written merged-head [BW, N, C].
It is a ``torch.autograd.Function``: for a tensor on a CUDA device it
launches K4f (``csrc/window_attention_qkv.cu``) forward and K4b backward;
for a tensor on the CPU it runs the plain forward and the explicit plain
backward. It never falls back from one to the other.

Numerics are the TPU kernel's, not K1's: q, k, v are read from their
stored dtype into f32; the softmax subtracts the plain row max and divides
by the row sum in f32; p . v uses f32 p and f32 v; the output is cast to
qkv's dtype once. The mask is additive -1e9 where region ids differ; pad
slots carry id -1. The backward gives dqkv in qkv's dtype and dbias summed
over every window in f32; ids and the static arguments get no gradient.

``window_attention_qkv_reference`` is the plain version on any device (the
plain forward, and ``window_attention_qkv_backward_reference`` as its
backward); ``mask_from_ids`` and ``window_attention_reference`` (split
heads) are the plain helpers the other kernels' plain versions share.
"""

from __future__ import annotations

import torch

from vsn_tpu_torch.ops._build import (
    check,
    expect,
    launches,
    library,
    stream_of,
)

NEG_INF = -1e9
MAX_HEAD_DIM = 32  # one warp lane per head channel in K4f/K4b


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


def _probs(q, k, bias, ids, scale):
    """p [BW, H, N, N] in f32, as _fwd_qkv_kernel forms it."""
    rows = torch.arange(q.shape[0], device=q.device) % ids.shape[0]
    s = (q @ k.transpose(-1, -2)) * scale + bias[None]
    s = s + mask_from_ids(ids)[rows][:, None]
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return p / p.sum(dim=-1, keepdim=True)


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


def _check(qkv, bias, ids, n_heads):
    """Validate K4's arguments; returns the number of id rows W."""
    if qkv.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"window_attention_qkv: qkv dtype {qkv.dtype} (f32 "
                        "or bf16)")
    bw, n, c3 = qkv.shape
    if c3 % (3 * n_heads) or c3 // (3 * n_heads) > MAX_HEAD_DIM:
        raise ValueError(f"window_attention_qkv: 3C={c3} over {n_heads} heads "
                         f"needs a head dim <= {MAX_HEAD_DIM}")
    dev = qkv.device
    expect(qkv, "qkv", (bw, n, c3), qkv.dtype, dev)
    expect(bias, "bias", (n_heads, n, n), torch.float32, dev)
    w = ids.shape[0]
    expect(ids, "ids", (w, n), torch.int32, dev)
    if w == 0 or bw % w:
        raise ValueError(f"window_attention_qkv: {w} id rows for {bw} windows")
    return w


def _forward_kernel(qkv, bias, ids, scale, n_heads):
    """K4f: launch ``csrc/window_attention_qkv.cu``."""
    w = _check(qkv, bias, ids, n_heads)
    bw, n, c3 = qkv.shape
    out = torch.empty((bw, n, c3 // 3), dtype=qkv.dtype, device=qkv.device)
    with torch.cuda.device(qkv.device):
        err = library().vsn_window_attention_qkv_fwd(
            int(qkv.dtype == torch.bfloat16), qkv.data_ptr(), bias.data_ptr(),
            ids.data_ptr(), w, out.data_ptr(), bw, n, c3 // 3, n_heads,
            float(scale), stream_of(qkv))
    check(err, "window_attention_qkv")
    launches["attention"] += 1
    return out


def window_attention_qkv_backward(qkv, bias, ids, dout, scale, n_heads):
    """VJP of ``window_attention_qkv``: K4b (``csrc/window_attention_qkv.cu``)
    for a CUDA tensor, ``window_attention_qkv_backward_reference`` for a CPU
    one; same returns."""
    if qkv.device.type == "cpu":
        return window_attention_qkv_backward_reference(qkv, bias, ids, dout,
                                                       scale, n_heads)
    w = _check(qkv, bias, ids, n_heads)
    bw, n, c3 = qkv.shape
    expect(dout, "dout", (bw, n, c3 // 3), qkv.dtype, qkv.device)
    dqkv = torch.empty_like(qkv)
    dbias = torch.zeros((n_heads, n, n), dtype=torch.float32,
                        device=qkv.device)  # K4b adds into it
    bias_t = bias.transpose(1, 2).contiguous()
    with torch.cuda.device(qkv.device):
        err = library().vsn_window_attention_qkv_bwd(
            int(qkv.dtype == torch.bfloat16), qkv.data_ptr(), bias.data_ptr(),
            bias_t.data_ptr(), ids.data_ptr(), w, dout.data_ptr(),
            dqkv.data_ptr(), dbias.data_ptr(), bw, n, c3 // 3, n_heads,
            float(scale), stream_of(qkv))
    check(err, "window_attention_qkv_bwd")
    launches["attention_bwd"] += 1
    return dqkv, dbias


class _WindowAttentionQKV(torch.autograd.Function):
    """K4 with its VJP; ``plain`` selects the plain forward and backward."""

    @staticmethod
    def forward(ctx, plain, qkv, bias, ids, scale, n_heads):
        fwd = window_attention_qkv_math if plain else _forward_kernel
        ctx.plain, ctx.static = plain, (scale, n_heads)
        ctx.save_for_backward(qkv, bias, ids)
        return fwd(qkv, bias, ids, scale, n_heads)

    @staticmethod
    def backward(ctx, dout):
        bwd = (window_attention_qkv_backward_reference if ctx.plain
               else window_attention_qkv_backward)
        qkv, bias, ids = ctx.saved_tensors
        dqkv, dbias = bwd(qkv, bias, ids, dout.contiguous(), *ctx.static)
        return None, dqkv, dbias, None, None, None


def window_attention_qkv(qkv, bias, ids, scale, n_heads):
    """Multi-head window attention on the qkv Linear's output.

    Args:
        qkv: [BW, N, 3C], f32 or bf16, channels [q heads | k heads | v
            heads], head dim C / n_heads <= 32.
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
