"""Swin block halves: K1 ``attn_half`` and K2 ``ln_mlp``, with their VJPs.

Port of vsn_tpu/ops/swin_block_kernels.py ``fused_attn_half`` and
``fused_ln_mlp``. Each is a ``torch.autograd.Function`` whose forward and
backward take their plain PyTorch versions for a tensor on the CPU and
launch hand-written CUDA kernels for a tensor on a CUDA device: K1f/K2f
(``csrc/attn_half.cu``, ``csrc/ln_mlp.cu``) forward, K1b/K2b
(``csrc/attn_half_bwd.cu``, ``csrc/ln_mlp_bwd.cu``) backward. They never
fall back from one to the other.

Precision follows the TPU kernels: with bf16 activations the matrix-product
operands are rounded to bf16 and accumulate in f32; with f32 activations
everything is f32. LayerNorm and softmax statistics are f32, and the
residual ``lam * x + gf[s] * branch`` is formed in f32 and cast once.

The residual gains are per sample: ``gf`` scales the branch forward and
``gb`` its cotangent backward (``dbranch = gb * do``, ``dx = lam * do +
...``), the (gf, gb) form of ShakeDrop and DropPath. Gains, region ids and
the static arguments get no gradient, as in the JAX VJP. The backward saves
the inputs and recomputes the forward, as the TPU kernels do, but for K1's
attention output and its softmax statistics, which K1f hands on.

``attn_half_reference`` / ``ln_mlp_reference`` are the plain versions: the
same Functions with the plain forward and the explicit plain backward
(``*_backward_reference``), which rounds operands where the TPU backward
kernels do. ``attn_half_math`` / ``ln_mlp_math`` are the bare forward math,
for autograd to differentiate as an independent check (in f32; in bf16
autograd rounds at other points).

K1's attention runs one hand-written body, the key-tiled one,
FlashAttention-2 on bf16 mma.sync (``csrc/attn_tiled.cuh``), at every head
dim from 1 to 8192 and every N: the presets' calls (Swin-T's windows at d =
32, N = 252 and 150; ViT's one window of N = 811 tokens per sample at d =
64) and any other (the tiny test models' d = 8; above 128 the body's slab
kernels, e.g. Swin-T at HEADS [1, 1, 1, 1], d = 96 to 768); a head dim
above 8192 raises. K1f also writes each row's softmax statistics (shift,
1 / (sum + 1e-30)) and, for bf16, an f32 copy of the attention output;
autograd keeps them with ao, and K1b reads them instead of recomputing the
softmax (s1 = dO . o). The launch counters are ``attn_half_tiled`` /
``attn_half_bwd_tiled`` (``attn_half_slabs`` / ``attn_half_bwd_slabs``
on the slab kernels, ``k1_body``). ``attention_tiled_reference`` and
``attention_tiled_backward_reference`` are the plain versions of the
body's two launches alone (``attention_tiled_launch`` and
``attention_tiled_backward_launch`` launch them).

Both kernels take the TPU kernels' two residual modes in band: ``gamma``
(LayerScale: a [C] f32 scale of the branch before the gains, with its
gradient dgamma) and ``post_norm`` (the LayerNorm moves from the block input
to the branch output: qkv / fc1 read raw x and ``norm_w`` / ``norm_b`` are
the post-norm's). The launch counters name the mode after the body:
``..._post`` for post-norm, ``..._ls`` with gamma (e.g.
``attn_half_tiled_post_ls``, ``ln_mlp_bwd_ls``).

The GEMM, weight-gradient and row kernels that K1 / K2 launch inside their
calls can also be launched alone, for the card's launch-level checks
(``gemm_launch``, ``wgrad_launch``; the LayerNorm backward of K1b / K2b,
``ln_bwd_launch`` and ``postnorm_bwd_launch``, and the other row kernels,
``ROW_KERNELS``), each beside its plain version.

Weights use the torch Linear layout ([out, in], f32), as the port's modules
hold them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from vsn_tpu_torch.models.layers import gated_residual
from vsn_tpu_torch.ops._build import (
    check,
    expect,
    launches,
    library,
    ptr,
    stream_of,
)
from vsn_tpu_torch.ops.window_attention import (
    MAX_HEAD_DIM,
    TILED_HEAD_DIM,
    mask_from_ids,
    takes_head_dim,
)

LN_EPS = 1e-5


def _compute_dtype(x):
    return torch.bfloat16 if x.dtype == torch.bfloat16 else torch.float32


def _r(t, cdt):
    """``t`` rounded to ``cdt`` (a product operand), held as f32."""
    return t.to(cdt).float()


def _mm(a, w, cdt):
    """a @ w.T with operands rounded to ``cdt`` and f32 accumulation."""
    return _r(a, cdt) @ _r(w, cdt).t()


def _ln_parts(x32, w, b):
    """LayerNorm over the last dim in f32: (y, xhat, rstd), as _ln_fwd."""
    mu = x32.mean(dim=-1, keepdim=True)
    xc = x32 - mu
    rstd = torch.rsqrt((xc * xc).mean(dim=-1, keepdim=True) + LN_EPS)
    xhat = xc * rstd
    return xhat * w + b, xhat, rstd


def _ln_backward(dy, w, xhat, rstd):
    """(dx, dw, db) of LayerNorm over the last dim, as _ln_bwd."""
    dxhat = dy * w
    m1 = dxhat.mean(dim=-1, keepdim=True)
    m2 = (dxhat * xhat).mean(dim=-1, keepdim=True)
    return rstd * (dxhat - m1 - xhat * m2), (dy * xhat).sum(0), dy.sum(0)


def _row_gains(g, rows):
    """Per-sample gains [B] -> per-row [rows, 1] (rows are sample-major)."""
    return g.float().repeat_interleave(rows // g.shape[0])[:, None]


def _residual(x, branch, gf, gb, lam):
    """gated_residual over the samples of a sample-major [rows, ...] x."""
    b = gf.shape[0]
    return gated_residual(x.reshape(b, -1), branch.reshape(b, -1), gf, gb,
                          lam).reshape(x.shape)


def k1_body(d, bwd=""):
    """K1f's (``bwd="_bwd"``: K1b's) launch counter at head dim ``d``:
    ``attn_half_tiled`` where the key-tiled body runs, ``attn_half_slabs``
    where its slab kernels run (d above 128)."""
    return f"attn_half{bwd}_slabs" if d > TILED_HEAD_DIM else \
        f"attn_half{bwd}_tiled"


def mode_key(base, gamma, post_norm):
    """The launch counter of a K1/K2 call: ``base`` (the kernel and its
    attention body), then ``_post`` under post-norm and ``_ls`` with a
    LayerScale gamma."""
    return base + ("_post" if post_norm else "") + (
        "_ls" if gamma is not None else "")


def _branch_out(branch, norm_w, norm_b, gamma, post_norm):
    """The branch as the gains see it: [LN(branch)] [* gamma], in f32
    (swin_block_kernels.py:284-287, :874-877)."""
    if post_norm:
        branch = _ln_parts(branch, norm_w, norm_b)[0]
    return branch if gamma is None else branch * gamma


def _out_backward(do, a, w, b, norm_w, norm_b, gamma, post_norm, cdt):
    """Backward of the last product and the residual mode, branch = a @
    w.T + b -> [post-norm] -> [* gamma], as the TPU kernels take it
    (swin_block_kernels.py:388-415, :917-950). ``do`` is the gated
    cotangent gb * do_res. Returns (the cotangent of the product's output,
    dw, db, dgamma or None, (dnorm_w, dnorm_b) of the post-norm or None).

    Pre-norm: M = round(do)^T round(a) and s = sum do; dgamma =
    rowsum(w * M) + b * s from the unscaled M and s, then dw = M * gamma,
    db = s * gamma and do * gamma. Post-norm: the f32 branch recomputed,
    its LayerNorm statistics, dgamma = sum do * LN(branch) and do * gamma,
    then LN's backward into dbranch and the norm's gradients; dw and db are
    taken on dbranch."""
    dgamma = None
    if post_norm:
        branch = _mm(a, w, cdt) + b
        bn, bxhat, brstd = _ln_parts(branch, norm_w, norm_b)
        if gamma is not None:
            dgamma = (do * bn).sum(0)
            do = do * gamma
        dbranch, dnw, dnb = _ln_backward(do, norm_w, bxhat, brstd)
        return (dbranch, _r(dbranch, cdt).t() @ _r(a, cdt), dbranch.sum(0),
                dgamma, (dnw, dnb))
    m = _r(do, cdt).t() @ _r(a, cdt)
    s = do.sum(0)
    if gamma is None:
        return do, m, s, None, None
    dgamma = (w * m).sum(1) + b * s
    return do * gamma, m * gamma[:, None], s * gamma, dgamma, None


def _check_gains(name, gf, gb, units, dev):
    nsamp = gf.shape[0]
    expect(gf, "gf", (nsamp,), torch.float32, dev)
    expect(gb, "gb", (nsamp,), torch.float32, dev)
    if units % nsamp:
        raise ValueError(f"{name}: {units} rows/windows over {nsamp} samples")
    return nsamp


# ---------------------------------------------------------------------------
# K1: LN1 + qkv + window attention + proj + gated residual
# ---------------------------------------------------------------------------

def _scores(q, k, bias, ids, scale):
    """Masked, biased, scaled scores [BW, H, N, N] in f32."""
    bw = q.shape[0]
    s = (q @ k.transpose(-1, -2)) * scale
    if ids is not None:
        rows = torch.arange(bw, device=q.device) % ids.shape[0]
        s = s + mask_from_ids(ids)[rows][:, None]
    if bias is not None:
        s = s + bias[None]
    return s


def _qkv_parts(x, norm_w, norm_b, qkv_w, qkv_b, post_norm=False):
    """K1's launch 1 as it rounds: (y, xhat, rstd, qkv [BW*N, 3C] f32 of
    values rounded to the activation type); under post-norm y is x (f32)
    and xhat, rstd are None."""
    bw, n, c = x.shape
    cdt = _compute_dtype(x)
    x32 = x.float().reshape(bw * n, c)
    if post_norm:
        y, xhat, rstd = x32, None, None
    else:
        y, xhat, rstd = _ln_parts(x32, norm_w, norm_b)
    qkv = _mm(y, qkv_w, cdt)
    if qkv_b is not None:
        qkv = qkv + qkv_b
    return y, xhat, rstd, _r(qkv, cdt)


def _attention_parts(x, norm_w, norm_b, qkv_w, qkv_b, bias, ids, scale,
                     num_heads, post_norm=False):
    """The forward up to the head-merged attention output, as K1 rounds it:
    returns (y, xhat, rstd, q, k, v, u, r, ao); under post-norm y is x (f32)
    and xhat, rstd are None."""
    bw, n, c = x.shape
    cdt = _compute_dtype(x)
    y, xhat, rstd, qkv = _qkv_parts(x, norm_w, norm_b, qkv_w, qkv_b,
                                    post_norm)
    qkv = qkv.reshape(bw, n, 3, num_heads, c // num_heads)
    q, k, v = qkv.permute(2, 0, 3, 1, 4)                    # [BW, H, N, d]
    s = _scores(q, k, bias, ids, scale)
    m = s.amax(dim=-1, keepdim=True).clamp_min(0.0)
    u = torch.exp(s - m)
    r = 1.0 / (u.sum(dim=-1, keepdim=True) + 1e-30)
    ao = (_r(u, cdt) @ v) * r                               # [BW, H, N, d]
    return y, xhat, rstd, q, k, v, u, r, ao.transpose(1, 2).reshape(bw * n, c)


def attn_half_math(x, norm_w, norm_b, qkv_w, qkv_b, bias, ids, proj_w, proj_b,
                   gf, gb, scale, num_heads, lam=1.0, gamma=None,
                   post_norm=False):
    """The forward of ``attn_half`` in plain PyTorch ops (differentiable by
    autograd; the residual's backward uses gb)."""
    cdt = _compute_dtype(x)
    ao = _attention_parts(x, norm_w, norm_b, qkv_w, qkv_b, bias, ids, scale,
                          num_heads, post_norm)[-1]
    branch = _branch_out(_mm(ao, proj_w, cdt) + proj_b, norm_w, norm_b, gamma,
                         post_norm)
    return _residual(x, branch, gf, gb, lam)


def attn_half_backward_reference(x, norm_w, norm_b, qkv_w, qkv_b, bias, ids,
                                 proj_w, gb, dout, scale, num_heads,
                                 lam=1.0, proj_b=None, gamma=None,
                                 post_norm=False):
    """Plain VJP of ``attn_half``, mirroring _attn_bwd_kernel: recompute,
    then the p-basis attention backward. Returns (dx, dnorm_w, dnorm_b,
    dqkv_w, dqkv_b, dbias, dproj_w, dproj_b, dgamma); dqkv_b / dbias /
    dgamma are None when qkv_b / bias / gamma are. ``proj_b`` is needed
    with gamma or post-norm."""
    bw, n, c = x.shape
    rows, hd = bw * n, c // num_heads
    cdt = _compute_dtype(x)
    y, xhat, rstd, q, k, v, u, r, ao = _attention_parts(
        x, norm_w, norm_b, qkv_w, qkv_b, bias, ids, scale, num_heads,
        post_norm)
    do_res = dout.float().reshape(rows, c)
    do, dproj_w, dproj_b, dgamma, post = _out_backward(
        _row_gains(gb, rows) * do_res, ao, proj_w, proj_b, norm_w, norm_b,
        gamma, post_norm, cdt)
    dao = _r(do, cdt) @ _r(proj_w, cdt)
    daoh = _r(dao, cdt).reshape(bw, n, num_heads, hd).transpose(1, 2)
    p = u * r                                               # [BW, H, N, N]
    dv = _r(p, cdt).transpose(-1, -2) @ daoh
    dp = daoh @ v.transpose(-1, -2)
    w = p * dp
    ds = w - w.sum(dim=-1, keepdim=True) * p
    dsb = _r(ds, cdt)
    dq = (dsb @ k) * scale
    dk = (dsb.transpose(-1, -2) @ q) * scale
    dbias = ds.sum(0) if bias is not None else None
    del u, p, dp, w, ds, dsb
    dqkv = torch.stack([dq, dk, dv])                        # [3, BW, H, N, d]
    dqkv = dqkv.permute(1, 3, 0, 2, 4).reshape(rows, 3 * c)
    dqkv_b = dqkv.sum(0) if qkv_b is not None else None
    dqkv_w = _r(dqkv, cdt).t() @ _r(y, cdt)
    dy = _r(dqkv, cdt) @ _r(qkv_w, cdt)
    if post_norm:
        dxn, (dnorm_w, dnorm_b) = dy, post
    else:
        dxn, dnorm_w, dnorm_b = _ln_backward(dy, norm_w, xhat, rstd)
    dx = (lam * do_res + dxn).to(x.dtype).reshape(x.shape)
    return (dx, dnorm_w, dnorm_b, dqkv_w, dqkv_b, dbias, dproj_w, dproj_b,
            dgamma)


def attention_tiled_reference(qkv, bias, ids, scale, num_heads):
    """Plain version of the key-tiled K1f attention launch alone: qkv [BW, N,
    3C] in the activation type -> (ao [BW, N, C] in that type, the row
    statistics [BW, H, N, 2] f32 (the shift max(rowmax, 0) and 1 / (sum +
    1e-30)), o [BW, N, C] f32: ao before its rounding)."""
    bw, n, c3 = qkv.shape
    cdt = _compute_dtype(qkv)
    q, k, v = qkv.float().reshape(bw, n, 3, num_heads, -1).permute(
        2, 0, 3, 1, 4)
    s = _scores(q, k, bias, ids, scale)
    m = s.amax(dim=-1, keepdim=True).clamp_min(0.0)
    u = torch.exp(s - m)
    r = 1.0 / (u.sum(dim=-1, keepdim=True) + 1e-30)
    o = ((_r(u, cdt) @ v) * r).transpose(1, 2).reshape(bw, n, c3 // 3)
    return o.to(qkv.dtype), torch.cat([m, r], dim=-1), o


def attention_tiled_backward_reference(qkv, dao, o, stats, bias, ids, scale,
                                       num_heads):
    """Plain version of the key-tiled K1b attention launches alone (phases A
    and B): from qkv [BW, N, 3C] and dao [BW, N, C] in the activation type,
    and K1f's o [BW, N, C] f32 and row statistics [BW, H, N, 2], p = exp(s -
    shift) / sum, s1 = dO . o, ds = p dp - s1 p -> (dqkv [BW, N, 3C] in the
    activation type, dbias [H, N, N] f32 or None without a bias, dbqkv [3C]
    f32: the column sums of the unrounded dq, dk, dv)."""
    bw, n, c3 = qkv.shape
    cdt = _compute_dtype(qkv)
    q, k, v = qkv.float().reshape(bw, n, 3, num_heads, -1).permute(
        2, 0, 3, 1, 4)
    split = lambda t: t.float().reshape(bw, n, num_heads, -1).transpose(1, 2)
    daoh, oh = split(dao), split(o)
    p = torch.exp(_scores(q, k, bias, ids, scale) - stats[..., :1]) \
        * stats[..., 1:]
    s1 = (daoh * oh).sum(dim=-1, keepdim=True)
    ds = p * (daoh @ v.transpose(-1, -2)) - s1 * p
    dsb = _r(ds, cdt)
    dqkv = torch.stack([(dsb @ k) * scale,
                        (dsb.transpose(-1, -2) @ q) * scale,
                        _r(p, cdt).transpose(-1, -2) @ daoh])
    dqkv = dqkv.permute(1, 3, 0, 2, 4).reshape(bw, n, c3)
    return (dqkv.to(qkv.dtype), ds.sum(0) if bias is not None else None,
            dqkv.sum((0, 1)))


def _check_attn(x, norm_w, norm_b, qkv_w, qkv_b, bias, ids, proj_w, proj_b,
                gf, gb, num_heads, gamma=None):
    """Validate K1's arguments (qkv_b, bias, ids, proj_b and gamma may be
    None); returns (ids_rows, nsamp)."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"attn_half: x dtype {x.dtype} (f32 or bf16)")
    bw, n, c = x.shape
    if c % num_heads or not takes_head_dim(c // num_heads):
        raise ValueError(f"attn_half: C={c} over {num_heads} heads: the "
                         f"kernels take head dims up to {MAX_HEAD_DIM}")
    dev, f32 = x.device, torch.float32
    expect(x, "x", (bw, n, c), x.dtype, dev)
    for t, name, shape in ((norm_w, "norm_w", (c,)), (norm_b, "norm_b", (c,)),
                           (qkv_w, "qkv_w", (3 * c, c)),
                           (qkv_b, "qkv_b", (3 * c,)),
                           (bias, "bias", (num_heads, n, n)),
                           (proj_w, "proj_w", (c, c)),
                           (proj_b, "proj_b", (c,)),
                           (gamma, "gamma", (c,))):
        if t is not None:
            expect(t, name, shape, f32, dev)
    ids_rows = 1
    if ids is not None:
        ids_rows = ids.shape[0]
        expect(ids, "ids", (ids_rows, n), torch.int32, dev)
        if bw % ids_rows:
            raise ValueError(f"attn_half: {ids_rows} id rows for {bw} windows")
    return ids_rows, _check_gains("attn_half", gf, gb, bw, dev)


def _tiled_buffers(x, num_heads):
    """K1f's outputs beside ao, K1b's inputs: the row statistics [BW, H, N,
    2] f32 and, for bf16 x, o [BW, N, C] f32 (None for f32 x: ao is o)."""
    bw, n, c = x.shape
    stats = torch.empty((bw, num_heads, n, 2), dtype=torch.float32,
                        device=x.device)
    o32 = (torch.empty((bw, n, c), dtype=torch.float32, device=x.device)
           if x.dtype == torch.bfloat16 else None)
    return stats, o32


def _attn_half_kernel(x, norm_w, norm_b, qkv_w, qkv_b, bias, ids, proj_w,
                      proj_b, gf, gb, scale, num_heads, lam, gamma=None,
                      post_norm=False):
    """K1f: launch ``csrc/attn_half.cu``. Returns (out, the attention output
    ao [BW, N, C], the row statistics [BW, H, N, 2] and o [BW, N, C] f32 (o
    None for f32 x)): K1b's inputs."""
    ids_rows, nsamp = _check_attn(x, norm_w, norm_b, qkv_w, qkv_b, bias, ids,
                                  proj_w, proj_b, gf, gb, num_heads, gamma)
    if post_norm:   # the post-norm finish reads x's rows by 16-byte vectors
        x = _aligned16(x)
    bw, n, c = x.shape
    stats, o32 = _tiled_buffers(x, num_heads)
    out = torch.empty_like(x)
    qkv_buf = torch.empty((bw * n, 3 * c), dtype=x.dtype, device=x.device)
    ao_buf = torch.empty_like(x)
    branch = (torch.empty((bw * n, c), dtype=torch.float32, device=x.device)
              if post_norm else None)
    with torch.cuda.device(x.device):
        err = library().vsn_attn_half_fwd(
            int(x.dtype == torch.bfloat16), x.data_ptr(),
            norm_w.data_ptr(), norm_b.data_ptr(), qkv_w.data_ptr(),
            ptr(qkv_b), ptr(bias), ptr(ids), ids_rows, proj_w.data_ptr(),
            proj_b.data_ptr(), gf.data_ptr(), ptr(gamma), int(post_norm),
            qkv_buf.data_ptr(), ao_buf.data_ptr(), ptr(o32), ptr(stats),
            ptr(branch), out.data_ptr(), bw, n, c, num_heads,
            (bw // nsamp) * n, float(scale), float(lam), stream_of(x))
    check(err, "attn_half")
    launches[mode_key(k1_body(c // num_heads), gamma, post_norm)] += 1
    return out, ao_buf, stats, o32


def _check_tiled_launch(qkv, bias, ids, num_heads):
    """Validate a tiled attention launch's arguments; returns ids_rows."""
    if qkv.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"attention_tiled: qkv dtype {qkv.dtype}")
    bw, n, c3 = qkv.shape
    c = c3 // 3
    if c3 % 3 or c % num_heads or not takes_head_dim(c // num_heads):
        raise ValueError(f"attention_tiled: qkv {tuple(qkv.shape)} over "
                         f"{num_heads} heads: head dims up to "
                         f"{MAX_HEAD_DIM}")
    expect(qkv, "qkv", (bw, n, c3), qkv.dtype, qkv.device)
    if bias is not None:
        expect(bias, "bias", (num_heads, n, n), torch.float32, qkv.device)
    if ids is None:
        return 1
    expect(ids, "ids", (ids.shape[0], n), torch.int32, qkv.device)
    if bw % ids.shape[0]:
        raise ValueError(f"attention_tiled: {ids.shape[0]} id rows for {bw} "
                         f"windows")
    return ids.shape[0]


def attention_tiled_launch(qkv, bias, ids, scale, num_heads):
    """K1f's key-tiled attention launch alone, for the card's launch-level
    checks (K1 itself launches it inside ``attn_half``): the CUDA kernel for
    a CUDA tensor, ``attention_tiled_reference`` for a CPU one; same
    returns (o is ao itself for f32 qkv)."""
    if qkv.device.type == "cpu":
        return attention_tiled_reference(qkv, bias, ids, scale, num_heads)
    ids_rows = _check_tiled_launch(qkv, bias, ids, num_heads)
    bw, n, c3 = qkv.shape
    ao = torch.empty((bw, n, c3 // 3), dtype=qkv.dtype, device=qkv.device)
    stats, o32 = _tiled_buffers(ao, num_heads)
    with torch.cuda.device(qkv.device):
        err = library().vsn_attention_tiled_fwd(
            int(qkv.dtype == torch.bfloat16), qkv.data_ptr(), ptr(bias),
            ptr(ids), ids_rows, ao.data_ptr(), ptr(o32), stats.data_ptr(), bw,
            n, c3 // 3, num_heads, float(scale), stream_of(qkv))
    check(err, "attention_tiled")
    launches["attention_tiled_launch"] += 1
    return ao, stats, ao if o32 is None else o32


def attention_tiled_backward_launch(qkv, dao, o, stats, bias, ids, scale,
                                    num_heads):
    """K1b's key-tiled attention launches alone (phases A and B), for the
    card's launch-level checks: the CUDA kernels for a CUDA tensor,
    ``attention_tiled_backward_reference`` for a CPU one; same returns."""
    if qkv.device.type == "cpu":
        return attention_tiled_backward_reference(qkv, dao, o, stats, bias,
                                                  ids, scale, num_heads)
    ids_rows = _check_tiled_launch(qkv, bias, ids, num_heads)
    bw, n, c3 = qkv.shape
    dev = qkv.device
    expect(dao, "dao", (bw, n, c3 // 3), qkv.dtype, dev)
    expect(o, "o", (bw, n, c3 // 3), torch.float32, dev)
    expect(stats, "stats", (bw, num_heads, n, 2), torch.float32, dev)
    dqkv = torch.empty_like(qkv)
    s1 = torch.empty((bw, num_heads, n), dtype=torch.float32, device=dev)
    dbias = (torch.zeros((num_heads, n, n), dtype=torch.float32, device=dev)
             if bias is not None else None)
    dbqkv = torch.zeros(c3, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = library().vsn_attention_tiled_bwd(
            int(qkv.dtype == torch.bfloat16), qkv.data_ptr(), dao.data_ptr(),
            o.data_ptr(), stats.data_ptr(), ptr(bias), ptr(ids), ids_rows,
            s1.data_ptr(), dqkv.data_ptr(), ptr(dbias), dbqkv.data_ptr(), bw,
            n, c3 // 3, num_heads, float(scale), stream_of(qkv))
    check(err, "attention_tiled_bwd")
    launches["attention_tiled_bwd_launch"] += 1
    return dqkv, dbias, dbqkv


# ---------------------------------------------------------------------------
# The GEMM and weight-gradient launches of K1 / K2 alone
# ---------------------------------------------------------------------------

# csrc/common.cuh ``Epilogue``, in its order, and ``LayerScaleFlags``
GEMM_EPILOGUES = ("bias", "gelu", "residual", "gelu_grad", "f32", "mul_f32",
                  "add_resid")
LS_FLAGS = {None: 0, "epi": 1, "pro": 2}
# (epilogue, LayerScale flag, W read as [K, N]): the launches K1 and K2
# make (csrc/gemm.cu takes these and no others)
GEMM_MODES = {
    ("bias", None, False), ("gelu", None, False), ("residual", None, False),
    ("residual", "epi", False), ("gelu_grad", None, False),
    ("f32", None, False),
    ("bias", None, True), ("bias", "pro", True), ("mul_f32", None, True),
    ("mul_f32", "pro", True), ("f32", None, True), ("add_resid", None, True),
}
# those whose A may be f32 under bf16 operands (dy, dh1: K1b's and K2b's
# post-norm and data gradients)
GEMM_F32_A = {("bias", None, True), ("mul_f32", None, True),
              ("f32", None, True), ("add_resid", None, True)}
# the attention probes' proj (bf16 operands only, out bf16 or f32)
GEMM_PROBE = ("residual", None, True)
_WRITES_OUT = {"bias", "gelu", "residual", "gelu_grad", "add_resid"}
_WRITES_OUT32 = {"gelu_grad", "f32", "mul_f32"}


def _gain_rows(g, rows_per_sample, m):
    """Per-sample gains [S] -> per-row [m, 1] f32: row r takes g[r // rps]."""
    return g.float()[torch.arange(m, device=g.device) // rows_per_sample][
        :, None]


def gemm_reference(a, w, epi, cdt, *, w_kn=False, ln=None, a_gain=None,
                   rows_per_sample=None, gamma=None, ls=None, bias=None,
                   resid=None, gains=None, lam=1.0, out32=None,
                   out_dtype=None):
    """Plain version of one GEMM launch of K1 / K2 (csrc/common.cuh
    ``launch_gemm``): out = epi(A' @ W' + bias), every product operand
    rounded to ``cdt`` and the sums in f32, as _mmw (swin_block_kernels.py
    :246) with ``.astype(cdt)`` operands.

    A' is LN(a) (``ln`` = (w, b), _ln_fwd), a_gain[row // rps] * a (times
    gamma[k] with ``ls`` "pro"), or a; W' is w ([N, K], a torch Linear
    weight) or, with ``w_kn``, w read as [K, N]. The epilogues
    (``GEMM_EPILOGUES``): "bias" out = v; "gelu" out = gelu_erf(v);
    "residual" out = lam * resid + gains[row // rps] * (v [* gamma] with
    ``ls`` "epi"), formed in f32 and cast once; "gelu_grad" out =
    gelu_erf(v), out32 = gelu_erf'(v); "f32" out32 = v; "mul_f32" out32 *=
    v, in place, as K2b's dh1 = dh * GELU' overwrites GELU'; "add_resid"
    out = lam * resid + v; with v = a' @ w' (+ bias). out is in
    ``out_dtype`` (default ``cdt``). Returns (out, out32), None where the
    epilogue writes none."""
    m = a.shape[0]
    rps = m if rows_per_sample is None else rows_per_sample
    a32 = a.float()
    if ln is not None:
        a32 = _ln_parts(a32, *ln)[0]
    elif a_gain is not None:
        a32 = _gain_rows(a_gain, rps, m) * a32
        if ls == "pro":
            a32 = a32 * gamma
    v = _mm(a32, w.t() if w_kn else w, cdt)
    if bias is not None:
        v = v + bias
    res = None
    if epi == "f32":
        return None, v
    if epi == "mul_f32":
        return None, out32.mul_(v)
    if epi == "gelu_grad":
        res = _gelu_grad(v)
    if epi in ("gelu", "gelu_grad"):
        v = F.gelu(v)
    if epi == "residual":
        v = lam * resid.float() + _gain_rows(gains, rps, m) * (
            v * gamma if ls == "epi" else v)
    if epi == "add_resid":
        v = lam * resid.float() + v
    return v.to(out_dtype or cdt), res


def wgrad_reference(a, b, cdt, a_gain=None, rows_per_sample=None):
    """Plain version of one weight-gradient launch of K1b / K2b (csrc/
    common.cuh ``launch_wgrad``): out [N1, N2] = sum_m round(g_m a[m, n1])
    round(b[m, n2]) in f32, with g_m = a_gain[m // rps] or 1 (the
    dot_generals over the token rows of _attn_bwd_kernel / _mlp_bwd_kernel,
    e.g. dW2 = h^T do, :917-935)."""
    a32 = a.float()
    if a_gain is not None:
        m = a.shape[0]
        a32 = _gain_rows(a_gain, m if rows_per_sample is None
                         else rows_per_sample, m) * a32
    return _r(a32, cdt).t() @ _r(b, cdt)


def _check_rows(t, name, m, k, dtype, dev):
    """A [m, k] operand whose rows may lie further apart than k (the q slice
    of a packed qkv): unit column stride, row stride >= k."""
    if t.device != dev:
        raise ValueError(f"{name}: on {t.device}, expected {dev}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if (t.dim() != 2 or tuple(t.shape) != (m, k) or t.stride(1) != 1
            or t.stride(0) < k):
        raise ValueError(f"{name}: shape {tuple(t.shape)} strides "
                         f"{t.stride()}, expected ({m}, {k}) rows of unit "
                         f"stride")


def gemm_launch(a, w, epi, cdt, *, w_kn=False, ln=None, a_gain=None,
                rows_per_sample=None, gamma=None, ls=None, bias=None,
                resid=None, gains=None, lam=1.0, out32=None, out_dtype=None,
                _fma=False):
    """One GEMM launch of K1 / K2 alone (csrc/gemm.cu ``vsn_gemm``), for
    the card's launch-level checks (K1 and K2 make it inside their own
    calls): the CUDA kernel for a CUDA tensor (bf16 ``cdt``: the tensor-core
    body; f32: the FMA body), ``gemm_reference`` for a CPU one; same
    arguments and returns. ``a`` [M, K] may be a row-strided view (the
    probes' ``lda``); it is ``cdt`` or, for the modes of ``GEMM_F32_A``
    under bf16, f32. ``_fma`` launches the FMA body on bf16 operands, the
    body every bf16 GEMM took before the tensor cores (chip_smoke.py's
    yardstick; counted apart, as ``gemm_fma``). A combination that K1,
    K2 and the probes do not launch raises."""
    kw = dict(w_kn=w_kn, ln=ln, a_gain=a_gain, rows_per_sample=rows_per_sample,
              gamma=gamma, ls=ls, bias=bias, resid=resid, gains=gains,
              lam=lam, out32=out32, out_dtype=out_dtype)
    if a.device.type == "cpu":
        return gemm_reference(a, w, epi, cdt, **kw)
    bf16 = cdt == torch.bfloat16
    out_dtype = out_dtype or cdt
    mode = (epi, ls, w_kn)
    ta_f32 = bf16 and a.dtype == torch.float32
    to_f32 = bf16 and out_dtype == torch.float32
    if not ((mode in GEMM_MODES and not to_f32
             and (not ta_f32 or mode in GEMM_F32_A))
            or (bf16 and mode == GEMM_PROBE and not ta_f32)) or (
                _fma and not bf16) or cdt not in (torch.bfloat16,
                                                  torch.float32):
        raise ValueError(f"gemm_launch: {epi}, LayerScale {ls}, w_kn {w_kn},"
                         f" A {a.dtype}, out {out_dtype} under {cdt}: not a "
                         "launch of K1 / K2")
    m, k = a.shape
    n = w.shape[1] if w_kn else w.shape[0]
    dev, f32 = a.device, torch.float32
    _check_rows(a, "a", m, k, f32 if ta_f32 else cdt, dev)
    expect(w, "w", (k, n) if w_kn else (n, k), f32, dev)
    rps = m if rows_per_sample is None else rows_per_sample
    for t, name, shape, dt in (
            (bias, "bias", (n,), f32),
            (gamma, "gamma", (k,) if ls == "pro" else (n,), f32),
            (resid, "resid", (m, n), out_dtype),
            (out32, "out32", (m, n), f32),
            *[(t, nm, (k,), f32) for t, nm in zip(ln or (), ("ln_w", "ln_b"))],
            (a_gain, "a_gain", (-(-m // rps),), f32),
            (gains, "gains", (-(-m // rps),), f32)):
        if t is not None:
            expect(t, name, shape, dt, dev)
    if (ls is None) != (gamma is None) or (
            epi in ("residual", "add_resid") and resid is None) or (
            epi == "residual" and gains is None) or (
            epi == "mul_f32" and out32 is None) or (
            ls == "pro" and a_gain is None):
        raise ValueError(f"gemm_launch: {epi} (LayerScale {ls}) lacks an "
                         "argument")
    out = (torch.empty((m, n), dtype=out_dtype, device=dev)
           if epi in _WRITES_OUT else None)
    if epi in ("gelu_grad", "f32"):
        out32 = torch.empty((m, n), dtype=f32, device=dev)
    ln_w, ln_b = ln if ln is not None else (None, None)
    with torch.cuda.device(dev):
        err = library().vsn_gemm(
            int(bf16), int(ta_f32), int(to_f32), GEMM_EPILOGUES.index(epi),
            LS_FLAGS[ls], int(w_kn), int(_fma), a.data_ptr(), a.stride(0),
            ptr(a_gain), rps, ptr(ln_w), ptr(ln_b), w.data_ptr(), ptr(bias),
            ptr(resid), ptr(gains), float(lam), ptr(gamma), ptr(out),
            ptr(out32), m, n, k, stream_of(a))
    check(err, "gemm")
    launches["gemm_fma" if _fma else "gemm"] += 1
    return out, out32 if epi in _WRITES_OUT32 else None


def wgrad_launch(a, b, cdt, a_gain=None, rows_per_sample=None, _fma=False):
    """One weight-gradient launch of K1b / K2b alone (csrc/gemm.cu
    ``vsn_wgrad``), for the card's launch-level checks: the CUDA kernel for
    a CUDA tensor (bf16: the tensor-core body; f32: the FMA body; ``_fma``
    the FMA body on bf16 operands, counted as ``wgrad_fma``),
    ``wgrad_reference`` for a CPU one; same arguments and returns. a [M,
    N1] is ``cdt`` or, under bf16, f32 (dy, dh1); b [M, N2] is ``cdt``."""
    if a.device.type == "cpu":
        return wgrad_reference(a, b, cdt, a_gain, rows_per_sample)
    bf16 = cdt == torch.bfloat16
    if cdt not in (torch.bfloat16, torch.float32) or (_fma and not bf16) or (
            a.dtype not in (cdt, torch.float32)):
        raise ValueError(f"wgrad_launch: A {a.dtype} under {cdt}")
    (m, n1), n2 = a.shape, b.shape[1]
    dev = a.device
    rps = m if rows_per_sample is None else rows_per_sample
    expect(a, "a", (m, n1), a.dtype, dev)
    expect(b, "b", (m, n2), cdt, dev)
    if a_gain is not None:
        expect(a_gain, "a_gain", (-(-m // rps),), torch.float32, dev)
    out = torch.zeros((n1, n2), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = library().vsn_wgrad(
            int(bf16), int(bf16 and a.dtype == torch.float32), int(_fma),
            a.data_ptr(), ptr(a_gain), rps, b.data_ptr(), out.data_ptr(), m,
            n1, n2, stream_of(a))
    check(err, "wgrad")
    launches["wgrad_fma" if _fma else "wgrad"] += 1
    return out


# ---------------------------------------------------------------------------
# The row kernels of K1 / K2 alone: the LayerNorm backward, and the others
# ---------------------------------------------------------------------------

def _row_scratch(dev, m, ln_c=None, sums=()):
    """The f32 scratch of block partials that the row kernels of one call
    over ``m`` rows share (they run one after another on its stream), and
    its size in floats: the LN backward's [blocks, 2C] at width ``ln_c``
    (csrc/common.cuh ``ln_bwd_plan``, asked through ``vsn_ln_bwd_blocks``)
    and the column sums' [blocks, N] at each width N of ``sums``
    (``colsum_plan``, ``vsn_colsum_blocks``), each plan a function of the
    call's shape alone; raises for a width the LN backward does not take
    (above 8192)."""
    lib, floats = library(), 0
    if ln_c is not None:
        blocks = lib.vsn_ln_bwd_blocks(m, ln_c)
        if not blocks:
            raise ValueError(f"LayerNorm backward: C = {ln_c}: the row "
                             "kernels take C <= 8192")
        floats = 2 * ln_c * blocks
    for n in sums:
        floats = max(floats, n * lib.vsn_colsum_blocks(m, n))
    return torch.empty(floats, dtype=torch.float32, device=dev), floats


def ln_backward_rows_reference(x, stats, w, dy, do_res, lam=1.0):
    """Plain version of the pre-norm LN-backward launch (csrc/common.cuh
    ``launch_ln_bwd``; K1b's and K2b's last line, swin_block_kernels.py
    :440-444, :971): from x [M, C] and do_res [M, C] in the activation type,
    LN's row statistics [M, 2] (mean, 1 / std), its scale w [C] and dy [M, C]
    f32 -> (dx = T(lam * do_res + LN_bwd(dy)), dw, db), as _ln_bwd."""
    xhat = (x.float() - stats[:, :1]) * stats[:, 1:]
    dxn, dw, db = _ln_backward(dy, w, xhat, stats[:, 1:])
    return (lam * do_res.float() + dxn).to(x.dtype), dw, db


def postnorm_backward_rows_reference(branch, do_res, gb, rows_per_sample, w, b,
                                     gamma=None):
    """Plain version of the post-norm LN-backward launch (csrc/common.cuh
    ``launch_postnorm_bwd``; swin_block_kernels.py :388-397, :917-926): from
    the f32 branch [M, C], do_res [M, C] in the activation type and the
    per-sample gains gb [M / rows_per_sample] -> (dbranch [M, C] f32, dw, db,
    dgamma or None without gamma): do = gb * do_res, dgamma = sum do *
    LN(branch), then LN's backward of do * gamma."""
    bn, xhat, rstd = _ln_parts(branch.float(), w, b)
    do = _gain_rows(gb, rows_per_sample, branch.shape[0]) * do_res.float()
    dgamma = None
    if gamma is not None:
        dgamma = (do * bn).sum(0)
        do = do * gamma
    dbranch, dw, db = _ln_backward(do, w, xhat, rstd)
    return dbranch, dw, db, dgamma


def _aligned16(t):
    """``t``, or a copy of it where its data does not start on a 16-byte
    boundary: the LN-backward body reads and writes its rows by 16-byte
    vectors."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check_act(t):
    """A row kernel's activations are f32 or bf16."""
    if t.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"row kernel: dtype {t.dtype} (f32 or bf16)")


def ln_bwd_launch(x, stats, w, dy, do_res, lam=1.0):
    """The pre-norm LN-backward launches alone (csrc/row_kernels.cu
    ``vsn_ln_bwd``: the rows, then the block-ordered sum of dw / db), for the
    card's launch-level checks (K1b and K2b make them inside their own
    calls): the CUDA kernels for a CUDA tensor, ``ln_backward_rows_reference``
    for a CPU one; same arguments and returns."""
    if x.device.type == "cpu":
        return ln_backward_rows_reference(x, stats, w, dy, do_res, lam)
    m, c = x.shape
    _check_act(x)
    f32, dev = torch.float32, x.device
    expect(x, "x", (m, c), x.dtype, dev)
    expect(stats, "stats", (m, 2), f32, dev)
    expect(w, "w", (c,), f32, dev)
    expect(dy, "dy", (m, c), f32, dev)
    expect(do_res, "do_res", (m, c), x.dtype, dev)
    part, floats = _row_scratch(dev, m, c)
    x, dy, do_res = _aligned16(x), _aligned16(dy), _aligned16(do_res)
    dx = torch.empty_like(x)
    grads = torch.empty(2 * c, dtype=f32, device=dev)
    dw, db = grads.split((c, c))
    with torch.cuda.device(dev):
        err = library().vsn_ln_bwd(
            int(x.dtype == torch.bfloat16), x.data_ptr(), stats.data_ptr(),
            w.data_ptr(), dy.data_ptr(), do_res.data_ptr(), float(lam),
            dx.data_ptr(), dw.data_ptr(), db.data_ptr(), part.data_ptr(),
            floats, m, c, stream_of(x))
    check(err, "ln_bwd")
    launches["ln_bwd"] += 1
    return dx, dw, db


def postnorm_bwd_launch(branch, do_res, gb, rows_per_sample, w, b,
                        gamma=None):
    """The post-norm LN-backward launches alone (``vsn_postnorm_bwd``), for
    the card's launch-level checks: the CUDA kernels for a CUDA tensor, which
    overwrite ``branch`` with dbranch as K1b / K2b overwrite theirs and
    return it; ``postnorm_backward_rows_reference`` for a CPU one; same
    arguments and returns."""
    if branch.device.type == "cpu":
        return postnorm_backward_rows_reference(branch, do_res, gb,
                                                rows_per_sample, w, b, gamma)
    m, c = branch.shape
    _check_act(do_res)
    f32, dev = torch.float32, branch.device
    expect(branch, "branch", (m, c), f32, dev)
    expect(do_res, "do_res", (m, c), do_res.dtype, dev)
    if m % rows_per_sample:
        raise ValueError(f"postnorm_bwd: {m} rows over samples of "
                         f"{rows_per_sample}")
    if branch.data_ptr() % 16:
        raise ValueError("postnorm_bwd: the branch, which the kernel "
                         "overwrites, must start on a 16-byte boundary")
    do_res = _aligned16(do_res)
    expect(gb, "gb", (m // rows_per_sample,), f32, dev)
    for t, name in ((w, "w"), (b, "b"), (gamma, "gamma")):
        if t is not None:
            expect(t, name, (c,), f32, dev)
    part, floats = _row_scratch(dev, m, c)
    grads = torch.empty(3 * c, dtype=f32, device=dev)
    dw, db, dgamma = grads.split((c, c, c))
    with torch.cuda.device(dev):
        err = library().vsn_postnorm_bwd(
            int(do_res.dtype == torch.bfloat16), branch.data_ptr(),
            do_res.data_ptr(), gb.data_ptr(), rows_per_sample, w.data_ptr(),
            b.data_ptr(), ptr(gamma), dw.data_ptr(), db.data_ptr(),
            dgamma.data_ptr(), part.data_ptr(), floats, m, c,
            stream_of(branch))
    check(err, "postnorm_bwd")
    launches["postnorm_bwd"] += 1
    return branch, dw, db, dgamma if gamma is not None else None


def ln_rows_reference(x, w, b, out_dtype=None):
    """Plain version of ``ln_rows_kernel`` (K1b / K2b's LN rows, and the
    probe P1 ``attn_only``'s on f32 x into bf16): (y = LN(x) in
    ``out_dtype``, x's by default; the row statistics [M, 2] (mean, 1 /
    std))."""
    y, xhat, rstd = _ln_parts(x.float(), w, b)
    mu = x.float().mean(dim=-1, keepdim=True)
    return y.to(out_dtype or x.dtype), torch.cat([mu, rstd], dim=-1)


def colsum_reference(a, a_gain=None, rows_per_sample=None):
    """Plain version of ``colsum_kernel`` (the bias gradients): [N] f32 =
    sum_m g_m a[m, :], g_m = a_gain[m // rps] or 1."""
    a32 = a.float()
    if a_gain is not None:
        a32 = _gain_rows(a_gain, rows_per_sample, a.shape[0]) * a32
    return a32.sum(0)


def postnorm_fwd_reference(branch, x, w, b, gamma, gains, rows_per_sample,
                           lam=1.0):
    """Plain version of ``postnorm_fwd_kernel``: T(lam * x + gains[row //
    rps] * (LN(branch) [* gamma]))."""
    bn = _branch_out(branch, w, b, gamma, True)
    g = _gain_rows(gains, rows_per_sample, branch.shape[0])
    return (lam * x.float() + g * bn).to(x.dtype)


def layerscale_grads_reference(w, bias, gamma, dw, db, dgamma):
    """Plain version of ``layerscale_grads_kernel``: (dw * gamma, db * gamma,
    dgamma + rowsum(w * dw) + bias * db) from the unscaled dw [N, K] and db
    [N]."""
    return (dw * gamma[:, None], db * gamma,
            dgamma + (w * dw).sum(1) + bias * db)


def _row_launch(key, dev, fn):
    with torch.cuda.device(dev):
        err = fn(library())
    check(err, key)
    launches[key] += 1


def ln_rows_launch(x, w, b, out_dtype=None):
    """``ln_rows_kernel`` alone (``vsn_ln_rows``, C <= 8192; y in x's dtype,
    or bf16 from f32 x as the probe P1 ``attn_only`` takes it): the kernel
    for a CUDA tensor, ``ln_rows_reference`` for a CPU one."""
    if x.device.type == "cpu":
        return ln_rows_reference(x, w, b, out_dtype)
    m, c = x.shape
    _check_act(x)
    f32, dev = torch.float32, x.device
    expect(x, "x", (m, c), x.dtype, dev)
    expect(w, "w", (c,), f32, dev)
    expect(b, "b", (c,), f32, dev)
    out_dtype = out_dtype or x.dtype
    if out_dtype not in (x.dtype, torch.bfloat16):
        raise TypeError(f"ln_rows_launch: y {out_dtype} from x {x.dtype}")
    x = _aligned16(x)
    y = torch.empty(x.shape, dtype=out_dtype, device=dev)
    stats = torch.empty((m, 2), dtype=f32, device=dev)
    _row_launch("ln_rows", dev, lambda lib: lib.vsn_ln_rows(
        int(x.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16),
        x.data_ptr(), w.data_ptr(),
        b.data_ptr(), y.data_ptr(), stats.data_ptr(), m, c, stream_of(x)))
    return y, stats


def colsum_launch(a, a_gain=None, rows_per_sample=None):
    """``colsum_kernel`` alone (``vsn_colsum``: the block partials, then
    their block-ordered sum): a [M, N] bf16 (the gated do_res) or f32 (dh1,
    dbranch), any N; the kernels for a CUDA tensor, ``colsum_reference`` for
    a CPU one."""
    if a.device.type == "cpu":
        return colsum_reference(a, a_gain, rows_per_sample)
    m, n = a.shape
    _check_act(a)
    f32, dev = torch.float32, a.device
    expect(a, "a", (m, n), a.dtype, dev)
    rps = m if rows_per_sample is None else rows_per_sample
    if a_gain is not None:
        expect(a_gain, "a_gain", (-(-m // rps),), f32, dev)
    a = _aligned16(a)
    out = torch.empty(n, dtype=f32, device=dev)
    part, floats = _row_scratch(dev, m, sums=(n,))
    _row_launch("colsum", dev, lambda lib: lib.vsn_colsum(
        int(a.dtype == torch.bfloat16), int(a.dtype == f32), a.data_ptr(),
        ptr(a_gain), rps, out.data_ptr(), part.data_ptr(), floats, m, n,
        stream_of(a)))
    return out


def postnorm_fwd_launch(branch, x, w, b, gamma, gains, rows_per_sample,
                        lam=1.0):
    """``postnorm_fwd_kernel`` alone (``vsn_postnorm_fwd``, C <= 8192):
    the kernel for a CUDA tensor, ``postnorm_fwd_reference`` for a CPU
    one."""
    if x.device.type == "cpu":
        return postnorm_fwd_reference(branch, x, w, b, gamma, gains,
                                      rows_per_sample, lam)
    m, c = x.shape
    _check_act(x)
    f32, dev = torch.float32, x.device
    expect(branch, "branch", (m, c), f32, dev)
    expect(x, "x", (m, c), x.dtype, dev)
    for t, name in ((w, "w"), (b, "b"), (gamma, "gamma")):
        if t is not None:
            expect(t, name, (c,), f32, dev)
    expect(gains, "gains", (-(-m // rows_per_sample),), f32, dev)
    branch, x = _aligned16(branch), _aligned16(x)
    out = torch.empty_like(x)
    _row_launch("postnorm_fwd", dev, lambda lib: lib.vsn_postnorm_fwd(
        int(x.dtype == torch.bfloat16), branch.data_ptr(), x.data_ptr(),
        w.data_ptr(), b.data_ptr(), ptr(gamma), gains.data_ptr(),
        rows_per_sample, float(lam), out.data_ptr(), m, c, stream_of(x)))
    return out


def layerscale_grads_launch(w, bias, gamma, dw, db, dgamma):
    """``layerscale_grads_kernel`` alone (``vsn_layerscale_grads``), on
    copies of dw, db and dgamma, which it updates in place: the kernel for a
    CUDA tensor, ``layerscale_grads_reference`` for a CPU one; same
    returns."""
    if w.device.type == "cpu":
        return layerscale_grads_reference(w, bias, gamma, dw, db, dgamma)
    n, k = w.shape
    dev, f32 = w.device, torch.float32
    for t, name, shape in ((w, "w", (n, k)), (dw, "dw", (n, k)),
                           (bias, "bias", (n,)), (gamma, "gamma", (n,)),
                           (db, "db", (n,)), (dgamma, "dgamma", (n,))):
        expect(t, name, shape, f32, dev)
    dw, db, dgamma = dw.clone(), db.clone(), dgamma.clone()
    _row_launch("layerscale_grads", dev,
                lambda lib: lib.vsn_layerscale_grads(
                    w.data_ptr(), bias.data_ptr(), gamma.data_ptr(),
                    dw.data_ptr(), db.data_ptr(), dgamma.data_ptr(), n, k,
                    stream_of(w)))
    return dw, db, dgamma


# The row kernels that K1 / K2 launch besides the LN backward, alone:
# name -> (launch wrapper, plain version)
ROW_KERNELS = {
    "ln_rows": (ln_rows_launch, ln_rows_reference),
    "colsum": (colsum_launch, colsum_reference),
    "postnorm_fwd": (postnorm_fwd_launch, postnorm_fwd_reference),
    "layerscale_grads": (layerscale_grads_launch, layerscale_grads_reference),
}


def attn_half_backward(x, norm_w, norm_b, qkv_w, qkv_b, bias, ids, proj_w,
                       gb, dout, scale, num_heads, lam=1.0, proj_b=None,
                       gamma=None, post_norm=False, ao=None, stats=None,
                       o32=None):
    """VJP of ``attn_half``: K1b (``csrc/attn_half_bwd.cu``) for a CUDA
    tensor; ``attn_half_backward_reference`` for a CPU one (which recomputes
    ao); same returns. On the card K1b reads ``ao``, K1f's attention output
    of this call, where the TPU kernel recomputes it, and K1f's row
    ``stats`` and (bf16) ``o32`` (``_attn_half_kernel``'s second to fourth
    returns)."""
    if x.device.type == "cpu":
        return attn_half_backward_reference(x, norm_w, norm_b, qkv_w, qkv_b,
                                            bias, ids, proj_w, gb, dout,
                                            scale, num_heads, lam, proj_b,
                                            gamma, post_norm)
    if (gamma is not None or post_norm) and proj_b is None:
        raise ValueError("attn_half_backward: LayerScale and post-norm need "
                         "proj_b")
    ids_rows, nsamp = _check_attn(x, norm_w, norm_b, qkv_w, qkv_b, bias, ids,
                                  proj_w, proj_b, gb, gb, num_heads, gamma)
    expect(dout, "dout", tuple(x.shape), x.dtype, x.device)
    bw, n, c = x.shape
    if (ao is None or stats is None
            or (o32 is None) != (x.dtype == torch.float32)):
        raise ValueError("attn_half_backward: K1b needs K1f's ao, row "
                         "statistics (and o32 for bf16)")
    expect(ao, "ao", tuple(x.shape), x.dtype, x.device)
    expect(stats, "stats", (bw, num_heads, n, 2), torch.float32, x.device)
    if o32 is not None:
        expect(o32, "o32", tuple(x.shape), torch.float32, x.device)
    rows, dev, dt = bw * n, x.device, x.dtype
    x, dout = _aligned16(x), _aligned16(dout)   # the LN backward's rows
    # the f32 gradients the kernels add into, zeroed in one buffer; dproj_w
    # first, 16-byte aligned: the LayerScale gradients read and write its
    # rows by 16-byte vectors
    sizes = (c * c, c, c, 3 * c * c, 3 * c, num_heads * n * n
             if bias is not None else 0, c, c if gamma is not None else 0)
    grads = torch.zeros(sum(sizes), dtype=torch.float32, device=dev)
    (dproj_w, dln_w, dln_b, dqkv_w, dqkv_b, dbias, dproj_b,
     dgamma) = grads.split(sizes)
    y = torch.empty((rows, c), dtype=dt, device=dev)
    ln_stats = torch.empty((rows, 2), dtype=torch.float32, device=dev)
    qkv = torch.empty((rows, 3 * c), dtype=dt, device=dev)
    dao = torch.empty((rows, c), dtype=dt, device=dev)
    dqkv = torch.empty((rows, 3 * c), dtype=dt, device=dev)
    dy = torch.empty((rows, c), dtype=torch.float32, device=dev)
    dx = torch.empty_like(x)
    s1 = torch.empty((bw, num_heads, n), dtype=torch.float32, device=dev)
    part, floats = _row_scratch(dev, rows, c, (c,))
    with torch.cuda.device(dev):
        err = library().vsn_attn_half_bwd(
            int(dt == torch.bfloat16), x.data_ptr(),
            norm_w.data_ptr(), norm_b.data_ptr(), qkv_w.data_ptr(),
            ptr(qkv_b), ptr(bias), ptr(ids), ids_rows,
            proj_w.data_ptr(), ptr(proj_b), ptr(gamma), int(post_norm),
            gb.data_ptr(), dout.data_ptr(), y.data_ptr(), ln_stats.data_ptr(),
            qkv.data_ptr(), dao.data_ptr(), ao.data_ptr(), dqkv.data_ptr(),
            dy.data_ptr(), dx.data_ptr(), dln_w.data_ptr(), dln_b.data_ptr(),
            dqkv_w.data_ptr(), dqkv_b.data_ptr(),
            dbias.data_ptr() if bias is not None else None,
            dproj_w.data_ptr(), dproj_b.data_ptr(),
            dgamma.data_ptr() if gamma is not None else None,
            ptr(o32), stats.data_ptr(), s1.data_ptr(), part.data_ptr(),
            floats, bw, n, c, num_heads, (bw // nsamp) * n, float(scale),
            float(lam), stream_of(x))
    check(err, "attn_half_bwd")
    launches[mode_key(k1_body(c // num_heads, "_bwd"), gamma,
                      post_norm)] += 1
    return (dx, dln_w, dln_b, dqkv_w.view(3 * c, c),
            dqkv_b if qkv_b is not None else None,
            dbias.view(num_heads, n, n) if bias is not None else None,
            dproj_w.view(c, c), dproj_b,
            dgamma if gamma is not None else None)


class _AttnHalf(torch.autograd.Function):
    """K1 with its VJP; ``plain`` selects the plain forward and backward. On
    the card the forward keeps what K1b reads of it: ao, the row statistics
    and (bf16) the f32 o."""

    @staticmethod
    def forward(ctx, plain, x, norm_w, norm_b, qkv_w, qkv_b, bias, ids,
                proj_w, proj_b, gf, gb, scale, num_heads, lam, gamma,
                post_norm):
        args = (x, norm_w, norm_b, qkv_w, qkv_b, bias, ids, proj_w, proj_b,
                gf, gb, scale, num_heads, lam, gamma, post_norm)
        ctx.plain, ctx.static = plain, (scale, num_heads, lam)
        ctx.post_norm = post_norm
        if plain:
            out, ao, stats, o32 = attn_half_math(*args), None, None, None
        else:
            out, ao, stats, o32 = _attn_half_kernel(*args)
        ctx.save_for_backward(x, norm_w, norm_b, qkv_w, qkv_b, bias, ids,
                              proj_w, gb, proj_b, gamma, ao, stats, o32)
        return out

    @staticmethod
    def backward(ctx, dout):
        (x, norm_w, norm_b, qkv_w, qkv_b, bias, ids, proj_w, gb, proj_b,
         gamma, ao, stats, o32) = ctx.saved_tensors
        args = (x, norm_w, norm_b, qkv_w, qkv_b, bias, ids, proj_w, gb,
                dout.contiguous(), *ctx.static)
        mode = dict(proj_b=proj_b, gamma=gamma, post_norm=ctx.post_norm)
        if ctx.plain:
            grads = attn_half_backward_reference(*args, **mode)
        else:
            grads = attn_half_backward(*args, ao=ao, stats=stats, o32=o32,
                                       **mode)
        (dx, dnorm_w, dnorm_b, dqkv_w, dqkv_b, dbias, dproj_w, dproj_b,
         dgamma) = grads
        return (None, dx, dnorm_w, dnorm_b, dqkv_w, dqkv_b, dbias, None,
                dproj_w, dproj_b, None, None, None, None, None, dgamma, None)


def attn_half(x, norm_w, norm_b, qkv_w, qkv_b, bias, ids, proj_w, proj_b,
              gf, gb, scale, num_heads, lam=1.0, gamma=None, post_norm=False):
    """lam * x + gf[s] * (gamma *) [LN](proj(window_attention(qkv([LN](x)))))
    per window: the LayerNorm on the input (pre-norm) or on the branch
    (``post_norm``).

    Args:
        x: [BW, N, C] raw window tokens, f32 or bf16; windows are
            sample-major (window bw belongs to sample bw // (BW // B)).
        norm_w, norm_b: [C] f32 LayerNorm scale/shift (eps 1e-5).
        qkv_w: [3C, C] f32; qkv_b: [3C] f32 or None.
        bias: [H, N, N] f32 relative-position bias, or None.
        ids: [W, N] int32 region ids (window bw uses row bw % W; ids that
            differ are masked with -1e9), or None for no mask.
        proj_w: [C, C] f32; proj_b: [C] f32.
        gf, gb: [B] f32 per-sample branch gains, forward and backward.
        scale, num_heads, lam: attention scale, heads (C / heads <= 8192),
            residual x-gain.
        gamma: [C] f32 LayerScale of the branch (before the gains), or None.
        post_norm: the LayerNorm applies to the proj output, not to x.
    Returns: [BW, N, C] in x's dtype. Differentiable in x and the
    parameters, gamma included (K1b on a CUDA device).
    """
    return _AttnHalf.apply(x.device.type == "cpu", x, norm_w, norm_b, qkv_w,
                           qkv_b, bias, ids, proj_w, proj_b, gf, gb, scale,
                           num_heads, lam, gamma, post_norm)


def attn_half_reference(x, norm_w, norm_b, qkv_w, qkv_b, bias, ids, proj_w,
                        proj_b, gf, gb, scale, num_heads, lam=1.0, gamma=None,
                        post_norm=False):
    """Plain version of ``attn_half`` on any device: the plain forward, and
    ``attn_half_backward_reference`` as its backward."""
    return _AttnHalf.apply(True, x, norm_w, norm_b, qkv_w, qkv_b, bias, ids,
                           proj_w, proj_b, gf, gb, scale, num_heads, lam,
                           gamma, post_norm)


# ---------------------------------------------------------------------------
# K2: LN2 + fc1 + exact GELU + fc2 + gated residual
# ---------------------------------------------------------------------------

def ln_mlp_math(x, norm_w, norm_b, fc1_w, fc1_b, fc2_w, fc2_b, gf, gb,
                lam=1.0, gamma=None, post_norm=False):
    """The forward of ``ln_mlp`` in plain PyTorch ops (differentiable by
    autograd; the residual's backward uses gb)."""
    cdt = _compute_dtype(x)
    y = x.float() if post_norm else _ln_parts(x.float(), norm_w, norm_b)[0]
    h = F.gelu(_mm(y, fc1_w, cdt) + fc1_b)
    branch = _branch_out(_mm(h, fc2_w, cdt) + fc2_b, norm_w, norm_b, gamma,
                         post_norm)
    return _residual(x, branch, gf, gb, lam)


def _gelu_grad(h1):
    """d/dh gelu_erf(h) = Phi(h) + h * phi(h) (_gelu_grad:117)."""
    cdf = 0.5 * (1.0 + torch.erf(h1 * 0.7071067811865476))
    return cdf + h1 * 0.3989422804014327 * torch.exp(-0.5 * h1 * h1)


def ln_mlp_backward_reference(x, norm_w, norm_b, fc1_w, fc1_b, fc2_w, gb,
                              dout, lam=1.0, fc2_b=None, gamma=None,
                              post_norm=False):
    """Plain VJP of ``ln_mlp``, mirroring _mlp_bwd_kernel. Returns (dx,
    dnorm_w, dnorm_b, dfc1_w, dfc1_b, dfc2_w, dfc2_b, dgamma); dgamma is
    None without gamma. ``fc2_b`` is needed with gamma or post-norm."""
    rows = x.shape[0]
    cdt = _compute_dtype(x)
    if post_norm:
        y, xhat, rstd = x.float(), None, None
    else:
        y, xhat, rstd = _ln_parts(x.float(), norm_w, norm_b)
    h1 = _mm(y, fc1_w, cdt) + fc1_b
    do_res = dout.float()
    do, dfc2_w, dfc2_b, dgamma, post = _out_backward(
        _row_gains(gb, rows) * do_res, F.gelu(h1), fc2_w, fc2_b, norm_w,
        norm_b, gamma, post_norm, cdt)
    dh1 = (_r(do, cdt) @ _r(fc2_w, cdt)) * _gelu_grad(h1)
    dfc1_w = _r(dh1, cdt).t() @ _r(y, cdt)
    dfc1_b = dh1.sum(0)
    dy = _r(dh1, cdt) @ _r(fc1_w, cdt)
    if post_norm:
        dxn, (dnorm_w, dnorm_b) = dy, post
    else:
        dxn, dnorm_w, dnorm_b = _ln_backward(dy, norm_w, xhat, rstd)
    dx = (lam * do_res + dxn).to(x.dtype)
    return dx, dnorm_w, dnorm_b, dfc1_w, dfc1_b, dfc2_w, dfc2_b, dgamma


def _check_mlp(x, norm_w, norm_b, fc1_w, fc1_b, fc2_w, fc2_b, gf, gb,
               gamma=None):
    """Validate K2's arguments (fc2_b and gamma may be None); returns
    nsamp."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"ln_mlp: x dtype {x.dtype} (f32 or bf16)")
    rows, c = x.shape
    hid = fc1_w.shape[0]
    dev, f32 = x.device, torch.float32
    expect(x, "x", (rows, c), x.dtype, dev)
    for t, name, shape in ((norm_w, "norm_w", (c,)), (norm_b, "norm_b", (c,)),
                           (fc1_w, "fc1_w", (hid, c)),
                           (fc1_b, "fc1_b", (hid,)),
                           (fc2_w, "fc2_w", (c, hid)),
                           (fc2_b, "fc2_b", (c,)),
                           (gamma, "gamma", (c,))):
        if t is not None:
            expect(t, name, shape, f32, dev)
    return _check_gains("ln_mlp", gf, gb, rows, dev)


def _ln_mlp_kernel(x, norm_w, norm_b, fc1_w, fc1_b, fc2_w, fc2_b, gf, gb,
                   lam, gamma=None, post_norm=False):
    """K2f: launch ``csrc/ln_mlp.cu``."""
    nsamp = _check_mlp(x, norm_w, norm_b, fc1_w, fc1_b, fc2_w, fc2_b, gf, gb,
                       gamma)
    if post_norm:   # as K1f's
        x = _aligned16(x)
    rows, c = x.shape
    hid = fc1_w.shape[0]
    out = torch.empty_like(x)
    hidden = torch.empty((rows, hid), dtype=x.dtype, device=x.device)
    branch = (torch.empty((rows, c), dtype=torch.float32, device=x.device)
              if post_norm else None)
    with torch.cuda.device(x.device):
        err = library().vsn_ln_mlp_fwd(
            int(x.dtype == torch.bfloat16), x.data_ptr(), norm_w.data_ptr(),
            norm_b.data_ptr(), fc1_w.data_ptr(), fc1_b.data_ptr(),
            fc2_w.data_ptr(), fc2_b.data_ptr(), gf.data_ptr(), ptr(gamma),
            int(post_norm), hidden.data_ptr(), ptr(branch), out.data_ptr(),
            rows, c, hid, rows // nsamp, float(lam), stream_of(x))
    check(err, "ln_mlp")
    launches[mode_key("ln_mlp", gamma, post_norm)] += 1
    return out


def ln_mlp_backward(x, norm_w, norm_b, fc1_w, fc1_b, fc2_w, gb, dout,
                    lam=1.0, fc2_b=None, gamma=None, post_norm=False):
    """VJP of ``ln_mlp``: K2b (``csrc/ln_mlp_bwd.cu``) for a CUDA tensor,
    ``ln_mlp_backward_reference`` for a CPU one; same returns."""
    if x.device.type == "cpu":
        return ln_mlp_backward_reference(x, norm_w, norm_b, fc1_w, fc1_b,
                                         fc2_w, gb, dout, lam, fc2_b, gamma,
                                         post_norm)
    if (gamma is not None or post_norm) and fc2_b is None:
        raise ValueError("ln_mlp_backward: LayerScale and post-norm need "
                         "fc2_b")
    nsamp = _check_mlp(x, norm_w, norm_b, fc1_w, fc1_b, fc2_w, fc2_b, gb, gb,
                       gamma)
    expect(dout, "dout", tuple(x.shape), x.dtype, x.device)
    rows, c = x.shape
    hid = fc1_w.shape[0]
    dev, dt = x.device, x.dtype
    x, dout = _aligned16(x), _aligned16(dout)   # the LN backward's rows
    # dfc2_w first, 16-byte aligned, as K1b's dproj_w
    sizes = (c * hid, c, c, hid * c, hid, c, c if gamma is not None else 0)
    grads = torch.zeros(sum(sizes), dtype=torch.float32, device=dev)
    dfc2_w, dln_w, dln_b, dfc1_w, dfc1_b, dfc2_b, dgamma = grads.split(sizes)
    y = torch.empty((rows, c), dtype=dt, device=dev)
    stats = torch.empty((rows, 2), dtype=torch.float32, device=dev)
    h = torch.empty((rows, hid), dtype=dt, device=dev)
    dh1 = torch.empty((rows, hid), dtype=torch.float32, device=dev)
    dy = torch.empty((rows, c), dtype=torch.float32, device=dev)
    dx = torch.empty_like(x)
    part, floats = _row_scratch(dev, rows, c, (c, hid))
    with torch.cuda.device(dev):
        err = library().vsn_ln_mlp_bwd(
            int(dt == torch.bfloat16), x.data_ptr(), norm_w.data_ptr(),
            norm_b.data_ptr(), fc1_w.data_ptr(), fc1_b.data_ptr(),
            fc2_w.data_ptr(), ptr(fc2_b), ptr(gamma), int(post_norm),
            gb.data_ptr(), dout.data_ptr(), y.data_ptr(), stats.data_ptr(),
            h.data_ptr(), dh1.data_ptr(), dy.data_ptr(), dx.data_ptr(),
            dln_w.data_ptr(), dln_b.data_ptr(), dfc1_w.data_ptr(),
            dfc1_b.data_ptr(), dfc2_w.data_ptr(), dfc2_b.data_ptr(),
            dgamma.data_ptr() if gamma is not None else None,
            part.data_ptr(), floats, rows, c, hid, rows // nsamp, float(lam),
            stream_of(x))
    check(err, "ln_mlp_bwd")
    launches[mode_key("ln_mlp_bwd", gamma, post_norm)] += 1
    return (dx, dln_w, dln_b, dfc1_w.view(hid, c), dfc1_b,
            dfc2_w.view(c, hid), dfc2_b,
            dgamma if gamma is not None else None)


class _LnMlp(torch.autograd.Function):
    """K2 with its VJP; ``plain`` selects the plain forward and backward."""

    @staticmethod
    def forward(ctx, plain, x, norm_w, norm_b, fc1_w, fc1_b, fc2_w, fc2_b,
                gf, gb, lam, gamma, post_norm):
        fwd = ln_mlp_math if plain else _ln_mlp_kernel
        ctx.plain, ctx.lam, ctx.post_norm = plain, lam, post_norm
        ctx.save_for_backward(x, norm_w, norm_b, fc1_w, fc1_b, fc2_w, gb,
                              fc2_b, gamma)
        return fwd(x, norm_w, norm_b, fc1_w, fc1_b, fc2_w, fc2_b, gf, gb,
                   lam, gamma, post_norm)

    @staticmethod
    def backward(ctx, dout):
        bwd = ln_mlp_backward_reference if ctx.plain else ln_mlp_backward
        *args, fc2_b, gamma = ctx.saved_tensors
        (dx, dnorm_w, dnorm_b, dfc1_w, dfc1_b, dfc2_w, dfc2_b,
         dgamma) = bwd(*args, dout.contiguous(), ctx.lam, fc2_b, gamma,
                       ctx.post_norm)
        return (None, dx, dnorm_w, dnorm_b, dfc1_w, dfc1_b, dfc2_w, dfc2_b,
                None, None, None, dgamma, None)


def ln_mlp(x, norm_w, norm_b, fc1_w, fc1_b, fc2_w, fc2_b, gf, gb, lam=1.0,
           gamma=None, post_norm=False):
    """lam * x + gf[row // (T // B)] * (gamma *) [LN](fc2(gelu_erf(fc1(
    [LN](x))))): the LayerNorm on the input (pre-norm) or on the branch
    (``post_norm``).

    Args:
        x: [T, C] tokens, f32 or bf16, sample-major (T divisible by B).
        norm_w, norm_b: [C] f32. fc1_w: [HID, C]; fc1_b: [HID];
        fc2_w: [C, HID]; fc2_b: [C] (f32).
        gf, gb: [B] f32 per-sample branch gains, forward and backward.
        lam: residual x-gain.
        gamma: [C] f32 LayerScale of the branch (before the gains), or None.
        post_norm: the LayerNorm applies to the fc2 output, not to x.
    Returns: [T, C] in x's dtype. Differentiable in x and the parameters,
    gamma included (K2b on a CUDA device).
    """
    return _LnMlp.apply(x.device.type == "cpu", x, norm_w, norm_b, fc1_w,
                        fc1_b, fc2_w, fc2_b, gf, gb, lam, gamma, post_norm)


def ln_mlp_reference(x, norm_w, norm_b, fc1_w, fc1_b, fc2_w, fc2_b, gf, gb,
                     lam=1.0, gamma=None, post_norm=False):
    """Plain version of ``ln_mlp`` on any device: the plain forward, and
    ``ln_mlp_backward_reference`` as its backward."""
    return _LnMlp.apply(True, x, norm_w, norm_b, fc1_w, fc1_b, fc2_w, fc2_b,
                        gf, gb, lam, gamma, post_norm)
