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
only the inputs and recomputes the forward, as the TPU kernels do.

``attn_half_reference`` / ``ln_mlp_reference`` are the plain versions: the
same Functions with the plain forward and the explicit plain backward
(``*_backward_reference``), which rounds operands where the TPU backward
kernels do. ``attn_half_math`` / ``ln_mlp_math`` are the bare forward math,
for autograd to differentiate as an independent check (in f32; in bf16
autograd rounds at other points).

Weights use the torch Linear layout ([out, in], f32), as the port's modules
hold them. LayerScale and post-norm, which the TPU kernels carry in band,
are not ported (ROADMAP).
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
from vsn_tpu_torch.ops.window_attention import mask_from_ids

LN_EPS = 1e-5
MAX_HEAD_DIM = 32  # one warp lane per head channel in the attention kernels


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


def _attention_parts(x, norm_w, norm_b, qkv_w, qkv_b, bias, ids, scale,
                     num_heads):
    """The forward up to the head-merged attention output, as K1 rounds it:
    returns (y, xhat, rstd, q, k, v, u, r, ao)."""
    bw, n, c = x.shape
    cdt = _compute_dtype(x)
    y, xhat, rstd = _ln_parts(x.float().reshape(bw * n, c), norm_w, norm_b)
    qkv = _mm(y, qkv_w, cdt)
    if qkv_b is not None:
        qkv = qkv + qkv_b
    qkv = _r(qkv, cdt).reshape(bw, n, 3, num_heads, c // num_heads)
    q, k, v = qkv.permute(2, 0, 3, 1, 4)                    # [BW, H, N, d]
    s = _scores(q, k, bias, ids, scale)
    m = s.amax(dim=-1, keepdim=True).clamp_min(0.0)
    u = torch.exp(s - m)
    r = 1.0 / (u.sum(dim=-1, keepdim=True) + 1e-30)
    ao = (_r(u, cdt) @ v) * r                               # [BW, H, N, d]
    return y, xhat, rstd, q, k, v, u, r, ao.transpose(1, 2).reshape(bw * n, c)


def attn_half_math(x, norm_w, norm_b, qkv_w, qkv_b, bias, ids, proj_w, proj_b,
                   gf, gb, scale, num_heads, lam=1.0):
    """The forward of ``attn_half`` in plain PyTorch ops (differentiable by
    autograd; the residual's backward uses gb)."""
    cdt = _compute_dtype(x)
    ao = _attention_parts(x, norm_w, norm_b, qkv_w, qkv_b, bias, ids, scale,
                          num_heads)[-1]
    branch = _mm(ao, proj_w, cdt) + proj_b
    return _residual(x, branch, gf, gb, lam)


def attn_half_backward_reference(x, norm_w, norm_b, qkv_w, qkv_b, bias, ids,
                                 proj_w, gb, dout, scale, num_heads,
                                 lam=1.0):
    """Plain VJP of ``attn_half``, mirroring _attn_bwd_kernel: recompute,
    then the p-basis attention backward. Returns (dx, dnorm_w, dnorm_b,
    dqkv_w, dqkv_b, dbias, dproj_w, dproj_b); dqkv_b / dbias are None when
    qkv_b / bias are."""
    bw, n, c = x.shape
    rows, hd = bw * n, c // num_heads
    cdt = _compute_dtype(x)
    y, xhat, rstd, q, k, v, u, r, ao = _attention_parts(
        x, norm_w, norm_b, qkv_w, qkv_b, bias, ids, scale, num_heads)
    do_res = dout.float().reshape(rows, c)
    do = _row_gains(gb, rows) * do_res
    dproj_w = _r(do, cdt).t() @ _r(ao, cdt)
    dproj_b = do.sum(0)
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
    dxn, dnorm_w, dnorm_b = _ln_backward(dy, norm_w, xhat, rstd)
    dx = (lam * do_res + dxn).to(x.dtype).reshape(x.shape)
    return dx, dnorm_w, dnorm_b, dqkv_w, dqkv_b, dbias, dproj_w, dproj_b


def _check_attn(x, norm_w, norm_b, qkv_w, qkv_b, bias, ids, proj_w, proj_b,
                gf, gb, num_heads):
    """Validate K1's arguments (qkv_b, bias, ids and proj_b may be None);
    returns (ids_rows, nsamp)."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"attn_half: x dtype {x.dtype} (f32 or bf16)")
    bw, n, c = x.shape
    if c % num_heads or c // num_heads > MAX_HEAD_DIM:
        raise ValueError(f"attn_half: C={c} over {num_heads} heads needs a "
                         f"head dim <= {MAX_HEAD_DIM}")
    dev, f32 = x.device, torch.float32
    expect(x, "x", (bw, n, c), x.dtype, dev)
    for t, name, shape in ((norm_w, "norm_w", (c,)), (norm_b, "norm_b", (c,)),
                           (qkv_w, "qkv_w", (3 * c, c)),
                           (qkv_b, "qkv_b", (3 * c,)),
                           (bias, "bias", (num_heads, n, n)),
                           (proj_w, "proj_w", (c, c)),
                           (proj_b, "proj_b", (c,))):
        if t is not None:
            expect(t, name, shape, f32, dev)
    ids_rows = 1
    if ids is not None:
        ids_rows = ids.shape[0]
        expect(ids, "ids", (ids_rows, n), torch.int32, dev)
        if bw % ids_rows:
            raise ValueError(f"attn_half: {ids_rows} id rows for {bw} windows")
    return ids_rows, _check_gains("attn_half", gf, gb, bw, dev)


def _attn_half_kernel(x, norm_w, norm_b, qkv_w, qkv_b, bias, ids, proj_w,
                      proj_b, gf, gb, scale, num_heads, lam):
    """K1f: launch ``csrc/attn_half.cu``."""
    ids_rows, nsamp = _check_attn(x, norm_w, norm_b, qkv_w, qkv_b, bias, ids,
                                  proj_w, proj_b, gf, gb, num_heads)
    bw, n, c = x.shape
    out = torch.empty_like(x)
    qkv_buf = torch.empty((bw * n, 3 * c), dtype=x.dtype, device=x.device)
    ao_buf = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = library().vsn_attn_half_fwd(
            int(x.dtype == torch.bfloat16), x.data_ptr(), norm_w.data_ptr(),
            norm_b.data_ptr(), qkv_w.data_ptr(), ptr(qkv_b), ptr(bias),
            ptr(ids), ids_rows, proj_w.data_ptr(), proj_b.data_ptr(),
            gf.data_ptr(), qkv_buf.data_ptr(), ao_buf.data_ptr(),
            out.data_ptr(), bw, n, c, num_heads, (bw // nsamp) * n,
            float(scale), float(lam), stream_of(x))
    check(err, "attn_half")
    launches["attn_half"] += 1
    return out


def attn_half_backward(x, norm_w, norm_b, qkv_w, qkv_b, bias, ids, proj_w,
                       gb, dout, scale, num_heads, lam=1.0):
    """VJP of ``attn_half``: K1b (``csrc/attn_half_bwd.cu``) for a CUDA
    tensor, ``attn_half_backward_reference`` for a CPU one; same returns."""
    if x.device.type == "cpu":
        return attn_half_backward_reference(x, norm_w, norm_b, qkv_w, qkv_b,
                                            bias, ids, proj_w, gb, dout,
                                            scale, num_heads, lam)
    ids_rows, nsamp = _check_attn(x, norm_w, norm_b, qkv_w, qkv_b, bias, ids,
                                  proj_w, None, gb, gb, num_heads)
    expect(dout, "dout", tuple(x.shape), x.dtype, x.device)
    bw, n, c = x.shape
    rows, dev, dt = bw * n, x.device, x.dtype
    # the f32 gradients the kernels add into, zeroed in one buffer
    sizes = (c, c, 3 * c * c, 3 * c, num_heads * n * n if bias is not None
             else 0, c * c, c)
    grads = torch.zeros(sum(sizes), dtype=torch.float32, device=dev)
    dln_w, dln_b, dqkv_w, dqkv_b, dbias, dproj_w, dproj_b = grads.split(sizes)
    bias_t = None if bias is None else bias.transpose(1, 2).contiguous()
    y = torch.empty((rows, c), dtype=dt, device=dev)
    stats = torch.empty((rows, 2), dtype=torch.float32, device=dev)
    qkv = torch.empty((rows, 3 * c), dtype=dt, device=dev)
    dao = torch.empty((rows, c), dtype=dt, device=dev)
    ao = torch.empty((rows, c), dtype=dt, device=dev)
    dqkv = torch.empty((rows, 3 * c), dtype=dt, device=dev)
    dy = torch.empty((rows, c), dtype=torch.float32, device=dev)
    dx = torch.empty_like(x)
    with torch.cuda.device(dev):
        err = library().vsn_attn_half_bwd(
            int(dt == torch.bfloat16), x.data_ptr(), norm_w.data_ptr(),
            norm_b.data_ptr(), qkv_w.data_ptr(), ptr(qkv_b), ptr(bias),
            ptr(bias_t), ptr(ids), ids_rows, proj_w.data_ptr(), gb.data_ptr(),
            dout.data_ptr(), y.data_ptr(), stats.data_ptr(), qkv.data_ptr(),
            dao.data_ptr(), ao.data_ptr(), dqkv.data_ptr(), dy.data_ptr(),
            dx.data_ptr(), dln_w.data_ptr(), dln_b.data_ptr(),
            dqkv_w.data_ptr(), dqkv_b.data_ptr(),
            dbias.data_ptr() if bias is not None else None,
            dproj_w.data_ptr(), dproj_b.data_ptr(), bw, n, c, num_heads,
            (bw // nsamp) * n, float(scale), float(lam), stream_of(x))
    check(err, "attn_half_bwd")
    launches["attn_half_bwd"] += 1
    return (dx, dln_w, dln_b, dqkv_w.view(3 * c, c),
            dqkv_b if qkv_b is not None else None,
            dbias.view(num_heads, n, n) if bias is not None else None,
            dproj_w.view(c, c), dproj_b)


class _AttnHalf(torch.autograd.Function):
    """K1 with its VJP; ``plain`` selects the plain forward and backward."""

    @staticmethod
    def forward(ctx, plain, x, norm_w, norm_b, qkv_w, qkv_b, bias, ids,
                proj_w, proj_b, gf, gb, scale, num_heads, lam):
        fwd = attn_half_math if plain else _attn_half_kernel
        ctx.plain, ctx.static = plain, (scale, num_heads, lam)
        ctx.save_for_backward(x, norm_w, norm_b, qkv_w, qkv_b, bias, ids,
                              proj_w, gb)
        return fwd(x, norm_w, norm_b, qkv_w, qkv_b, bias, ids, proj_w,
                   proj_b, gf, gb, scale, num_heads, lam)

    @staticmethod
    def backward(ctx, dout):
        bwd = (attn_half_backward_reference if ctx.plain
               else attn_half_backward)
        x, norm_w, norm_b, qkv_w, qkv_b, bias, ids, proj_w, gb = (
            ctx.saved_tensors)
        (dx, dnorm_w, dnorm_b, dqkv_w, dqkv_b, dbias, dproj_w,
         dproj_b) = bwd(x, norm_w, norm_b, qkv_w, qkv_b, bias, ids, proj_w,
                        gb, dout.contiguous(), *ctx.static)
        return (None, dx, dnorm_w, dnorm_b, dqkv_w, dqkv_b, dbias, None,
                dproj_w, dproj_b, None, None, None, None, None)


def attn_half(x, norm_w, norm_b, qkv_w, qkv_b, bias, ids, proj_w, proj_b,
              gf, gb, scale, num_heads, lam=1.0):
    """lam * x + gf[s] * proj(window_attention(qkv(LN(x)))), per window.

    Args:
        x: [BW, N, C] raw (pre-norm) window tokens, f32 or bf16; windows are
            sample-major (window bw belongs to sample bw // (BW // B)).
        norm_w, norm_b: [C] f32 LayerNorm scale/shift (eps 1e-5).
        qkv_w: [3C, C] f32; qkv_b: [3C] f32 or None.
        bias: [H, N, N] f32 relative-position bias, or None.
        ids: [W, N] int32 region ids (window bw uses row bw % W; ids that
            differ are masked with -1e9), or None for no mask.
        proj_w: [C, C] f32; proj_b: [C] f32.
        gf, gb: [B] f32 per-sample branch gains, forward and backward.
        scale, num_heads, lam: attention scale, heads (C / heads <= 32),
            residual x-gain.
    Returns: [BW, N, C] in x's dtype. Differentiable in x and the
    parameters (K1b on a CUDA device).
    """
    return _AttnHalf.apply(x.device.type == "cpu", x, norm_w, norm_b, qkv_w,
                           qkv_b, bias, ids, proj_w, proj_b, gf, gb, scale,
                           num_heads, lam)


def attn_half_reference(x, norm_w, norm_b, qkv_w, qkv_b, bias, ids, proj_w,
                        proj_b, gf, gb, scale, num_heads, lam=1.0):
    """Plain version of ``attn_half`` on any device: the plain forward, and
    ``attn_half_backward_reference`` as its backward."""
    return _AttnHalf.apply(True, x, norm_w, norm_b, qkv_w, qkv_b, bias, ids,
                           proj_w, proj_b, gf, gb, scale, num_heads, lam)


# ---------------------------------------------------------------------------
# K2: LN2 + fc1 + exact GELU + fc2 + gated residual
# ---------------------------------------------------------------------------

def ln_mlp_math(x, norm_w, norm_b, fc1_w, fc1_b, fc2_w, fc2_b, gf, gb,
                lam=1.0):
    """The forward of ``ln_mlp`` in plain PyTorch ops (differentiable by
    autograd; the residual's backward uses gb)."""
    cdt = _compute_dtype(x)
    h = F.gelu(_mm(_ln_parts(x.float(), norm_w, norm_b)[0], fc1_w, cdt)
               + fc1_b)
    return _residual(x, _mm(h, fc2_w, cdt) + fc2_b, gf, gb, lam)


def _gelu_grad(h1):
    """d/dh gelu_erf(h) = Phi(h) + h * phi(h) (_gelu_grad:117)."""
    cdf = 0.5 * (1.0 + torch.erf(h1 * 0.7071067811865476))
    return cdf + h1 * 0.3989422804014327 * torch.exp(-0.5 * h1 * h1)


def ln_mlp_backward_reference(x, norm_w, norm_b, fc1_w, fc1_b, fc2_w, gb,
                              dout, lam=1.0):
    """Plain VJP of ``ln_mlp``, mirroring _mlp_bwd_kernel. Returns (dx,
    dnorm_w, dnorm_b, dfc1_w, dfc1_b, dfc2_w, dfc2_b)."""
    rows = x.shape[0]
    cdt = _compute_dtype(x)
    y, xhat, rstd = _ln_parts(x.float(), norm_w, norm_b)
    h1 = _mm(y, fc1_w, cdt) + fc1_b
    do_res = dout.float()
    do = _row_gains(gb, rows) * do_res
    dfc2_w = _r(do, cdt).t() @ _r(F.gelu(h1), cdt)
    dfc2_b = do.sum(0)
    dh1 = (_r(do, cdt) @ _r(fc2_w, cdt)) * _gelu_grad(h1)
    dfc1_w = _r(dh1, cdt).t() @ _r(y, cdt)
    dfc1_b = dh1.sum(0)
    dy = _r(dh1, cdt) @ _r(fc1_w, cdt)
    dxn, dnorm_w, dnorm_b = _ln_backward(dy, norm_w, xhat, rstd)
    dx = (lam * do_res + dxn).to(x.dtype)
    return dx, dnorm_w, dnorm_b, dfc1_w, dfc1_b, dfc2_w, dfc2_b


def _check_mlp(x, norm_w, norm_b, fc1_w, fc1_b, fc2_w, fc2_b, gf, gb):
    """Validate K2's arguments (fc2_b may be None); returns nsamp."""
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
                           (fc2_b, "fc2_b", (c,))):
        if t is not None:
            expect(t, name, shape, f32, dev)
    return _check_gains("ln_mlp", gf, gb, rows, dev)


def _ln_mlp_kernel(x, norm_w, norm_b, fc1_w, fc1_b, fc2_w, fc2_b, gf, gb,
                   lam):
    """K2f: launch ``csrc/ln_mlp.cu``."""
    nsamp = _check_mlp(x, norm_w, norm_b, fc1_w, fc1_b, fc2_w, fc2_b, gf, gb)
    rows, c = x.shape
    hid = fc1_w.shape[0]
    out = torch.empty_like(x)
    hidden = torch.empty((rows, hid), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = library().vsn_ln_mlp_fwd(
            int(x.dtype == torch.bfloat16), x.data_ptr(), norm_w.data_ptr(),
            norm_b.data_ptr(), fc1_w.data_ptr(), fc1_b.data_ptr(),
            fc2_w.data_ptr(), fc2_b.data_ptr(), gf.data_ptr(),
            hidden.data_ptr(), out.data_ptr(), rows, c, hid, rows // nsamp,
            float(lam), stream_of(x))
    check(err, "ln_mlp")
    launches["ln_mlp"] += 1
    return out


def ln_mlp_backward(x, norm_w, norm_b, fc1_w, fc1_b, fc2_w, gb, dout,
                    lam=1.0):
    """VJP of ``ln_mlp``: K2b (``csrc/ln_mlp_bwd.cu``) for a CUDA tensor,
    ``ln_mlp_backward_reference`` for a CPU one; same returns."""
    if x.device.type == "cpu":
        return ln_mlp_backward_reference(x, norm_w, norm_b, fc1_w, fc1_b,
                                         fc2_w, gb, dout, lam)
    nsamp = _check_mlp(x, norm_w, norm_b, fc1_w, fc1_b, fc2_w, None, gb, gb)
    expect(dout, "dout", tuple(x.shape), x.dtype, x.device)
    rows, c = x.shape
    hid = fc1_w.shape[0]
    dev, dt = x.device, x.dtype
    sizes = (c, c, hid * c, hid, c * hid, c)
    grads = torch.zeros(sum(sizes), dtype=torch.float32, device=dev)
    dln_w, dln_b, dfc1_w, dfc1_b, dfc2_w, dfc2_b = grads.split(sizes)
    y = torch.empty((rows, c), dtype=dt, device=dev)
    stats = torch.empty((rows, 2), dtype=torch.float32, device=dev)
    h = torch.empty((rows, hid), dtype=dt, device=dev)
    dh1 = torch.empty((rows, hid), dtype=torch.float32, device=dev)
    dy = torch.empty((rows, c), dtype=torch.float32, device=dev)
    dx = torch.empty_like(x)
    with torch.cuda.device(dev):
        err = library().vsn_ln_mlp_bwd(
            int(dt == torch.bfloat16), x.data_ptr(), norm_w.data_ptr(),
            norm_b.data_ptr(), fc1_w.data_ptr(), fc1_b.data_ptr(),
            fc2_w.data_ptr(), gb.data_ptr(), dout.data_ptr(), y.data_ptr(),
            stats.data_ptr(), h.data_ptr(), dh1.data_ptr(), dy.data_ptr(),
            dx.data_ptr(), dln_w.data_ptr(), dln_b.data_ptr(),
            dfc1_w.data_ptr(), dfc1_b.data_ptr(), dfc2_w.data_ptr(),
            dfc2_b.data_ptr(), rows, c, hid, rows // nsamp, float(lam),
            stream_of(x))
    check(err, "ln_mlp_bwd")
    launches["ln_mlp_bwd"] += 1
    return (dx, dln_w, dln_b, dfc1_w.view(hid, c), dfc1_b,
            dfc2_w.view(c, hid), dfc2_b)


class _LnMlp(torch.autograd.Function):
    """K2 with its VJP; ``plain`` selects the plain forward and backward."""

    @staticmethod
    def forward(ctx, plain, x, norm_w, norm_b, fc1_w, fc1_b, fc2_w, fc2_b,
                gf, gb, lam):
        fwd = ln_mlp_math if plain else _ln_mlp_kernel
        ctx.plain, ctx.lam = plain, lam
        ctx.save_for_backward(x, norm_w, norm_b, fc1_w, fc1_b, fc2_w, gb)
        return fwd(x, norm_w, norm_b, fc1_w, fc1_b, fc2_w, fc2_b, gf, gb,
                   lam)

    @staticmethod
    def backward(ctx, dout):
        bwd = ln_mlp_backward_reference if ctx.plain else ln_mlp_backward
        grads = bwd(*ctx.saved_tensors, dout.contiguous(), ctx.lam)
        return (None, *grads, None, None, None)


def ln_mlp(x, norm_w, norm_b, fc1_w, fc1_b, fc2_w, fc2_b, gf, gb, lam=1.0):
    """lam * x + gf[row // (T // B)] * fc2(gelu_erf(fc1(LN(x)))).

    Args:
        x: [T, C] tokens, f32 or bf16, sample-major (T divisible by B).
        norm_w, norm_b: [C] f32. fc1_w: [HID, C]; fc1_b: [HID];
        fc2_w: [C, HID]; fc2_b: [C] (f32).
        gf, gb: [B] f32 per-sample branch gains, forward and backward.
        lam: residual x-gain.
    Returns: [T, C] in x's dtype. Differentiable in x and the parameters
    (K2b on a CUDA device).
    """
    return _LnMlp.apply(x.device.type == "cpu", x, norm_w, norm_b, fc1_w,
                        fc1_b, fc2_w, fc2_b, gf, gb, lam)


def ln_mlp_reference(x, norm_w, norm_b, fc1_w, fc1_b, fc2_w, fc2_b, gf, gb,
                     lam=1.0):
    """Plain version of ``ln_mlp`` on any device: the plain forward, and
    ``ln_mlp_backward_reference`` as its backward."""
    return _LnMlp.apply(True, x, norm_w, norm_b, fc1_w, fc1_b, fc2_w, fc2_b,
                        gf, gb, lam)
