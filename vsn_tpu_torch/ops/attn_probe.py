"""The attention-ablation probes P1-P5: K1f's stage-1 call taken apart.

Port of ``scripts/perf_probe_attn_ablate.py`` (P1, ``kernel`` under
``build``) and ``scripts/perf_probe_attn_ablate2.py`` (P2-P4, ``copy_kernel``
and ``copy_ops_kernel``; P5, ``slot_kernel`` under ``build_slot``). Each
probe drops one piece of the Swin attention half-block so that its time
against the whole says what that piece costs:

- ``attn_ablate(variant, ...)``: P1's six variants, ``ABLATIONS``;
- ``attn_slot(wb, variant, ...)``: P5, "full" or "lin" (P1's ``full2d`` and
  ``linear_only``) over ``wb`` windows per block;
- ``copy_windows(xw, wb, operands)``: P2-P4, out = x.

On a CUDA tensor the wrappers launch hand-written kernels and never fall
back: P1 and P5 run the three launches of K1f (``csrc/attn_half.cu``: LN +
qkv GEMM, attention, proj + residual GEMM) as compile-time variants of
K1f's own body, the copies ``csrc/probe_copy.cu``. On a CPU tensor they run
the plain versions ``attn_ablate_reference``, ``attn_slot_reference`` and
``copy_reference``, which repeat the scripts' bodies op for op, rounding
where they round. The probes are forward only, as the scripts are.

What the probes compute is not K1f's function: LayerNorm without affine
(eps 1e-5, f32 statistics); qkv = bf16(y) @ bf16(wqkv) in f32, no qkv bias;
per head s = bf16(q) bf16(k)^T d^-0.5 + bias[h], the plain row max
subtracted, p = exp(s) / sum, rounded to bf16 after the division, then
bf16(p) @ bf16(v); branch = bf16(ao) @ bf16(wproj), no proj bias, gains or
ids; out = (x + branch) in x's dtype. Product operands are bf16 even when
x is f32 (P5's ``full2d_wb8_f32``).

Weights are the scripts' own: wqkv [C, 3C], wproj [C, C] in the (in, out)
layout and bias [H, N, N], all f32; the wrappers take that layout, so the
same numpy arrays feed the JAX scripts and the port and no ``convert.py``
rule is needed.

Launch counters (``_build.launches``) are per run, keyed by ``launch_key``,
and a call adds the number of CUDA launches it made (``launches_per_call``).
"""

from __future__ import annotations

import torch

from vsn_tpu_torch.ops._build import (
    check,
    expect,
    launches,
    library,
    ptr,
    stream_of,
)

LN_EPS = 1e-5
NOSM_FACTOR = 0.001  # the ``nosm`` probe's p = 0.001 s
MAX_HEAD_DIM = 32    # one warp lane per head channel in the attention kernel
ABLATIONS = ("full2d", "noln", "nosm", "nobias", "linear_only", "attn_only")
SLOT_VARIANTS = {"full": "full2d", "lin": "linear_only"}  # P5 -> P1 variant
# csrc/attn_half.cu ``Probe``
_CODE = {name: i for i, name in enumerate(ABLATIONS)}


def launch_key(kind: str, variant: str, wb: int = 1, f32: bool = False) -> str:
    """The launch counter of one run: ``attn_ablate.<variant>``,
    ``attn_slot.<variant>.wb<wb>`` (".f32" appended for f32 x), or
    ``copy_windows.wb<wb>`` (".ops" for ``variant`` "ops", P3)."""
    if kind == "copy_windows":
        return f"copy_windows.wb{wb}" + (".ops" if variant == "ops" else "")
    key = (f"attn_ablate.{variant}" if kind == "attn_ablate"
           else f"attn_slot.{variant}.wb{wb}")
    return key + (".f32" if f32 else "")


def launches_per_call(kind: str, variant: str) -> int:
    """CUDA launches of one call: LN + qkv GEMM, attention, proj GEMM; no
    attention for ``linear_only`` / "lin", LN rows + attention for
    ``attn_only``; one for a copy."""
    if kind == "copy_windows":
        return 1
    return 2 if SLOT_VARIANTS.get(variant, variant) in ("linear_only",
                                                        "attn_only") else 3


def _r(t):
    """``t`` rounded to bf16 (a product operand), held as f32."""
    return t.to(torch.bfloat16).float()


def _probe_math(variant, x, wqkv, bias, wproj, qkv=None):
    """perf_probe_attn_ablate.py ``kernel`` for every window of x [BW, N,
    C] at once (``slot_kernel`` is its "full2d" / "linear_only"). ``qkv``
    [BW, N, 3C], when given, stands for the rounded qkv product (launch 1's
    output), and the rest runs on it."""
    bw, n, c = x.shape
    heads = bias.shape[0]
    d = c // heads
    x32 = x.float()
    if variant == "noln":
        y = x32
    else:
        mu = x32.mean(dim=-1, keepdim=True)
        xc = x32 - mu
        var = (xc * xc).mean(dim=-1, keepdim=True)
        y = xc * torch.rsqrt(var + LN_EPS)
    if variant == "attn_only":
        qkv = torch.cat([y, y, y], dim=-1)
    elif qkv is None:
        qkv = _r(y) @ _r(wqkv)
    else:
        qkv = qkv.float()
    if variant == "linear_only":
        ao = qkv[..., :c]
    else:
        q, k, v = _r(qkv).reshape(bw, n, 3, heads, d).permute(2, 0, 3, 1, 4)
        s = (q @ k.transpose(-1, -2)) * d ** -0.5           # [BW, H, N, N]
        if variant != "nobias":
            s = s + bias
        if variant == "nosm":
            p = s * NOSM_FACTOR
        else:
            s = s - s.amax(dim=-1, keepdim=True)
            p = torch.exp(s)
            p = p / p.sum(dim=-1, keepdim=True)
        ao = (_r(p) @ v).transpose(1, 2).reshape(bw, n, c)
    branch = ao if variant == "attn_only" else _r(ao) @ _r(wproj)
    return (x32 + branch).to(x.dtype)


def _check_variant(name, variant, variants):
    if variant not in variants:
        raise ValueError(f"{name}: variant {variant!r}, one of "
                         f"{tuple(variants)}")


def _check(name, x, wqkv, bias, wproj, wb=1):
    """Validate a probe's arguments (``_check_attn``'s rules)."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: x dtype {x.dtype} (f32 or bf16)")
    if x.dim() != 3:
        raise ValueError(f"{name}: x must be [BW, N, C], got {tuple(x.shape)}")
    bw, n, c = x.shape
    heads = bias.shape[0]
    if c % heads or c // heads > MAX_HEAD_DIM:
        raise ValueError(f"{name}: C={c} over {heads} heads needs a head dim "
                         f"<= {MAX_HEAD_DIM}")
    if wb < 1 or bw % wb:
        raise ValueError(f"{name}: {bw} windows in blocks of {wb}")
    dev, f32 = x.device, torch.float32
    expect(x, "x", (bw, n, c), x.dtype, dev)
    expect(wqkv, "wqkv", (c, 3 * c), f32, dev)
    expect(bias, "bias", (heads, n, n), f32, dev)
    expect(wproj, "wproj", (c, c), f32, dev)


_units: dict = {}


def _unit(c, device):
    """[1] * c + [0] * c in f32 on ``device``: the affine-free LayerNorm's
    scale and shift, and the residual's gain."""
    key = (device, c)
    if key not in _units:
        _units[key] = torch.cat([torch.ones(c), torch.zeros(c)]).to(device)
    return _units[key]


def _probe_kernel(variant, wb, key, x, wqkv, bias, wproj):
    """Launch ``vsn_probe_attn_half`` (csrc/attn_half.cu)."""
    bw, n, c = x.shape
    rows, dev, bf16 = bw * n, x.device, torch.bfloat16
    attn_only = variant == "attn_only"
    if attn_only and x.data_ptr() % 16:   # LN's rows read x by 16-byte vectors
        x = x.clone()
    out = torch.empty_like(x)
    qkv_buf = None if attn_only else torch.empty((rows, 3 * c), dtype=bf16,
                                                 device=dev)
    ao_buf = torch.empty((rows, c), dtype=bf16, device=dev)  # attn_only: y
    stats = (torch.empty((rows, 2), dtype=torch.float32, device=dev)
             if attn_only else None)
    heads = bias.shape[0]
    with torch.cuda.device(dev):
        err = library().vsn_probe_attn_half(
            _CODE[variant], wb, int(x.dtype == bf16), x.data_ptr(),
            wqkv.data_ptr(), bias.data_ptr(), wproj.data_ptr(),
            _unit(c, dev).data_ptr(), ptr(qkv_buf), ao_buf.data_ptr(),
            ptr(stats), out.data_ptr(), bw, n, c, heads,
            float((c // heads) ** -0.5), stream_of(x))
    check(err, key)
    launches[key] += launches_per_call("attn_ablate", variant)
    return out


def attn_ablate_reference(variant, xw, wqkv, bias, wproj, qkv=None):
    """Plain version of ``attn_ablate`` (perf_probe_attn_ablate.py
    ``kernel``), on any device; ``qkv`` as ``_probe_math`` takes it."""
    _check_variant("attn_ablate", variant, ABLATIONS)
    _check("attn_ablate", xw, wqkv, bias, wproj)
    return _probe_math(variant, xw, wqkv, bias, wproj, qkv)


def attn_ablate(variant, xw, wqkv, bias, wproj):
    """P1: one ablation of the stage-1 attention half-block, one window per
    block.

    Args:
        variant: one of ``ABLATIONS``: "full2d" (the whole body), "noln"
            (y = x), "nosm" (p = 0.001 s), "nobias", "linear_only" (ao = the
            q slice of qkv) or "attn_only" (q = k = v = LN(x), branch = ao
            in f32).
        xw: [BW, N, C] windows, bf16 or f32.
        wqkv: [C, 3C], bias: [H, N, N], wproj: [C, C], f32.
    Returns: x + branch, [BW, N, C] in x's dtype.
    """
    if xw.device.type == "cpu":
        return attn_ablate_reference(variant, xw, wqkv, bias, wproj)
    _check_variant("attn_ablate", variant, ABLATIONS)
    _check("attn_ablate", xw, wqkv, bias, wproj)
    key = launch_key("attn_ablate", variant, f32=xw.dtype == torch.float32)
    return _probe_kernel(variant, 1, key, xw, wqkv, bias, wproj)


def attn_slot_reference(wb, variant, xw, wqkv, bias, wproj, qkv=None):
    """Plain version of ``attn_slot`` (perf_probe_attn_ablate2.py
    ``slot_kernel``); ``wb`` only schedules the kernel and changes nothing
    here; ``qkv`` as ``_probe_math`` takes it."""
    _check_variant("attn_slot", variant, SLOT_VARIANTS)
    _check("attn_slot", xw, wqkv, bias, wproj, wb)
    return _probe_math(SLOT_VARIANTS[variant], xw, wqkv, bias, wproj, qkv)


def attn_slot(wb, variant, xw, wqkv, bias, wproj):
    """P5: "full" (P1's full2d) or "lin" (linear_only) with ``wb`` windows
    per block of the attention launch (BW divisible by wb); arguments and
    result as ``attn_ablate``."""
    if xw.device.type == "cpu":
        return attn_slot_reference(wb, variant, xw, wqkv, bias, wproj)
    _check_variant("attn_slot", variant, SLOT_VARIANTS)
    _check("attn_slot", xw, wqkv, bias, wproj, wb)
    key = launch_key("attn_slot", variant, wb, xw.dtype == torch.float32)
    return _probe_kernel(SLOT_VARIANTS[variant], wb, key, xw, wqkv, bias,
                         wproj)


def _check_copy(xw, wb, operands):
    if xw.dtype != torch.bfloat16 or xw.dim() != 3:
        raise TypeError(f"copy_windows: x must be bf16 [BW, N, C], got "
                        f"{xw.dtype} {tuple(xw.shape)}")
    bw, n, c = xw.shape
    if wb < 1 or bw % wb:
        raise ValueError(f"copy_windows: {bw} windows in blocks of {wb}")
    if (n * c) % 8:
        raise ValueError(f"copy_windows: N*C={n * c} is not a multiple of 8 "
                         "(16-byte vectors)")
    expect(xw, "x", (bw, n, c), torch.bfloat16, xw.device)
    if operands is not None:
        _check("copy_windows", xw, *operands)


def copy_reference(xw, wb=1, operands=None):
    """Plain version of ``copy_windows``: a copy of x."""
    _check_copy(xw, wb, operands)
    return xw.clone()


def copy_windows(xw, wb=1, operands=None):
    """P2-P4: out = x for bf16 windows [BW, N, C], ``wb`` windows per block
    (P2: 1, P4: 8). ``operands`` (wqkv, bias, wproj), P3, are checked and
    passed to the kernel, which does not read them."""
    if xw.device.type == "cpu":
        return copy_reference(xw, wb, operands)
    _check_copy(xw, wb, operands)
    if xw.data_ptr() % 16:
        raise ValueError("copy_windows: x must be 16-byte aligned")
    bw, n, c = xw.shape
    out = torch.empty_like(xw)
    w = (None,) * 3 if operands is None else operands
    key = launch_key("copy_windows", "copy" if operands is None else "ops", wb)
    with torch.cuda.device(xw.device):
        err = library().vsn_probe_copy(
            xw.data_ptr(), out.data_ptr(), bw, n, c, wb, *map(ptr, w),
            stream_of(xw))
    check(err, key)
    launches[key] += 1
    return out
