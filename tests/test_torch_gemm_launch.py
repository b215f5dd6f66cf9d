"""The plain versions of K1 / K2's GEMM and weight-gradient launches alone
(``gemm_reference``, ``wgrad_reference``; on the CPU ``gemm_launch`` and
``wgrad_launch`` run them) against the JAX package's own arithmetic.

The JAX side is built from vsn_tpu/ops/swin_block_kernels.py's pieces, as
its Pallas kernels compose them: ``_mmw`` (:246) on operands cast with
``.astype(cdt)``, ``_ln_fwd`` (:75) for the LayerNorm prologue,
``_gelu_exact`` (:113) and ``_gelu_grad`` (:117) for the GELU epilogues, the
residual line of ``_mlp_fwd_kernel`` (:878-881, ``lam * x + gf * branch``,
cast once), the gated cotangent ``gb * do_res`` (times gamma through
LayerScale) of the backward kernels, and their weight gradients over the
token rows, ``_mm(a, b, 0, 0)`` (:228, as dWqkv at :434). The CUDA launches
(csrc/common.cuh) are held to these plain versions on the card
(tests/test_torch_cuda_kernels.py, chip_smoke.py's GEMM phase).

One call shape: a ragged M of 70 rows (two samples of 35, so the per-sample
gains differ within a row tile), K = 96 and N = 288, Swin-T's stage-1 qkv;
the probes' proj reads A at a row stride of 3 K (the q slice of qkv).

Tolerances, by the output's type and relative to its largest value: f32
outputs 1e-5, bf16 operands or not (the two sides sum the same f32 products
of identically rounded operands in other orders; JAX's GELU is the
Abramowitz-Stegun erf polynomial, max error 1.5e-7, the port's torch.erf);
bf16 outputs 1e-2 (an f32 sum a few ulps apart may round the output to the
neighbouring bf16 value, 2^-8 of it).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vsn_tpu.ops import swin_block_kernels as jk
from vsn_tpu_torch.ops import swin_block_kernels as port

M, K, N = 70, 96, 288
RPS = 35                       # rows per sample
LAM = 0.75
TOL = {"float32": 1e-5, "bfloat16": 1e-2}   # by the output's type

# (epilogue, LayerScale flag, W read as [K, N], A's prologue): every GEMM
# launch of K1 / K2 ("ln": LayerNorm; "gain": the gated cotangent; "f32":
# an f32 A rounded at load under bf16; "plain": A as it is)
GEMM_CASES = [
    ("bias", None, False, "ln"),          # K1f qkv
    ("bias", None, False, "plain"),       # K1b qkv recomputed
    ("gelu", None, False, "ln"),          # K2f fc1
    ("residual", None, False, "plain"),   # K1f proj, K2f fc2
    ("residual", "epi", False, "plain"),  # ... with LayerScale
    ("gelu_grad", None, False, "plain"),  # K2b fc1 recomputed
    ("f32", None, False, "plain"),        # the post-norm branch
    ("bias", None, True, "gain"),         # K1b dao
    ("bias", "pro", True, "gain"),        # ... through LayerScale
    ("bias", None, True, "f32"),          # K1b post-norm dao from dbranch
    ("bias", None, True, "ln"),           # the probes' qkv (W as [in, out])
    ("mul_f32", None, True, "gain"),      # K2b dh1
    ("mul_f32", "pro", True, "gain"),
    ("mul_f32", None, True, "f32"),       # K2b post-norm dh1
    ("f32", None, True, "plain"),         # K1b dy
    ("f32", None, True, "f32"),           # K2b dy
    ("add_resid", None, True, "plain"),   # K1b post-norm dx
    ("add_resid", None, True, "f32"),     # K2b post-norm dx
]


def _inputs(seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return dict(a=3.0 * f(M, 3 * K) + 1.0, w=K ** -0.5 * f(N, K),
                w_kn=N ** -0.5 * f(K, N), lnw=1.0 + 0.1 * f(K),
                lnb=0.1 * f(K), bias=0.1 * f(N), gamma_k=0.5 + 0.1 * f(K),
                gamma_n=0.5 + 0.1 * f(N), gains=np.asarray([0.6, 1.4],
                                                           np.float32),
                resid=f(M, N), out32=f(M, N))


def _jax(p, case, cdt, a_dtype, out_dtype):
    """The launch's function from the JAX kernels' pieces."""
    epi, ls, w_kn, a_kind = case
    a = jnp.asarray(p["a"][:, :K]).astype(a_dtype).astype(jnp.float32)
    g_rows = jnp.repeat(jnp.asarray(p["gains"]), RPS)[:, None]
    if a_kind == "ln":
        a = jk._ln_fwd(a, jnp.asarray(p["lnw"]), jnp.asarray(p["lnb"]))[0]
    elif a_kind == "gain":
        a = g_rows * a
        if ls == "pro":
            a = a * jnp.asarray(p["gamma_k"])
    if w_kn:   # the data gradient dA = dOut @ W of a Linear W [K, N]:
        # JAX holds W as [in, out] = [N, K] and contracts its axis 1
        v = jk._mmw(a.astype(cdt), jnp.asarray(p["w_kn"].T).astype(cdt), 1)
    else:      # torch [N, K] is JAX's [K, N] transposed
        v = jk._mmw(a.astype(cdt), jnp.asarray(p["w"].T).astype(cdt))
    v = v + jnp.asarray(p["bias"])
    if epi == "f32":
        return None, v
    if epi == "mul_f32":
        return None, jnp.asarray(p["out32"]) * v
    out32 = jk._gelu_grad(v) if epi == "gelu_grad" else None
    if epi in ("gelu", "gelu_grad"):
        v = jk._gelu_exact(v)
    resid = jnp.asarray(p["resid"]).astype(out_dtype).astype(jnp.float32)
    if epi == "residual":
        branch = v * jnp.asarray(p["gamma_n"]) if ls == "epi" else v
        v = LAM * resid + g_rows * branch                  # :878-881
    if epi == "add_resid":
        v = LAM * resid + v
    return v.astype(out_dtype), out32


def _port(p, case, cdt, a_dtype, out_dtype, lda):
    """``gemm_launch`` on CPU tensors (its plain version); A is the first K
    columns of an [M, lda] buffer."""
    epi, ls, w_kn, a_kind = case
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x))
    a = t(p["a"][:, :lda]).to(a_dtype)[:, :K]
    gains = t(p["gains"])
    kw = dict(w_kn=w_kn, rows_per_sample=RPS, lam=LAM, out_dtype=out_dtype,
              bias=t(p["bias"]))
    if a_kind == "ln":
        kw["ln"] = (t(p["lnw"]), t(p["lnb"]))
    if a_kind == "gain":
        kw["a_gain"] = gains
    if ls is not None:
        kw.update(ls=ls, gamma=t(p["gamma_k"] if ls == "pro"
                                 else p["gamma_n"]))
    if epi in ("residual", "add_resid"):
        kw["resid"] = t(p["resid"]).to(out_dtype)
    if epi == "residual":
        kw["gains"] = gains
    if epi == "mul_f32":
        kw["out32"] = t(p["out32"]).clone()
    return port.gemm_launch(a, t(p["w_kn"] if w_kn else p["w"]), epi, cdt,
                            **kw)


def _close(got, want, tol, what):
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    got = got.float().numpy()
    assert got.shape == want.shape, what
    assert np.isfinite(got).all(), what
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: max|d| {err} > {tol} x {scale}"


def _check(case, dtype, out_dtype=None, lda=K):
    cdt = getattr(torch, dtype)
    jcdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    f32_a = case[3] == "f32"
    out_dtype = out_dtype or cdt
    p = _inputs(0)
    want, want32 = _jax(p, case, jcdt, jnp.float32 if f32_a else jcdt,
                        jnp.float32 if out_dtype == torch.float32
                        else jnp.bfloat16)
    got, got32 = _port(p, case, cdt, torch.float32 if f32_a else cdt,
                       out_dtype, lda)
    assert (got is None) == (want is None)
    assert (got32 is None) == (want32 is None)
    if got is not None:
        assert got.dtype == out_dtype and got.shape == (M, N)
        _close(got, want, TOL[str(out_dtype).removeprefix("torch.")],
               f"{case} {dtype} out")
    if got32 is not None:
        assert got32.dtype == torch.float32 and got32.shape == (M, N)
        _close(got32, want32, TOL["float32"], f"{case} {dtype} out32")


@pytest.mark.parametrize("case,dtype", [
    (case, dtype) for case in GEMM_CASES for dtype in ("float32", "bfloat16")
    if dtype == "bfloat16" or case[3] != "f32"],   # f32 A is f32's own type
    ids=lambda v: "-".join(map(str, v)) if isinstance(v, tuple) else v)
def test_gemm_plain_version_matches_jax(case, dtype):
    _check(case, dtype)


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_probe_proj_plain_version_matches_jax(out_dtype):
    """The attention probes' proj: bf16 operands, W as [K, N], A the q slice
    of a packed [M, 3K] qkv (lda = 3K), out and the residual bf16 or f32;
    gains 1 and lam as given."""
    _check(("residual", None, True, "plain"), "bfloat16", out_dtype,
           lda=3 * K)


@pytest.mark.parametrize("gain", [False, True])
@pytest.mark.parametrize("dtype,a_dtype", [
    ("float32", "float32"), ("bfloat16", "bfloat16"),
    ("bfloat16", "float32")])
def test_wgrad_plain_version_matches_jax(dtype, a_dtype, gain):
    """out [N1, N2] = sum_m round(g_m a[m]) round(b[m]): dW2 = do^T h
    (gained, a = do_res), dWqkv = dqkv^T y, dW1 = round(dh1)^T y (a f32
    under bf16)."""
    rng = np.random.default_rng(3)
    a = (2.0 * rng.standard_normal((M, K)) + 0.5).astype(np.float32)
    b = rng.standard_normal((M, N)).astype(np.float32)
    gains = np.asarray([0.6, 1.4], np.float32)
    cdt, tdt = getattr(torch, dtype), getattr(torch, a_dtype)
    jcdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    ja = jnp.asarray(a).astype(jnp.bfloat16 if a_dtype == "bfloat16"
                                else jnp.float32).astype(jnp.float32)
    if gain:
        ja = jnp.repeat(jnp.asarray(gains), RPS)[:, None] * ja
    jb = jnp.asarray(b).astype(jcdt)
    want = jk._mm(ja.astype(jcdt), jb, 0, 0)   # dwqkv += _mm(y, dqkv, 0, 0)
    ta, tb = torch.from_numpy(a).to(tdt), torch.from_numpy(b).to(cdt)
    kw = dict(a_gain=torch.from_numpy(gains), rows_per_sample=RPS) \
        if gain else {}
    got = port.wgrad_launch(ta, tb, cdt, **kw)
    assert got.dtype == torch.float32 and got.shape == (K, N)
    # an f32 sum over the rows in either type: f32 rounding of the order
    _close(got, want, TOL["float32"], f"wgrad {dtype} A {a_dtype} gain {gain}")
