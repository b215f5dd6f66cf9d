// The row kernels of K1 / K1b / K2 / K2b alone (common.cuh), bound through
// plain C entry points for the card's launch-level checks and chip_smoke.py's
// row-kernel phase. K1f (attn_half.cu), K1b (attn_half_bwd.cu), K2f
// (ln_mlp.cu) and K2b (ln_mlp_bwd.cu) make the same launches inside their
// own calls; nothing else of the port calls these entry points.
//
//   vsn_ln_bwd / vsn_postnorm_bwd: the LayerNorm-backward body in its two
//     modes (``launch_ln_bwd`` / ``launch_postnorm_bwd``: the rows, then the
//     block-ordered sum of dw / db / dgamma). Replaces _ln_bwd
//     (vsn_tpu/ops/swin_block_kernels.py:85) at its four call sites in
//     _attn_bwd_kernel and _mlp_bwd_kernel.
//   vsn_ln_rows: LN's rows and statistics (``ln_rows_kernel``, on the LN
//     backward's row plan), the _ln_fwd (:75) of K1b's and K2b's recompute.
//   vsn_colsum: the bias gradients' column sums (``colsum_kernel``, then the
//     block-ordered sum).
//   vsn_postnorm_fwd, vsn_layerscale_grads: the post-norm forward's finish
//     and the pre-norm LayerScale gradients, timed alone beside them.
//
// Each returns cudaGetLastError() of its launches, or cudaErrorInvalidValue
// for arguments its kernels do not take. is_bf16 selects bf16 activations
// (else f32); every parameter, gradient and statistic is f32.

#include "common.cuh"

// The blocks of the LN-backward plan of an [m, c] call (``ln_bwd_plan``, a
// function of (m, c) alone): the rows of the [blocks, 2c] f32 scratch that
// vsn_ln_bwd / vsn_postnorm_bwd and K1b / K2b take. 0 for a width the body
// does not take (c above kRowMaxC).
extern "C" int vsn_ln_bwd_blocks(long long m, int c) {
  LnBwdPlan plan;
  return ln_bwd_plan(m, c, &plan) ? plan.blocks : 0;
}

// The row blocks of the column-sum plan of an [m, n] call (``colsum_plan``, a
// function of (m, n) alone): the rows of the [blocks, n] f32 scratch that
// vsn_colsum and K1b / K2b take. 0 for an empty call.
extern "C" int vsn_colsum_blocks(long long m, int n) {
  ColsumPlan plan;
  return colsum_plan(m, n, &plan) ? plan.blocks : 0;
}

// Pre-norm LN backward: dx [m, c] = T(lam * do_res + LN_bwd(dy)) from x, the
// row statistics [m, 2] and dy (f32); dw, db [c] written. part: f32 scratch
// of part_floats >= 2c x vsn_ln_bwd_blocks(m, c).
extern "C" int vsn_ln_bwd(int is_bf16, const void* x, const float* stats, const float* w,
                          const float* dy, const void* do_res, float lam, void* dx,
                          float* dw, float* db, float* part, long long part_floats, long long m,
                          int c, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    using B = __nv_bfloat16;
    return (int)launch_ln_bwd<B>(static_cast<const B*>(x), stats, w, dy,
                                 static_cast<const B*>(do_res), lam, static_cast<B*>(dx), dw,
                                 db, part, part_floats, m, c, s);
  }
  return (int)launch_ln_bwd<float>(static_cast<const float*>(x), stats, w, dy,
                                   static_cast<const float*>(do_res), lam,
                                   static_cast<float*>(dx), dw, db, part, part_floats, m, c, s);
}

// Post-norm LN backward: the f32 branch [m, c] overwritten with dbranch, do
// = gb[row / rps] * do_res; dw, db and (gamma not null) dgamma [c] written.
extern "C" int vsn_postnorm_bwd(int is_bf16, float* branch, const void* do_res,
                                const float* gb, long long rps, const float* w,
                                const float* b, const float* gamma, float* dw, float* db,
                                float* dgamma, float* part, long long part_floats, long long m,
                                int c, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    using B = __nv_bfloat16;
    return (int)launch_postnorm_bwd<B>(branch, static_cast<const B*>(do_res), gb, rps, w, b,
                                       gamma, dw, db, dgamma, part, part_floats, m, c, s);
  }
  return (int)launch_postnorm_bwd<float>(branch, static_cast<const float*>(do_res), gb, rps,
                                         w, b, gamma, dw, db, dgamma, part, part_floats, m, c, s);
}

// y [m, c] = LN(x) and the row statistics [m, 2] (K1b's / K2b's launch 1):
// y in x's type, or bf16 from f32 x (y_bf16); x 16-byte aligned, c <=
// kRowMaxC.
extern "C" int vsn_ln_rows(int is_bf16, int y_bf16, const void* x, const float* w,
                           const float* b, void* y, float* stats, long long m, int c,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using B = __nv_bfloat16;
  if (is_bf16 && y_bf16)
    return (int)launch_ln_rows<B>(static_cast<const B*>(x), w, b, static_cast<B*>(y), stats,
                                  m, c, s);
  if (is_bf16) return (int)cudaErrorInvalidValue;
  if (y_bf16)  // the probe P1 attn_only's form (attn_half.cu)
    return (int)launch_ln_rows<float, B>(static_cast<const float*>(x), w, b,
                                         static_cast<B*>(y), stats, m, c, s);
  return (int)launch_ln_rows<float>(static_cast<const float*>(x), w, b,
                                    static_cast<float*>(y), stats, m, c, s);
}

// out [n] = sum_m g_m a[m, n] (written), g_m = a_gain[m / rps] or 1: a of
// the activation type (a_f32 = 0: the gated do_res) or f32 (dh1, dbranch),
// 16-byte aligned. part: f32 scratch of part_floats >= n x
// vsn_colsum_blocks(m, n).
extern "C" int vsn_colsum(int is_bf16, int a_f32, const void* a, const float* a_gain,
                          long long rps, float* out, float* part, long long part_floats,
                          long long m, int n, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a_f32 || !is_bf16)
    return (int)launch_colsum<float>(static_cast<const float*>(a), a_gain, rps, out, part,
                                     part_floats, m, n, s);
  return (int)launch_colsum<__nv_bfloat16>(static_cast<const __nv_bfloat16*>(a), a_gain, rps,
                                           out, part, part_floats, m, n, s);
}

// out [m, c] = T(lam * x + gains[row / rps] * (LN(branch) [* gamma])).
extern "C" int vsn_postnorm_fwd(int is_bf16, const float* branch, const void* x,
                                const float* w, const float* b, const float* gamma,
                                const float* gains, long long rps, float lam, void* out,
                                long long m, int c, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    using B = __nv_bfloat16;
    return (int)launch_postnorm_fwd<B>(branch, static_cast<const B*>(x), w, b, gamma, gains,
                                       rps, lam, static_cast<B*>(out), m, c, s);
  }
  return (int)launch_postnorm_fwd<float>(branch, static_cast<const float*>(x), w, b, gamma,
                                         gains, rps, lam, static_cast<float*>(out), m, c, s);
}

// dgamma [n] += rowsum(w * dw) + bias * db, then dw [n, k] and db [n] scaled
// by gamma, in place.
extern "C" int vsn_layerscale_grads(const float* w, const float* bias, const float* gamma,
                                    float* dw, float* db, float* dgamma, int n, int k,
                                    void* stream) {
  return (int)launch_layerscale_grads<float>(w, bias, gamma, dw, db, dgamma, n, k,
                                             static_cast<cudaStream_t>(stream));
}
