// K2b: the Swin MLP half-block, backward.
//
//   out = lam * x + gf[row / rows_per_sample] * fc2(gelu_erf(fc1(LN(x))))
//   given do_res = dL/dout, returns dx, dLN2 (w, b), dW1, db1, dW2, db2; the
//   branch sees do = gb[s] * do_res.
//
// Replaces vsn_tpu/ops/swin_block_kernels.py _ln_mlp_bwd_arrays (Pallas
// kernel _mlp_bwd_kernel), which recomputes LN2 + fc1 + GELU on row tiles in
// VMEM and adds its weight gradients into output blocks carried across a
// sequential grid. Here the recompute and the VJP run as nine steps (ten
// launches) on the caller's stream, the carried sums as reductions
// (common.cuh):
//
//   1. y = LN2(x) (rounded to the activation type T) and row statistics;
//   2. h1 = y @ W1^T + b1: one GEMM writes h = T(gelu(h1)) and GELU'(h1) (f32);
//   3. dh1 = (round(gb * do_res) @ W2) * GELU'(h1), in place over GELU' (f32);
//   4. dW2 = do^T @ h (split-K), 5. db2 = sum do, 6. db1 = sum dh1;
//   7. dW1 = round(dh1)^T @ y (split-K), 8. dy = round(dh1) @ W1 (f32 out);
//   9. LN2 backward + residual: dx = T(lam * do_res + LN_bwd(dy)), dLN2
//      (two launches: the rows and the block-ordered sum of dLN2).
//
// The residual modes (_mlp_bwd_kernel :904-968):
//
//   in-band LayerScale (gamma, pre-norm): launch 3's prologue reads do =
//   (gb * do_res) * gamma (common.cuh LS_PRO); launches 4 and 5 take dW2 and
//   db2 unscaled (M and s), and one more launch, after them on the stream,
//   forms dgamma = rowsum(W2 * M) + b2 * s and only then scales dW2 and db2
//   by gamma (common.cuh layerscale_grads_kernel);
//   post-norm: fc1 reads raw x (launch 1 is skipped: y is x), the fc2
//   output is recomputed into f32 (EPI_F32 into the dy buffer), and the
//   post-norm row kernel turns it into dbranch with LN2's gradients (and
//   dgamma); launches 3-5 take dbranch for do; launch 8 forms dx = T(lam *
//   do_res + dh1 @ W1) in its epilogue (EPI_ADD_RESID), with no LN backward.
//
// What bounds it here: the five products of 8 C^2 operations per row each
// (fc1 recomputed, two data gradients, two weight gradients), which run on
// the tensor cores under bf16 (common.cuh's GEMM and weight-gradient
// bodies); and, at Swin's stage 1 (C = 96), the bytes of the [rows, 4C]
// hidden activations, which do not fit on chip (a 128-row tile is 1.5 MB in
// f32 at C = 768), so h, GELU' and dh1 go through device memory as in K2f.
// GELU' is the exact-erf derivative (_gelu_grad:117) with erff.

#include "common.cuh"

namespace {

template <typename T>
int ln_mlp_bwd(const T* x, const float* ln_w, const float* ln_b, const float* fc1_w,
               const float* fc1_b, const float* fc2_w, const float* fc2_b,
               const float* gamma, int post_norm, const float* gb, const T* dout, T* y,
               float* stats, T* h, float* dh1, float* dy, T* dx, float* dln_w,
               float* dln_b, float* dfc1_w, float* dfc1_b, float* dfc2_w, float* dfc2_b,
               float* dgamma, float* ln_part, int ln_blocks, long long rows, int c, int hid,
               long long rows_per_sample, float lam, cudaStream_t stream) {
  cudaError_t err = cudaSuccess;
  const T* yin = x;  // post-norm: fc1 reads raw x
  if (!post_norm) {
    err = launch_ln_rows<T>(x, ln_w, ln_b, y, stats, rows, c, stream);
    if (err != cudaSuccess) return (int)err;
    yin = y;
  }

  GemmParams<T> g1 = {};  // h = gelu(h1), dh1 <- GELU'(h1)
  g1.a = yin;
  g1.w = fc1_w;
  g1.bias = fc1_b;
  g1.out = h;
  g1.out32 = dh1;
  g1.m = rows;
  g1.n = hid;
  g1.k = c;
  err = launch_gemm<T, EPI_GELU_GRAD>(g1, stream);
  if (err != cudaSuccess) return (int)err;

  if (post_norm) {
    // dbranch (f32, in the dy buffer): recompute fc2 + b2, then LN2's
    // backward through gamma and the gains
    GemmParams<T> gb2 = {};
    gb2.a = h;
    gb2.w = fc2_w;
    gb2.bias = fc2_b;
    gb2.out32 = dy;
    gb2.m = rows;
    gb2.n = c;
    gb2.k = hid;
    err = launch_gemm<T, EPI_F32>(gb2, stream);
    if (err != cudaSuccess) return (int)err;
    err = launch_postnorm_bwd<T>(dy, dout, gb, rows_per_sample, ln_w, ln_b, gamma, dln_w,
                                 dln_b, dgamma, ln_part, ln_blocks, rows, c, stream);
    if (err != cudaSuccess) return (int)err;

    GemmParams<T, float> g2 = {};  // dh1 = (dbranch @ W2) * GELU'(h1)
    g2.a = dy;
    g2.w = fc2_w;
    g2.out32 = dh1;
    g2.m = rows;
    g2.n = hid;
    g2.k = c;
    err = launch_gemm<T, EPI_MUL_F32, true>(g2, stream);
    if (err != cudaSuccess) return (int)err;

    WgradParams<T, float> w2 = {};  // dW2[o, k] = sum_m dbranch[m, o] h[m, k]
    w2.a = dy;
    w2.b = h;
    w2.out = dfc2_w;
    w2.m = rows;
    w2.n1 = c;
    w2.n2 = hid;
    err = launch_wgrad(w2, stream);
    if (err != cudaSuccess) return (int)err;
    err = launch_colsum<float>(dy, nullptr, 1, dfc2_b, rows, c, stream);
    if (err != cudaSuccess) return (int)err;
  } else {
    GemmParams<T> g2 = {};  // dh1[m, k] = GELU'(h1)[m, k] * sum_o do[m, o] W2[o, k]
    g2.a = dout;
    g2.a_gain = gb;
    g2.rows_per_sample = rows_per_sample;
    g2.w = fc2_w;
    g2.gamma = gamma;
    g2.out32 = dh1;
    g2.m = rows;
    g2.n = hid;
    g2.k = c;
    err = gamma ? launch_gemm<T, EPI_MUL_F32, true, LS_PRO>(g2, stream)
                : launch_gemm<T, EPI_MUL_F32, true>(g2, stream);
    if (err != cudaSuccess) return (int)err;

    WgradParams<T, T> w2 = {};  // dW2[o, k] = sum_m do[m, o] h[m, k]
    w2.a = dout;
    w2.a_gain = gb;
    w2.rows_per_sample = rows_per_sample;
    w2.b = h;
    w2.out = dfc2_w;
    w2.m = rows;
    w2.n1 = c;
    w2.n2 = hid;
    err = launch_wgrad(w2, stream);
    if (err != cudaSuccess) return (int)err;
    err = launch_colsum<T>(dout, gb, rows_per_sample, dfc2_b, rows, c, stream);
    if (err != cudaSuccess) return (int)err;
    if (gamma) {
      err = launch_layerscale_grads<float>(fc2_w, fc2_b, gamma, dfc2_w, dfc2_b, dgamma, c,
                                           hid, stream);
      if (err != cudaSuccess) return (int)err;
    }
  }
  err = launch_colsum<float>(dh1, nullptr, 1, dfc1_b, rows, hid, stream);
  if (err != cudaSuccess) return (int)err;

  WgradParams<T, float> w1 = {};  // dW1[k, i] = sum_m dh1[m, k] y[m, i]
  w1.a = dh1;
  w1.b = yin;
  w1.out = dfc1_w;
  w1.m = rows;
  w1.n1 = hid;
  w1.n2 = c;
  err = launch_wgrad(w1, stream);
  if (err != cudaSuccess) return (int)err;

  GemmParams<T, float> g3 = {};  // dy[m, i] = sum_k dh1[m, k] W1[k, i]
  g3.a = dh1;
  g3.w = fc1_w;
  g3.out32 = dy;
  g3.m = rows;
  g3.n = c;
  g3.k = hid;
  if (post_norm) {  // dx = T(lam * do_res + dy): no LN backward
    g3.resid = dout;
    g3.lam = lam;
    g3.out = dx;
    return (int)launch_gemm<T, EPI_ADD_RESID, true>(g3, stream);
  }
  err = launch_gemm<T, EPI_F32, true>(g3, stream);
  if (err != cudaSuccess) return (int)err;

  return (int)launch_ln_bwd<T>(x, stats, ln_w, dy, dout, lam, dx, dln_w, dln_b, ln_part,
                               ln_blocks, rows, c, stream);
}

}  // namespace

// Returns cudaGetLastError() of the first launch that failed, else 0.
// is_bf16 selects bf16 activations (else f32); parameters and their
// gradients are f32. The f32 gradient outputs (dfc1_w .. dfc2_b, and dgamma
// with a pre-norm gamma) must be zeroed by the caller: the kernels add into
// them; LN2's (dln_w, dln_b, and dgamma under post-norm) are written. y,
// stats, h, dh1, dy and ln_part ([ln_blocks, 2C] f32, ln_blocks = common.cuh
// ln_bwd_plan(rows, C).blocks) are scratch. gamma [C] (in-band LayerScale,
// with dgamma) may be null; post_norm selects the post-norm backward (y and
// stats are then unused).
extern "C" int vsn_ln_mlp_bwd(int is_bf16, const void* x, const float* ln_w,
                              const float* ln_b, const float* fc1_w, const float* fc1_b,
                              const float* fc2_w, const float* fc2_b, const float* gamma,
                              int post_norm, const float* gb, const void* dout, void* y,
                              float* stats, void* h, float* dh1, float* dy, void* dx,
                              float* dln_w, float* dln_b, float* dfc1_w, float* dfc1_b,
                              float* dfc2_w, float* dfc2_b, float* dgamma, float* ln_part,
                              int ln_blocks, long long rows, int c, int hid,
                              long long rows_per_sample, float lam, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    using B = __nv_bfloat16;
    return ln_mlp_bwd<B>(static_cast<const B*>(x), ln_w, ln_b, fc1_w, fc1_b, fc2_w, fc2_b,
                         gamma, post_norm, gb, static_cast<const B*>(dout),
                         static_cast<B*>(y), stats, static_cast<B*>(h), dh1, dy,
                         static_cast<B*>(dx), dln_w, dln_b, dfc1_w, dfc1_b, dfc2_w,
                         dfc2_b, dgamma, ln_part, ln_blocks, rows, c, hid, rows_per_sample,
                         lam, s);
  }
  return ln_mlp_bwd<float>(static_cast<const float*>(x), ln_w, ln_b, fc1_w, fc1_b, fc2_w,
                           fc2_b, gamma, post_norm, gb, static_cast<const float*>(dout),
                           static_cast<float*>(y), stats, static_cast<float*>(h), dh1, dy,
                           static_cast<float*>(dx), dln_w, dln_b, dfc1_w, dfc1_b, dfc2_w,
                           dfc2_b, dgamma, ln_part, ln_blocks, rows, c, hid, rows_per_sample,
                           lam, s);
}
