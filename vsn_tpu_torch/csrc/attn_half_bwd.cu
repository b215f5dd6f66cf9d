// K1b: the Swin attention half-block, backward.
//
//   out = lam * x + gf[s] * proj(window_attention(qkv(LN(x))))
//   given do_res = dL/dout, returns dx, dLN1 (w, b), dWqkv, dbqkv,
//   dbias [H, N, N], dWproj, dbproj; the branch sees do = gb[s] * do_res.
//
// Replaces vsn_tpu/ops/swin_block_kernels.py _attn_half_bwd_arrays (Pallas
// kernel _attn_bwd_kernel, attention chain in _heads_attention_bwd). The TPU
// kernel recomputes the forward inside one VMEM program per window and adds
// its weight gradients into output blocks carried across a sequential grid.
// Here the same recompute-then-VJP runs as the nine steps below (twelve
// launches) on the caller's stream, and every carried accumulator is a
// reduction (common.cuh):
//
//   1. y = LN1(x) (rounded to the activation type T) and row statistics;
//   2. qkv = y @ Wqkv^T + bqkv, recomputed (GEMM);
//   3. dao = round(gb * do_res) @ Wproj (GEMM with a row-gain prologue);
//   4. attention backward on the key-tiled tensor-core body (attn_tiled.cuh)
//      at every head dim from 1 to 128 (Swin's d = 32, ViT's d = 64): two
//      launches, phase A over query tiles and phase B over key tiles, which
//      read K1f's row statistics and f32 o of the call (kept by the caller)
//      and recompute none of the forward's softmax; dWproj reads K1f's ao;
//   5. dWproj = do^T @ ao (split-K weight-gradient GEMM), 6. dbproj = sum do
//      (two launches: the block partials and their block-ordered sum);
//   7. dWqkv = dqkv^T @ y (split-K), 8. dy = dqkv @ Wqkv (GEMM, f32 out);
//   9. LN1 backward + residual: dx = T(lam * do_res + LN_bwd(dy)), dLN1
//      (two launches: the rows and the block-ordered sum of dLN1, common.cuh
//      ln_bwd_rows_kernel / ordered_sum_kernel).
//
// The residual modes (_attn_bwd_kernel :369-442):
//
//   in-band LayerScale (gamma, pre-norm): launch 3's prologue reads do =
//   (gb * do_res) * gamma (common.cuh LS_PRO); launches 5 and 6 take dWproj
//   and dbproj unscaled (M and s), and one more launch, after them on the
//   stream, forms dgamma = rowsum(Wproj * M) + bproj * s and only then
//   scales dWproj and dbproj by gamma (common.cuh layerscale_grads_kernel);
//   post-norm: the LayerNorm sits on the branch, so do must pass LN1's
//   backward before dao. Launch 1 is skipped (qkv reads raw x, y is x);
//   after launch 2, a GEMM recomputes the f32 branch proj(ao) + bproj (into
//   the dy buffer) from K1f's ao and the post-norm row kernel turns it into
//   dbranch with LN1's gradients (and dgamma); launches 3, 5 and 6 take
//   dbranch for do; launch 8 forms dx = T(lam * do_res + dqkv @ Wqkv) in its
//   epilogue (EPI_ADD_RESID), with no LN backward.
//
// What bounds it here: the attention backward's products (10 N^2 d per
// window and head) and, at stage 1, the bytes of the [rows, 3C] qkv and
// dqkv round trips. The GEMM and weight-gradient launches (2, 3, 5, 7, 8)
// and the tiled attention run on the tensor cores under bf16 (common.cuh,
// attn_tiled.cuh).
//
// The attention backward works in the p-basis of _heads_attention_bwd
// (swin_block_kernels.py:292-336), exact at saturated logits:
//
//   p = exp(s - max(rowmax, 0)) / (rowsum + 1e-30),  dp = dO V^T
//   ds = p * dp - rowsum(p * dp) * p
//   dq = scale * ds K,  dk = scale * ds^T Q,  dv = p^T dO,  dbias += ds
//
// with p from K1f's kept row statistics and rowsum(p * dp) = dO . o (see
// attn_tiled.cuh). Rounding follows the TPU kernel: p and ds are rounded to
// T as product operands, dbias and the bias gradients take them unrounded.

#include "attn_tiled.cuh"
#include "common.cuh"

namespace {

// The attention backward (launch 4): phases A and B of the key-tiled body
// from K1f's o (f32) and row statistics.
template <typename T>
cudaError_t attention_bwd_launch(const T* qkv, const T* dao, const float* bias, const int* ids,
                                 int ids_rows, const float* o, const float* row_stats,
                                 float* s1, T* dqkv, float* dbias, float* dqkv_b, long long bw,
                                 int n, int c, int heads, float scale, cudaStream_t stream) {
  return launch_attention_bwd_tiled<T>(qkv, dao, o, row_stats, bias, ids, ids_rows, s1, dqkv,
                                       dbias, dqkv_b, bw, n, c, heads, scale, stream,
                                       plain_loads<T>(c / heads, {qkv, dao}));
}

template <typename T>
int attn_half_bwd(const T* x, const float* ln_w, const float* ln_b, const float* qkv_w,
                  const float* qkv_b, const float* bias, const int* ids, int ids_rows,
                  const float* proj_w, const float* proj_b, const float* gamma, int post_norm,
                  const float* gb,
                  const T* dout, T* y, float* stats, T* qkv, T* dao, T* ao, T* dqkv,
                  float* dy, T* dx, float* dln_w, float* dln_b, float* dqkv_w,
                  float* dqkv_b, float* dbias, float* dproj_w, float* dproj_b,
                  float* dgamma, const float* o32, const float* row_stats, float* s1,
                  float* part, long long part_floats, long long bw, int n, int c, int heads,
                  long long rows_per_sample, float scale, float lam,
                  cudaStream_t stream) {
  const long long rows = bw * n;
  cudaError_t err = cudaSuccess;
  const T* yin = x;  // post-norm: qkv reads raw x
  if (!post_norm) {
    err = launch_ln_rows<T>(x, ln_w, ln_b, y, stats, rows, c, stream);
    if (err != cudaSuccess) return (int)err;
    yin = y;
  }

  GemmParams<T> g_qkv = {};
  g_qkv.a = yin;
  g_qkv.w = qkv_w;
  g_qkv.bias = qkv_b;
  g_qkv.out = qkv;
  g_qkv.m = rows;
  g_qkv.n = 3 * c;
  g_qkv.k = c;
  err = launch_gemm<T, EPI_BIAS>(g_qkv, stream);
  if (err != cudaSuccess) return (int)err;

  if (post_norm) {  // ao: K1f's, from the caller
    GemmParams<T> g_br = {};  // the f32 branch proj(ao) + bproj, in dy
    g_br.a = ao;
    g_br.w = proj_w;
    g_br.bias = proj_b;
    g_br.out32 = dy;
    g_br.m = rows;
    g_br.n = c;
    g_br.k = c;
    err = launch_gemm<T, EPI_F32>(g_br, stream);
    if (err != cudaSuccess) return (int)err;
    err = launch_postnorm_bwd<T>(dy, dout, gb, rows_per_sample, ln_w, ln_b, gamma, dln_w,
                                 dln_b, dgamma, part, part_floats, rows, c, stream);
    if (err != cudaSuccess) return (int)err;

    GemmParams<T, float> g_dao = {};  // dao[m, i] = sum_o dbranch[m, o] Wproj[o, i]
    g_dao.a = dy;
    g_dao.w = proj_w;
    g_dao.out = dao;
    g_dao.m = rows;
    g_dao.n = c;
    g_dao.k = c;
    err = launch_gemm<T, EPI_BIAS, true>(g_dao, stream);
    if (err != cudaSuccess) return (int)err;
    err = attention_bwd_launch<T>(qkv, dao, bias, ids, ids_rows, o32, row_stats, s1, dqkv,
                                  dbias, dqkv_b, bw, n, c, heads, scale, stream);
    if (err != cudaSuccess) return (int)err;

    WgradParams<T, float> w_proj = {};  // dWproj[o, i] = sum_m dbranch[m, o] ao[m, i]
    w_proj.a = dy;
    w_proj.b = ao;
    w_proj.out = dproj_w;
    w_proj.m = rows;
    w_proj.n1 = c;
    w_proj.n2 = c;
    err = launch_wgrad(w_proj, stream);
    if (err != cudaSuccess) return (int)err;
    err = launch_colsum<float>(dy, nullptr, 1, dproj_b, part, part_floats, rows, c, stream);
    if (err != cudaSuccess) return (int)err;
  } else {
    GemmParams<T> g_dao = {};  // dao[m, i] = sum_o do[m, o] Wproj[o, i]
    g_dao.a = dout;
    g_dao.a_gain = gb;
    g_dao.rows_per_sample = rows_per_sample;
    g_dao.w = proj_w;
    g_dao.gamma = gamma;
    g_dao.out = dao;
    g_dao.m = rows;
    g_dao.n = c;
    g_dao.k = c;
    err = gamma ? launch_gemm<T, EPI_BIAS, true, LS_PRO>(g_dao, stream)
                : launch_gemm<T, EPI_BIAS, true>(g_dao, stream);
    if (err != cudaSuccess) return (int)err;
    err = attention_bwd_launch<T>(qkv, dao, bias, ids, ids_rows, o32, row_stats, s1, dqkv,
                                  dbias, dqkv_b, bw, n, c, heads, scale, stream);
    if (err != cudaSuccess) return (int)err;

    WgradParams<T, T> w_proj = {};  // dWproj[o, i] = sum_m do[m, o] ao[m, i]
    w_proj.a = dout;
    w_proj.a_gain = gb;
    w_proj.rows_per_sample = rows_per_sample;
    w_proj.b = ao;
    w_proj.out = dproj_w;
    w_proj.m = rows;
    w_proj.n1 = c;
    w_proj.n2 = c;
    err = launch_wgrad(w_proj, stream);
    if (err != cudaSuccess) return (int)err;
    err = launch_colsum<T>(dout, gb, rows_per_sample, dproj_b, part, part_floats, rows, c,
                            stream);
    if (err != cudaSuccess) return (int)err;
    if (gamma) {
      err = launch_layerscale_grads<float>(proj_w, proj_b, gamma, dproj_w, dproj_b, dgamma,
                                           c, c, stream);
      if (err != cudaSuccess) return (int)err;
    }
  }

  WgradParams<T, T> w_qkv = {};  // dWqkv[o, i] = sum_m dqkv[m, o] y[m, i]
  w_qkv.a = dqkv;
  w_qkv.b = yin;
  w_qkv.out = dqkv_w;
  w_qkv.m = rows;
  w_qkv.n1 = 3 * c;
  w_qkv.n2 = c;
  err = launch_wgrad(w_qkv, stream);
  if (err != cudaSuccess) return (int)err;

  GemmParams<T> g_dy = {};  // dy[m, i] = sum_o dqkv[m, o] Wqkv[o, i]
  g_dy.a = dqkv;
  g_dy.w = qkv_w;
  g_dy.out32 = dy;
  g_dy.m = rows;
  g_dy.n = c;
  g_dy.k = 3 * c;
  if (post_norm) {  // dx = T(lam * do_res + dy): no LN backward
    g_dy.resid = dout;
    g_dy.lam = lam;
    g_dy.out = dx;
    return (int)launch_gemm<T, EPI_ADD_RESID, true>(g_dy, stream);
  }
  err = launch_gemm<T, EPI_F32, true>(g_dy, stream);
  if (err != cudaSuccess) return (int)err;

  return (int)launch_ln_bwd<T>(x, stats, ln_w, dy, dout, lam, dx, dln_w, dln_b, part,
                               part_floats, rows, c, stream);
}

}  // namespace

// Returns cudaGetLastError() of the first launch that failed, else 0.
// is_bf16 selects bf16 activations (else f32); parameters and their
// gradients are f32. bias and ids may be null; dbias is then not written.
// The f32 gradient outputs dqkv_w, dqkv_b, dbias, dproj_w (and dgamma with a
// pre-norm gamma) must be zeroed by the caller: the kernels add into them;
// LN1's (dln_w, dln_b, and dgamma under post-norm) and dproj_b are written.
// y, stats, qkv, dao, dqkv, dy, s1 ([BW, H, N] f32) and part (part_floats
// f32, at least what the LN backward's and the column sum's plans need:
// common.cuh ln_bwd_plan(BW*N, C).blocks x 2C and colsum_plan(BW*N,
// C).blocks x C, their block partials) are scratch. ao, row_stats and o32
// are K1f's of this call (vsn_attn_half_fwd's ao_buf, row_stats and o32;
// o32 null for f32 activations, whose ao is f32), read only. Every head dim
// from 1 to 128 at any N. gamma [C] (in-band LayerScale, with dgamma) may be
// null; post_norm selects the post-norm backward (stats unused).
extern "C" int vsn_attn_half_bwd(
    int is_bf16, const void* x, const float* ln_w, const float* ln_b,
    const float* qkv_w, const float* qkv_b, const float* bias,
    const int* ids, int ids_rows, const float* proj_w, const float* proj_b,
    const float* gamma, int post_norm, const float* gb, const void* dout, void* y,
    float* stats, void* qkv, void* dao, void* ao, void* dqkv, float* dy, void* dx,
    float* dln_w, float* dln_b, float* dqkv_w, float* dqkv_b, float* dbias,
    float* dproj_w, float* dproj_b, float* dgamma, const float* o32,
    const float* row_stats, float* s1, float* part, long long part_floats, long long bw, int n,
    int c, int heads, long long rows_per_sample, float scale, float lam, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    using B = __nv_bfloat16;
    return attn_half_bwd<B>(
        static_cast<const B*>(x), ln_w, ln_b, qkv_w, qkv_b, bias, ids, ids_rows,
        proj_w, proj_b, gamma, post_norm, gb, static_cast<const B*>(dout),
        static_cast<B*>(y), stats, static_cast<B*>(qkv), static_cast<B*>(dao),
        static_cast<B*>(ao), static_cast<B*>(dqkv), dy, static_cast<B*>(dx), dln_w, dln_b,
        dqkv_w, dqkv_b, dbias, dproj_w, dproj_b, dgamma, o32, row_stats, s1, part,
        part_floats, bw, n, c, heads, rows_per_sample, scale, lam, s);
  }
  return attn_half_bwd<float>(
      static_cast<const float*>(x), ln_w, ln_b, qkv_w, qkv_b, bias, ids, ids_rows,
      proj_w, proj_b, gamma, post_norm, gb, static_cast<const float*>(dout),
      static_cast<float*>(y), stats, static_cast<float*>(qkv), static_cast<float*>(dao),
      static_cast<float*>(ao), static_cast<float*>(dqkv), dy, static_cast<float*>(dx), dln_w,
      dln_b, dqkv_w, dqkv_b, dbias, dproj_w, dproj_b, dgamma,
      static_cast<const float*>(ao), row_stats, s1, part, part_floats, bw, n, c, heads,
      rows_per_sample, scale, lam, s);
}

// K1b's key-tiled attention backward alone (launch 4 above): from qkv
// [BW*N, 3C], dao [BW*N, C], K1f's o (f32 [BW*N, C]) and row_stats [BW, H,
// N, 2], into dqkv [BW*N, 3C], and added into the zeroed f32 dbias [H, N, N]
// (may be null: phase A then adds nothing, the same work otherwise) and
// dbqkv [3C]; s1 [BW, H, N] f32 scratch; qkv and dao may lie at any offset.
extern "C" int vsn_attention_tiled_bwd(int is_bf16, const void* qkv, const void* dao,
                                       const float* o, const float* row_stats,
                                       const float* bias, const int* ids, int ids_rows,
                                       float* s1, void* dqkv, float* dbias, float* dbqkv,
                                       long long bw, int n, int c, int heads, float scale,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    using B = __nv_bfloat16;
    return (int)launch_attention_bwd_tiled<B>(
        static_cast<const B*>(qkv), static_cast<const B*>(dao), o, row_stats, bias, ids,
        ids_rows, s1, static_cast<B*>(dqkv), dbias, dbqkv, bw, n, c, heads, scale, s,
        plain_loads<B>(c / heads, {qkv, dao}));
  }
  return (int)launch_attention_bwd_tiled<float>(
      static_cast<const float*>(qkv), static_cast<const float*>(dao), o, row_stats, bias, ids,
      ids_rows, s1, static_cast<float*>(dqkv), dbias, dbqkv, bw, n, c, heads, scale, s,
      plain_loads<float>(c / heads, {qkv, dao}));
}
