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
// Here the same recompute-then-VJP runs as the nine steps below (eleven
// launches with the key-tiled attention) on the caller's stream, and every
// carried accumulator is a reduction (common.cuh):
//
//   1. y = LN1(x) (rounded to the activation type T) and row statistics;
//   2. qkv = y @ Wqkv^T + bqkv, recomputed (GEMM);
//   3. dao = round(gb * do_res) @ Wproj (GEMM with a row-gain prologue);
//   4. attention backward on the key-tiled tensor-core body (attn_tiled.cuh)
//      wherever it takes the head dim (multiples of 16 up to 128: Swin's
//      d = 32, ViT's d = 64): two launches, phase A over query tiles and
//      phase B over key tiles, which read K1f's ao, row statistics and f32
//      o of the call (kept by the caller) and recompute none of the
//      forward's softmax. Other head dims (none of the presets) take the
//      whole-window body below, one block per (window, head), which also
//      recomputes the attention output ao, which dWproj needs;
//   5. dWproj = do^T @ ao (split-K weight-gradient GEMM), 6. dbproj = sum do;
//   7. dWqkv = dqkv^T @ y (split-K), 8. dy = dqkv @ Wqkv (GEMM, f32 out);
//   9. LN1 backward + residual: dx = T(lam * do_res + LN_bwd(dy)), dLN1
//      (two launches: the rows and the block-ordered sum of dLN1, common.cuh
//      ln_bwd_rows_kernel / ln_bwd_sum_kernel).
//
// The residual modes (_attn_bwd_kernel :369-442):
//
//   in-band LayerScale (gamma, pre-norm): launch 3's prologue reads do =
//   (gb * do_res) * gamma (common.cuh LS_PRO); launches 5 and 6 take dWproj
//   and dbproj unscaled (M and s), and one more launch, after them on the
//   stream, forms dgamma = rowsum(Wproj * M) + bproj * s and only then
//   scales dWproj and dbproj by gamma (common.cuh layerscale_grads_kernel);
//   post-norm: the LayerNorm sits on the branch, so do must pass LN1's
//   backward before dao, and dao needs ao before the attention backward
//   could recompute it: the caller passes K1f's own ao of the call (kept
//   from the forward) in the ao argument. Launch 1 is skipped (qkv reads
//   raw x, y is x); after launch 2, a GEMM recomputes the f32 branch
//   proj(ao) + bproj (into the dy buffer) and the post-norm row kernel
//   turns it into dbranch with LN1's gradients (and dgamma); launches 3, 5
//   and 6 take dbranch for do (the attention backward writes its own ao
//   into the unused y buffer, and dWproj reads the forward's); launch 8
//   forms dx = T(lam * do_res + dqkv @ Wqkv) in its epilogue
//   (EPI_ADD_RESID), with no LN backward.
//
// What bounds it here: the attention backward's products (10 N^2 d per
// window and head on the tiled body) and, at stage 1, the bytes of the
// [rows, 3C] qkv and dqkv round trips. The GEMM and weight-gradient
// launches (2, 3, 5, 7, 8) and the tiled attention run on the tensor cores
// under bf16 (common.cuh, attn_tiled.cuh). The whole-window body keeps Q,
// K, V and dO of its head in shared memory as f32 (4 x N x 33 floats, 133
// KB at N = 252) and never the [N, N] matrices: one row buffer per warp.
//
// The attention backward works in the p-basis of _heads_attention_bwd
// (swin_block_kernels.py:292-336), exact at saturated logits:
//
//   p = exp(s - max(rowmax, 0)) / (rowsum + 1e-30),  dp = dO V^T
//   ds = p * dp - rowsum(p * dp) * p
//   dq = scale * ds K,  dk = scale * ds^T Q,  dv = p^T dO,  dbias += ds
//
// in two phases. Phase A takes query rows (one per warp at a time): scores,
// shift, row sum, ao, dp, ds and dq; it adds ds into dbias (f32 atomics; the
// TPU's dbias accumulator sums over every window of every sample) and keeps
// the row's shift, 1/sum and rowsum(p * dp). Phase B takes key rows and
// recomputes the same p and ds column by column from those row statistics,
// for dk and dv, so no [N, N] matrix is stored and no dk/dv sum needs
// atomics. Both phases form s, p and ds with the same round-to-nearest
// operations (no contraction into FMA), so phase B's p and ds equal phase
// A's bit for bit. Rounding follows the TPU kernel: p and ds are rounded to
// T as product operands, dbias and the bias gradients take them unrounded.

#include "attn_tiled.cuh"
#include "common.cuh"

namespace {

constexpr int kBwdWarps = 16;

// The masked, biased, scaled score of one (query, key) pair; phases A and B
// call this with the same operands and get the same bits.
__device__ __forceinline__ float score(float dot, float scale, bool masked,
                                       bool has_mask, const float* bias_at) {
  float s = __fmul_rn(dot, scale);
  if (has_mask) s = __fadd_rn(s, masked ? kNegInf : 0.f);
  if (bias_at) s = __fadd_rn(s, *bias_at);
  return s;
}

template <typename T>
__global__ void __launch_bounds__(kBwdWarps * 32) window_attention_bwd_kernel(
    const T* __restrict__ qkv, const T* __restrict__ dao,
    const float* __restrict__ bias, const float* __restrict__ bias_t,
    const int* __restrict__ ids, int ids_rows, T* __restrict__ ao,
    T* __restrict__ dqkv, float* __restrict__ dbias, float* __restrict__ dbqkv,
    int n, int c, int heads, float scale) {
  extern __shared__ float smem[];
  const int d = c / heads, dp1 = d + 1;
  float* qs = smem;                  // [n][d + 1]   (padded: no bank conflicts)
  float* ks = qs + n * dp1;          // [n][d + 1]
  float* vs = ks + n * dp1;          // [n][d + 1]
  float* dos = vs + n * dp1;         // [n][d + 1]   dO of the head
  float* shift_s = dos + n * dp1;    // [n]  max(rowmax, 0)
  float* rinv_s = shift_s + n;       // [n]  1 / (rowsum + 1e-30)
  float* s1_s = rinv_s + n;          // [n]  rowsum(p * dp)
  float* bufs = s1_s + n;            // [warps][2][n]
  int* ids_s = reinterpret_cast<int*>(bufs + 2 * kBwdWarps * n);  // [n]

  const long long bw = blockIdx.x / heads;
  const int h = blockIdx.x % heads;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long base = bw * n;
  const int c3 = 3 * c;
  const bool has_mask = ids != nullptr;

  for (int e = tid; e < n * d; e += blockDim.x) {
    const int j = e / d, cc = e % d;
    const T* row = qkv + (base + j) * c3 + h * d + cc;
    qs[j * dp1 + cc] = to_f32(row[0]);
    ks[j * dp1 + cc] = to_f32(row[c]);
    vs[j * dp1 + cc] = to_f32(row[2 * c]);
    dos[j * dp1 + cc] = to_f32(dao[(base + j) * c + h * d + cc]);
  }
  if (has_mask) {
    const int* id_row = ids + (bw % ids_rows) * n;
    for (int j = tid; j < n; j += blockDim.x) ids_s[j] = id_row[j];
  }
  __syncthreads();

  float* u = bufs + warp * 2 * n;  // phase A: exp row, then p; phase B: p column
  float* w = u + n;                // phase A: p * dp, then ds; phase B: ds column
  const float* bias_h = bias ? bias + (long long)h * n * n : nullptr;
  const float* bias_th = bias_t ? bias_t + (long long)h * n * n : nullptr;
  float dq_sum = 0.f, dk_sum = 0.f, dv_sum = 0.f;

  // Phase A: query rows.
  for (int i = warp; i < n; i += kBwdWarps) {
    const float* qi = qs + i * dp1;
    const float* doi = dos + i * dp1;
    const int id_i = has_mask ? ids_s[i] : 0;
    float mx = -INFINITY;
    for (int j = lane; j < n; j += 32) {
      const float* kr = ks + j * dp1;
      float dot = 0.f;
      for (int cc = 0; cc < d; ++cc) dot = fmaf(qi[cc], kr[cc], dot);
      const float s = score(dot, scale, has_mask && ids_s[j] != id_i, has_mask,
                            bias_h ? bias_h + (long long)i * n + j : nullptr);
      u[j] = s;
      mx = fmaxf(mx, s);
    }
    mx = fmaxf(warp_max(mx), 0.f);
    float sum = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float e = expf(__fsub_rn(u[j], mx));
      sum += e;
      u[j] = e;
    }
    const float r = 1.f / (warp_sum(sum) + 1e-30f);
    __syncwarp();
    if (lane < d) {  // ao, as K1f forms it: (round(u) @ v) * r
      float o = 0.f;
      for (int j = 0; j < n; ++j) o = fmaf(round_to<T>(u[j]), vs[j * dp1 + lane], o);
      ao[(base + i) * c + h * d + lane] = from_f32<T>(o * r);
    }
    __syncwarp();
    float s1 = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float* vr = vs + j * dp1;
      float dot = 0.f;
      for (int cc = 0; cc < d; ++cc) dot = fmaf(doi[cc], vr[cc], dot);
      const float p = __fmul_rn(u[j], r);
      const float pw = __fmul_rn(p, dot);
      s1 += pw;
      u[j] = p;
      w[j] = pw;
    }
    s1 = warp_sum(s1);
    for (int j = lane; j < n; j += 32) {
      const float ds = __fsub_rn(w[j], __fmul_rn(s1, u[j]));
      if (dbias) atomicAdd(&dbias[(long long)h * n * n + (long long)i * n + j], ds);
      w[j] = round_to<T>(ds);
    }
    __syncwarp();
    if (lane < d) {
      float a = 0.f;
      for (int j = 0; j < n; ++j) a = fmaf(w[j], ks[j * dp1 + lane], a);
      const float dq = a * scale;
      dqkv[(base + i) * c3 + h * d + lane] = from_f32<T>(dq);
      dq_sum += dq;
    }
    if (lane == 0) {
      shift_s[i] = mx;
      rinv_s[i] = r;
      s1_s[i] = s1;
    }
    __syncwarp();
  }
  __syncthreads();

  // Phase B: key rows, from the row statistics of phase A.
  for (int j = warp; j < n; j += kBwdWarps) {
    const float* kj = ks + j * dp1;
    const float* vj = vs + j * dp1;
    const int id_j = has_mask ? ids_s[j] : 0;
    for (int i = lane; i < n; i += 32) {
      const float* qi = qs + i * dp1;
      const float* doi = dos + i * dp1;
      float dot = 0.f;
      for (int cc = 0; cc < d; ++cc) dot = fmaf(qi[cc], kj[cc], dot);
      const float s = score(dot, scale, has_mask && id_j != ids_s[i], has_mask,
                            bias_th ? bias_th + (long long)j * n + i : nullptr);
      const float p = __fmul_rn(expf(__fsub_rn(s, shift_s[i])), rinv_s[i]);
      float dp = 0.f;
      for (int cc = 0; cc < d; ++cc) dp = fmaf(doi[cc], vj[cc], dp);
      const float ds = __fsub_rn(__fmul_rn(p, dp), __fmul_rn(s1_s[i], p));
      u[i] = round_to<T>(p);
      w[i] = round_to<T>(ds);
    }
    __syncwarp();
    if (lane < d) {
      float av = 0.f, ak = 0.f;
      for (int i = 0; i < n; ++i) {
        av = fmaf(u[i], dos[i * dp1 + lane], av);
        ak = fmaf(w[i], qs[i * dp1 + lane], ak);
      }
      const float dk = ak * scale;
      dqkv[(base + j) * c3 + c + h * d + lane] = from_f32<T>(dk);
      dqkv[(base + j) * c3 + 2 * c + h * d + lane] = from_f32<T>(av);
      dk_sum += dk;
      dv_sum += av;
    }
    __syncwarp();
  }

  if (lane < d) {  // dbqkv: column sums of the unrounded dq, dk, dv
    atomicAdd(&dbqkv[h * d + lane], dq_sum);
    atomicAdd(&dbqkv[c + h * d + lane], dk_sum);
    atomicAdd(&dbqkv[2 * c + h * d + lane], dv_sum);
  }
}

size_t attention_bwd_smem_bytes(int n, int d) {
  return sizeof(float) * ((size_t)4 * n * (d + 1) + 3 * (size_t)n +
                          2 * (size_t)kBwdWarps * n) +
         sizeof(int) * (size_t)n;
}

// The attention backward (launch 4). Tiled: phases A and B from K1f's o
// (f32) and row statistics; ao is not touched. Whole-window: the body
// above, which writes ao.
template <typename T>
cudaError_t attention_bwd_launch(int tiled, const T* qkv, const T* dao, const float* bias,
                                 const float* bias_t, const int* ids, int ids_rows, T* ao,
                                 const float* o, const float* row_stats, float* s1, T* dqkv,
                                 float* dbias, float* dqkv_b, long long bw, int n, int c,
                                 int heads, float scale, cudaStream_t stream) {
  if (tiled)
    return launch_attention_bwd_tiled<T>(qkv, dao, o, row_stats, bias, ids, ids_rows, s1, dqkv,
                                         dbias, dqkv_b, bw, n, c, heads, scale, stream);
  const size_t smem = attention_bwd_smem_bytes(n, c / heads);
  cudaError_t err = cudaFuncSetAttribute(window_attention_bwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  window_attention_bwd_kernel<T><<<(unsigned)(bw * heads), kBwdWarps * 32, smem, stream>>>(
      qkv, dao, bias, bias_t, ids, ids_rows, ao, dqkv, dbias, dqkv_b, n, c, heads, scale);
  return cudaGetLastError();
}

template <typename T>
int attn_half_bwd(int tiled, const T* x, const float* ln_w, const float* ln_b, const float* qkv_w,
                  const float* qkv_b, const float* bias, const float* bias_t,
                  const int* ids, int ids_rows, const float* proj_w, const float* proj_b,
                  const float* gamma, int post_norm, const float* gb,
                  const T* dout, T* y, float* stats, T* qkv, T* dao, T* ao, T* dqkv,
                  float* dy, T* dx, float* dln_w, float* dln_b, float* dqkv_w,
                  float* dqkv_b, float* dbias, float* dproj_w, float* dproj_b,
                  float* dgamma, const float* o32, const float* row_stats, float* s1,
                  float* ln_part, int ln_blocks, long long bw, int n, int c, int heads,
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
                                 dln_b, dgamma, ln_part, ln_blocks, rows, c, stream);
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
    err = attention_bwd_launch<T>(tiled, qkv, dao, bias, bias_t, ids, ids_rows, y, o32,
                                  row_stats, s1, dqkv, dbias, dqkv_b, bw, n, c, heads, scale,
                                  stream);
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
    err = launch_colsum<float>(dy, nullptr, 1, dproj_b, rows, c, stream);
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
    err = attention_bwd_launch<T>(tiled, qkv, dao, bias, bias_t, ids, ids_rows, ao, o32,
                                  row_stats, s1, dqkv, dbias, dqkv_b, bw, n, c, heads, scale,
                                  stream);
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
    err = launch_colsum<T>(dout, gb, rows_per_sample, dproj_b, rows, c, stream);
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

  return (int)launch_ln_bwd<T>(x, stats, ln_w, dy, dout, lam, dx, dln_w, dln_b, ln_part,
                               ln_blocks, rows, c, stream);
}

}  // namespace

// Returns cudaGetLastError() of the first launch that failed, else 0.
// is_bf16 selects bf16 activations (else f32); parameters and their
// gradients are f32. bias/bias_t (the bias and its [H, N^T, N] transpose)
// and ids may be null; dbias is then not written. The f32 gradient outputs
// (dqkv_w .. dproj_b, dbias, and dgamma with a pre-norm gamma) must be
// zeroed by the caller: the kernels add into them; LN1's (dln_w, dln_b, and
// dgamma under post-norm) are written. y, stats, qkv, dao, ao, dqkv, dy and
// ln_part ([ln_blocks, 2C] f32, ln_blocks = common.cuh ln_bwd_plan(BW*N,
// C).blocks, the LN-backward body's block partials) are scratch,
// but for ao under post_norm or tiled: the input K1f's attention output
// [BW*N, C] of this call (vsn_attn_half_fwd's ao_buf), read only.
// tiled selects the key-tiled attention backward (phases A and B, head dims
// that are multiples of 16 up to 128, any N), which reads K1f's row_stats
// [BW, H, N, 2] and o32 (the f32 attention output; null for f32
// activations, whose ao is f32) of the call and takes s1 [BW, H, N] f32 as
// scratch, over the whole-window one (other head dims up to 32; o32,
// row_stats and s1 unused and may be null); the caller chooses by head dim.
// gamma [C] (in-band LayerScale, with dgamma) may be null; post_norm
// selects the post-norm backward (stats unused).
extern "C" int vsn_attn_half_bwd(
    int tiled, int is_bf16, const void* x, const float* ln_w, const float* ln_b,
    const float* qkv_w, const float* qkv_b, const float* bias, const float* bias_t,
    const int* ids, int ids_rows, const float* proj_w, const float* proj_b,
    const float* gamma, int post_norm, const float* gb, const void* dout, void* y,
    float* stats, void* qkv, void* dao, void* ao, void* dqkv, float* dy, void* dx,
    float* dln_w, float* dln_b, float* dqkv_w, float* dqkv_b, float* dbias,
    float* dproj_w, float* dproj_b, float* dgamma, const float* o32,
    const float* row_stats, float* s1, float* ln_part, int ln_blocks, long long bw, int n,
    int c, int heads, long long rows_per_sample, float scale, float lam, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    using B = __nv_bfloat16;
    return attn_half_bwd<B>(
        tiled, static_cast<const B*>(x), ln_w, ln_b, qkv_w, qkv_b, bias, bias_t, ids, ids_rows,
        proj_w, proj_b, gamma, post_norm, gb, static_cast<const B*>(dout),
        static_cast<B*>(y), stats, static_cast<B*>(qkv), static_cast<B*>(dao),
        static_cast<B*>(ao), static_cast<B*>(dqkv), dy, static_cast<B*>(dx), dln_w, dln_b,
        dqkv_w, dqkv_b, dbias, dproj_w, dproj_b, dgamma, o32, row_stats, s1, ln_part,
        ln_blocks, bw, n, c, heads, rows_per_sample, scale, lam, s);
  }
  return attn_half_bwd<float>(
      tiled, static_cast<const float*>(x), ln_w, ln_b, qkv_w, qkv_b, bias, bias_t, ids, ids_rows,
      proj_w, proj_b, gamma, post_norm, gb, static_cast<const float*>(dout),
      static_cast<float*>(y), stats, static_cast<float*>(qkv), static_cast<float*>(dao),
      static_cast<float*>(ao), static_cast<float*>(dqkv), dy, static_cast<float*>(dx), dln_w,
      dln_b, dqkv_w, dqkv_b, dbias, dproj_w, dproj_b, dgamma,
      static_cast<const float*>(ao), row_stats, s1, ln_part, ln_blocks, bw, n, c, heads,
      rows_per_sample, scale, lam, s);
}

// K1b's key-tiled attention backward alone (launch 4 of ``tiled`` above):
// from qkv [BW*N, 3C], dao [BW*N, C], K1f's o (f32 [BW*N, C]) and row_stats
// [BW, H, N, 2], into dqkv [BW*N, 3C], and added into the zeroed f32 dbias
// [H, N, N] (may be null: phase A then adds nothing, the same work
// otherwise) and dbqkv [3C]; s1 [BW, H, N] f32 scratch.
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
        ids_rows, s1, static_cast<B*>(dqkv), dbias, dbqkv, bw, n, c, heads, scale, s);
  }
  return (int)launch_attention_bwd_tiled<float>(
      static_cast<const float*>(qkv), static_cast<const float*>(dao), o, row_stats, bias, ids,
      ids_rows, s1, static_cast<float*>(dqkv), dbias, dbqkv, bw, n, c, heads, scale, s);
}
