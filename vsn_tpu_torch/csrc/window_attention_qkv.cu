// K4f / K4b: multi-head window attention on the packed qkv projection,
// forward and backward.
//
//   out[bw, i, h] = sum_j p[i, j] v[bw, j, h]
//   p = softmax_j(q[bw, i, h] . k[bw, j, h] * scale + bias[h, i, j]
//                 + (ids[bw % W][i] != ids[bw % W][j] ? -1e9 : 0))
//
// Replaces vsn_tpu/ops/window_attention.py _fwd_qkv (Pallas kernel
// _fwd_qkv_kernel, one window with all its heads per program) and
// _bwd_qkv_vjp (_bwd_qkv_kernel, which also adds every window's ds into one
// dbias block revisited on its sequential grid). It is the attention core
// of an unfused Swin block (non-LayerNorm norms, or dropout in training),
// between the qkv and proj Linears, which stay PyTorch matmuls.
//
// Numerics are the TPU kernel's, not K1's: q, k, v are read from the stored
// type into f32 and every product is an f32 FMA; the softmax subtracts the
// plain row max and divides each term by the f32 row sum before p . v; the
// output and dqkv are cast to the activation type T once. The mask is
// additive -1e9 where the region ids of query and key differ (pad slots
// carry -1, an unshifted block passes W = 1 row of zeros).
//
// What bounds it here: the FMA arithmetic of the products (4 N^2 d per
// window and head forward, 10 N^2 d backward; no tensor cores yet), while
// the bytes it must move are small (qkv once, the output once). One
// window's [N, N] f32 scores (254 KB at N = 252) do not fit in the 227 KB a
// block may hold, so no [N, N] matrix is ever stored: as in K1f
// (attn_half.cu) and K1b (attn_half_bwd.cu), one block takes one (window,
// head), keeps that head's operands in shared memory as f32 and gives each
// warp one query row at a time, whose N scores sit in a row buffer.
//
// K4b runs in the two phases of K1b. Phase A takes query rows: scores, row
// max and sum, p, dp = dO V^T, ds = p (dp - rowsum(p dp)), dq = scale ds K,
// and adds ds into dbias with f32 atomics (the TPU's revisited block is a
// reduction over every window here; the order of the adds varies, so dbias
// matches a plain sum to rounding). Phase B takes key rows and recomputes
// p and ds column by column from phase A's row statistics for
// dk = scale ds^T Q and dv = p^T dO, so no dk/dv sum needs atomics. Both
// phases form the score, p and ds with the same round-to-nearest operations
// (no contraction into FMA), so phase B's p and ds equal phase A's bit for
// bit.
//
// Operands are addressed through strides (HeadStrides), not through the
// packed layout: the split [BW, H, N, d] layout of the v1 kernel
// (fused_window_attention) is another setting of the same strides.

#include "common.cuh"

namespace {

// Element (window bw, head h, token i, channel c) of an operand lies at
// bw * win + h * head + i * row + c from its base pointer.
struct HeadStrides {
  long long win, head, row;
  __device__ __forceinline__ long long at(long long bw, int h) const {
    return bw * win + (long long)h * head;
  }
};

template <typename T>
struct AttnParams {
  const T* q;            // q, k, v (and dq, dk, dv) in ``in`` strides
  const T* k;
  const T* v;
  HeadStrides in;
  T* out;                // out (K4f) and dout (K4b) in ``outs`` strides
  const T* dout;
  HeadStrides outs;
  T* dq;                 // K4b
  T* dk;
  T* dv;
  const float* bias;     // [H, N, N]
  const float* bias_t;   // [H, N, N], each head transposed (K4b)
  float* dbias;          // [H, N, N], zeroed by the caller (K4b adds)
  const int* ids;        // [W, N]: window bw uses row bw % W
  int ids_rows;
  int n, d, heads;
  float scale;
};

// The masked, biased, scaled score as _fwd_qkv_kernel forms it:
// (dot * scale + bias) + mask, each step rounded to nearest.
__device__ __forceinline__ float qkv_score(float dot, float scale, float bias,
                                           bool masked) {
  return __fadd_rn(__fadd_rn(__fmul_rn(dot, scale), bias), masked ? kNegInf : 0.f);
}

__device__ __forceinline__ float dot_row(const float* a, const float* b, int d) {
  float s = 0.f;
  for (int c = 0; c < d; ++c) s = fmaf(a[c], b[c], s);
  return s;
}

// Copies one (window, head) operand [N, d] of ``src`` into shared memory
// as f32 rows of ``ld`` floats.
template <typename T>
__device__ __forceinline__ void stage_head(float* dst, int ld, const T* src,
                                           long long base, long long row, int n,
                                           int d) {
  for (int e = threadIdx.x; e < n * d; e += blockDim.x) {
    const int j = e / d, c = e % d;
    dst[j * ld + c] = to_f32(src[base + j * row + c]);
  }
}

// Copies the region ids of window bw (row bw % W) into shared memory.
template <typename T>
__device__ __forceinline__ void stage_ids(int* dst, const AttnParams<T>& p, long long bw) {
  const int* row = p.ids + (bw % p.ids_rows) * p.n;
  for (int j = threadIdx.x; j < p.n; j += blockDim.x) dst[j] = row[j];
}

constexpr int kFwdWarps = 8;

template <typename T>
__global__ void __launch_bounds__(kFwdWarps * 32) attention_qkv_fwd_kernel(AttnParams<T> p) {
  extern __shared__ float smem[];
  const int n = p.n, d = p.d, dp1 = d + 1;
  float* ks = smem;                      // [n][d + 1]  (padded: no bank conflicts)
  float* vs = ks + n * dp1;              // [n][d]
  float* qs = vs + n * d;                // [warps][32]
  float* us = qs + kFwdWarps * 32;       // [warps][n]  one row of scores, then p
  int* ids_s = reinterpret_cast<int*>(us + kFwdWarps * n);  // [n]

  const long long bw = blockIdx.x / p.heads;
  const int h = blockIdx.x % p.heads;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long in0 = p.in.at(bw, h), out0 = p.outs.at(bw, h);

  stage_head(ks, dp1, p.k, in0, p.in.row, n, d);
  stage_head(vs, d, p.v, in0, p.in.row, n, d);
  stage_ids(ids_s, p, bw);
  __syncthreads();

  float* q = qs + warp * 32;
  float* u = us + warp * n;
  const float* bias_h = p.bias + (long long)h * n * n;
  for (int i = warp; i < n; i += kFwdWarps) {
    if (lane < d) q[lane] = to_f32(p.q[in0 + i * p.in.row + lane]);
    __syncwarp();
    const int id_i = ids_s[i];
    float mx = -INFINITY;
    for (int j = lane; j < n; j += 32) {
      const float s = qkv_score(dot_row(q, ks + j * dp1, d), p.scale,
                                bias_h[(long long)i * n + j], ids_s[j] != id_i);
      u[j] = s;
      mx = fmaxf(mx, s);
    }
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float e = expf(__fsub_rn(u[j], mx));
      sum += e;
      u[j] = e;
    }
    sum = warp_sum(sum);
    for (int j = lane; j < n; j += 32) u[j] = __fdiv_rn(u[j], sum);
    __syncwarp();
    if (lane < d) {
      float o = 0.f;
      for (int j = 0; j < n; ++j) o = fmaf(u[j], vs[j * d + lane], o);
      p.out[out0 + i * p.outs.row + lane] = from_f32<T>(o);
    }
    __syncwarp();
  }
}

size_t fwd_smem_bytes(int n, int d) {
  return sizeof(float) * ((size_t)n * (d + 1) + (size_t)n * d + kFwdWarps * 32 +
                          (size_t)kFwdWarps * n) +
         sizeof(int) * (size_t)n;
}

constexpr int kBwdWarps = 16;

template <typename T>
__global__ void __launch_bounds__(kBwdWarps * 32) attention_qkv_bwd_kernel(AttnParams<T> p) {
  extern __shared__ float smem[];
  const int n = p.n, d = p.d, dp1 = d + 1;
  float* qs = smem;                  // [n][d + 1]
  float* ks = qs + n * dp1;          // [n][d + 1]
  float* vs = ks + n * dp1;          // [n][d + 1]
  float* dos = vs + n * dp1;         // [n][d + 1]   dO of the head
  float* mx_s = dos + n * dp1;       // [n]  row max
  float* sum_s = mx_s + n;           // [n]  row sum of exp(s - max)
  float* s1_s = sum_s + n;           // [n]  rowsum(p * dp)
  float* bufs = s1_s + n;            // [warps][2][n]
  int* ids_s = reinterpret_cast<int*>(bufs + 2 * kBwdWarps * n);  // [n]

  const long long bw = blockIdx.x / p.heads;
  const int h = blockIdx.x % p.heads;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long in0 = p.in.at(bw, h), out0 = p.outs.at(bw, h);

  stage_head(qs, dp1, p.q, in0, p.in.row, n, d);
  stage_head(ks, dp1, p.k, in0, p.in.row, n, d);
  stage_head(vs, dp1, p.v, in0, p.in.row, n, d);
  stage_head(dos, dp1, p.dout, out0, p.outs.row, n, d);
  stage_ids(ids_s, p, bw);
  __syncthreads();

  float* u = bufs + warp * 2 * n;  // phase A: scores, exp, then p; phase B: p column
  float* w = u + n;                // phase A: dp, then ds; phase B: ds column
  const long long hnn = (long long)h * n * n;
  const float* bias_h = p.bias + hnn;
  const float* bias_th = p.bias_t + hnn;
  float* dbias_h = p.dbias + hnn;

  // Phase A: query rows.
  for (int i = warp; i < n; i += kBwdWarps) {
    const float* qi = qs + i * dp1;
    const float* doi = dos + i * dp1;
    const int id_i = ids_s[i];
    float mx = -INFINITY;
    for (int j = lane; j < n; j += 32) {
      const float s = qkv_score(dot_row(qi, ks + j * dp1, d), p.scale,
                                bias_h[(long long)i * n + j], ids_s[j] != id_i);
      u[j] = s;
      mx = fmaxf(mx, s);
    }
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float e = expf(__fsub_rn(u[j], mx));
      sum += e;
      u[j] = e;
    }
    sum = warp_sum(sum);
    float s1 = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float dpv = dot_row(doi, vs + j * dp1, d);
      const float pj = __fdiv_rn(u[j], sum);
      s1 += __fmul_rn(pj, dpv);
      u[j] = pj;
      w[j] = dpv;
    }
    s1 = warp_sum(s1);
    for (int j = lane; j < n; j += 32) {
      const float ds = __fmul_rn(u[j], __fsub_rn(w[j], s1));
      atomicAdd(&dbias_h[(long long)i * n + j], ds);
      w[j] = ds;
    }
    __syncwarp();
    if (lane < d) {
      float a = 0.f;
      for (int j = 0; j < n; ++j) a = fmaf(w[j], ks[j * dp1 + lane], a);
      p.dq[in0 + i * p.in.row + lane] = from_f32<T>(a * p.scale);
    }
    if (lane == 0) {
      mx_s[i] = mx;
      sum_s[i] = sum;
      s1_s[i] = s1;
    }
    __syncwarp();
  }
  __syncthreads();

  // Phase B: key rows, from the row statistics of phase A.
  for (int j = warp; j < n; j += kBwdWarps) {
    const float* kj = ks + j * dp1;
    const float* vj = vs + j * dp1;
    const int id_j = ids_s[j];
    for (int i = lane; i < n; i += 32) {
      const float s = qkv_score(dot_row(qs + i * dp1, kj, d), p.scale,
                                bias_th[(long long)j * n + i], id_j != ids_s[i]);
      const float pij = __fdiv_rn(expf(__fsub_rn(s, mx_s[i])), sum_s[i]);
      const float dpv = dot_row(dos + i * dp1, vj, d);
      u[i] = pij;
      w[i] = __fmul_rn(pij, __fsub_rn(dpv, s1_s[i]));
    }
    __syncwarp();
    if (lane < d) {
      float av = 0.f, ak = 0.f;
      for (int i = 0; i < n; ++i) {
        av = fmaf(u[i], dos[i * dp1 + lane], av);
        ak = fmaf(w[i], qs[i * dp1 + lane], ak);
      }
      p.dk[in0 + j * p.in.row + lane] = from_f32<T>(ak * p.scale);
      p.dv[in0 + j * p.in.row + lane] = from_f32<T>(av);
    }
    __syncwarp();
  }
}

size_t bwd_smem_bytes(int n, int d) {
  return sizeof(float) * ((size_t)4 * n * (d + 1) + 3 * (size_t)n +
                          2 * (size_t)kBwdWarps * n) +
         sizeof(int) * (size_t)n;
}

// The strides of the packed layout: qkv [BW, N, 3C] (q at channel 0, k at
// C, v at 2C; head h at h * d) and the merged-head out / dout [BW, N, C].
template <typename T>
AttnParams<T> packed(const T* qkv, const float* bias, const int* ids, int ids_rows,
                     int n, int c, int heads, float scale) {
  AttnParams<T> p = {};
  const int d = c / heads;
  p.q = qkv;
  p.k = qkv + c;
  p.v = qkv + 2 * c;
  p.in = {(long long)n * 3 * c, d, 3LL * c};
  p.outs = {(long long)n * c, d, (long long)c};
  p.bias = bias;
  p.ids = ids;
  p.ids_rows = ids_rows;
  p.n = n;
  p.d = d;
  p.heads = heads;
  p.scale = scale;
  return p;
}

template <typename T>
int attention_qkv_fwd(const T* qkv, const float* bias, const int* ids, int ids_rows,
                      T* out, long long bw, int n, int c, int heads, float scale,
                      cudaStream_t stream) {
  AttnParams<T> p = packed(qkv, bias, ids, ids_rows, n, c, heads, scale);
  p.out = out;
  const size_t smem = fwd_smem_bytes(n, p.d);
  cudaError_t err = cudaFuncSetAttribute(attention_qkv_fwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  attention_qkv_fwd_kernel<T><<<(unsigned)(bw * heads), kFwdWarps * 32, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int attention_qkv_bwd(const T* qkv, const float* bias, const float* bias_t,
                      const int* ids, int ids_rows, const T* dout, T* dqkv,
                      float* dbias, long long bw, int n, int c, int heads,
                      float scale, cudaStream_t stream) {
  AttnParams<T> p = packed(qkv, bias, ids, ids_rows, n, c, heads, scale);
  p.dout = dout;
  p.dq = dqkv;
  p.dk = dqkv + c;
  p.dv = dqkv + 2 * c;
  p.bias_t = bias_t;
  p.dbias = dbias;
  const size_t smem = bwd_smem_bytes(n, p.d);
  cudaError_t err = cudaFuncSetAttribute(attention_qkv_bwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  attention_qkv_bwd_kernel<T><<<(unsigned)(bw * heads), kBwdWarps * 32, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// Both return cudaGetLastError() of the launch (or of setting its shared
// memory size), else 0. is_bf16 selects bf16 activations (qkv, out, dout,
// dqkv), else f32; bias, bias_t (bias with each head transposed) and dbias
// are f32, ids int32. dbias must be zeroed by the caller: K4b adds into it.
extern "C" int vsn_window_attention_qkv_fwd(int is_bf16, const void* qkv,
                                            const float* bias, const int* ids,
                                            int ids_rows, void* out, long long bw,
                                            int n, int c, int heads, float scale,
                                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    using B = __nv_bfloat16;
    return attention_qkv_fwd<B>(static_cast<const B*>(qkv), bias, ids, ids_rows,
                                static_cast<B*>(out), bw, n, c, heads, scale, s);
  }
  return attention_qkv_fwd<float>(static_cast<const float*>(qkv), bias, ids, ids_rows,
                                  static_cast<float*>(out), bw, n, c, heads, scale, s);
}

extern "C" int vsn_window_attention_qkv_bwd(int is_bf16, const void* qkv,
                                            const float* bias, const float* bias_t,
                                            const int* ids, int ids_rows,
                                            const void* dout, void* dqkv,
                                            float* dbias, long long bw, int n, int c,
                                            int heads, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    using B = __nv_bfloat16;
    return attention_qkv_bwd<B>(static_cast<const B*>(qkv), bias, bias_t, ids, ids_rows,
                                static_cast<const B*>(dout), static_cast<B*>(dqkv), dbias,
                                bw, n, c, heads, scale, s);
  }
  return attention_qkv_bwd<float>(static_cast<const float*>(qkv), bias, bias_t, ids,
                                  ids_rows, static_cast<const float*>(dout),
                                  static_cast<float*>(dqkv), dbias, bw, n, c, heads,
                                  scale, s);
}
