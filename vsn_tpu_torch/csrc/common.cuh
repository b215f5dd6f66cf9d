// Shared device code for the port's hand-written Hopper kernels.
//
// Precision contract (vsn_tpu/ops/swin_block_kernels.py _mm_dtype): with
// bf16 activations every matrix-product operand is rounded to bf16 and the
// products accumulate in f32; with f32 activations everything stays f32.
// LayerNorm and softmax statistics are f32 in both cases. The kernels below
// hold every operand as an f32 register value that has already been rounded
// to the activation type T (``round_to<T>``), so one FMA code path serves
// both precisions with the same arithmetic as bf16 MMA + f32 accumulation.
//
// Everything here has internal linkage (anonymous namespace): each .cu file
// is its own translation unit and instantiates what it uses.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kLnEps = 1e-5f;   // models/layers.py make_norm epsilon
constexpr float kNegInf = -1e9f;  // ops/window_attention.py NEG_INF

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as jnp astype
}

// ``v`` rounded to T's precision, held as f32.
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f32<T>(from_f32<T>(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// ---------------------------------------------------------------------------
// Tiled FMA GEMM with an optional A prologue and a set of epilogues:
//
//   out[M, N] = epi( A'[M, K] @ W'[K, N] + bias[N] )
//   A' = round_T(LN(A))              when ln_w is given (forward prologue)
//      = round_T(a_gain[m / rps] * A) when a_gain is given (the gated
//                                      cotangent do = gb[s] * do_res)
//      = round_T((a_gain[m / rps] * A) * gamma[k])
//                                     with a_gain and LS_PRO (the gated
//                                      cotangent through LayerScale)
//      = round_T(A)                   otherwise (A may be an f32 buffer)
//   W' = round_T(W^T) for a torch Linear weight W [N, K] (forward, W_KN
//        false), or round_T(W) for W read as [K, N] (W_KN true: the data
//        gradient dA = dOut @ W of a Linear layer)
//
//   EPI_BIAS       out   = T(acc + bias)                       (qkv)
//   EPI_GELU       out   = T(gelu_erf(acc + bias))             (fc1)
//   EPI_RESIDUAL   out   = T(lam * resid + gains[m / rps] * (acc + bias))
//                                                              (proj, fc2)
//                  with LS_EPI: lam * resid + gains[m / rps] * ((acc + bias)
//                  * gamma[n]), in-band LayerScale in the TPU's order
//                  (swin_block_kernels.py:283-288)
//   EPI_GELU_GRAD  out   = T(gelu_erf(acc + bias)),
//                  out32 = gelu_erf'(acc + bias)               (fc1, in K2b)
//   EPI_F32        out32 = acc + bias                          (dy in K1b/K2b)
//   EPI_MUL_F32    out32 = out32 * (acc + bias)                (dh1 = dh * GELU')
//   EPI_ADD_RESID  out   = T(lam * resid + acc)   (dx = lam * do_res + dy, the
//                                                  post-norm backward's dx)
//
// LS is a compile-time set of LayerScale flags (LS_EPI, LS_PRO): gamma is
// read only where a flag asks for it, so an instantiation without them is
// the GEMM the default modes have always launched.
//
// W is f32 and rounded to T as it is loaded, like ``w.astype(cdt)`` in the
// TPU kernels. The residual is formed in f32 and cast once
// (swin_block_kernels.py:288-289, :880-881).
//
// T is the operand type (every product operand is rounded to it); TA is A's
// element type and TO that of ``resid`` and ``out``, both T unless given.
// The attention probes round their operands to bf16 under f32 activations
// (TO = float), and read A at a row stride ``lda`` wider than K (the q
// slice of a packed qkv buffer); lda = 0 means K.
//
// Tiles: 64 x 64 outputs per block of 256 threads, 4 x 4 per thread, K in
// steps of 16 through shared memory. Ragged M, N and K edges are masked with
// zeros, so they add exactly 0 to the sums.
// ---------------------------------------------------------------------------

enum Epilogue {
  EPI_BIAS = 0,
  EPI_GELU = 1,
  EPI_RESIDUAL = 2,
  EPI_GELU_GRAD = 3,
  EPI_F32 = 4,
  EPI_MUL_F32 = 5,
  EPI_ADD_RESID = 6,
};

enum LayerScaleFlags { LS_EPI = 1, LS_PRO = 2 };

constexpr float kInvSqrt2 = 0.70710678118654752f;
constexpr float kInvSqrt2Pi = 0.39894228040143268f;

__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.f + erff(v * kInvSqrt2));
}

// d/dv gelu_erf(v) = Phi(v) + v * phi(v) (swin_block_kernels.py _gelu_grad)
__device__ __forceinline__ float gelu_erf_grad(float v) {
  return 0.5f * (1.f + erff(v * kInvSqrt2)) + v * kInvSqrt2Pi * expf(-0.5f * v * v);
}

template <typename T, typename TA = T, typename TO = T>
struct GemmParams {
  const TA* a;                // [M, K], row stride lda
  const float* a_gain;        // [M / rows_per_sample] or null
  const float* ln_w;          // [K] or null (no LayerNorm prologue)
  const float* ln_b;          // [K]
  const float* w;             // [N, K], or [K, N] with W_KN
  const float* bias;          // [N] or null
  const TO* resid;            // [M, N] (EPI_RESIDUAL)
  const float* gains;         // [M / rows_per_sample] (EPI_RESIDUAL)
  long long rows_per_sample;  // (EPI_RESIDUAL, a_gain)
  float lam;                  // (EPI_RESIDUAL)
  TO* out;                    // [M, N]
  float* out32;               // [M, N] (EPI_GELU_GRAD, EPI_F32, EPI_MUL_F32)
  long long m;
  int n;
  int k;
  long long lda;              // A's row stride; 0 means k
  const float* gamma;         // [N] (LS_EPI) or [K] (LS_PRO) LayerScale
};

constexpr int kBM = 64, kBN = 64, kBK = 16, kGemmThreads = 256;

template <typename T, int EPI, typename TA, bool W_KN, typename TO, int LS>
__global__ void __launch_bounds__(kGemmThreads) gemm_kernel(GemmParams<T, TA, TO> p) {
  __shared__ __align__(16) float As[kBK][kBM];
  __shared__ __align__(16) float Bs[kBK][kBN];
  __shared__ float mu_s[kBM], rstd_s[kBM];

  const int tid = threadIdx.x;
  const long long m0 = (long long)blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const bool ln = p.ln_w != nullptr;
  const long long lda = p.lda ? p.lda : p.k;

  if (ln) {  // two-pass row statistics, as _ln_fwd
    const int warp = tid >> 5, lane = tid & 31;
    for (int r = warp; r < kBM; r += kGemmThreads / 32) {
      const long long m = m0 + r;
      float mu = 0.f, rstd = 0.f;
      if (m < p.m) {
        const TA* row = p.a + m * lda;
        float s = 0.f;
        for (int k = lane; k < p.k; k += 32) s += to_f32(row[k]);
        mu = warp_sum(s) / p.k;
        float v = 0.f;
        for (int k = lane; k < p.k; k += 32) {
          const float d = to_f32(row[k]) - mu;
          v += d * d;
        }
        rstd = 1.f / sqrtf(warp_sum(v) / p.k + kLnEps);
      }
      if (lane == 0) {
        mu_s[r] = mu;
        rstd_s[r] = rstd;
      }
    }
    __syncthreads();
  }

  const int tx = tid % 16, ty = tid / 16;   // 4 x 4 outputs each
  const int lr = tid / 4, lk = (tid % 4) * 4;  // loader: row lr, 4 k's from lk
  float acc[4][4] = {};
  const long long am = m0 + lr;
  const float a_scale =
      (p.a_gain && am < p.m) ? p.a_gain[am / p.rows_per_sample] : 1.f;

  for (int k0 = 0; k0 < p.k; k0 += kBK) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = k0 + lk + e;
      float v = 0.f;
      if (am < p.m && k < p.k) {
        v = to_f32(p.a[am * lda + k]);
        if (ln)
          v = round_to<T>((v - mu_s[lr]) * rstd_s[lr] * p.ln_w[k] + p.ln_b[k]);
        else if (p.a_gain)
          v = round_to<T>((LS & LS_PRO) ? (a_scale * v) * p.gamma[k] : a_scale * v);
        else if (!std::is_same<TA, T>::value)
          v = round_to<T>(v);
      }
      As[lk + e][lr] = v;
    }
    const int bn = n0 + lr;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = k0 + lk + e;
      float wv = 0.f;
      if (bn < p.n && k < p.k)
        wv = round_to<T>(W_KN ? p.w[(long long)k * p.n + bn] : p.w[(long long)bn * p.k + k]);
      Bs[lk + e][lr] = wv;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long m = m0 + ty * 4 + i;
    if (m >= p.m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n >= p.n) continue;
      const long long o = m * p.n + n;
      float v = acc[i][j] + (p.bias ? p.bias[n] : 0.f);
      if (EPI == EPI_F32) {
        p.out32[o] = v;
        continue;
      }
      if (EPI == EPI_MUL_F32) {
        p.out32[o] = p.out32[o] * v;
        continue;
      }
      if (EPI == EPI_GELU_GRAD) p.out32[o] = gelu_erf_grad(v);
      if (EPI == EPI_GELU || EPI == EPI_GELU_GRAD) v = gelu_erf(v);
      if (EPI == EPI_RESIDUAL)
        v = p.lam * to_f32(p.resid[o]) +
            p.gains[m / p.rows_per_sample] * ((LS & LS_EPI) ? v * p.gamma[n] : v);
      if (EPI == EPI_ADD_RESID) v = p.lam * to_f32(p.resid[o]) + v;
      p.out[o] = from_f32<TO>(v);
    }
  }
}

template <typename T, int EPI, bool W_KN = false, int LS = 0, typename TA, typename TO>
cudaError_t launch_gemm(const GemmParams<T, TA, TO>& p, cudaStream_t stream) {
  const dim3 grid((unsigned)((p.m + kBM - 1) / kBM), (unsigned)((p.n + kBN - 1) / kBN));
  gemm_kernel<T, EPI, TA, W_KN, TO, LS><<<grid, kGemmThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Backward building blocks (K1b, K2b)
//
// The TPU backward kernels keep their parameter-gradient accumulators in
// output blocks that every program of a sequential grid adds to. Blocks of a
// GPU grid run in parallel, so each such sum is a reduction here: a block
// reduces its slice of the rows and adds its partial into a zeroed f32
// output with atomicAdd. The order of those adds varies from run to run, so
// the parameter gradients agree with a plain version to the f32 rounding of
// the sums, not bit for bit.
// ---------------------------------------------------------------------------

// Splits of a reduction over ``m`` rows so that about four blocks per SM
// run, each over at least ``min_rows`` rows (a multiple of 16).
inline long long rows_per_split(long long m, long long blocks_per_split,
                                long long min_rows) {
  const long long target = 4 * 132;
  long long splits = (target + blocks_per_split - 1) / blocks_per_split;
  const long long most = (m + min_rows - 1) / min_rows;
  if (splits > most) splits = most;
  if (splits < 1) splits = 1;
  long long rows = (m + splits - 1) / splits;
  return (rows + 15) / 16 * 16;
}

// y = round_TY(LN(x)) and the row statistics (mean, 1/std) [M, 2], one warp
// per row, computed as the forward GEMM's LayerNorm prologue computes them.
template <typename T, typename TY = T>
__global__ void __launch_bounds__(256) ln_rows_kernel(const T* __restrict__ x,
                                                      const float* __restrict__ w,
                                                      const float* __restrict__ b,
                                                      TY* __restrict__ y,
                                                      float* __restrict__ stats,
                                                      long long m, int k) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * 8 + warp;
  if (row >= m) return;
  const T* xr = x + row * k;
  float s = 0.f;
  for (int c = lane; c < k; c += 32) s += to_f32(xr[c]);
  const float mu = warp_sum(s) / k;
  float v = 0.f;
  for (int c = lane; c < k; c += 32) {
    const float d = to_f32(xr[c]) - mu;
    v += d * d;
  }
  const float rstd = 1.f / sqrtf(warp_sum(v) / k + kLnEps);
  for (int c = lane; c < k; c += 32)
    y[row * k + c] = from_f32<TY>((to_f32(xr[c]) - mu) * rstd * w[c] + b[c]);
  if (lane == 0) {
    stats[2 * row] = mu;
    stats[2 * row + 1] = rstd;
  }
}

template <typename T, typename TY = T>
cudaError_t launch_ln_rows(const T* x, const float* w, const float* b, TY* y,
                           float* stats, long long m, int k, cudaStream_t stream) {
  ln_rows_kernel<T, TY><<<(unsigned)((m + 7) / 8), 256, 0, stream>>>(x, w, b, y, stats, m, k);
  return cudaGetLastError();
}

// LayerNorm backward with the residual cotangent (swin_block_kernels.py
// _ln_bwd and the dx line of both backward kernels):
//
//   xhat = (x - mu) * rstd, dxhat = dy * w
//   dx   = T(lam * do_res + rstd * (dxhat - mean(dxhat) - xhat * mean(dxhat * xhat)))
//   dw  += sum_rows dy * xhat,  db += sum_rows dy
//
// One warp per row; each block sums its rows' dw/db in shared memory and adds
// them to the zeroed outputs once.
constexpr int kLnBwdRows = 128;

template <typename T>
__global__ void __launch_bounds__(256) ln_bwd_kernel(
    const T* __restrict__ x, const float* __restrict__ stats,
    const float* __restrict__ w, const float* __restrict__ dy,
    const T* __restrict__ do_res, float lam, T* __restrict__ dx,
    float* __restrict__ dw, float* __restrict__ db, long long m, int k) {
  extern __shared__ float part[];  // [2k]: dw, db partials
  for (int c = threadIdx.x; c < 2 * k; c += blockDim.x) part[c] = 0.f;
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long r0 = (long long)blockIdx.x * kLnBwdRows;
  for (int rr = warp; rr < kLnBwdRows; rr += 8) {
    const long long row = r0 + rr;
    if (row >= m) break;
    const float mu = stats[2 * row], rstd = stats[2 * row + 1];
    const T* xr = x + row * k;
    const float* dyr = dy + row * k;
    float s1 = 0.f, s2 = 0.f;
    for (int c = lane; c < k; c += 32) {
      const float xhat = (to_f32(xr[c]) - mu) * rstd;
      const float g = dyr[c];
      const float dxhat = g * w[c];
      s1 += dxhat;
      s2 += dxhat * xhat;
      atomicAdd(&part[c], g * xhat);
      atomicAdd(&part[k + c], g);
    }
    const float m1 = warp_sum(s1) / k, m2 = warp_sum(s2) / k;
    for (int c = lane; c < k; c += 32) {
      const float xhat = (to_f32(xr[c]) - mu) * rstd;
      const float dxhat = dyr[c] * w[c];
      const float v = rstd * (dxhat - m1 - xhat * m2);
      dx[row * k + c] = from_f32<T>(lam * to_f32(do_res[row * k + c]) + v);
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < k; c += blockDim.x) {
    atomicAdd(&dw[c], part[c]);
    atomicAdd(&db[c], part[k + c]);
  }
}

template <typename T>
cudaError_t launch_ln_bwd(const T* x, const float* stats, const float* w, const float* dy,
                          const T* do_res, float lam, T* dx, float* dw, float* db,
                          long long m, int k, cudaStream_t stream) {
  const size_t smem = sizeof(float) * 2 * (size_t)k;
  ln_bwd_kernel<T><<<(unsigned)((m + kLnBwdRows - 1) / kLnBwdRows), 256, smem, stream>>>(
      x, stats, w, dy, do_res, lam, dx, dw, db, m, k);
  return cudaGetLastError();
}

// Column sums out[n] += sum_m g_m * A[m, n], with g_m = a_gain[m / rps] or 1:
// the bias gradients (sum of do = gb * do_res, or of dh1). Blocks of 32
// columns x 8 row lanes over a slice of the rows.
template <typename TA>
__global__ void __launch_bounds__(256) colsum_kernel(const TA* __restrict__ a,
                                                     const float* __restrict__ a_gain,
                                                     long long rps, float* __restrict__ out,
                                                     long long m, int n, long long rows) {
  __shared__ float red[8][33];
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int col = blockIdx.x * 32 + tx;
  const long long r0 = (long long)blockIdx.y * rows;
  const long long r1 = r0 + rows < m ? r0 + rows : m;
  float s = 0.f;
  if (col < n)
    for (long long r = r0 + ty; r < r1; r += 8)
      s += (a_gain ? a_gain[r / rps] : 1.f) * to_f32(a[r * n + col]);
  red[ty][tx] = s;
  __syncthreads();
  if (ty == 0 && col < n) {
    float t = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) t += red[i][tx];
    atomicAdd(&out[col], t);
  }
}

template <typename TA>
cudaError_t launch_colsum(const TA* a, const float* a_gain, long long rps, float* out,
                          long long m, int n, cudaStream_t stream) {
  const unsigned cols = (unsigned)((n + 31) / 32);
  const long long rows = rows_per_split(m, cols, 1024);
  const dim3 grid(cols, (unsigned)((m + rows - 1) / rows));
  colsum_kernel<TA><<<grid, 256, 0, stream>>>(a, a_gain, rps, out, m, n, rows);
  return cudaGetLastError();
}

// Weight gradient of a Linear layer, a product that contracts over the token
// rows (435k of them at Swin-T stage 1, micro-batch 8):
//
//   out[N1, N2] += sum_m round_T(g_m * A[m, n1]) * round_T(B[m, n2])
//
// with g_m = a_gain[m / rps] or 1. Split-K: blockIdx.z takes one slice of
// the rows, accumulates a 64 x 64 tile in registers as the GEMM above does,
// and adds it into the zeroed f32 output with atomicAdd.
template <typename T, typename TA>
struct WgradParams {
  const TA* a;                // [M, N1]
  const float* a_gain;        // [M / rows_per_sample] or null
  long long rows_per_sample;
  const T* b;                 // [M, N2]
  float* out;                 // [N1, N2]
  long long m;
  int n1;
  int n2;
  long long rows;             // rows per split
};

template <typename T, typename TA>
__global__ void __launch_bounds__(kGemmThreads) wgrad_kernel(WgradParams<T, TA> p) {
  __shared__ __align__(16) float As[kBK][kBM];
  __shared__ __align__(16) float Bs[kBK][kBN];
  const int tid = threadIdx.x;
  const int i0 = blockIdx.x * kBM, j0 = blockIdx.y * kBN;
  const long long r0 = (long long)blockIdx.z * p.rows;
  const long long r1 = r0 + p.rows < p.m ? r0 + p.rows : p.m;
  const int tx = tid % 16, ty = tid / 16;         // 4 x 4 outputs each
  const int lr = tid / 16, lc = (tid % 16) * 4;   // loader: row lr, 4 columns from lc
  float acc[4][4] = {};

  for (long long k0 = r0; k0 < r1; k0 += kBK) {
    const long long r = k0 + lr;
    const bool live = r < r1;
    const float g = (live && p.a_gain) ? p.a_gain[r / p.rows_per_sample] : 1.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = i0 + lc + e, j = j0 + lc + e;
      As[lr][lc + e] = (live && i < p.n1) ? round_to<T>(g * to_f32(p.a[r * p.n1 + i])) : 0.f;
      Bs[lr][lc + e] = (live && j < p.n2) ? to_f32(p.b[r * p.n2 + j]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int oi = i0 + ty * 4 + i;
    if (oi >= p.n1) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int oj = j0 + tx * 4 + j;
      if (oj < p.n2) atomicAdd(&p.out[(long long)oi * p.n2 + oj], acc[i][j]);
    }
  }
}

template <typename T, typename TA>
cudaError_t launch_wgrad(WgradParams<T, TA> p, cudaStream_t stream) {
  const unsigned gx = (unsigned)((p.n1 + kBM - 1) / kBM);
  const unsigned gy = (unsigned)((p.n2 + kBN - 1) / kBN);
  p.rows = rows_per_split(p.m, (long long)gx * gy, 256);
  const dim3 grid(gx, gy, (unsigned)((p.m + p.rows - 1) / p.rows));
  wgrad_kernel<T, TA><<<grid, kGemmThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The residual modes of K1 and K2 (swin_block_kernels.py _attn_fwd_kernel
// :271-288, _attn_bwd_kernel :388-415, _mlp_fwd_kernel :862-878,
// _mlp_bwd_kernel :904-950): in-band LayerScale (gamma scales the branch
// before the gains) and post-norm (the LayerNorm moves from the block input
// to the branch output). Post-norm needs LayerNorm statistics over a whole
// row of the proj / fc2 output, which a 64 x 64 GEMM tile does not see: the
// last GEMM writes the f32 branch (EPI_F32) and a row kernel below finishes.
// ---------------------------------------------------------------------------

// Post-norm forward: out = T(lam * x + gains[row / rps] * (LN(branch) [*
// gamma])), the LayerNorm statistics of the f32 branch in f32 (two passes,
// as the forward GEMM's prologue), one warp per row. gamma may be null.
template <typename T>
__global__ void __launch_bounds__(256) postnorm_fwd_kernel(
    const float* __restrict__ branch, const T* __restrict__ x,
    const float* __restrict__ w, const float* __restrict__ b,
    const float* __restrict__ gamma, const float* __restrict__ gains,
    long long rps, float lam, T* __restrict__ out, long long m, int k) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * 8 + warp;
  if (row >= m) return;
  const float* br = branch + row * k;
  float s = 0.f;
  for (int c = lane; c < k; c += 32) s += br[c];
  const float mu = warp_sum(s) / k;
  float v = 0.f;
  for (int c = lane; c < k; c += 32) {
    const float d = br[c] - mu;
    v += d * d;
  }
  const float rstd = 1.f / sqrtf(warp_sum(v) / k + kLnEps);
  const float g = gains[row / rps];
  for (int c = lane; c < k; c += 32) {
    float bn = (br[c] - mu) * rstd * w[c] + b[c];
    if (gamma) bn *= gamma[c];
    out[row * k + c] = from_f32<T>(lam * to_f32(x[row * k + c]) + g * bn);
  }
}

template <typename T>
cudaError_t launch_postnorm_fwd(const float* branch, const T* x, const float* w,
                                const float* b, const float* gamma, const float* gains,
                                long long rps, float lam, T* out, long long m, int k,
                                cudaStream_t stream) {
  postnorm_fwd_kernel<T><<<(unsigned)((m + 7) / 8), 256, 0, stream>>>(
      branch, x, w, b, gamma, gains, rps, lam, out, m, k);
  return cudaGetLastError();
}

// Post-norm backward, on the recomputed f32 branch, which it overwrites
// with dbranch:
//
//   xhat = (branch - mu) * rstd, bn = xhat * w + b, do = gb[s] * do_res
//   dgamma += sum_rows do * bn, then do *= gamma            (gamma not null)
//   dbranch = rstd * (do w - mean(do w) - xhat * mean(do w xhat))
//   dw += sum_rows do * xhat,  db += sum_rows do
//
// One warp per row; each block sums its rows' dw / db / dgamma in shared
// memory and adds them to the zeroed outputs once (f32 atomics).
template <typename T>
__global__ void __launch_bounds__(256) postnorm_bwd_kernel(
    float* __restrict__ branch, const T* __restrict__ do_res,
    const float* __restrict__ gb, long long rps, const float* __restrict__ w,
    const float* __restrict__ b, const float* __restrict__ gamma,
    float* __restrict__ dw, float* __restrict__ db, float* __restrict__ dgamma,
    long long m, int k) {
  extern __shared__ float part[];  // [3k]: dw, db, dgamma partials
  for (int c = threadIdx.x; c < 3 * k; c += blockDim.x) part[c] = 0.f;
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long r0 = (long long)blockIdx.x * kLnBwdRows;
  for (int rr = warp; rr < kLnBwdRows; rr += 8) {
    const long long row = r0 + rr;
    if (row >= m) break;
    float* br = branch + row * k;
    const T* dr = do_res + row * k;
    const float g = gb[row / rps];
    float s = 0.f;
    for (int c = lane; c < k; c += 32) s += br[c];
    const float mu = warp_sum(s) / k;
    float v = 0.f;
    for (int c = lane; c < k; c += 32) {
      const float d = br[c] - mu;
      v += d * d;
    }
    const float rstd = 1.f / sqrtf(warp_sum(v) / k + kLnEps);
    float s1 = 0.f, s2 = 0.f;
    for (int c = lane; c < k; c += 32) {
      const float xhat = (br[c] - mu) * rstd;
      float d = g * to_f32(dr[c]);
      if (gamma) {
        atomicAdd(&part[2 * k + c], d * (xhat * w[c] + b[c]));
        d *= gamma[c];
      }
      const float dxhat = d * w[c];
      s1 += dxhat;
      s2 += dxhat * xhat;
      atomicAdd(&part[c], d * xhat);
      atomicAdd(&part[k + c], d);
    }
    const float m1 = warp_sum(s1) / k, m2 = warp_sum(s2) / k;
    for (int c = lane; c < k; c += 32) {
      const float xhat = (br[c] - mu) * rstd;
      float d = g * to_f32(dr[c]);
      if (gamma) d *= gamma[c];
      br[c] = rstd * (d * w[c] - m1 - xhat * m2);
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < k; c += blockDim.x) {
    atomicAdd(&dw[c], part[c]);
    atomicAdd(&db[c], part[k + c]);
    if (gamma) atomicAdd(&dgamma[c], part[2 * k + c]);
  }
}

template <typename T>
cudaError_t launch_postnorm_bwd(float* branch, const T* do_res, const float* gb, long long rps,
                                const float* w, const float* b, const float* gamma, float* dw,
                                float* db, float* dgamma, long long m, int k,
                                cudaStream_t stream) {
  const size_t smem = sizeof(float) * 3 * (size_t)k;
  postnorm_bwd_kernel<T><<<(unsigned)((m + kLnBwdRows - 1) / kLnBwdRows), 256, smem, stream>>>(
      branch, do_res, gb, rps, w, b, gamma, dw, db, dgamma, m, k);
  return cudaGetLastError();
}

// Pre-norm LayerScale gradients of the last product out = gamma * (a @ W^T +
// bias), from its unscaled weight and bias gradients M = do^T @ a [N, K] and
// s = sum_rows do [N] (the split-K and column-sum launches, finished on the
// stream before this one):
//
//   dgamma[o] += sum_i W[o, i] M[o, i] + bias[o] s[o]
//   M[o, :] *= gamma[o],  s[o] *= gamma[o]
//
// as the TPU kernels take it (swin_block_kernels.py:404-415, :936-950):
// dgamma from the unscaled sums, dW and db scaled after. One warp per o.
// TW is the parameters' and their gradients' type (f32); as a template the
// kernel is compiled only into the sources that launch it.
template <typename TW>
__global__ void __launch_bounds__(256) layerscale_grads_kernel(
    const TW* __restrict__ w, const TW* __restrict__ bias,
    const TW* __restrict__ gamma, TW* __restrict__ dw, TW* __restrict__ db,
    TW* __restrict__ dgamma, int n, int k) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int o = blockIdx.x * 8 + warp;
  if (o >= n) return;
  TW* mrow = dw + (long long)o * k;
  const TW* wrow = w + (long long)o * k;
  float acc = 0.f;
  for (int i = lane; i < k; i += 32) acc += wrow[i] * mrow[i];
  acc = warp_sum(acc);
  const float g = gamma[o];
  for (int i = lane; i < k; i += 32) mrow[i] *= g;
  if (lane == 0) {
    dgamma[o] += acc + bias[o] * db[o];
    db[o] *= g;
  }
}

template <typename TW>
cudaError_t launch_layerscale_grads(const TW* w, const TW* bias, const TW* gamma, TW* dw,
                                   TW* db, TW* dgamma, int n, int k, cudaStream_t stream) {
  layerscale_grads_kernel<TW><<<(unsigned)((n + 7) / 8), 256, 0, stream>>>(w, bias, gamma, dw,
                                                                           db, dgamma, n, k);
  return cudaGetLastError();
}

}  // namespace
