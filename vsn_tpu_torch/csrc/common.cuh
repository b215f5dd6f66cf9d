// Shared device code for the port's hand-written Hopper kernels.
//
// Precision contract (vsn_tpu/ops/swin_block_kernels.py _mm_dtype): with
// bf16 activations every matrix-product operand is rounded to bf16 and the
// products accumulate in f32; with f32 activations everything stays f32.
// LayerNorm and softmax statistics are f32 in both cases. The kernels below
// round every product operand to the activation type T (``round_to<T>``)
// once, before the product: the bf16 GEMM bodies feed them to mma.sync
// (mma.cuh), the f32 ones and the row kernels hold them as f32 register
// values, the same arithmetic as bf16 MMA + f32 accumulation.
//
// Everything here has internal linkage (anonymous namespace): each .cu file
// is its own translation unit and instantiates what it uses.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mma.cuh"

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
// Tiled GEMM with an optional A prologue and a set of epilogues:
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
// Replaces the products of vsn_tpu/ops/swin_block_kernels.py: ``_mmw``
// (:246) in _attn_fwd_kernel / _attn_bwd_kernel and the dot_generals of
// _mlp_fwd_kernel / _mlp_bwd_kernel (:857-966), which the TPU runs on its
// MXU inside the fused kernels. Two bodies, chosen by T in ``launch_gemm``:
//
//   - bf16 (T = __nv_bfloat16): ``gemm_mma_kernel``, mma.sync.m16n8k16 on
//     bf16 operands with f32 accumulators (mma.cuh). What bounds it on the
//     H100: bytes at K = 96 (Swin stage 1: qkv reads 83.6 MB and writes
//     250.8 MB per micro-batch of 8 against 24 GFLOP, 72 FLOP/byte under the
//     card's ~295), the products from K >= 384 (ViT: 24 C^2 operations per
//     row and block). What the design does: 128 x 128 output tiles of 4
//     warps (64 x 64 each), two blocks an SM; K in steps of 32. cp.async
//     copies A (as TA) and W (f32) kStages k-tiles ahead into raw tiles, so
//     that no thread waits on device memory; one k-tile ahead of the
//     products each thread turns its chunks of a raw tile into bf16 operand
//     tiles (double-buffered, rows padded by 16 bytes so that ldmatrix hits
//     no bank twice): A's LN, gain and LS_PRO in f32, W and an f32 A
//     rounded once (round to nearest even, as round_to<T>); a bf16 A with no
//     transform is copied. The N tiles of one row block are neighbours in
//     the grid, so A's row block is read from DRAM once and from L2 after.
//     The epilogue stages the tile in f32 over the pipeline's shared memory
//     and finishes it in coalesced 16-byte chunks of 8 columns (resid,
//     out32 and out read and written as whole vectors). LN statistics are
//     computed per block from A (two passes, as _ln_fwd, 8 lanes a row,
//     under the first k-tiles' copies): ceil(N / 128) times per row, 3 at
//     qkv (N = 288).
//   - f32 (T = float, the tests' type, held to 1e-4, which bf16 mma does not
//     keep): ``gemm_kernel``, 64 x 64 outputs per block of 256 threads, 4 x 4
//     per thread, K in steps of 16 through shared memory, FMA on f32
//     registers.
//
// Ragged M, N and K edges are masked with zeros in both, so they add exactly
// 0 to the sums.
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

// The FMA body's launch: every f32 GEMM; on bf16 operands only where
// chip_smoke.py times it beside the tensor-core body (csrc/gemm.cu).
template <typename T, int EPI, bool W_KN = false, int LS = 0, typename TA, typename TO>
cudaError_t launch_gemm_fma(const GemmParams<T, TA, TO>& p, cudaStream_t stream) {
  const dim3 grid((unsigned)((p.m + kBM - 1) / kBM), (unsigned)((p.n + kBN - 1) / kBN));
  gemm_kernel<T, EPI, TA, W_KN, TO, LS><<<grid, kGemmThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The tensor-core GEMM body (bf16), see the note above ``enum Epilogue``.
// ---------------------------------------------------------------------------

constexpr int kMmaBM = 128, kMmaBN = 128, kMmaBK = 32, kMmaThreads = 128;
constexpr int kMmaLdK = kMmaBK + 8;   // [rows][32 depth] tiles: 80-byte rows
constexpr int kMmaLdN = kMmaBN + 8;   // [32 depth][128 columns] tiles: 272-byte rows
constexpr int kMmaLdE = kMmaBN + 4;   // the f32 epilogue tile's rows
constexpr int kMmaMinBlocks = 2;      // per SM: one block's epilogue runs under another's products

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Eight consecutive elements of a row, held as loaded: by 16-byte vector
// loads where all eight lie inside the row (``valid`` >= 8) and ``vec`` says
// the address is aligned, else element by element, zero past ``valid``.
template <typename TA>
struct Row8;

template <>
struct Row8<__nv_bfloat16> {
  uint32_t w[4];  // bf16 bits, element 2 i in the low half of w[i]
  __device__ __forceinline__ void load(const __nv_bfloat16* src, int valid, bool vec) {
    if (vec && valid >= 8) {
      const uint4 v = *reinterpret_cast<const uint4*>(src);
      w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
      return;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t lo = 2 * i < valid ? __bfloat16_as_ushort(src[2 * i]) : 0u;
      const uint32_t hi = 2 * i + 1 < valid ? __bfloat16_as_ushort(src[2 * i + 1]) : 0u;
      w[i] = lo | (hi << 16);
    }
  }
  __device__ __forceinline__ float get(int e) const {
    return __uint_as_float(e & 1 ? w[e >> 1] & 0xffff0000u : w[e >> 1] << 16);
  }
};

template <>
struct Row8<float> {
  float f[8];
  __device__ __forceinline__ void load(const float* src, int valid, bool vec) {
    if (vec && valid >= 8) {
      const float4 a = reinterpret_cast<const float4*>(src)[0];
      const float4 b = reinterpret_cast<const float4*>(src)[1];
      f[0] = a.x, f[1] = a.y, f[2] = a.z, f[3] = a.w;
      f[4] = b.x, f[5] = b.y, f[6] = b.z, f[7] = b.w;
      return;
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) f[e] = e < valid ? src[e] : 0.f;
  }
  __device__ __forceinline__ float get(int e) const { return f[e]; }
};

// Eight f32 values rounded to bf16 (nearest even), as one 16-byte vector.
__device__ __forceinline__ uint4 pack8(const float (&v)[8]) {
  return make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]), pack_bf16(v[4], v[5]),
                    pack_bf16(v[6], v[7]));
}

// Store the first ``valid`` of eight values as TO: one or two 16-byte
// vectors where all eight are valid and ``vec`` says the address is aligned.
__device__ __forceinline__ void store8(__nv_bfloat16* dst, const float (&v)[8], int valid,
                                       bool vec) {
  if (vec && valid >= 8) {
    *reinterpret_cast<uint4*>(dst) = pack8(v);
    return;
  }
#pragma unroll
  for (int e = 0; e < 8; ++e)
    if (e < valid) dst[e] = __float2bfloat16(v[e]);
}

__device__ __forceinline__ void store8(float* dst, const float (&v)[8], int valid, bool vec) {
  if (vec && valid >= 8) {
    reinterpret_cast<float4*>(dst)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(dst)[1] = make_float4(v[4], v[5], v[6], v[7]);
    return;
  }
#pragma unroll
  for (int e = 0; e < 8; ++e)
    if (e < valid) dst[e] = v[e];
}

// The epilogue of eight columns n.. of row m from their staged values v
// (acc + bias, and for EPI_RESIDUAL already gains[m / rps] * (... [* gamma])):
// every read and write a whole vector where the row allows.
template <typename T, int EPI, typename TA, typename TO>
__device__ __forceinline__ void gemm_epilogue8(const GemmParams<T, TA, TO>& p, float (&v)[8],
                                               long long o, int valid, bool vec) {
  if (EPI == EPI_F32) {
    store8(p.out32 + o, v, valid, vec);
    return;
  }
  if (EPI == EPI_MUL_F32) {
    Row8<float> old;
    old.load(p.out32 + o, valid, vec);
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = old.get(e) * v[e];
    store8(p.out32 + o, v, valid, vec);
    return;
  }
  if (EPI == EPI_GELU_GRAD) {
    float d[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) d[e] = gelu_erf_grad(v[e]);
    store8(p.out32 + o, d, valid, vec);
  }
  if (EPI == EPI_GELU || EPI == EPI_GELU_GRAD) {
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = gelu_erf(v[e]);
  }
  if (EPI == EPI_RESIDUAL || EPI == EPI_ADD_RESID) {
    Row8<TO> r;
    r.load(p.resid + o, valid, vec);
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = p.lam * r.get(e) + v[e];
  }
  store8(p.out + o, v, valid, vec);
}

// Let ``kernel`` take ``bytes`` of dynamic shared memory, with the SM's
// whole carveout given to shared memory: CUDA may otherwise pick a carveout
// that holds one block, not the kMmaMinBlocks the sizes allow.
template <typename K>
cudaError_t set_smem(K kernel, int bytes) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

// Copy a [rows][cols] tile of elements E (cols a multiple of 16 bytes) from
// row r0 of a [nrows][ld] array, at column c0 of ncols, into shared memory
// dst (row stride dld elements), by 16-byte cp.async where ``vec``, else by
// plain element loads; rows past nrows and columns past ncols are zero. The
// block's threads take the tile's 16-byte chunks in turn.
template <int ROWS, int COLS, typename E>
__device__ __forceinline__ void stage_raw(E* dst, int dld, const E* src, long long ld,
                                          long long r0, long long nrows, int c0, int ncols,
                                          bool vec) {
  constexpr int kPer = 16 / (int)sizeof(E), kChunks = ROWS * COLS / kPer;
#pragma unroll 1
  for (int c = threadIdx.x; c < kChunks; c += kMmaThreads) {
    const int r = c / (COLS / kPer), cc = (c % (COLS / kPer)) * kPer;
    const long long row = r0 + r;
    const int col = c0 + cc;
    if (vec) {
      const bool ok = row < nrows && col < ncols;
      cp_async16(dst + r * dld + cc, ok ? src + row * ld + col : src, ok);
    } else {
#pragma unroll
      for (int e = 0; e < kPer; ++e)
        dst[r * dld + cc + e] = row < nrows && col + e < ncols ? src[row * ld + col + e]
                                                               : from_f32<E>(0.f);
    }
  }
}

// Shared memory of the tensor-core GEMM body: kStages raw k-tiles of A (as
// TA) and W (f32) that cp.async fills, two bf16 operand tiles of each that
// the products read, and the f32 epilogue tile over all of them.
template <typename TA, bool W_KN>
struct GemmSmem {
  static constexpr int kStages = sizeof(TA) == 2 ? 3 : 2;
  static constexpr int kRawA = kMmaBM * kMmaBK * (int)sizeof(TA);
  static constexpr int kRawW = kMmaBN * kMmaBK * 4;
  static constexpr int kOpA = kMmaBM * kMmaLdK * 2;
  static constexpr int kOpW = (W_KN ? kMmaBK * kMmaLdN : kMmaBN * kMmaLdK) * 2;
  static constexpr int kPipe = kStages * (kRawA + kRawW) + 2 * (kOpA + kOpW);
  static constexpr int kEpi = kMmaBM * kMmaLdE * 4;
  static constexpr int kBytes = kPipe > kEpi ? kPipe : kEpi;
};

template <typename T, int EPI, typename TA, bool W_KN, typename TO, int LS>
__global__ void __launch_bounds__(kMmaThreads, kMmaMinBlocks)
    gemm_mma_kernel(GemmParams<T, TA, TO> p) {
  using B = __nv_bfloat16;
  using S = GemmSmem<TA, W_KN>;
  constexpr int kStages = S::kStages;
  extern __shared__ __align__(16) unsigned char gemm_smem[];
  __shared__ float mu_s[kMmaBM], rstd_s[kMmaBM];  // LN statistics
  float* scale_s = mu_s;                            // or the row gains
  unsigned char* raw = gemm_smem;                                  // [kStages][A, W]
  B* op = reinterpret_cast<B*>(gemm_smem + kStages * (S::kRawA + S::kRawW));  // [2][A, W]
  auto raw_a = [&](int s) { return reinterpret_cast<TA*>(raw + s * (S::kRawA + S::kRawW)); };
  auto raw_w = [&](int s) {
    return reinterpret_cast<float*>(raw + s * (S::kRawA + S::kRawW) + S::kRawA);
  };
  auto op_a = [&](int b) { return op + b * (S::kOpA + S::kOpW) / 2; };
  auto op_w = [&](int b) { return op + b * (S::kOpA + S::kOpW) / 2 + S::kOpA / 2; };

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ntn = (p.n + kMmaBN - 1) / kMmaBN;  // the N tiles of a row block: neighbours
  const long long m0 = (long long)(blockIdx.x / ntn) * kMmaBM;
  const int n0 = (int)(blockIdx.x % ntn) * kMmaBN;
  const bool ln = p.ln_w != nullptr;
  const long long lda = p.lda ? p.lda : p.k;
  constexpr int kPerA = 16 / (int)sizeof(TA);
  const bool a_vec = aligned16(p.a) && lda % kPerA == 0 && p.k % kPerA == 0;
  const bool w_vec = aligned16(p.w) && p.n % 4 == 0 && p.k % 4 == 0;

  auto fetch = [&](int t) {  // raw k-tile t into stage t % kStages, one commit group
    if (t < (p.k + kMmaBK - 1) / kMmaBK) {
      const int k0 = t * kMmaBK, s = t % kStages;
      stage_raw<kMmaBM, kMmaBK>(raw_a(s), kMmaBK, p.a, lda, m0, p.m, k0, p.k, a_vec);
      if (W_KN)
        stage_raw<kMmaBK, kMmaBN>(raw_w(s), kMmaBN, p.w, p.n, k0, p.k, n0, p.n, w_vec);
      else
        stage_raw<kMmaBN, kMmaBK>(raw_w(s), kMmaBK, p.w, p.k, n0, p.n, k0, p.k, w_vec);
    }
    cp_async_commit();
  };
  fetch(0);
  fetch(1);
  if (kStages > 2) fetch(2);

  // Row terms of the A prologue: LayerNorm statistics (two passes over the
  // row, as _ln_fwd; 8 lanes a row, 4 rows a warp at a time) or the gain.
  if (ln) {
    const int sub = lane & 7;
    for (int r = warp * 4 + (lane >> 3); r < kMmaBM; r += 16) {
      const long long m = m0 + r;
      const TA* row = p.a + (m < p.m ? m : 0) * lda;
      float s = 0.f;
      if (m < p.m) {
        if (a_vec) {
          for (int k = sub * kPerA; k < p.k; k += 8 * kPerA) {
            Row8<TA> v;
            v.load(row + k, kPerA, true);
#pragma unroll
            for (int e = 0; e < kPerA; ++e) s += v.get(e);
          }
        } else {
          for (int k = sub; k < p.k; k += 8) s += to_f32(row[k]);
        }
      }
#pragma unroll
      for (int o = 4; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      const float mu = s / p.k;
      float v2 = 0.f;
      if (m < p.m) {
        if (a_vec) {
          for (int k = sub * kPerA; k < p.k; k += 8 * kPerA) {
            Row8<TA> v;
            v.load(row + k, kPerA, true);
#pragma unroll
            for (int e = 0; e < kPerA; ++e) {
              const float d = v.get(e) - mu;
              v2 += d * d;
            }
          }
        } else {
          for (int k = sub; k < p.k; k += 8) {
            const float d = to_f32(row[k]) - mu;
            v2 += d * d;
          }
        }
      }
#pragma unroll
      for (int o = 4; o > 0; o >>= 1) v2 += __shfl_xor_sync(0xffffffffu, v2, o);
      if (sub == 0) {
        mu_s[r] = mu;
        rstd_s[r] = m < p.m ? 1.f / sqrtf(v2 / p.k + kLnEps) : 0.f;
      }
    }
  } else if (p.a_gain) {
    for (int r = tid; r < kMmaBM; r += kMmaThreads) {
      const long long m = m0 + r;
      scale_s[r] = m < p.m ? p.a_gain[m / p.rows_per_sample] : 1.f;
    }
  }

  // Raw k-tile t (stage t % kStages) -> bf16 operand tiles b: A transformed
  // in f32 and rounded once, W rounded. Each thread takes four 8-element
  // chunks of each, at one depth (A) or column (W_KN) offset.
  auto transform = [&](int t, int b) {
    const int k0 = t * kMmaBK, s = t % kStages;
    const TA* ra = raw_a(s);
    const float* rw = raw_w(s);
    B* oa = op_a(b);
    B* ow = op_w(b);
    const int lc = (tid & 3) * 8;  // A: depth offset, rows tid / 4 + 32 q
    const int k = k0 + lc;
#pragma unroll 1
    for (int q = 0; q < 4; ++q) {
      const int r = (tid >> 2) + 32 * q;
      const bool live = m0 + r < p.m;
      uint4* dst = reinterpret_cast<uint4*>(oa + r * kMmaLdK + lc);
      Row8<TA> x8;
      x8.load(ra + r * kMmaBK + lc, 8, true);
      float v[8];
      if (!ln && !(LS & LS_PRO)) {
        // the raw tile holds zeros past M and K: no masks. A bf16 A with
        // no gain is a copy; otherwise the gain times A, rounded
        if constexpr (std::is_same<TA, B>::value) {
          if (!p.a_gain) {
            *dst = make_uint4(x8.w[0], x8.w[1], x8.w[2], x8.w[3]);
            continue;
          }
        }
        const float g = p.a_gain ? scale_s[r] : 1.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = g * x8.get(e);
        *dst = pack8(v);
        continue;
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        float x = x8.get(e);
        if (live && k + e < p.k) {
          if (ln)
            x = (x - mu_s[r]) * rstd_s[r] * p.ln_w[k + e] + p.ln_b[k + e];
          else if (p.a_gain)
            x = (scale_s[r] * x) * p.gamma[k + e];  // LS_PRO
        } else {
          x = 0.f;
        }
        v[e] = x;
      }
      *dst = pack8(v);
    }
#pragma unroll 1
    for (int q = 0; q < 4; ++q) {
      // W: [128 n][32 k] -> rows tid / 4 + 32 q at depth lc; W_KN: [32 k][128
      // n] -> rows tid / 16 + 8 q at column (tid % 16) * 8
      const int r = W_KN ? (tid >> 4) + 8 * q : (tid >> 2) + 32 * q;
      const int c = W_KN ? (tid & 15) * 8 : lc;
      Row8<float> w8;
      w8.load(rw + r * (W_KN ? kMmaBN : kMmaBK) + c, 8, true);
      *reinterpret_cast<uint4*>(ow + r * (W_KN ? kMmaLdN : kMmaLdK) + c) = pack8(w8.f);
    }
  };

  const int wm = warp >> 1, wn = warp & 1;  // 2 x 2 warps of 64 x 64 outputs
  float acc[4][8][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int nk = (p.k + kMmaBK - 1) / kMmaBK;
  cp_async_wait<kStages - 1>();  // raw tile 0
  __syncthreads();               // ... and the row terms
  transform(0, 0);
  for (int t = 0; t < nk; ++t) {
    // raw tile t + 1 landed; operand tile t written; every warp done with
    // the products of t - 1 and the transform of raw tile t
    cp_async_wait<kStages - 2>();
    __syncthreads();
    fetch(t + kStages);
    if (t + 1 < nk) transform(t + 1, (t + 1) & 1);
    const B* at = op_a(t & 1);
    const B* wt = op_w(t & 1);
#pragma unroll 1
    for (int ks = 0; ks < kMmaBK; ks += 16) {
      uint32_t a[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) load_a<kMmaLdK>(a[i], at, wm * 64 + i * 16, ks, lane);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t b[4];
        if (W_KN)
          load_b_nn<kMmaLdN>(b, wt, ks, wn * 64 + j * 16, lane);
        else
          load_b_nt<kMmaLdK>(b, wt, wn * 64 + j * 16, ks, lane);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          mma_bf16(acc[i][2 * j], a[i], b[0], b[1]);
          mma_bf16(acc[i][2 * j + 1], a[i], b[2], b[3]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // Epilogue: the warps stage acc + bias (EPI_RESIDUAL: times gamma and the
  // row's gain) in f32 over the pipeline's memory, then every thread
  // finishes chunks of 8 columns of it.
  float* es = reinterpret_cast<float*>(gemm_smem);  // [128][kMmaLdE]
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = wm * 64 + i * 16 + g + 8 * hh;
      const long long m = m0 + r;
      const float gain =
          (EPI == EPI_RESIDUAL && m < p.m) ? p.gains[m / p.rows_per_sample] : 1.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = wn * 64 + j * 8 + 2 * t4 + e, n = n0 + c;
          float v = acc[i][j][2 * hh + e];
          if (n < p.n) {
            if (p.bias) v += p.bias[n];
            if (EPI == EPI_RESIDUAL) v = gain * ((LS & LS_EPI) ? p.gamma[n] * v : v);
          }
          es[r * kMmaLdE + c] = v;
        }
    }
  __syncthreads();
  const bool o_vec = p.n % 8 == 0 && aligned16(p.out) && aligned16(p.out32) &&
                     aligned16(p.resid);
#pragma unroll 1
  for (int c = tid; c < kMmaBM * (kMmaBN / 8); c += kMmaThreads) {
    const int r = c >> 4, col = (c & 15) * 8;
    const long long m = m0 + r;
    const int n = n0 + col;
    if (m < p.m && n < p.n) {
      float v[8];
      const float4 lo = *reinterpret_cast<const float4*>(es + r * kMmaLdE + col);
      const float4 hi = *reinterpret_cast<const float4*>(es + r * kMmaLdE + col + 4);
      v[0] = lo.x, v[1] = lo.y, v[2] = lo.z, v[3] = lo.w;
      v[4] = hi.x, v[5] = hi.y, v[6] = hi.z, v[7] = hi.w;
      gemm_epilogue8<T, EPI, TA, TO>(p, v, m * p.n + n, p.n - n, o_vec);
    }
  }
}

// The GEMM launch: the tensor-core body for bf16 operands, the FMA body for
// f32. Blocks are numbered row block by row block, the N tiles of one row
// block next to each other.
template <typename T, int EPI, bool W_KN = false, int LS = 0, typename TA, typename TO>
cudaError_t launch_gemm(const GemmParams<T, TA, TO>& p, cudaStream_t stream) {
  if constexpr (kTensorCores<T>) {
    auto kernel = gemm_mma_kernel<T, EPI, TA, W_KN, TO, LS>;
    constexpr int kBytes = GemmSmem<TA, W_KN>::kBytes;
    cudaError_t err = set_smem(kernel, kBytes);
    if (err != cudaSuccess) return err;
    const long long blocks =
        (p.m + kMmaBM - 1) / kMmaBM * ((p.n + kMmaBN - 1) / kMmaBN);
    kernel<<<(unsigned)blocks, kMmaThreads, kBytes, stream>>>(p);
    return cudaGetLastError();
  } else {
    return launch_gemm_fma<T, EPI, W_KN, LS>(p, stream);
  }
}

// ---------------------------------------------------------------------------
// Backward building blocks (K1b, K2b)
//
// The TPU backward kernels keep their parameter-gradient accumulators in
// output blocks that every program of a sequential grid adds to. Blocks of a
// GPU grid run in parallel, so each such sum is a reduction here. The weight
// gradients' blocks add their partials into a zeroed f32 output with
// atomicAdd; the order of those adds varies from run to run, so they agree
// with a plain version to the f32 rounding of the sums, not bit for bit. The
// row kernels' sums (the LayerNorm backward's dw / db / dgamma, the bias
// gradients' column sums) are the exception: their blocks write their
// partials, which a second launch adds in block order (the same bits on
// every run).
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

// The row plan of the kernels that hold whole rows: LN's rows
// (``ln_rows_kernel``) and the LayerNorm backward (``ln_bwd_rows_kernel``).
// A plan of (M, C) alone (``ln_bwd_plan``): a lane group of L lanes (a power
// of two) owns a row, each lane K units of VEC columns (unit u = k * L + the
// lane's place in the group), loaded once into registers; a block of
// kLnBwdWarps warps walks a run of rows, 256 / L rows at a time, so where L
// < 32 a warp keeps several rows' loads in flight.
//
//   - C a multiple of 8: 8-column units, read and written by 16-byte vectors
//     (two for f32); L is the least power of two with 3 L >= C / 8, so K <= 3
//     up to C = 768 at L = 32 (Swin-T's and ViT-S's widths: 4 lanes at C =
//     96, 32 at 768), L = 64-256 above, and K = 4 at L = 256 (C <= 8192).
//   - Other C: one column a lane (coalesced scalar loads); L = 32 with K = 1,
//     2, 4 or 8 up to C = 256, then L = 64, 128, 256 at K = 8, and K = 16,
//     32 at L = 256 (C <= 8192).
//   - L <= 32: a row's sums are shuffles within its group. L = 64-256
//     (``WIDE``): a group spans 2-8 warps, whose sums meet through shared
//     memory, added in warp order (``RowSum``).
// The rows' operands must be 16-byte aligned (the wrappers copy one that is
// not); LN's parameters are staged once a block in shared memory, so their
// vector reads are aligned where they are views into a flat buffer
// (training's).
constexpr int kLnBwdWarps = 8;
constexpr int kLnBwdThreads = 32 * kLnBwdWarps;
constexpr int kLnBwdMaxBlocks = 2 * 132;  // one wave at two blocks an SM
constexpr int kLnRowsMaxBlocks = 4 * 132; // LN's rows: one wave at four blocks an SM
constexpr int kLnBwdMinSteps = 2;         // least block steps of rows in a run
constexpr int kRowMaxLanes = 256;         // a row's group: at most the block's warps
constexpr int kRowMaxC = 8192;            // the widest row the plan takes

// The launch plan of one row call: columns per unit (8: whole 16-byte
// chunks of bf16; 1), lanes per row (a power of two), units per lane, rows
// per block (a multiple of the block's step, kLnBwdThreads / lanes rows) and
// blocks. The wrappers size the LN backward's scratch by it (row_kernels.cu
// ``vsn_ln_bwd_blocks``).
struct LnBwdPlan {
  int vec, lanes, shift, units;
  long long run;
  int blocks;
};

inline bool ln_bwd_plan(long long m, int c, LnBwdPlan* p,
                        int max_blocks = kLnBwdMaxBlocks) {
  if (m < 1 || c < 1 || c > kRowMaxC) return false;
  p->vec = c % 8 == 0 ? 8 : 1;
  const int chunks = c / p->vec;
  if (p->vec == 8) {
    p->lanes = 1;
    while (p->lanes < kRowMaxLanes && 3 * p->lanes < chunks) p->lanes <<= 1;
    p->units = (chunks + p->lanes - 1) / p->lanes;
  } else {
    p->lanes = 32;
    while (p->lanes < kRowMaxLanes && 8 * p->lanes < chunks) p->lanes <<= 1;
    const int units = (chunks + p->lanes - 1) / p->lanes;
    p->units = 1;
    while (p->units < units) p->units <<= 1;
  }
  p->shift = 0;
  while ((1 << p->shift) < p->lanes) ++p->shift;
  const long long step = kLnBwdThreads / p->lanes;
  long long run = (m + max_blocks - 1) / max_blocks;
  if (run < kLnBwdMinSteps * step) run = kLnBwdMinSteps * step;
  p->run = (run + step - 1) / step * step;
  p->blocks = (int)((m + p->run - 1) / p->run);
  return true;
}

// Calls f(VEC, K, WIDE), each an integral_constant, for the body's
// instantiation that takes ``plan``; cudaErrorInvalidValue for none.
template <typename F>
cudaError_t with_row_plan(const LnBwdPlan& plan, F&& f) {
  using std::integral_constant;
  using W = std::true_type;
  using N = std::false_type;
  using I1 = integral_constant<int, 1>;
  using I8 = integral_constant<int, 8>;
  const bool wide = plan.lanes > 32;
  if (plan.vec == 8 && !wide) {
    switch (plan.units) {
      case 1: return f(I8(), I1(), N());
      case 2: return f(I8(), integral_constant<int, 2>(), N());
      case 3: return f(I8(), integral_constant<int, 3>(), N());
    }
  } else if (plan.vec == 8) {
    switch (plan.units) {
      case 2: return f(I8(), integral_constant<int, 2>(), W());
      case 3: return f(I8(), integral_constant<int, 3>(), W());
      case 4: return f(I8(), integral_constant<int, 4>(), W());
    }
  } else if (!wide) {
    switch (plan.units) {
      case 1: return f(I1(), I1(), N());
      case 2: return f(I1(), integral_constant<int, 2>(), N());
      case 4: return f(I1(), integral_constant<int, 4>(), N());
      case 8: return f(I1(), I8(), N());
    }
  } else {
    switch (plan.units) {
      case 8: return f(I1(), I8(), W());
      case 16: return f(I1(), integral_constant<int, 16>(), W());
      case 32: return f(I1(), integral_constant<int, 32>(), W());
    }
  }
  return cudaErrorInvalidValue;
}

// One element of a row, for the one-column-a-lane form (Row8's interface).
template <typename TA>
struct Row1 {
  float f;
  __device__ __forceinline__ void load(const TA* src, int valid, bool) {
    f = valid > 0 ? to_f32(*src) : 0.f;
  }
  __device__ __forceinline__ float get(int) const { return f; }
};

template <typename TA, int VEC>
using RowV = typename std::conditional<VEC == 8, Row8<TA>, Row1<TA>>::type;

template <int VEC, typename TO>
__device__ __forceinline__ void store_row(TO* dst, const float (&v)[VEC]) {
  if constexpr (VEC == 8) {
    store8(dst, v, 8, true);
  } else {
    *dst = from_f32<TO>(v[0]);
  }
}

// Hopper's programmatic dependent launch: a grid launched by
// ``launch_ordered_sum`` may be scheduled while the grid before it on the
// stream still runs, once that grid's blocks have let it
// (``let_dependents_start``); ``wait_for_prior_grid`` then holds it until
// the earlier grid has finished and its writes are visible. Launched
// without the attribute, the wait returns at once.
__device__ __forceinline__ void wait_for_prior_grid() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

__device__ __forceinline__ void let_dependents_start() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

// The sum of ``v`` over this lane's row group of ``lanes`` lanes, the same
// value in every lane of the group. Within a warp (L <= 32) a butterfly of
// shuffles; a group of several warps (WIDE) adds the warps' sums in warp
// order through ``red`` [2][kLnBwdWarps] in shared memory, its two halves in
// turn, so one barrier a sum suffices: every thread of the block calls it
// alike.
template <bool WIDE>
struct RowSum {
  float (*red)[kLnBwdWarps];
  int turn;
  __device__ __forceinline__ float operator()(float v, int lanes) {
    if constexpr (!WIDE) {
      for (int o = 1; o < lanes; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      return v;
    } else {
      const int warp = threadIdx.x >> 5, gw = lanes >> 5, w0 = warp & ~(gw - 1);
      v = warp_sum(v);
      if ((threadIdx.x & 31) == 0) red[turn][warp] = v;
      __syncthreads();
      float s = red[turn][w0];
      for (int j = 1; j < gw; ++j) s += red[turn][w0 + j];
      turn ^= 1;
      return s;
    }
  }
};

// y = round_TY(LN(x)) and the row statistics (mean, 1/std) [M, 2], computed
// as the forward GEMM's LayerNorm prologue computes them (the mean, then the
// variance about it, two passes over the row's registers). Replaces _ln_fwd
// (vsn_tpu/ops/swin_block_kernels.py:75) as K1b and K2b recompute it.
//
// What bounds it: bytes (x read, y and 8 bytes of statistics a row
// written; ~6 f32 operations an element). The row plan above: each lane
// loads its units of x once by 16-byte vectors, y leaves by vector stores
// and the statistics as one float2 a row; LN's scale and shift are staged
// once a block in shared memory, under the block's first loads.
template <typename T, typename TY, int VEC, int K, bool WIDE>
__global__ void __launch_bounds__(kLnBwdThreads) ln_rows_kernel(
    const T* __restrict__ x, const float* __restrict__ w, const float* __restrict__ b,
    TY* __restrict__ y, float* __restrict__ stats, long long m, int c, LnBwdPlan plan) {
  extern __shared__ __align__(16) float ln_smem[];  // [C] w, then [C] b
  float* w_s = ln_smem;
  float* b_s = ln_smem + c;
  __shared__ float red[2][kLnBwdWarps];
  RowSum<WIDE> group_sum{red, 0};
  const int tid = threadIdx.x, lanes = plan.lanes;
  const int sub = (WIDE ? tid : tid & 31) & (lanes - 1);
  const int groups = kLnBwdThreads >> plan.shift, gid = tid >> plan.shift;
  const int chunks = c / VEC;
  const long long r0 = (long long)blockIdx.x * plan.run;
  const long long r1 = min(r0 + plan.run, m);
  for (long long base = r0; base < r1; base += groups) {
    const long long row = base + gid;
    const bool live = row < r1;
    RowV<T, VEC> xin[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int u = k * lanes + sub;
      xin[k].load(x + (live ? row : r0) * c + (long long)u * VEC,
                  live && u < chunks ? VEC : 0, true);
    }
    if (base == r0) {  // the block's first step: stage w and b under its loads
      for (int j = tid; j < c; j += kLnBwdThreads) {
        w_s[j] = w[j];
        b_s[j] = b[j];
      }
      __syncthreads();
    }
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int e = 0; e < VEC; ++e) s += xin[k].get(e);
    const float mu = group_sum(s, lanes) / c;
    float v = 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (k * lanes + sub < chunks)
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float t = xin[k].get(e) - mu;
          v += t * t;
        }
    const float rstd = 1.f / sqrtf(group_sum(v, lanes) / c + kLnEps);
    if (!live) continue;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int u = k * lanes + sub;
      if (u >= chunks) continue;
      RowV<float, VEC> wk, bk;
      wk.load(w_s + u * VEC, VEC, true);
      bk.load(b_s + u * VEC, VEC, true);
      float out[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) out[e] = (xin[k].get(e) - mu) * rstd * wk.get(e) + bk.get(e);
      store_row<VEC>(y + row * c + (long long)u * VEC, out);
    }
    if (sub == 0) *reinterpret_cast<float2*>(stats + 2 * row) = make_float2(mu, rstd);
  }
}

// x and y must be 16-byte aligned and stats 8-byte aligned; C <= kRowMaxC.
template <typename T, typename TY = T>
cudaError_t launch_ln_rows(const T* x, const float* w, const float* b, TY* y,
                           float* stats, long long m, int k, cudaStream_t stream) {
  LnBwdPlan plan;
  const uintptr_t rows = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y);
  if (!ln_bwd_plan(m, k, &plan, kLnRowsMaxBlocks) || rows % 16 ||
      reinterpret_cast<uintptr_t>(stats) % 8)
    return cudaErrorInvalidValue;
  return with_row_plan(plan, [&](auto vec, auto units, auto wide) {
    auto kernel = ln_rows_kernel<T, TY, decltype(vec)::value, decltype(units)::value,
                                 decltype(wide)::value>;
    const size_t bytes = 2 * sizeof(float) * k;  // w and b
    cudaError_t err = bytes > 48 * 1024 ? cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes) : cudaSuccess;
    if (err != cudaSuccess) return err;
    kernel<<<plan.blocks, kLnBwdThreads, bytes, stream>>>(x, w, b, y, stats, m, k, plan);
    return cudaGetLastError();
  });
}

// LayerNorm backward rows, the last launches of K1b and K2b
// (swin_block_kernels.py _ln_bwd :85 at its four call sites: the pre-norm dx
// line of K1b :440-444 and K2b :971, the post-norm branch backward of K1b
// :397 and K2b :926). One body, two modes:
//
//   pre-norm (POST false), on the block input x [M, C] with LN's row
//   statistics [M, 2] (ln_rows_kernel) and dy [M, C] f32 (the EPI_F32 GEMM):
//     xhat = (x - mu) * rstd, d = dy, dxhat = d * w
//     dx   = T(lam * do_res + rstd * (dxhat - mean(dxhat) - xhat * mean(dxhat * xhat)))
//     dw   = sum_rows d * xhat,  db = sum_rows d
//   post-norm (POST true), on the recomputed f32 branch [M, C], which it
//   overwrites with dbranch (its statistics in f32, two passes, as the
//   forward GEMM's prologue):
//     xhat = (branch - mu) * rstd, d = gb[row / rps] * do_res
//     dgamma = sum_rows d * (xhat * w + b), then d *= gamma   (gamma not null)
//     dbranch = rstd * (d w - mean(d w) - xhat * mean(d w xhat))
//     dw = sum_rows d * xhat,  db = sum_rows d
//
// What bounds it: bytes. Each element is read and written once: 10 bytes
// pre-norm under bf16 (x, do_res and dx bf16, dy f32), 10 post-norm (the
// f32 branch read and written, do_res); the arithmetic is ~10 f32 operations
// an element. The design:
//
//   - The row plan above (``ln_bwd_plan``): x / branch, dy and do_res are
//     read once into registers, the row sums (mean, variance, then
//     mean(dxhat) and mean(dxhat xhat)) are taken there, and dx / dbranch
//     leave by vector stores. LN's scale (post-norm: gamma * w) is staged
//     once a block in shared memory.
//   - No atomics: each lane keeps the partial sums A = sum d xhat and B =
//     sum d of its columns in registers over the rows its group walks (the
//     post-norm's d before gamma; dgamma = w A + b B and dw, db = gamma A,
//     gamma B are formed from them once, at the end). A block adds its
//     groups' partials in a fixed order (shuffles over the groups of a
//     warp, then a tree over the warps that hold the same columns through
//     shared memory) into its row of a [blocks, 2C] f32 scratch.
//   - A deterministic cross-block sum: the grid and each block's run of
//     rows are a plan of (M, C) alone (at most 2 x 132 blocks, runs of
//     whole block steps), and ``ordered_sum_kernel`` adds the blocks'
//     partials in block order (a programmatic dependent launch). Two
//     launches on the same inputs give the same bits in dx, dw, db and
//     dgamma; the outputs are written, not added into.
//
// Two launches a call: the rows, then the sum (``launch_ln_bwd_rows``).
template <typename T>
struct LnBwdParams {
  const T* x;              // pre-norm: the block input [M, C]
  const float* stats;      // pre-norm: LN's (mean, 1/std) [M, 2]
  const float* dy;         // pre-norm: LN's output cotangent [M, C] f32
  float* branch;           // post-norm: the f32 branch, overwritten by dbranch
  const float* gb;         // post-norm: per-sample gains [M / rps]
  long long rps;           // post-norm: rows per sample
  const T* do_res;         // the residual cotangent [M, C]
  const float* w;          // LN's scale [C]
  const float* gamma;      // post-norm LayerScale [C] or null
  float lam;               // pre-norm residual x-gain
  T* dx;                   // pre-norm: [M, C]
  float* part;             // [blocks, 2C]: sum d xhat, sum d of each block
  long long m;
  int c;
  LnBwdPlan plan;
};

// The body's dynamic shared memory, in floats: LN's scale [C], then the
// slots of the warps' partials on their way to the first warps: 2C for each
// group among warps [0, kLnBwdWarps / 2) (none where one group spans all
// the block's warps).
inline int ln_bwd_smem_floats(const LnBwdPlan& plan, int c) {
  const int gw = plan.lanes > 32 ? plan.lanes >> 5 : 1;  // warps a group spans
  return c + (gw <= kLnBwdWarps / 2 ? 2 * c * (kLnBwdWarps / 2 / gw) : 0);
}

template <typename T, bool POST, int VEC, int K, bool WIDE>
__global__ void __launch_bounds__(kLnBwdThreads) ln_bwd_rows_kernel(LnBwdParams<T> p) {
  // [C] LN's scale (post-norm: gamma * w), staged once: 16-byte aligned
  // whatever the parameters' own addresses; then the warps' partials on
  // their way to the first warps (``ln_bwd_smem_floats``)
  extern __shared__ __align__(16) float ln_smem[];
  float* w_s = ln_smem;
  float* slots = ln_smem + p.c;
  __shared__ float red[2][kLnBwdWarps];
  RowSum<WIDE> group_sum{red, 0};
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int lanes = p.plan.lanes, sub = (WIDE ? tid : lane) & (lanes - 1);
  const int groups = kLnBwdThreads >> p.plan.shift;
  const int gw = WIDE ? lanes >> 5 : 1;  // warps a group spans
  const int gid = tid >> p.plan.shift;
  const int chunks = p.c / VEC;
  const long long r0 = (long long)blockIdx.x * p.plan.run;
  const long long r1 = min(r0 + p.plan.run, p.m);
  float acc_a[K][VEC], acc_b[K][VEC];
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc_a[k][e] = acc_b[k][e] = 0.f;

  for (long long base = r0; base < r1; base += groups) {
    const long long row = base + gid;
    const bool live = row < r1;
    const long long r = live ? row : r0;  // a row to address; nothing is loaded for it
    RowV<T, VEC> res[K];                  // do_res
    RowV<float, VEC> d32[K];              // dy (pre-norm), the branch (post-norm)
    RowV<T, VEC> xin[K];                  // x (pre-norm)
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int u = k * lanes + sub;
      const int valid = live && u < chunks ? VEC : 0;
      const long long off = r * p.c + (long long)u * VEC;
      res[k].load(p.do_res + off, valid, true);
      if constexpr (POST) {
        d32[k].load(p.branch + off, valid, true);
      } else {
        xin[k].load(p.x + off, valid, true);
        d32[k].load(p.dy + off, valid, true);
      }
    }
    if (base == r0) {  // the block's first step: stage LN's scale under its loads
      for (int j = tid; j < p.c; j += kLnBwdThreads)
        w_s[j] = POST && p.gamma ? p.gamma[j] * p.w[j] : p.w[j];
      __syncthreads();
    }
    // xhat of each column (post-norm: kept in place of the branch), and d:
    // dy (pre-norm), g * do_res (post-norm)
    float xh[POST ? K : 1][POST ? VEC : 1], mu, rstd, g = 1.f;
    if constexpr (POST) {
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < K; ++k)
#pragma unroll
        for (int e = 0; e < VEC; ++e) s += d32[k].get(e);
      mu = group_sum(s, lanes) / p.c;
      float v = 0.f;
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (k * lanes + sub < chunks)
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            const float t = d32[k].get(e) - mu;
            v += t * t;
          }
      rstd = 1.f / sqrtf(group_sum(v, lanes) / p.c + kLnEps);
      if (live) g = p.gb[(unsigned)row / (unsigned)p.rps];  // M < 2^31 (the launch)
    } else {
      const float2 st = live ? *reinterpret_cast<const float2*>(p.stats + 2 * r)
                             : make_float2(0.f, 0.f);
      mu = st.x;
      rstd = st.y;
    }
    if constexpr (POST) {
#pragma unroll
      for (int k = 0; k < K; ++k)
#pragma unroll
        for (int e = 0; e < VEC; ++e) xh[k][e] = (d32[k].get(e) - mu) * rstd;
    }
    auto xhat_of = [&](int k, int e) {
      if constexpr (POST) {
        return xh[k][e];
      } else {
        return (xin[k].get(e) - mu) * rstd;
      }
    };
    auto d_of = [&](int k, int e) { return POST ? g * res[k].get(e) : d32[k].get(e); };
    // dxhat = d * w (d * gamma * w post-norm) and its two row means
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int u = k * lanes + sub;
      RowV<float, VEC> wk;
      wk.load(w_s + u * VEC, u < chunks ? VEC : 0, true);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        // a row past the run adds 0: its d is 0 and its xhat finite
        const float d = d_of(k, e), xhat = xhat_of(k, e);
        acc_a[k][e] += d * xhat;
        acc_b[k][e] += d;
        const float dxhat = d * wk.get(e);
        s1 += dxhat;
        s2 += dxhat * xhat;
      }
    }
    const float m1 = group_sum(s1, lanes) / p.c, m2 = group_sum(s2, lanes) / p.c;
    if (!live) continue;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int u = k * lanes + sub;
      if (u >= chunks) continue;
      RowV<float, VEC> wk;
      wk.load(w_s + u * VEC, VEC, true);
      float out[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float v = rstd * (d_of(k, e) * wk.get(e) - m1 - xhat_of(k, e) * m2);
        out[e] = POST ? v : p.lam * res[k].get(e) + v;
      }
      const long long off = row * p.c + (long long)u * VEC;
      if constexpr (POST) {
        store_row<VEC>(p.branch + off, out);
      } else {
        store_row<VEC>(p.dx + off, out);
      }
    }
  }
  let_dependents_start();  // the ordered sum may be scheduled

  // The block's partials: the groups of a warp hold the same columns
  // (butterfly over them); then a fixed tree over the warps that hold the
  // same columns, warps [h, 2h) handing theirs to warps [0, h) through
  // shared memory, h = 4, 2, 1 down to the warps a group spans; the first
  // group's warps write the block's row of the scratch.
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      for (int o = lanes; o < 32; o <<= 1) {
        acc_a[k][e] += __shfl_xor_sync(0xffffffffu, acc_a[k][e], o);
        acc_b[k][e] += __shfl_xor_sync(0xffffffffu, acc_b[k][e], o);
      }
  for (int h = kLnBwdWarps / 2; h >= gw; h >>= 1) {
    const bool gives = warp >= h && warp < 2 * h, takes = warp < h;
    float* slot = slots + 2 * p.c * ((gives ? warp - h : warp) / gw);
    if ((gives || takes) && lane < lanes) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int u = k * lanes + sub;
        if (u >= chunks) continue;
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const int col = u * VEC + e;
          if (gives) {
            slot[col] = acc_a[k][e];
            slot[p.c + col] = acc_b[k][e];
          }
        }
      }
    }
    __syncthreads();
    if (takes && lane < lanes) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int u = k * lanes + sub;
        if (u >= chunks) continue;
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const int col = u * VEC + e;
          acc_a[k][e] += slot[col];
          acc_b[k][e] += slot[p.c + col];
        }
      }
    }
    __syncthreads();
  }
  if (warp < gw && lane < lanes) {
    float* part = p.part + (long long)blockIdx.x * 2 * p.c;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int u = k * lanes + sub;
      if (u >= chunks) continue;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        part[u * VEC + e] = acc_a[k][e];
        part[p.c + u * VEC + e] = acc_b[k][e];
      }
    }
  }
}

// The blocks' partials [blocks, C] (``pairs``: [blocks, 2C], the LN
// backward's A and B side by side) summed in block order, 32 columns a block
// of 32 slices: slice s takes the blocks s, s + 32, ... (their loads all in
// flight), and the slices' sums are added in slice order. Then dw = A (the
// column sums' out), db = B, or with a post-norm gamma dgamma = w A + b B,
// dw = gamma A, db = gamma B.
constexpr int kLnSumSlices = 32;

__global__ void __launch_bounds__(32 * kLnSumSlices) ordered_sum_kernel(
    const float* __restrict__ part, int blocks, int c, int pairs,
    const float* __restrict__ w, const float* __restrict__ b,
    const float* __restrict__ gamma, float* __restrict__ dw, float* __restrict__ db,
    float* __restrict__ dgamma) {
  __shared__ float red[kLnSumSlices][2][33];
  const int lane = threadIdx.x & 31, slice = threadIdx.x >> 5;
  const int col = blockIdx.x * 32 + lane;
  const long long ld = pairs ? 2LL * c : c;
  float a = 0.f, s = 0.f;
  wait_for_prior_grid();  // the partials of the grid before
  if (col < c) {
#pragma unroll 8
    for (int g = slice; g < blocks; g += kLnSumSlices) {
      a += part[g * ld + col];
      if (pairs) s += part[g * ld + c + col];
    }
  }
  red[slice][0][lane] = a;
  red[slice][1][lane] = s;
  __syncthreads();
  if (slice || col >= c) return;
  for (int i = 1; i < kLnSumSlices; ++i) {
    a += red[i][0][lane];
    s += red[i][1][lane];
  }
  if (gamma) {
    dgamma[col] = w[col] * a + b[col] * s;
    dw[col] = gamma[col] * a;
    db[col] = gamma[col] * s;
  } else {
    dw[col] = a;
    if (pairs) db[col] = s;
  }
}

// ``ordered_sum_kernel`` after the rows' grid on ``stream``, as a
// programmatic dependent launch.
inline cudaError_t launch_ordered_sum(const float* part, int blocks, int c, int pairs,
                                      const float* w, const float* b, const float* gamma,
                                      float* dw, float* db, float* dgamma,
                                      cudaStream_t stream) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((c + 31) / 32);
  cfg.blockDim = dim3(32 * kLnSumSlices);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, ordered_sum_kernel, part, blocks, c, pairs, w, b, gamma, dw,
                            db, dgamma);
}

template <typename T, bool POST, int VEC, int K, bool WIDE>
cudaError_t launch_ln_bwd_body(const LnBwdParams<T>& p, cudaStream_t stream) {
  ln_bwd_rows_kernel<T, POST, VEC, K, WIDE>
      <<<p.plan.blocks, kLnBwdThreads, sizeof(float) * ln_bwd_smem_floats(p.plan, p.c),
         stream>>>(p);
  return cudaGetLastError();
}

// The two launches of one call. ``part_floats``, the scratch's size, must
// hold the plan's [blocks, 2C]; the rows' pointers must be 16-byte aligned
// (the wrappers copy a row operand that is not).
template <typename T, bool POST>
cudaError_t launch_ln_bwd_rows(LnBwdParams<T> p, long long part_floats, const float* b,
                               float* dw, float* db, float* dgamma, cudaStream_t stream) {
  const uintptr_t rows = reinterpret_cast<uintptr_t>(p.do_res) |
                         reinterpret_cast<uintptr_t>(p.branch) |
                         reinterpret_cast<uintptr_t>(p.x) | reinterpret_cast<uintptr_t>(p.dy) |
                         reinterpret_cast<uintptr_t>(p.dx);
  if (!ln_bwd_plan(p.m, p.c, &p.plan) || 2LL * p.c * p.plan.blocks > part_floats ||
      rows % 16 || p.m >= (1LL << 31) || p.rps < 1 || p.rps >= (1LL << 31))
    return cudaErrorInvalidValue;
  cudaError_t err = with_row_plan(p.plan, [&](auto vec, auto units, auto wide) {
    return launch_ln_bwd_body<T, POST, decltype(vec)::value, decltype(units)::value,
                              decltype(wide)::value>(p, stream);
  });
  if (err != cudaSuccess) return err;
  return launch_ordered_sum(p.part, p.plan.blocks, p.c, 1, p.w, b, POST ? p.gamma : nullptr,
                            dw, db, dgamma, stream);
}

// Pre-norm: dx = T(lam * do_res + LN_bwd(dy)) and LN's dw, db (written).
// part is f32 scratch of part_floats >= 2C x the plan's blocks
// (``ln_bwd_plan``).
template <typename T>
cudaError_t launch_ln_bwd(const T* x, const float* stats, const float* w, const float* dy,
                          const T* do_res, float lam, T* dx, float* dw, float* db,
                          float* part, long long part_floats, long long m, int k,
                          cudaStream_t stream) {
  LnBwdParams<T> p = {};
  p.x = x;
  p.stats = stats;
  p.dy = dy;
  p.do_res = do_res;
  p.w = w;
  p.lam = lam;
  p.dx = dx;
  p.part = part;
  p.m = m;
  p.c = k;
  p.rps = 1;
  return launch_ln_bwd_rows<T, false>(p, part_floats, nullptr, dw, db, nullptr, stream);
}

// Column sums out[n] = sum_m g_m * A[m, n], with g_m = a_gain[m / rps] or 1:
// the bias gradients (K1b's dbproj and K2b's dfc2_b over the gated do_res
// or, post-norm, the f32 dbranch; K2b's dfc1_b over the f32 dh1). Replaces
// the bias-gradient sums of _attn_bwd_kernel and _mlp_bwd_kernel
// (vsn_tpu/ops/swin_block_kernels.py:401, :408-418, :933-950, :963).
//
// What bounds it: bytes (A read once; 2 f32 operations an element). The
// design, the LN backward's without its row sums:
//
//   - A lane group of L <= 32 lanes owns whole units of a row (8 columns
//     read by one 16-byte vector, two for f32; one column a lane where N is
//     not a multiple of 8), K <= 3 units a lane (K <= 8 single columns); a
//     warp walks 32 / L rows at once, and a group loads kColsumRows rows
//     before it adds them, so each thread keeps 96-192 bytes in flight.
//     Columns wider than one group's registers are split over the grid's
//     second dimension, column groups of at most 96 units (a column sum has
//     no row-wide term, so the split costs nothing): hidden = 3072 f32 is 4
//     groups of 96.
//   - Every block takes the same number of rows, and the grid is one wave
//     of two blocks an SM (f32 rows at K = 3 need ~80 registers; a bound of
//     four blocks spilled them, in throwaway builds on the card).
//   - The gain is one load a row a lane group, its sample tracked by the
//     next sample's first row (one division a thread, none a row).
//   - No atomics: each lane keeps f32 partials of its columns in registers
//     over the block's run of rows; the block adds its groups' partials in a
//     fixed order (shuffles, then a tree over its warps through shared
//     memory) into its row of a [blocks, N] f32 scratch, and
//     ``ordered_sum_kernel`` adds the blocks' rows in block order, launched
//     as a programmatic dependent launch (its blocks are scheduled while the
//     rows' grid drains). The plan is a function of (M, N) alone
//     (``colsum_plan``), so two launches on the same inputs give the same
//     bits; out is written, not added into.
constexpr int kColsumUnits = 3;           // units (8 columns) a lane at most
constexpr int kColsumGroupUnits = 32 * kColsumUnits;  // units a column group at most
constexpr int kColsumRows = 2;            // rows a lane group loads at once
constexpr int kColsumBlocksPerSm = 2;     // the body's launch bound
constexpr int kColsumMaxBlocks = kColsumBlocksPerSm * 132;  // row x column blocks: one wave
constexpr int kColsumMinSteps = 2;        // least block steps of rows in a run

// vec, lanes, shift, units (a lane), cols (column groups), per (units a
// column group), run (rows a block, a multiple of the block's step
// kLnBwdThreads / lanes) and blocks (row blocks; the scratch is [blocks, N]).
struct ColsumPlan {
  int vec, lanes, shift, units, cols, per;
  long long run;
  int blocks;
};

inline bool colsum_plan(long long m, int n, ColsumPlan* p) {
  if (m < 1 || n < 1) return false;
  p->vec = n % 8 == 0 ? 8 : 1;
  const int chunks = n / p->vec;
  const int most = p->vec == 8 ? kColsumGroupUnits : 32 * 8;
  p->cols = (chunks + most - 1) / most;
  p->per = (chunks + p->cols - 1) / p->cols;
  if (p->vec == 8) {
    p->lanes = 1;
    while (p->lanes < 32 && kColsumUnits * p->lanes < p->per) p->lanes <<= 1;
    p->units = (p->per + p->lanes - 1) / p->lanes;
  } else {
    p->lanes = 32;
    const int units = (p->per + 31) / 32;
    p->units = 1;
    while (p->units < units) p->units <<= 1;
  }
  p->shift = 0;
  while ((1 << p->shift) < p->lanes) ++p->shift;
  // the same rows in every block, a wave of blocks (the last rows ragged)
  const long long step = kColsumRows * (kLnBwdThreads / p->lanes);
  const long long row_blocks = p->cols < kColsumMaxBlocks ? kColsumMaxBlocks / p->cols : 1;
  p->run = (m + row_blocks - 1) / row_blocks;
  if (p->run < kColsumMinSteps * step) p->run = kColsumMinSteps * step;
  p->blocks = (int)((m + p->run - 1) / p->run);
  return true;
}

template <typename TA>
struct ColsumParams {
  const TA* a;             // [M, N]
  const float* a_gain;     // [ceil(M / rps)] or null
  long long rps;
  float* part;             // [blocks, N]
  long long m;
  int n;
  ColsumPlan plan;
};

template <typename TA, int VEC, int K>
__global__ void __launch_bounds__(kLnBwdThreads, kColsumBlocksPerSm)
    colsum_kernel(ColsumParams<TA> p) {
  // the warps' partials of the column group on their way to warp 0
  __shared__ __align__(16) float slots[kLnBwdWarps / 2][kColsumGroupUnits * 8];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int lanes = p.plan.lanes, sub = lane & (lanes - 1);
  const int groups = kLnBwdThreads >> p.plan.shift, gid = tid >> p.plan.shift;
  const int u0 = blockIdx.y * p.plan.per;  // the column group's first unit
  const int units = min(p.plan.per, p.n / VEC - u0);
  const long long r0 = (long long)blockIdx.x * p.plan.run;
  const long long r1 = min(r0 + p.plan.run, p.m);
  float acc[K][VEC];
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[k][e] = 0.f;
  long long row = r0 + gid;
  // the gain of this group's latest row, and the first row of the next
  // sample: the group's rows only grow
  long long sample = p.a_gain ? row / p.rps : 0, next = (sample + 1) * p.rps;
  float gain = p.a_gain && row < r1 ? p.a_gain[sample] : 1.f;
  auto gain_of = [&](long long r) {
    if (p.a_gain && r >= next) {
      do {
        ++sample;
        next += p.rps;
      } while (r >= next);
      gain = p.a_gain[sample];
    }
    return gain;
  };
  const TA* src = p.a + (long long)u0 * VEC + sub * VEC;
  for (; row < r1; row += kColsumRows * groups) {  // the group's next rows, in order
    RowV<TA, VEC> v[kColsumRows][K];
#pragma unroll
    for (int j = 0; j < kColsumRows; ++j)
#pragma unroll
      for (int k = 0; k < K; ++k)
        v[j][k].load(src + (row + j * groups) * p.n + (long long)k * lanes * VEC,
                     row + j * groups < r1 && k * lanes + sub < units ? VEC : 0, true);
#pragma unroll
    for (int j = 0; j < kColsumRows; ++j) {
      const float g = row + j * groups < r1 ? gain_of(row + j * groups) : 0.f;
#pragma unroll
      for (int k = 0; k < K; ++k)
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[k][e] = fmaf(g, v[j][k].get(e), acc[k][e]);
    }
  }
  let_dependents_start();  // the ordered sum may be scheduled

  // The block's partials, in the LN backward's fixed order: butterfly over
  // the groups of a warp, then warps [h, 2h) hand theirs to warps [0, h), h
  // = 4, 2, 1; warp 0 writes the column group's part of the block's row.
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      for (int o = lanes; o < 32; o <<= 1)
        acc[k][e] += __shfl_xor_sync(0xffffffffu, acc[k][e], o);
  for (int h = kLnBwdWarps / 2; h >= 1; h >>= 1) {
    const bool gives = warp >= h && warp < 2 * h, takes = warp < h;
    float* slot = slots[gives ? warp - h : warp];
    if (gives && lane < lanes) {
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (k * lanes + sub < units)
#pragma unroll
          for (int e = 0; e < VEC; ++e) slot[(k * lanes + sub) * VEC + e] = acc[k][e];
    }
    __syncthreads();
    if (takes && lane < lanes) {
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (k * lanes + sub < units)
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[k][e] += slot[(k * lanes + sub) * VEC + e];
    }
    __syncthreads();
  }
  if (warp == 0 && lane < lanes) {
    float* part = p.part + (long long)blockIdx.x * p.n + (long long)u0 * VEC;
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (k * lanes + sub < units)
#pragma unroll
        for (int e = 0; e < VEC; ++e) part[(k * lanes + sub) * VEC + e] = acc[k][e];
  }
}

// Calls f(VEC, K), each an integral_constant, for the column-sum body that
// takes ``plan``; cudaErrorInvalidValue for none.
template <typename F>
cudaError_t with_colsum_plan(const ColsumPlan& plan, F&& f) {
  using std::integral_constant;
  if (plan.vec == 8) {
    switch (plan.units) {
      case 1: return f(integral_constant<int, 8>(), integral_constant<int, 1>());
      case 2: return f(integral_constant<int, 8>(), integral_constant<int, 2>());
      case 3: return f(integral_constant<int, 8>(), integral_constant<int, 3>());
    }
  } else {
    switch (plan.units) {
      case 1: return f(integral_constant<int, 1>(), integral_constant<int, 1>());
      case 2: return f(integral_constant<int, 1>(), integral_constant<int, 2>());
      case 4: return f(integral_constant<int, 1>(), integral_constant<int, 4>());
      case 8: return f(integral_constant<int, 1>(), integral_constant<int, 8>());
    }
  }
  return cudaErrorInvalidValue;
}

// out [n] = sum_m g_m a[m, n] (written): the rows, then the block-ordered
// sum. part is f32 scratch of part_floats >= the plan's blocks x n; a must
// be 16-byte aligned (the wrappers copy one that is not).
template <typename TA>
cudaError_t launch_colsum(const TA* a, const float* a_gain, long long rps, float* out,
                          float* part, long long part_floats, long long m, int n,
                          cudaStream_t stream) {
  ColsumParams<TA> p = {a, a_gain, rps, part, m, n, {}};
  if (!colsum_plan(m, n, &p.plan) || (long long)p.plan.blocks * n > part_floats ||
      reinterpret_cast<uintptr_t>(a) % 16 || rps < 1 || p.plan.cols > 65535)
    return cudaErrorInvalidValue;
  const ColsumPlan plan = p.plan;
  cudaError_t err = with_colsum_plan(plan, [&](auto vec, auto units) {
    colsum_kernel<TA, decltype(vec)::value, decltype(units)::value>
        <<<dim3(plan.blocks, plan.cols), kLnBwdThreads, 0, stream>>>(p);
    return cudaGetLastError();
  });
  if (err != cudaSuccess) return err;
  return launch_ordered_sum(part, plan.blocks, n, 0, nullptr, nullptr, nullptr, out, nullptr,
                            nullptr, stream);
}

// Weight gradient of a Linear layer, a product that contracts over the token
// rows (435k of them at Swin-T stage 1, micro-batch 8):
//
//   out[N1, N2] += sum_m round_T(g_m * A[m, n1]) * round_T(B[m, n2])
//
// with g_m = a_gain[m / rps] or 1. Split-K: blockIdx.z takes one slice of
// the rows, accumulates one output tile, and adds it into the zeroed f32
// output with atomicAdd once.
//
// Replaces the weight-gradient dot_generals of the TPU backward kernels
// (swin_block_kernels.py _attn_bwd_kernel, _mlp_bwd_kernel :917-966), which
// add into output blocks carried across a sequential grid. Two bodies,
// chosen by T in ``launch_wgrad``:
//
//   - bf16: ``wgrad_mma_kernel``, 128 x 128 output tiles of 4 warps on
//     mma.sync.m16n8k16. What bounds it: the products (2 N1 N2 per row;
//     ViT's dW1 is 23 GFLOP per micro-batch of 24), and at Swin stage 1 the
//     bytes of the two [rows, .] operands. Both operands are read k-major
//     (rows are the depth): cp.async copies 32-row k-tiles of A (as TA)
//     and B (bf16, rows padded for ldmatrix, read by the products as they
//     land) kStages - 1 ahead; each thread turns its chunks of raw A into
//     round(g A) bf16 operand tiles one k-tile ahead (a copy for a bf16 A
//     without gain); the fragments come from ldmatrix.trans (``load_a_t``
//     for A^T, ``load_b_nn`` for B). Each split covers at least
//     kWgradMmaRows rows, so that its one atomicAdd per output (16,384 per
//     tile) stays small beside its products.
//   - f32: ``wgrad_kernel``, 64 x 64 tiles, 4 x 4 FMA outputs per thread.
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

// The FMA body's launch: every f32 weight gradient; on bf16 operands only
// where chip_smoke.py times it beside the tensor-core body (csrc/gemm.cu).
template <typename T, typename TA>
cudaError_t launch_wgrad_fma(WgradParams<T, TA> p, cudaStream_t stream) {
  const unsigned gx = (unsigned)((p.n1 + kBM - 1) / kBM);
  const unsigned gy = (unsigned)((p.n2 + kBN - 1) / kBN);
  p.rows = rows_per_split(p.m, (long long)gx * gy, 256);
  const dim3 grid(gx, gy, (unsigned)((p.m + p.rows - 1) / p.rows));
  wgrad_kernel<T, TA><<<grid, kGemmThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

constexpr int kWgradMmaRows = 2048;  // least rows of a split of the tensor-core body

// Shared memory of the tensor-core weight-gradient body: kStages raw
// 32-row k-tiles of A (as TA, [32][128]) and B (bf16 [32][136], which the
// products read as it lands), and two bf16 operand tiles of round(g A).
template <typename TA>
struct WgradSmem {
  static constexpr int kStages = sizeof(TA) == 2 ? 4 : 3;
  static constexpr int kRawA = kMmaBK * kMmaBM * (int)sizeof(TA);
  static constexpr int kRawB = kMmaBK * kMmaLdN * 2;
  static constexpr int kOpA = kMmaBK * kMmaLdN * 2;
  static constexpr int kBytes = kStages * (kRawA + kRawB) + 2 * kOpA;
};

template <typename T, typename TA>
__global__ void __launch_bounds__(kMmaThreads, kMmaMinBlocks)
    wgrad_mma_kernel(WgradParams<T, TA> p) {
  using B = __nv_bfloat16;
  using S = WgradSmem<TA>;
  constexpr int kStages = S::kStages;
  extern __shared__ __align__(16) unsigned char wgrad_smem[];
  auto raw_a = [&](int s) { return reinterpret_cast<TA*>(wgrad_smem + s * (S::kRawA + S::kRawB)); };
  auto raw_b = [&](int s) {
    return reinterpret_cast<B*>(wgrad_smem + s * (S::kRawA + S::kRawB) + S::kRawA);
  };
  auto op_a = [&](int b) {
    return reinterpret_cast<B*>(wgrad_smem + kStages * (S::kRawA + S::kRawB) + b * S::kOpA);
  };
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int i0 = blockIdx.x * kMmaBM, j0 = blockIdx.y * kMmaBN;
  const long long r0 = (long long)blockIdx.z * p.rows;
  const long long r1 = min(r0 + p.rows, p.m);
  constexpr int kPerA = 16 / (int)sizeof(TA);
  const bool a_vec = aligned16(p.a) && p.n1 % kPerA == 0;
  const bool b_vec = aligned16(p.b) && p.n2 % 8 == 0;
  const int nk = (int)((r1 - r0 + kMmaBK - 1) / kMmaBK);
  const bool small = p.m < (1LL << 31) && p.rows_per_sample < (1LL << 31);

  auto fetch = [&](int t) {  // raw k-tile t into stage t % kStages, one commit group
    if (t < nk) {
      const long long k0 = r0 + (long long)t * kMmaBK;
      const int s = t % kStages;
      stage_raw<kMmaBK, kMmaBM>(raw_a(s), kMmaBM, p.a, p.n1, k0, r1, i0, p.n1, a_vec);
      stage_raw<kMmaBK, kMmaBN>(raw_b(s), kMmaLdN, p.b, p.n2, k0, r1, j0, p.n2, b_vec);
    }
    cp_async_commit();
  };
  // raw A of k-tile t -> round(g A) in operand tile b (rows past r1 are zero
  // in the raw tile)
  auto transform = [&](int t, int b) {
    const long long k0 = r0 + (long long)t * kMmaBK;
    const TA* ra = raw_a(t % kStages);
    B* oa = op_a(b);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int r = (tid >> 4) + 8 * q, c = (tid & 15) * 8;
      const long long row = k0 + r;
      Row8<TA> x8;
      x8.load(ra + r * kMmaBM + c, 8, true);
      uint4* dst = reinterpret_cast<uint4*>(oa + r * kMmaLdN + c);
      if constexpr (std::is_same<TA, B>::value) {
        if (!p.a_gain) {  // a copy
          *dst = make_uint4(x8.w[0], x8.w[1], x8.w[2], x8.w[3]);
          continue;
        }
      }
      float g = 1.f;
      if (p.a_gain && row < r1)
        g = p.a_gain[small ? (long long)((unsigned)row / (unsigned)p.rows_per_sample)
                           : row / p.rows_per_sample];
      float v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = g * x8.get(e);
      *dst = pack8(v);
    }
  };

  for (int t = 0; t < kStages - 1; ++t) fetch(t);
  const int wi = warp >> 1, wj = warp & 1;  // 2 x 2 warps of 64 x 64 outputs
  float acc[4][8][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  cp_async_wait<kStages - 2>();  // raw tile 0
  __syncthreads();
  transform(0, 0);
  for (int t = 0; t < nk; ++t) {
    // raw tile t + 1 landed; operand tile t written; every warp done with
    // the products of t - 1 (raw B of its stage) and the transform of t
    cp_async_wait<kStages - 3>();
    __syncthreads();
    fetch(t + kStages - 1);  // into the stage of tile t - 1
    if (t + 1 < nk) transform(t + 1, (t + 1) & 1);
    const B* at = op_a(t & 1);
    const B* bt = raw_b(t % kStages);
#pragma unroll
    for (int ks = 0; ks < kMmaBK; ks += 16) {
      uint32_t a[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) load_a_t<kMmaLdN>(a[i], at, ks, wi * 64 + i * 16, lane);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t b[4];
        load_b_nn<kMmaLdN>(b, bt, ks, wj * 64 + j * 16, lane);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          mma_bf16(acc[i][2 * j], a[i], b[0], b[1]);
          mma_bf16(acc[i][2 * j + 1], a[i], b[2], b[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  const int gq = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int oi = i0 + wi * 64 + i * 16 + gq + 8 * hh;
      if (oi >= p.n1) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int oj = j0 + wj * 64 + j * 8 + 2 * t4 + e;
          if (oj < p.n2) atomicAdd(&p.out[(long long)oi * p.n2 + oj], acc[i][j][2 * hh + e]);
        }
    }
}

// The weight-gradient launch: the tensor-core body for bf16 operands, the
// FMA body for f32.
template <typename T, typename TA>
cudaError_t launch_wgrad(WgradParams<T, TA> p, cudaStream_t stream) {
  if constexpr (kTensorCores<T>) {
    const unsigned gx = (unsigned)((p.n1 + kMmaBM - 1) / kMmaBM);
    const unsigned gy = (unsigned)((p.n2 + kMmaBN - 1) / kMmaBN);
    p.rows = rows_per_split(p.m, (long long)gx * gy, kWgradMmaRows);
    auto kernel = wgrad_mma_kernel<T, TA>;
    constexpr int kBytes = WgradSmem<TA>::kBytes;
    cudaError_t err = set_smem(kernel, kBytes);
    if (err != cudaSuccess) return err;
    const dim3 grid(gx, gy, (unsigned)((p.m + p.rows - 1) / p.rows));
    kernel<<<grid, kMmaThreads, kBytes, stream>>>(p);
    return cudaGetLastError();
  } else {
    return launch_wgrad_fma(p, stream);
  }
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

// Post-norm backward (the LN-backward body's post-norm mode, above): the
// recomputed f32 branch [M, C] is overwritten with dbranch; LN's dw, db and,
// with gamma, dgamma are written. part is f32 scratch of part_floats >= 2C x
// the plan's blocks.
template <typename T>
cudaError_t launch_postnorm_bwd(float* branch, const T* do_res, const float* gb, long long rps,
                                const float* w, const float* b, const float* gamma, float* dw,
                                float* db, float* dgamma, float* part, long long part_floats,
                                long long m, int k, cudaStream_t stream) {
  LnBwdParams<T> p = {};
  p.branch = branch;
  p.gb = gb;
  p.rps = rps;
  p.do_res = do_res;
  p.w = w;
  p.gamma = gamma;
  p.part = part;
  p.m = m;
  p.c = k;
  return launch_ln_bwd_rows<T, true>(p, part_floats, b, dw, db, dgamma, stream);
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
