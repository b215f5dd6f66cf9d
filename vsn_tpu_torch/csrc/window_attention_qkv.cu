// K4f / K4b, V1f / V1b and V3f / V3b: multi-head window attention, forward
// and backward, on three operand layouts.
//
//   out[bw, t, h] = sum_j p[t, j] v[bw, j, h]
//   p = softmax_j(q[bw, t, h] . k[bw, j, h] * scale + bias[h, t, j]
//                 + (ids[r][t] != ids[r][j] ? -1e9 : 0)),  r = ids row of bw
//
// Replaces, in vsn_tpu/ops/window_attention.py:
// - _fwd_qkv and _bwd_qkv_vjp (K4, fused_window_attention_qkv): q, k, v
//   packed in the qkv projection [BW, N, 3C], out merged-head [BW, N, C],
//   window bw on ids row bw % W. It is the attention core of an unfused
//   Swin block, between the qkv and proj Linears (PyTorch matmuls);
// - _fwd and _bwd (V1, fused_window_attention): q, k, v and out split
//   [BW, H, N, d], window bw on ids row bw % W;
// - _fwd_win and _bwd_win_vjp (V3, fused_window_attention_windows): qkv
//   [B, D, H, W, 3C] and out [B, D, H, W, C] on the unpartitioned (rolled,
//   padded) map, windows of (wd, wh, ww) voxels in row-major (i, j, kw)
//   order within each sample; window (i, j, kw) on ids row flat(i, j, kw)
//   % W, its index within its sample (not bw % W: the two agree only when
//   W divides the windows per sample).
//
// K4 runs the key-tiled tensor-core body of attn_tiled.cuh (FlashAttention-2
// on bf16 mma.sync; FMA product steps in f32) under K4's softmax policy,
// ``K4Softmax`` below: the TPU kernel's score (dot * scale + bias) + mask,
// each step rounded; the plain row max (the running shift starts at -inf);
// the plain row sum; ds = p (dp - rowsum(p dp)). K4f keeps each row's (max,
// 1 / sum) and, for bf16, the f32 output for K4b, whose phase A takes s1 =
// dO . o and adds dbias with f32 atomics and whose phase B gives dk and dv.
// e, p and ds are rounded to T before their products, as the TPU's MXU
// rounds its f32 operands at default precision. Head dims: any up to 32 and
// multiples of 16 up to 128.
//
// The rest of this file is the FMA body that V1 and V3 run, and only they.
// The Pallas bodies (_fwd_kernel,
// _fwd_win_kernel and their backward) agree op for op and differ only in
// where an operand lies, so one kernel body serves both, templated on an
// addressing policy: Strided (V1) or WindowRows (V3) maps (window, head,
// token) to an element offset and a window to its ids row. Each (TPU
// kernel, layout) pair is its own instantiation and C entry point.
//
// Numerics are the TPU kernels': q, k, v are read from the stored type into
// f32 and every product is an f32 FMA; the softmax subtracts the plain row
// max and divides each term by the f32 row sum before p . v; the output and
// the gradients are cast to the activation type T once. The mask is
// additive -1e9 where the region ids of query and key differ (pad slots
// carry -1, an unshifted block passes W = 1 row of zeros).
//
// What bounds it here: the FMA arithmetic of the products (4 N^2 d per
// window and head forward, 10 N^2 d backward; no tensor cores), while the
// bytes it must move are small (q, k, v once, the output once). One
// window's [N, N] f32 scores (254 KB at N = 252) do not fit in the 227 KB a
// block may hold, so no [N, N] matrix is ever stored: as in K1f
// (attn_half.cu) and K1b (attn_half_bwd.cu), one block takes one (window,
// head), keeps that head's operands in shared memory as f32 and gives each
// warp one query row at a time, whose N scores sit in a row buffer.
//
// The backward runs in the two phases of K1b. Phase A takes query rows:
// scores, row max and sum, p, dp = dO V^T, ds = p (dp - rowsum(p dp)),
// dq = scale ds K, and adds ds into dbias with f32 atomics (the TPU's
// revisited block is a reduction over every window here; the order of the
// adds varies, so dbias matches a plain sum to rounding). Phase B takes key
// rows and recomputes p and ds column by column from phase A's row
// statistics for dk = scale ds^T Q and dv = p^T dO, so no dk/dv sum needs
// atomics. Both phases form the score, p and ds with the same
// round-to-nearest operations (no contraction into FMA), so phase B's p
// and ds equal phase A's bit for bit.

#include <cstdint>

#include "attn_tiled.cuh"

namespace {

// Element (window bw, head h, token t, channel c) of a strided operand
// lies at bw * win + h * head + t * row + c from its base pointer.
struct HeadStrides {
  long long win, head, row;
};

// Addressing policy of V1 (split q, k, v and out): every operand in
// strides; window bw on ids row bw % W.
struct Strided {
  HeadStrides in, out;  // q, k, v (and dq, dk, dv); out (and dout)
  // One (window, head): token t at in(t) in q, k, v and at out(t) in out.
  struct At {
    long long in0, out0, in_row, out_row;
    __device__ __forceinline__ long long in(int t) const { return in0 + t * in_row; }
    __device__ __forceinline__ long long out(int t) const { return out0 + t * out_row; }
  };
  __device__ __forceinline__ At at(long long bw, int h) const {
    return {bw * in.win + h * in.head, bw * out.win + h * out.head, in.row, out.row};
  }
  __device__ __forceinline__ long long ids_row(long long bw, int rows) const {
    return bw % rows;
  }
};

// Addressing policy of V3: the unpartitioned map [B, md, mh, mw, ch] (ch
// = 3C channels for qkv, C for out; q, k, v at channel 0, C, 2C; head h
// at h * d). Window bw = (b, i, j, kw) and token t = (td, th, tw) sit at
// voxel ((b md + i wd + td) mh + j wh + th) mw + kw ww + tw, in 64 bits.
struct WindowRows {
  int md, mh, mw;             // the map's D, H, W (multiples of the window)
  int wd, wh, ww;             // the window
  int d;                      // head dim
  long long in_row, out_row;  // channels per voxel of qkv (3C) and out (C)
  struct At {
    long long in0, out0, in_row, out_row;
    int mh, mw, wh, ww;
    // token t's voxel, counted from the window's first voxel
    __device__ __forceinline__ long long voxel(int t) const {
      const int td = t / (wh * ww), th = (t / ww) % wh, tw = t % ww;
      return ((long long)td * mh + th) * mw + tw;
    }
    __device__ __forceinline__ long long in(int t) const { return in0 + voxel(t) * in_row; }
    __device__ __forceinline__ long long out(int t) const { return out0 + voxel(t) * out_row; }
  };
  __device__ __forceinline__ long long windows() const {
    return (long long)(md / wd) * (mh / wh) * (mw / ww);
  }
  // the first voxel of window bw
  __device__ __forceinline__ long long voxel0(long long bw) const {
    const int nwh = mh / wh, nww = mw / ww;
    const long long b = bw / windows(), r = bw % windows();
    const long long i = r / (nwh * nww), j = (r / nww) % nwh, kw = r % nww;
    return ((b * md + i * wd) * mh + j * wh) * mw + kw * ww;
  }
  __device__ __forceinline__ At at(long long bw, int h) const {
    const long long v0 = voxel0(bw);
    return {v0 * in_row + h * d, v0 * out_row + h * d, in_row, out_row, mh, mw, wh, ww};
  }
  __device__ __forceinline__ long long ids_row(long long bw, int rows) const {
    return (bw % windows()) % rows;
  }
};

template <typename T>
struct AttnParams {
  const T* q;            // q, k, v (and dq, dk, dv): the policy's in(t)
  const T* k;
  const T* v;
  T* out;                // out (forward) and dout (backward): its out(t)
  const T* dout;
  T* dq;                 // backward
  T* dk;
  T* dv;
  const float* bias;     // [H, N, N]
  const float* bias_t;   // [H, N, N], each head transposed (backward)
  float* dbias;          // [H, N, N], zeroed by the caller (backward adds)
  const int* ids;        // [W, N]: window bw uses the policy's ids_row
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

// Copies one (window, head) operand [N, d] of ``src``, token t at
// offset(t), into shared memory as f32 rows of ``ld`` floats.
template <typename T, typename Offset>
__device__ __forceinline__ void stage_head(float* dst, int ld, const T* src,
                                           Offset offset, int n, int d) {
  for (int e = threadIdx.x; e < n * d; e += blockDim.x) {
    const int j = e / d, c = e % d;
    dst[j * ld + c] = to_f32(src[offset(j) + c]);
  }
}

// Copies ids row ``row`` into shared memory.
__device__ __forceinline__ void stage_ids(int* dst, const int* ids, long long row, int n) {
  const int* src = ids + row * n;
  for (int j = threadIdx.x; j < n; j += blockDim.x) dst[j] = src[j];
}

constexpr int kFwdWarps = 8;

template <typename T, typename L>
__global__ void __launch_bounds__(kFwdWarps * 32) attention_fwd_kernel(AttnParams<T> p, L lay) {
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
  const typename L::At at = lay.at(bw, h);
  const auto in = [&](int t) { return at.in(t); };

  stage_head(ks, dp1, p.k, in, n, d);
  stage_head(vs, d, p.v, in, n, d);
  stage_ids(ids_s, p.ids, lay.ids_row(bw, p.ids_rows), n);
  __syncthreads();

  float* q = qs + warp * 32;
  float* u = us + warp * n;
  const float* bias_h = p.bias + (long long)h * n * n;
  for (int i = warp; i < n; i += kFwdWarps) {
    if (lane < d) q[lane] = to_f32(p.q[at.in(i) + lane]);
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
      p.out[at.out(i) + lane] = from_f32<T>(o);
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

template <typename T, typename L>
__global__ void __launch_bounds__(kBwdWarps * 32) attention_bwd_kernel(AttnParams<T> p, L lay) {
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
  const typename L::At at = lay.at(bw, h);
  const auto in = [&](int t) { return at.in(t); };
  const auto out = [&](int t) { return at.out(t); };

  stage_head(qs, dp1, p.q, in, n, d);
  stage_head(ks, dp1, p.k, in, n, d);
  stage_head(vs, dp1, p.v, in, n, d);
  stage_head(dos, dp1, p.dout, out, n, d);
  stage_ids(ids_s, p.ids, lay.ids_row(bw, p.ids_rows), n);
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
      p.dq[at.in(i) + lane] = from_f32<T>(a * p.scale);
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
      p.dk[at.in(j) + lane] = from_f32<T>(ak * p.scale);
      p.dv[at.in(j) + lane] = from_f32<T>(av);
    }
    __syncwarp();
  }
}

size_t bwd_smem_bytes(int n, int d) {
  return sizeof(float) * ((size_t)4 * n * (d + 1) + 3 * (size_t)n +
                          2 * (size_t)kBwdWarps * n) +
         sizeof(int) * (size_t)n;
}

template <typename T>
AttnParams<T> params(const T* q, const T* k, const T* v, const float* bias,
                     const int* ids, int ids_rows, int n, int d, int heads,
                     float scale) {
  AttnParams<T> p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.bias = bias;
  p.ids = ids;
  p.ids_rows = ids_rows;
  p.n = n;
  p.d = d;
  p.heads = heads;
  p.scale = scale;
  return p;
}

template <typename T, typename L>
int launch_fwd(const AttnParams<T>& p, const L& lay, long long bw, cudaStream_t stream) {
  const size_t smem = fwd_smem_bytes(p.n, p.d);
  cudaError_t err = cudaFuncSetAttribute(attention_fwd_kernel<T, L>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  attention_fwd_kernel<T, L><<<(unsigned)(bw * p.heads), kFwdWarps * 32, smem, stream>>>(p, lay);
  return (int)cudaGetLastError();
}

template <typename T, typename L>
int launch_bwd(const AttnParams<T>& p, const L& lay, long long bw, cudaStream_t stream) {
  const size_t smem = bwd_smem_bytes(p.n, p.d);
  cudaError_t err = cudaFuncSetAttribute(attention_bwd_kernel<T, L>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  attention_bwd_kernel<T, L><<<(unsigned)(bw * p.heads), kBwdWarps * 32, smem, stream>>>(p, lay);
  return (int)cudaGetLastError();
}

// V1: q, k, v, out and their gradients [BW, H, N, d].
Strided split(int n, int d, int heads) {
  const HeadStrides s = {(long long)heads * n * d, (long long)n * d, d};
  return {s, s};
}

// V3: qkv [B, md, mh, mw, 3C] and out / dout [B, md, mh, mw, C].
WindowRows grid(int md, int mh, int mw, int wd, int wh, int ww, int c, int heads) {
  return {md, mh, mw, wd, wh, ww, c / heads, 3LL * c, (long long)c};
}

template <typename T>
int attention_split_fwd(const T* q, const T* k, const T* v, const float* bias,
                        const int* ids, int ids_rows, T* out, long long bw, int n,
                        int d, int heads, float scale, cudaStream_t stream) {
  AttnParams<T> p = params(q, k, v, bias, ids, ids_rows, n, d, heads, scale);
  p.out = out;
  return launch_fwd(p, split(n, d, heads), bw, stream);
}

template <typename T>
int attention_split_bwd(const T* q, const T* k, const T* v, const float* bias,
                        const float* bias_t, const int* ids, int ids_rows,
                        const T* dout, T* dq, T* dk, T* dv, float* dbias,
                        long long bw, int n, int d, int heads, float scale,
                        cudaStream_t stream) {
  AttnParams<T> p = params(q, k, v, bias, ids, ids_rows, n, d, heads, scale);
  p.dout = dout;
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.bias_t = bias_t;
  p.dbias = dbias;
  return launch_bwd(p, split(n, d, heads), bw, stream);
}

template <typename T>
int attention_windows_fwd(const T* qkv, const float* bias, const int* ids, int ids_rows,
                          T* out, int b, int md, int mh, int mw, int wd, int wh,
                          int ww, int c, int heads, float scale, cudaStream_t stream) {
  const WindowRows lay = grid(md, mh, mw, wd, wh, ww, c, heads);
  const long long bw = (long long)b * (md / wd) * (mh / wh) * (mw / ww);
  AttnParams<T> p = params(qkv, qkv + c, qkv + 2 * c, bias, ids, ids_rows,
                           wd * wh * ww, c / heads, heads, scale);
  p.out = out;
  return launch_fwd(p, lay, bw, stream);
}

template <typename T>
int attention_windows_bwd(const T* qkv, const float* bias, const float* bias_t,
                          const int* ids, int ids_rows, const T* dout, T* dqkv,
                          float* dbias, int b, int md, int mh, int mw, int wd,
                          int wh, int ww, int c, int heads, float scale,
                          cudaStream_t stream) {
  const WindowRows lay = grid(md, mh, mw, wd, wh, ww, c, heads);
  const long long bw = (long long)b * (md / wd) * (mh / wh) * (mw / ww);
  AttnParams<T> p = params(qkv, qkv + c, qkv + 2 * c, bias, ids, ids_rows,
                           wd * wh * ww, c / heads, heads, scale);
  p.dout = dout;
  p.dq = dqkv;
  p.dk = dqkv + c;
  p.dv = dqkv + 2 * c;
  p.bias_t = bias_t;
  p.dbias = dbias;
  return launch_bwd(p, lay, bw, stream);
}

// K4's softmax policy on the tiled body (attn_tiled.cuh), as _fwd_qkv_kernel
// and _bwd_qkv_kernel form it.
struct K4Softmax {
  static constexpr float kShift0 = -INFINITY;  // the plain row max
  static constexpr float kSumEps = 0.f;        // a row always keeps its own key
  static constexpr bool kColumnSums = false;   // the qkv bias gradient is the Linear's
  static constexpr bool kPlainLoads = true;    // any head dim up to 32

  // (dot * scale + bias) + mask, each step rounded to nearest.
  static __device__ __forceinline__ float score(float acc, float scale, const int* id_row,
                                                int id_i, const float* bias_i, int j) {
    const float s = __fadd_rn(__fmul_rn(acc, scale), bias_i ? bias_i[j] : 0.f);
    return __fadd_rn(s, id_row && id_row[j] != id_i ? kNegInf : 0.f);
  }

  static __device__ __forceinline__ float ds(float p, float dp, float s1) {
    return __fmul_rn(p, __fsub_rn(dp, s1));
  }
};

// Whether K4's rows must be staged by plain loads: a head's channels that are
// not whole 16-byte chunks, or an operand that is not 16-byte aligned.
template <typename T>
bool k4_plain_loads(int d, const void* a, const void* b) {
  return d % (16 / (int)sizeof(T)) || reinterpret_cast<uintptr_t>(a) % 16 ||
         reinterpret_cast<uintptr_t>(b) % 16;
}

template <typename T>
int k4_fwd(const T* qkv, const float* bias, const int* ids, int ids_rows, T* out, float* o32,
           float* stats, long long bw, int n, int c, int heads, float scale,
           cudaStream_t stream) {
  const bool plain = k4_plain_loads<T>(c / heads, qkv, qkv);
  return (int)launch_attention_tiled<T, K4Softmax>(qkv, bias, ids, ids_rows, out, o32, stats,
                                                   bw, n, c, heads, scale, stream, plain);
}

template <typename T>
int k4_bwd(const T* qkv, const T* dout, const float* o, const float* stats,
           const float* bias, const int* ids, int ids_rows, float* s1, T* dqkv, float* dbias,
           long long bw, int n, int c, int heads, float scale, cudaStream_t stream) {
  const bool plain = k4_plain_loads<T>(c / heads, qkv, dout);
  return (int)launch_attention_bwd_tiled<T, K4Softmax>(qkv, dout, o, stats, bias, ids,
                                                       ids_rows, s1, dqkv, dbias, nullptr, bw,
                                                       n, c, heads, scale, stream, plain);
}

}  // namespace

// Every entry returns cudaGetLastError() of the launch (or of setting its
// shared memory size; K4: cudaErrorInvalidValue for a head dim it does not
// take), else 0. is_bf16 selects bf16 activations (q, k, v
// or qkv, out, dout and their gradients), else f32; bias, bias_t (bias
// with each head transposed) and dbias are f32, ids int32. dbias must be
// zeroed by the caller: the backward adds into it.

// K4f on packed qkv [BW, N, 3C] (c = C): out [BW, N, C] (T), o32 [BW, N, C]
// f32 (bf16 only; null for f32, where out is o), stats [BW, H, N, 2] f32
// (each row's max and 1 / sum).
extern "C" int vsn_window_attention_qkv_tiled_fwd(int is_bf16, const void* qkv,
                                                  const float* bias, const int* ids,
                                                  int ids_rows, void* out, float* o32,
                                                  float* stats, long long bw, int n, int c,
                                                  int heads, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    using B = __nv_bfloat16;
    return k4_fwd<B>(static_cast<const B*>(qkv), bias, ids, ids_rows, static_cast<B*>(out),
                     o32, stats, bw, n, c, heads, scale, s);
  }
  return k4_fwd<float>(static_cast<const float*>(qkv), bias, ids, ids_rows,
                       static_cast<float*>(out), nullptr, stats, bw, n, c, heads, scale, s);
}

// K4b from K4f's o (f32 [BW, N, C]) and stats: dqkv [BW, N, 3C] (T), and
// added into the zeroed f32 dbias [H, N, N] (null: no dbias, a probe of the
// atomics' cost); s1 [BW, H, N] f32 is scratch.
extern "C" int vsn_window_attention_qkv_tiled_bwd(int is_bf16, const void* qkv,
                                                  const void* dout, const float* o,
                                                  const float* stats, const float* bias,
                                                  const int* ids, int ids_rows, float* s1,
                                                  void* dqkv, float* dbias, long long bw,
                                                  int n, int c, int heads, float scale,
                                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    using B = __nv_bfloat16;
    return k4_bwd<B>(static_cast<const B*>(qkv), static_cast<const B*>(dout), o, stats, bias,
                     ids, ids_rows, s1, static_cast<B*>(dqkv), dbias, bw, n, c, heads, scale,
                     s);
  }
  return k4_bwd<float>(static_cast<const float*>(qkv), static_cast<const float*>(dout), o,
                       stats, bias, ids, ids_rows, s1, static_cast<float*>(dqkv), dbias, bw, n,
                       c, heads, scale, s);
}

// V1 on split q, k, v [BW, H, N, d].
extern "C" int vsn_window_attention_fwd(int is_bf16, const void* q, const void* k,
                                        const void* v, const float* bias,
                                        const int* ids, int ids_rows, void* out,
                                        long long bw, int n, int d, int heads,
                                        float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    using B = __nv_bfloat16;
    return attention_split_fwd<B>(static_cast<const B*>(q), static_cast<const B*>(k),
                                  static_cast<const B*>(v), bias, ids, ids_rows,
                                  static_cast<B*>(out), bw, n, d, heads, scale, s);
  }
  return attention_split_fwd<float>(static_cast<const float*>(q),
                                    static_cast<const float*>(k),
                                    static_cast<const float*>(v), bias, ids, ids_rows,
                                    static_cast<float*>(out), bw, n, d, heads, scale, s);
}

extern "C" int vsn_window_attention_bwd(int is_bf16, const void* q, const void* k,
                                        const void* v, const float* bias,
                                        const float* bias_t, const int* ids,
                                        int ids_rows, const void* dout, void* dq,
                                        void* dk, void* dv, float* dbias,
                                        long long bw, int n, int d, int heads,
                                        float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    using B = __nv_bfloat16;
    return attention_split_bwd<B>(
        static_cast<const B*>(q), static_cast<const B*>(k), static_cast<const B*>(v),
        bias, bias_t, ids, ids_rows, static_cast<const B*>(dout), static_cast<B*>(dq),
        static_cast<B*>(dk), static_cast<B*>(dv), dbias, bw, n, d, heads, scale, s);
  }
  return attention_split_bwd<float>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), bias, bias_t, ids, ids_rows,
      static_cast<const float*>(dout), static_cast<float*>(dq), static_cast<float*>(dk),
      static_cast<float*>(dv), dbias, bw, n, d, heads, scale, s);
}

// V3 on the map qkv [b, md, mh, mw, 3C] (c = C), windows (wd, wh, ww).
extern "C" int vsn_window_attention_windows_fwd(int is_bf16, const void* qkv,
                                                const float* bias, const int* ids,
                                                int ids_rows, void* out, int b, int md,
                                                int mh, int mw, int wd, int wh, int ww,
                                                int c, int heads, float scale,
                                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    using B = __nv_bfloat16;
    return attention_windows_fwd<B>(static_cast<const B*>(qkv), bias, ids, ids_rows,
                                    static_cast<B*>(out), b, md, mh, mw, wd, wh, ww, c,
                                    heads, scale, s);
  }
  return attention_windows_fwd<float>(static_cast<const float*>(qkv), bias, ids,
                                      ids_rows, static_cast<float*>(out), b, md, mh, mw,
                                      wd, wh, ww, c, heads, scale, s);
}

extern "C" int vsn_window_attention_windows_bwd(int is_bf16, const void* qkv,
                                                const float* bias, const float* bias_t,
                                                const int* ids, int ids_rows,
                                                const void* dout, void* dqkv,
                                                float* dbias, int b, int md, int mh,
                                                int mw, int wd, int wh, int ww, int c,
                                                int heads, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    using B = __nv_bfloat16;
    return attention_windows_bwd<B>(static_cast<const B*>(qkv), bias, bias_t, ids,
                                    ids_rows, static_cast<const B*>(dout),
                                    static_cast<B*>(dqkv), dbias, b, md, mh, mw, wd, wh,
                                    ww, c, heads, scale, s);
  }
  return attention_windows_bwd<float>(static_cast<const float*>(qkv), bias, bias_t, ids,
                                      ids_rows, static_cast<const float*>(dout),
                                      static_cast<float*>(dqkv), dbias, b, md, mh, mw,
                                      wd, wh, ww, c, heads, scale, s);
}
