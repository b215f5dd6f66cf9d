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
// The three Pallas bodies (_fwd_qkv_kernel, _fwd_kernel, _fwd_win_kernel and
// their backward) compute one function with one set of numerics and differ
// only in where an operand lies. So all three run the key-tiled tensor-core
// body of attn_tiled.cuh (FlashAttention-2 on bf16 mma.sync; FMA product
// steps in f32) under K4's softmax policy, ``K4Softmax`` below, each on its
// layout: ``Packed`` (K4, attn_tiled.cuh), ``Split`` (V1) and ``MapRows``
// (V3) below. K4Softmax is the TPU kernel's: the score (dot * scale + bias)
// + mask, each step rounded; the plain row max (the running shift starts at
// -inf); the plain row sum; ds = p (dp - rowsum(p dp)). The forward keeps
// each row's (max, 1 / sum) [BW, H, N, 2] and, for bf16, the f32 output in
// out's layout for the backward, whose phase A takes s1 = dO . o and adds
// dbias with f32 atomics and whose phase B gives dk and dv. e, p and ds are
// rounded to T before their products, as the TPU's MXU rounds its f32
// operands at default precision. The mask is additive -1e9 where the region
// ids of query and key differ (pad slots carry -1, an unshifted block
// passes W = 1 row of zeros). Head dims: every d from 1 to 8192 (above 128
// on the body's slab kernels); rows that are not whole 16-byte chunks (or an
// operand that is not 16-byte aligned) are staged by plain loads.
//
// What bounds it: the products, 4 N^2 d per window and head forward and 10
// N^2 d backward (above the H100's ridge: the tensor cores), against q, k,
// v, bias read and out written once. The same body stages the same tiles
// in the same order on every layout, so V1f and V3f give K4f's out, row
// statistics and o bit for bit; only where a row lies changes. V3's 64-token
// tiles cross its window's row (ww) and slice (wh ww) boundaries, so its
// rows are not at a fixed stride: each thread maps a tile row to its voxel
// once and copies the row's q (or k and v, or q and dO) from there.

#include "attn_tiled.cuh"

namespace {

// K4's softmax policy on the tiled body (attn_tiled.cuh), as _fwd_qkv_kernel
// and _bwd_qkv_kernel form it.
struct K4Softmax {
  static constexpr float kShift0 = -INFINITY;  // the plain row max
  static constexpr float kSumEps = 0.f;        // a row always keeps its own key
  static constexpr bool kColumnSums = false;   // the qkv bias gradient is the Linear's
  static constexpr bool kPlainLoads = true;    // every head dim
  static constexpr Probs kProbs = Probs::kOnline;
  static constexpr bool kKeepsStats = true;    // the row statistics, for K4b

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

// V1's layout: q, k, v, out, o32, dO and dq, dk, dv [BW, H, N, d]; token t
// of head h of window bw at ((bw H + h) N + t) d in each. q, out and dq come
// in the kernels' qkv, ao and dqkv; k, v, dk and dv have their own base
// pointers here. Window bw on ids row bw % W.
template <typename T>
struct Split {
  const T* k;
  const T* v;
  T* dk;  // backward
  T* dv;

  struct Head {
    const T* q;     // the base pointers, as given
    const T* k;
    const T* v;
    T* dk;
    T* dv;
    long long off;  // the head's token 0 in every tensor
    int ld;         // elements from token to token: the head dim

    template <int D, typename P>
    __device__ __forceinline__ void stage_q(T* dst, int t0, int nrows, int d, bool plain) const {
      stage_tile<T, D, P>(dst, q + in(t0), ld, nrows, d, plain);
    }
    template <int D, typename P>
    __device__ __forceinline__ void stage_kv(T* kvs, int n, int kt, int d, bool plain) const {
      constexpr int LD = kLd<T, D>;
      T* dst = kvs + (kt & 1) * 2 * kTile * LD;
      const int nk = min(kTile, n - kt * kTile);
      stage_keys<D, P>(dst, dst + kTile * LD, kt * kTile, nk, d, plain);
      cp_async_commit();
    }
    template <int D, typename P>
    __device__ __forceinline__ void stage_do(T* dst, const T* dao, int t0, int nrows, int d,
                                             bool plain) const {
      stage_tile<T, D, P>(dst, dao + in(t0), ld, nrows, d, plain);
    }
    template <int D, typename P>
    __device__ __forceinline__ void stage_keys(T* ks, T* vs, int t0, int nrows, int d,
                                               bool plain) const {
      stage_tile<T, D, P>(ks, k + in(t0), ld, nrows, d, plain);
      stage_tile<T, D, P>(vs, v + in(t0), ld, nrows, d, plain);
    }
    template <int D, typename P>
    __device__ __forceinline__ void stage_q_do(T* qd, T* dd, const T* dao, int t0, int nrows,
                                               int d, bool plain) const {
      stage_q<D, P>(qd, t0, nrows, d, plain);
      stage_do<D, P>(dd, dao, t0, nrows, d, plain);
    }
    __device__ __forceinline__ long long in(int t) const { return off + (long long)t * ld; }
    __device__ __forceinline__ long long out(int t) const { return in(t); }
    // token t's channel 0 of the head in q, k, v (the slab kernels' rows)
    __device__ __forceinline__ const T* q_row(int t) const { return q + in(t); }
    __device__ __forceinline__ const T* k_row(int t) const { return k + in(t); }
    __device__ __forceinline__ const T* v_row(int t) const { return v + in(t); }
    // channel ch of token t's dk (part 1) or dv (part 2)
    __device__ __forceinline__ void store_kv(T*, int part, int t, int ch, T x) const {
      (part == 1 ? dk : dv)[in(t) + ch] = x;
    }
    __device__ __forceinline__ void store_dkv(T*, int t, int ch, T dk_t, T dv_t) const {
      dk[in(t) + ch] = dk_t;
      dv[in(t) + ch] = dv_t;
    }
  };

  __device__ __forceinline__ Head head(const T* q, long long bw, int h, int n, int, int d,
                                       int heads) const {
    const long long off = (bw * heads + h) * n * d;
    return {q, k, v, dk, dv, off, d};
  }
  __device__ __forceinline__ const int* ids(const int* ids, long long bw, int ids_rows,
                                            int n) const {
    return window_ids(ids, bw, ids_rows, n);
  }
};

// V1b's phase A at bf16 D = 64 spills at the 168 registers that 3 blocks an
// SM leave (ptxas: K and V have their own base pointers here): 2 blocks.
template <typename T>
constexpr bool kRowsSpill<Split<T>, __nv_bfloat16, 64> = true;

// V3's layout: qkv [B, md, mh, mw, 3C] (q, k, v at channel 0, C, 2C; head h
// at h d) and out, o32, dO [B, md, mh, mw, C] on the unpartitioned map;
// dqkv as qkv. Window bw = (b, i, j, kw) and its token t = (td, th, tw) sit
// at voxel ((b md + i wd + td) mh + j wh + th) mw + kw ww + tw, in 64 bits;
// a voxel is a row of 3C (qkv) or C (out) elements. Window bw takes ids row
// flat(i, j, kw) % W, its index within its sample.
struct WindowGrid {
  int md, mh, mw;  // the map's D, H, W (multiples of the window)
  int wd, wh, ww;  // the window
  // ceil(2^32 / ww), ceil(2^32 / wh): x / ww = x ww_inv >> 32 exactly for
  // x ww < 2^32 (the host checks N ww and N wh), a multiply in place of a
  // division in every staged row
  long long ww_inv, wh_inv;

  // token t's voxel, counted from its window's first voxel
  __device__ __forceinline__ long long row(int t) const {
    const int a = (int)(t * ww_inv >> 32), tw = t - a * ww;  // a = td wh + th
    const int td = (int)(a * wh_inv >> 32), th = a - td * wh;
    return ((long long)td * mh + th) * mw + tw;
  }
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
  __device__ __forceinline__ long long ids_row(long long bw, int rows) const {
    return (bw % windows()) % rows;
  }
};

struct MapRows : WindowGrid {
  template <typename T>
  struct Head {
    WindowGrid map;
    const T* head;     // q of the window's first voxel
    long long c3, v0;  // 3C; the window's first voxel
    int c, hd;         // C; h d

    template <int D, typename P>
    __device__ __forceinline__ void stage_q(T* dst, int t0, int nrows, int d, bool plain) const {
      stage_rows<T, D, P>(dst, head, c3, nullptr, nullptr, 0, map, t0, nrows, d, plain);
    }
    template <int D, typename P>
    __device__ __forceinline__ void stage_kv(T* kvs, int n, int kt, int d, bool plain) const {
      constexpr int LD = kLd<T, D>;
      T* dst = kvs + (kt & 1) * 2 * kTile * LD;
      const int nk = min(kTile, n - kt * kTile);
      stage_rows<T, D, P>(dst, head + c, c3, dst + kTile * LD, head + 2 * c, c3, map,
                          kt * kTile, nk, d, plain);
      cp_async_commit();
    }
    template <int D, typename P>
    __device__ __forceinline__ void stage_do(T* dst, const T* dao, int t0, int nrows, int d,
                                             bool plain) const {
      stage_rows<T, D, P>(dst, dao + v0 * c + hd, c, nullptr, nullptr, 0, map, t0, nrows, d,
                          plain);
    }
    template <int D, typename P>
    __device__ __forceinline__ void stage_keys(T* ks, T* vs, int t0, int nrows, int d,
                                               bool plain) const {
      stage_rows<T, D, P>(ks, head + c, c3, vs, head + 2 * c, c3, map, t0, nrows, d, plain);
    }
    template <int D, typename P>
    __device__ __forceinline__ void stage_q_do(T* qd, T* dd, const T* dao, int t0, int nrows,
                                               int d, bool plain) const {
      stage_rows<T, D, P>(qd, head, c3, dd, dao + v0 * c + hd, c, map, t0, nrows, d, plain);
    }
    __device__ __forceinline__ long long out(int t) const { return (v0 + map.row(t)) * c + hd; }
    __device__ __forceinline__ long long in(int t) const { return (v0 + map.row(t)) * c3 + hd; }
    // token t's channel 0 of the head in q, k, v (the slab kernels' rows)
    __device__ __forceinline__ const T* q_row(int t) const { return head + map.row(t) * c3; }
    __device__ __forceinline__ const T* k_row(int t) const { return q_row(t) + c; }
    __device__ __forceinline__ const T* v_row(int t) const { return q_row(t) + 2 * c; }
    // channel ch of token t's dk (part 1) or dv (part 2)
    __device__ __forceinline__ void store_kv(T* dqkv, int part, int t, int ch, T x) const {
      dqkv[in(t) + part * c + ch] = x;
    }
    __device__ __forceinline__ void store_dkv(T* dqkv, int t, int ch, T dk, T dv) const {
      T* row = dqkv + in(t) + ch;
      row[c] = dk;
      row[2 * c] = dv;
    }
  };

  template <typename T>
  __device__ __forceinline__ Head<T> head(const T* qkv, long long bw, int h, int, int c, int d,
                                          int) const {
    const long long c3 = 3LL * c, v0 = voxel0(bw);
    return {*this, qkv + v0 * c3 + h * d, c3, v0, c, h * d};
  }
  __device__ __forceinline__ const int* ids(const int* ids, long long bw, int ids_rows,
                                            int n) const {
    return ids + ids_row(bw, ids_rows) * n;
  }
};

// V3b's slab phase A in bf16 spills at 255 registers with 32 keys a step
// (the map's row arithmetic beside dq, S and dp): 16.
template <>
constexpr bool kSlabRowsSpill<MapRows, __nv_bfloat16> = true;

template <typename T>
int k4_fwd(const T* qkv, const float* bias, const int* ids, int ids_rows, T* out, float* o32,
           float* stats, long long bw, int n, int c, int heads, float scale,
           cudaStream_t stream) {
  const bool plain = plain_loads<T>(c / heads, {qkv});
  return (int)launch_attention_tiled<T, K4Softmax>(qkv, bias, ids, ids_rows, out, o32, stats,
                                                   bw, n, c, heads, scale, stream, plain);
}

template <typename T>
int k4_bwd(const T* qkv, const T* dout, const float* o, const float* stats,
           const float* bias, const int* ids, int ids_rows, float* s1, T* dqkv, float* dbias,
           long long bw, int n, int c, int heads, float scale, cudaStream_t stream) {
  const bool plain = plain_loads<T>(c / heads, {qkv, dout});
  return (int)launch_attention_bwd_tiled<T, K4Softmax>(qkv, dout, o, stats, bias, ids,
                                                       ids_rows, s1, dqkv, dbias, nullptr, bw,
                                                       n, c, heads, scale, stream, plain);
}

template <typename T>
int v1_fwd(const T* q, const T* k, const T* v, const float* bias, const int* ids, int ids_rows,
           T* out, float* o32, float* stats, long long bw, int n, int d, int heads, float scale,
           cudaStream_t stream) {
  const Split<T> lay = {k, v, nullptr, nullptr};
  const bool plain = plain_loads<T>(d, {q, k, v});
  return (int)launch_attention_tiled<T, K4Softmax>(q, bias, ids, ids_rows, out, o32, stats, bw,
                                                   n, heads * d, heads, scale, stream, plain,
                                                   lay);
}

template <typename T>
int v1_bwd(const T* q, const T* k, const T* v, const T* dout, const float* o,
           const float* stats, const float* bias, const int* ids, int ids_rows, float* s1,
           T* dq, T* dk, T* dv, float* dbias, long long bw, int n, int d, int heads, float scale,
           cudaStream_t stream) {
  const Split<T> lay = {k, v, dk, dv};
  const bool plain = plain_loads<T>(d, {q, k, v, dout});
  return (int)launch_attention_bwd_tiled<T, K4Softmax>(q, dout, o, stats, bias, ids, ids_rows,
                                                       s1, dq, dbias, nullptr, bw, n, heads * d,
                                                       heads, scale, stream, plain, lay);
}

// V3's layout of a map [b, md, mh, mw, .] in windows (wd, wh, ww); false
// where the row map's multiplies would not divide exactly (N ww or N wh at
// 2^32 or past).
bool map_rows(MapRows& lay, int md, int mh, int mw, int wd, int wh, int ww) {
  const long long n = (long long)wd * wh * ww, one = 1LL << 32;
  lay = {{md, mh, mw, wd, wh, ww, (one + ww - 1) / ww, (one + wh - 1) / wh}};
  return n * ww < one && n * wh < one;
}

template <typename T>
int v3_fwd(const T* qkv, const float* bias, const int* ids, int ids_rows, T* out, float* o32,
           float* stats, int b, const MapRows& lay, int c, int heads, float scale,
           cudaStream_t stream) {
  const long long bw = b * (long long)(lay.md / lay.wd) * (lay.mh / lay.wh) * (lay.mw / lay.ww);
  const bool plain = plain_loads<T>(c / heads, {qkv});
  return (int)launch_attention_tiled<T, K4Softmax>(qkv, bias, ids, ids_rows, out, o32, stats,
                                                   bw, lay.wd * lay.wh * lay.ww, c, heads,
                                                   scale, stream, plain, lay);
}

template <typename T>
int v3_bwd(const T* qkv, const T* dout, const float* o, const float* stats, const float* bias,
           const int* ids, int ids_rows, float* s1, T* dqkv, float* dbias, int b,
           const MapRows& lay, int c, int heads, float scale, cudaStream_t stream) {
  const long long bw = b * (long long)(lay.md / lay.wd) * (lay.mh / lay.wh) * (lay.mw / lay.ww);
  const bool plain = plain_loads<T>(c / heads, {qkv, dout});
  return (int)launch_attention_bwd_tiled<T, K4Softmax>(
      qkv, dout, o, stats, bias, ids, ids_rows, s1, dqkv, dbias, nullptr, bw,
      lay.wd * lay.wh * lay.ww, c, heads, scale, stream, plain, lay);
}

}  // namespace

// Every entry returns cudaGetLastError() of the launch (or of setting its
// shared memory size; cudaErrorInvalidValue for a head dim above 8192), else
// 0. is_bf16 selects bf16 activations (q, k, v or qkv,
// out, dout and their gradients), else f32; o, stats, bias and dbias are
// f32, ids int32. dbias must be zeroed by the caller: the backward adds
// into it.

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

// V1f on split q, k, v [BW, H, N, d]: out [BW, H, N, d] (T), o32 (f32,
// out's shape; bf16 only, null for f32) and stats [BW, H, N, 2] f32.
extern "C" int vsn_window_attention_fwd(int is_bf16, const void* q, const void* k,
                                        const void* v, const float* bias, const int* ids,
                                        int ids_rows, void* out, float* o32, float* stats,
                                        long long bw, int n, int d, int heads, float scale,
                                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    using B = __nv_bfloat16;
    return v1_fwd<B>(static_cast<const B*>(q), static_cast<const B*>(k),
                     static_cast<const B*>(v), bias, ids, ids_rows, static_cast<B*>(out), o32,
                     stats, bw, n, d, heads, scale, s);
  }
  return v1_fwd<float>(static_cast<const float*>(q), static_cast<const float*>(k),
                       static_cast<const float*>(v), bias, ids, ids_rows,
                       static_cast<float*>(out), nullptr, stats, bw, n, d, heads, scale, s);
}

// V1b from V1f's o (f32 [BW, H, N, d]) and stats: dq, dk, dv [BW, H, N, d]
// (T), and added into the zeroed f32 dbias [H, N, N]; s1 [BW, H, N] f32 is
// scratch.
extern "C" int vsn_window_attention_bwd(int is_bf16, const void* q, const void* k,
                                        const void* v, const void* dout, const float* o,
                                        const float* stats, const float* bias, const int* ids,
                                        int ids_rows, float* s1, void* dq, void* dk, void* dv,
                                        float* dbias, long long bw, int n, int d, int heads,
                                        float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    using B = __nv_bfloat16;
    return v1_bwd<B>(static_cast<const B*>(q), static_cast<const B*>(k),
                     static_cast<const B*>(v), static_cast<const B*>(dout), o, stats, bias,
                     ids, ids_rows, s1, static_cast<B*>(dq), static_cast<B*>(dk),
                     static_cast<B*>(dv), dbias, bw, n, d, heads, scale, s);
  }
  return v1_bwd<float>(static_cast<const float*>(q), static_cast<const float*>(k),
                       static_cast<const float*>(v), static_cast<const float*>(dout), o, stats,
                       bias, ids, ids_rows, s1, static_cast<float*>(dq),
                       static_cast<float*>(dk), static_cast<float*>(dv), dbias, bw, n, d,
                       heads, scale, s);
}

// V3f on the map qkv [b, md, mh, mw, 3C] (c = C), windows (wd, wh, ww): out
// [b, md, mh, mw, C] (T), o32 (f32, out's shape; bf16 only, null for f32),
// stats [b nW, H, N, 2] f32.
extern "C" int vsn_window_attention_windows_fwd(int is_bf16, const void* qkv,
                                                const float* bias, const int* ids,
                                                int ids_rows, void* out, float* o32,
                                                float* stats, int b, int md, int mh, int mw,
                                                int wd, int wh, int ww, int c, int heads,
                                                float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  MapRows lay;
  if (!map_rows(lay, md, mh, mw, wd, wh, ww)) return (int)cudaErrorInvalidValue;
  if (is_bf16) {
    using B = __nv_bfloat16;
    return v3_fwd<B>(static_cast<const B*>(qkv), bias, ids, ids_rows, static_cast<B*>(out),
                     o32, stats, b, lay, c, heads, scale, s);
  }
  return v3_fwd<float>(static_cast<const float*>(qkv), bias, ids, ids_rows,
                       static_cast<float*>(out), nullptr, stats, b, lay, c, heads, scale, s);
}

// V3b from V3f's o (f32, out's shape) and stats: dqkv [b, md, mh, mw, 3C]
// (T), and added into the zeroed f32 dbias [H, N, N]; s1 [b nW, H, N] f32 is
// scratch.
extern "C" int vsn_window_attention_windows_bwd(int is_bf16, const void* qkv, const void* dout,
                                                const float* o, const float* stats,
                                                const float* bias, const int* ids,
                                                int ids_rows, float* s1, void* dqkv,
                                                float* dbias, int b, int md, int mh, int mw,
                                                int wd, int wh, int ww, int c, int heads,
                                                float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  MapRows lay;
  if (!map_rows(lay, md, mh, mw, wd, wh, ww)) return (int)cudaErrorInvalidValue;
  if (is_bf16) {
    using B = __nv_bfloat16;
    return v3_bwd<B>(static_cast<const B*>(qkv), static_cast<const B*>(dout), o, stats, bias,
                     ids, ids_rows, s1, static_cast<B*>(dqkv), dbias, b, lay, c, heads, scale,
                     s);
  }
  return v3_bwd<float>(static_cast<const float*>(qkv), static_cast<const float*>(dout), o,
                       stats, bias, ids, ids_rows, s1, static_cast<float*>(dqkv), dbias, b, lay,
                       c, heads, scale, s);
}
