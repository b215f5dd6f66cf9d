// The key-tiled attention body, forward and backward (phases A and B), for
// any N and every head dim d from 1 to 8192 (above 128 on its slab kernels,
// below): the one attention body of the port. K1 (K1f's launch 2, K1b's
// launch 4) runs it at every call: Swin's
// (d = 32: windows of N = 252 with the relative-position bias and region
// ids, N = 150 at the clamped last stage) and ViT's (vsn_tpu/models/vit3d.py
// _fused_attn_half, one window of N = 811 tokens per sample at d = 64), and
// at any other head dim; K4f / K4b, the unfused Swin block's window
// attention on packed qkv, and V1 / V3, the same function on split heads and
// on the unpartitioned map (window_attention_qkv.cu), under K4's softmax
// policy; the attention probes P1 / P5 (attn_half.cu) under theirs.
//
// Replaces the attention chain of vsn_tpu/ops/swin_block_kernels.py
// _heads_attention_fwd / _heads_attention_bwd (:169-226, :292-336), which the
// TPU runs as MXU matmuls on a whole window in VMEM. Here one window's K and
// V (832 KB in f32 at ViT's N) do not fit in a block's shared memory, so the
// body is the FlashAttention-2 form: keys stream through shared memory in
// tiles, and the softmax is taken online.
//
// What bounds it: the products, 4 N^2 d per (window, head) forward and 10 N^2
// d backward (24.25 and 60.6 GFLOP per ViT-S call at micro-batch 24), about
// 300 bf16 operations per byte of q, k, v read: above the H100's ridge, so
// the tensor cores. What the design does about it:
//
//   - bf16 (T = __nv_bfloat16): every product is mma.sync.m16n8k16 (bf16 in,
//     f32 accumulate). Tiles are staged in shared memory as bf16, rows padded
//     by 16 bytes so that ldmatrix / ldmatrix.trans hit no bank twice, and
//     filled by cp.async double-buffered: the next tile's copy runs under the
//     current tile's products. The probabilities (e, p, ds) go from the
//     accumulator fragments of one product to the A fragments of the next in
//     registers: no round trip through shared memory.
//   - f32 (the tests' type, held to 1e-4, which neither bf16 mma nor TF32
//     keeps): the same tiles, staging and loops, with FMA product steps on the
//     same fragment layout (``fma_nt`` / ``fma_nn``); only they pass a
//     probability chunk through a per-warp scratch in shared memory.
//
// Blocks have 4 warps; each warp owns 16 rows of a 64-row tile. A thread
// holds the accumulator fragment of mma.m16n8k16: rows g = lane / 4 and g + 8,
// columns 8 nt + 2 t + {0, 1} (t = lane % 4) of each 8-column tile nt.
//
// Forward (``attention_tiled_mma_kernel``): one block per (window, head, tile
// of 64 query rows). Q goes once into A fragments; per key tile, S = Q K^T,
// then in the fragment layout: x scale, + the -1e9 region mask, + the bias;
// the running shift m starts at 0 (so it is max(rowmax, 0)), alpha = exp(m -
// m') rescales the running sum l and O when the max grows, and e = exp(s -
// m') is rounded to T as the A fragment of O += e V. The ragged last key tile
// (811 = 12 x 64 + 43) stages its missing keys as zero rows and gives their
// scores -inf before the max. ao = O / (l + 1e-30) in T; beside it the kernel
// writes each row's (m, 1 / (l + 1e-30)) f32 [BW, H, N, 2] and, for bf16, o
// in f32 [BW*N, C], for K1b.
//
// e is rounded against the running shift, so a tile whose max is later
// overtaken contributes round(exp(s - m)) exp(m - m_final) where the TPU
// forms round(exp(s - m_final)): the same up to one rounding of e in T.
//
// Backward, from K1f's kept statistics, in the p-basis:
//   p = exp(s - m) / (l + 1e-30),  dp = dO V^T,  s1 = rowsum(p dp) = dO . o
//   ds = p dp - s1 p,  dq = scale ds K,  dk = scale ds^T Q,  dv = p^T dO
// with s1 taken as dO . o on K1f's f32 o (the FlashAttention identity; o in
// f32, so s1 carries no bf16 rounding of o), in phase A's prologue.
//
// Phase A (``attention_bwd_rows_mma_kernel``): one block per (window, head,
// tile of 64 query rows), Q and dO in A fragments, one pass over the key
// tiles, 16 keys a step: S, p, dp, ds; dbias += ds (f32 atomics, only with a
// bias); dq += round(ds) K. It writes s1 [BW, H, N] for phase B. At Swin's
// stage 1 (1,728 windows a call onto one [H, N, N] dbias) the atomics take
// half of phase A, but a block that sums ds over 4-16 windows in a shared
// f32 dbias tile first (the TPU kernel's carried accumulator) ran slower:
// the tile halves the blocks an SM holds (PERF.md, PR 13).
// Phase B (``attention_bwd_keys_mma_kernel``): one block per (window, head,
// tile of 64 keys), each warp 16 keys, one pass over the query tiles, 16
// queries a step: the same S (the same mma on the same A = Q and B = K
// fragments, in the same channel order) and dp, so p and ds are phase A's
// bit for bit; dv += round(p)^T dO and dk += round(ds)^T Q summed in
// registers, the transposes of p and ds taken in registers with
// movmatrix.trans. No atomics for dq, dk, dv: each is written once into dqkv
// [rows, 3C]. dbqkv (the qkv bias gradient) takes the column sums of the
// unrounded dq, dk, dv with f32 atomics, one per column and block.
//
// Rounding follows the TPU kernels: q, k, v, dO are T; e before PV, p before
// dv and ds before dq / dk are rounded to T; dbias takes ds unrounded.
//
// Head dims: every d from 1 to 128, compiled as D = 32, 64 and 128; the
// channels d..D-1 of a tile stage as zeros, which add exactly 0 to every
// product. Above 128, up to 8192, the slab kernels (``attention_slab_*``)
// take the head dim in slabs of 128 channels (64 in f32), under the same
// policies and layouts; the instantiations up to 128 keep their code.
// Tiles are filled by 16-byte cp.async copies wherever a head's rows
// are whole, 16-byte aligned chunks (d a multiple of 8 in bf16, of 4 in f32,
// every operand 16-byte aligned: ``plain_loads``), and by plain element
// loads otherwise (bf16 d = 12: 24-byte rows at 24-byte offsets). A policy
// whose own instantiations stage by cp.async only (K1's) takes the others
// as ``PlainLoads<P>``, so the instantiations at the presets' head dims keep
// their code.
//
// Softmax policies. The kernels are templated on a policy P that says how a
// score is formed from its product, where the running shift starts, what the
// row sum adds, how the forward forms its probabilities (``Probs``), whether
// it keeps the row statistics, how ds is formed, whether dbqkv's column sums
// are taken and whether rows may be staged by plain loads. ``K1Softmax``
// (here) is K1's, as described above; ``K4Softmax`` (window_attention_qkv.cu)
// is K4's: the score (dot * scale + bias) + mask, the plain row max (the
// shift starts at -inf), no epsilon, ds = p (dp - s1), no dbqkv. The probes'
// (attn_half.cu, forward only, no statistics kept, head dims up to 64):
// ``ProbeSoftmax``, p = round(exp(s - rowmax) / rowsum), normalized before
// its rounding: a first pass over the key tiles for each row's max and sum,
// a second for p and O += p V, O not scaled; ``ProbeScaled``, p = round(0.001
// s) in one pass.
//
// Layouts. The kernels are also templated on a layout L that places a
// (window, head)'s operands (see ``Packed`` below): ``Packed`` (K1, K4: qkv
// [BW*N, 3C], ao [BW*N, C]); ``Split`` (V1: q, k, v, out [BW, H, N, d]) and
// ``MapRows`` (V3: qkv and out on the unpartitioned map, a window's tokens
// not at a fixed stride), both in window_attention_qkv.cu; ``ProbeRows``
// (P1 / P5, attn_half.cu: qkv [BW*N, 3C], or q = k = v = y [BW*N, C] with out
// = x + o; wb windows to a block, taken in turn, 2 blocks an SM). The row
// statistics are [BW, H, N, 2] in every layout; o32 and o lie as out does.

#pragma once

#include <cstdint>
#include <initializer_list>

#include "common.cuh"

namespace {

constexpr int kMaxHeadDim = 128;        // the body's widest D; above it, slabs
constexpr int kMaxSlabHeadDim = 8192;   // the widest head a launch takes
constexpr int kTile = 64;        // rows of a query tile, keys of a key tile
constexpr int kTiledWarps = 4;   // 16 rows each
constexpr int kTiledThreads = kTiledWarps * 32;
constexpr int kSp = 17;          // row stride of the f32 scratch [16][16]

// Blocks an SM must hold (launch bounds): 3 for bf16 at d <= 64, which
// shared memory allows and which keeps ptxas at <= 168 registers without
// spills; 1 otherwise (ptxas spills at 168 there). Without a minimum, ptxas
// chose 128 registers for phase B at d = 64, with spills.
template <typename T, int D>
constexpr int kTiledMinBlocks = kTensorCores<T> && D <= 64 ? 3 : 1;

// Phase A's on layout L: kTiledMinBlocks, but 2 where a layout's phase A
// spills at the registers that 3 blocks leave (``kRowsSpill``, which the
// layout sets; window_attention_qkv.cu).
template <typename L, typename T, int D>
constexpr bool kRowsSpill = false;
template <typename T, int D, typename L>
constexpr int kRowsMinBlocks = kRowsSpill<L, T, D> ? 2 : kTiledMinBlocks<T, D>;

// Row stride (elements) of a staged [kTile][D] tile: 16 bytes of padding.
template <typename T, int D>
constexpr int kLd = D + 16 / (int)sizeof(T);

template <typename T, int D>
constexpr size_t kTileBytes = sizeof(T) * kTile * kLd<T, D>;

// ---------------------------------------------------------------------------
// Staging
// ---------------------------------------------------------------------------

// Policy P with its rows staged by plain loads only: what the launchers run
// where a head's rows are not whole, aligned 16-byte chunks under a policy
// that stages by cp.async (kPlainLoads false).
template <typename P>
struct PlainLoads : P {
  static constexpr bool kPlainLoads = true;
};

template <typename P>
constexpr bool kPlainOnly = false;
template <typename P>
constexpr bool kPlainOnly<PlainLoads<P>> = true;

// Copy rows [0, nrows) x channels [0, d) of a [rows][stride] T array into a
// staged tile; the tile's other rows and channels (up to kTile x D) are
// zero-filled, so they add exactly 0 to a product. By 16-byte cp.async
// copies, or, where the policy allows and ``plain`` asks for it (a row whose
// channels are not whole 16-byte chunks), by plain element copies (always,
// under PlainLoads).
template <typename T, int D, typename P>
__device__ __forceinline__ void stage_tile(T* dst, const T* src, long long stride, int nrows,
                                           int d, bool plain) {
  constexpr int E = 16 / (int)sizeof(T), CPR = D / E, LD = kLd<T, D>;
  if (kPlainOnly<P> || (P::kPlainLoads && plain)) {
    for (int e = threadIdx.x; e < kTile * D; e += kTiledThreads) {
      const int r = e / D, ch = e % D;
      dst[r * LD + ch] = r < nrows && ch < d ? src[r * stride + ch] : from_f32<T>(0.f);
    }
    return;
  }
  for (int e = threadIdx.x; e < kTile * CPR; e += kTiledThreads) {
    const int r = e / CPR, cc = e % CPR;
    const bool ok = r < nrows && cc * E < d;
    cp_async16(dst + r * LD + cc * E, ok ? src + r * stride + cc * E : src, ok);
  }
}

// Stage key tile kt of a head (K and V; head points at its q of token 0,
// rows 3C apart) into buffer kt % 2 of kvs [2][K, V][kTile][LD], and commit
// the copies as one group. The last tile is ragged (811 = 12 x 64 + 43): its
// missing keys stage as zero rows.
template <typename T, int D, typename P>
__device__ __forceinline__ void stage_kv(T* kvs, const T* head, long long c3, int c, int n,
                                         int kt, int d, bool plain) {
  constexpr int LD = kLd<T, D>;
  T* dst = kvs + (kt & 1) * 2 * kTile * LD;
  const T* src = head + (long long)kt * kTile * c3;
  const int nk = min(kTile, n - kt * kTile);
  stage_tile<T, D, P>(dst, src + c, c3, nk, d, plain);
  stage_tile<T, D, P>(dst + kTile * LD, src + 2 * c, c3, nk, d, plain);
  cp_async_commit();
}

// Copy two tiles from the same token rows, for a layout whose tokens do not
// lie at a fixed stride: tile row r of dst0 (dst1) is token t0 + r, row
// rows.row(t0 + r) of src0 (src1), ld0 (ld1) elements per row; dst1 null
// copies one tile. Each thread computes a row's offset once, for both
// tiles. Rows and channels past (nrows, d) are zero-filled, as stage_tile
// fills them, by the same cp.async copies or plain loads.
template <typename T, int D, typename P, typename Rows>
__device__ __forceinline__ void stage_rows(T* dst0, const T* src0, long long ld0, T* dst1,
                                           const T* src1, long long ld1, const Rows& rows,
                                           int t0, int nrows, int d, bool plain) {
  constexpr int E = 16 / (int)sizeof(T), CPR = D / E, LD = kLd<T, D>;
  if (kPlainOnly<P> || (P::kPlainLoads && plain)) {
    for (int e = threadIdx.x; e < kTile * D; e += kTiledThreads) {
      const int r = e / D, ch = e % D;
      const bool ok = r < nrows && ch < d;
      const long long row = ok ? rows.row(t0 + r) : 0;
      dst0[r * LD + ch] = ok ? src0[row * ld0 + ch] : from_f32<T>(0.f);
      if (dst1) dst1[r * LD + ch] = ok ? src1[row * ld1 + ch] : from_f32<T>(0.f);
    }
    return;
  }
  for (int e = threadIdx.x; e < kTile * CPR; e += kTiledThreads) {
    const int r = e / CPR, cc = e % CPR;
    const bool ok = r < nrows && cc * E < d;
    const long long row = ok ? rows.row(t0 + r) : 0;
    cp_async16(dst0 + r * LD + cc * E, ok ? src0 + row * ld0 + cc * E : src0, ok);
    if (dst1) cp_async16(dst1 + r * LD + cc * E, ok ? src1 + row * ld1 + cc * E : src1, ok);
  }
}

// ---------------------------------------------------------------------------
// Tensor-core product steps (bf16)
// ---------------------------------------------------------------------------

// acc[DT] += A Y over 16 depth rows row0.. of a staged tile Y [.][D]: the
// accumulators of a [16 x D] output.
template <int D>
__device__ __forceinline__ void mma_nn(float (&acc)[D / 8][4], const uint32_t (&a)[4],
                                       const __nv_bfloat16* tile, int row0, int lane) {
  constexpr int LD = kLd<__nv_bfloat16, D>;
#pragma unroll
  for (int j = 0; j < D / 16; ++j) {
    uint32_t b[4];
    load_b_nn<LD>(b, tile, row0, 16 * j, lane);
    mma_bf16(acc[2 * j], a, b[0], b[1]);
    mma_bf16(acc[2 * j + 1], a, b[2], b[3]);
  }
}

// The A fragment of a [16 x 16] chunk whose accumulators are v0 (columns 0-7)
// and v1 (columns 8-15), rounded to bf16.
__device__ __forceinline__ void a_from_acc(uint32_t (&a)[4], const float (&v0)[4],
                                           const float (&v1)[4]) {
  a[0] = pack_bf16(v0[0], v0[1]);
  a[1] = pack_bf16(v0[2], v0[3]);
  a[2] = pack_bf16(v1[0], v1[1]);
  a[3] = pack_bf16(v1[2], v1[3]);
}

// The A fragment of the transpose of the same chunk (rows and columns
// swapped), rounded to bf16: each 8 x 8 quarter transposed in registers.
__device__ __forceinline__ void a_from_acc_t(uint32_t (&a)[4], const float (&v0)[4],
                                             const float (&v1)[4]) {
  a[0] = transpose_8x8(pack_bf16(v0[0], v0[1]));  // rows 0-7 of v0
  a[1] = transpose_8x8(pack_bf16(v1[0], v1[1]));  // rows 0-7 of v1
  a[2] = transpose_8x8(pack_bf16(v0[2], v0[3]));  // rows 8-15 of v0
  a[3] = transpose_8x8(pack_bf16(v1[2], v1[3]));  // rows 8-15 of v1
}

// ---------------------------------------------------------------------------
// FMA product steps (f32), on the same fragment layout
// ---------------------------------------------------------------------------

// acc[NT] += X Y^T for X's 16 rows at x and Y's 8 NT rows at y (staged f32
// tiles), each output one FMA chain over the channels in order.
template <int NT, int D>
__device__ __forceinline__ void fma_nt(float (&acc)[NT][4], const float* x, const float* y,
                                       int lane) {
  constexpr int LD = kLd<float, D>;
  const int g = lane >> 2, t = lane & 3;
  const float* x0 = x + g * LD;
  const float* x1 = x0 + 8 * LD;
#pragma unroll 2
  for (int cc = 0; cc < D; cc += 4) {
    const float4 a0 = *reinterpret_cast<const float4*>(x0 + cc);
    const float4 a1 = *reinterpret_cast<const float4*>(x1 + cc);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float4 b = *reinterpret_cast<const float4*>(y + (8 * nt + 2 * t + e) * LD + cc);
        float u = acc[nt][e], v = acc[nt][2 + e];
        u = fmaf(a0.x, b.x, u);
        v = fmaf(a1.x, b.x, v);
        u = fmaf(a0.y, b.y, u);
        v = fmaf(a1.y, b.y, v);
        u = fmaf(a0.z, b.z, u);
        v = fmaf(a1.z, b.z, v);
        u = fmaf(a0.w, b.w, u);
        v = fmaf(a1.w, b.w, v);
        acc[nt][e] = u;
        acc[nt][2 + e] = v;
      }
  }
}

// Store a [16 x 16] chunk's accumulators v0, v1 into a warp's scratch sp
// [16][kSp].
__device__ __forceinline__ void store_chunk(float* sp, const float (&v0)[4],
                                            const float (&v1)[4], int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    sp[g * kSp + 2 * t + e] = v0[e];
    sp[(g + 8) * kSp + 2 * t + e] = v0[2 + e];
    sp[g * kSp + 8 + 2 * t + e] = v1[e];
    sp[(g + 8) * kSp + 8 + 2 * t + e] = v1[2 + e];
  }
}

// acc[DT] += P Y over 16 depth rows of Y at y (a staged f32 tile [.][D]), P
// the [16 x 16] chunk in the scratch sp, or its transpose (PT).
template <int D, bool PT>
__device__ __forceinline__ void fma_nn(float (&acc)[D / 8][4], const float* sp, const float* y,
                                       int lane) {
  constexpr int LD = kLd<float, D>;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll 4
  for (int k = 0; k < 16; ++k) {
    const float p0 = PT ? sp[k * kSp + g] : sp[g * kSp + k];
    const float p1 = PT ? sp[k * kSp + g + 8] : sp[(g + 8) * kSp + k];
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      const float2 b = *reinterpret_cast<const float2*>(y + k * LD + 8 * dt + 2 * t);
      acc[dt][0] = fmaf(p0, b.x, acc[dt][0]);
      acc[dt][1] = fmaf(p0, b.y, acc[dt][1]);
      acc[dt][2] = fmaf(p1, b.x, acc[dt][2]);
      acc[dt][3] = fmaf(p1, b.y, acc[dt][3]);
    }
  }
}

// ---------------------------------------------------------------------------
// Scores and probabilities, the same operations in every kernel
// ---------------------------------------------------------------------------

// How the forward forms the probabilities of O += P V from a row's scores s:
// kOnline e = exp(s - m) against the running shift m, the sum and O
// rescaled when m grows, O / (sum + eps) at the end (K1, K4); kNormalized p
// = exp(s - max) / sum after a first pass over the key tiles for each row's
// max and sum, O not scaled (the probes' SM_PLAIN); kScaled p = 0.001 s (the
// probes' SM_SCALE).
enum class Probs { kOnline, kNormalized, kScaled };

// K1's softmax policy (see the header; K4's is K4Softmax in
// window_attention_qkv.cu, the probes' in attn_half.cu).
struct K1Softmax {
  static constexpr float kShift0 = 0.f;       // the running shift: max(rowmax, 0)
  static constexpr float kSumEps = 1e-30f;    // a fully masked row gives 0
  static constexpr bool kColumnSums = true;   // dbqkv
  static constexpr bool kPlainLoads = false;  // others by PlainLoads<K1Softmax>
  static constexpr Probs kProbs = Probs::kOnline;
  static constexpr bool kKeepsStats = true;   // the row statistics, for K1b

  // The masked, biased, scaled score of query i, key j from its product.
  static __device__ __forceinline__ float score(float acc, float scale, const int* id_row,
                                                int id_i, const float* bias_i, int j) {
    float s = __fmul_rn(acc, scale);
    if (id_row) s = __fadd_rn(s, id_row[j] != id_i ? kNegInf : 0.f);
    if (bias_i) s = __fadd_rn(s, bias_i[j]);
    return s;
  }

  static __device__ __forceinline__ float ds(float p, float dp, float s1) {
    return __fsub_rn(__fmul_rn(p, dp), __fmul_rn(s1, p));
  }
};

template <typename P>
constexpr int kPasses = P::kProbs == Probs::kNormalized ? 2 : 1;

// Whether rows must be staged by plain loads: a head's channels that are
// not whole 16-byte chunks, or an operand that is not 16-byte aligned. Every
// row stride of every layout is a multiple of the head dim, so the head dim
// and the base pointers decide.
template <typename T>
bool plain_loads(int d, std::initializer_list<const void*> operands) {
  bool plain = d % (16 / (int)sizeof(T));
  for (const void* a : operands) plain = plain || reinterpret_cast<uintptr_t>(a) % 16;
  return plain;
}

// The ids row of window bw (row bw % ids_rows), null without ids.
__device__ __forceinline__ const int* window_ids(const int* ids, long long bw, int ids_rows,
                                                 int n) {
  return ids ? ids + (bw % ids_rows) * n : nullptr;
}

// Row i of head h of a [H, N, N] bias (or of its gradient).
template <typename F>
__device__ __forceinline__ F* bias_row(F* bias, int h, int n, int i) {
  return bias + ((long long)h * n + i) * n;
}

// Operand layouts (the kernels' template parameter L). A layout places the
// q, k, v rows of one (window, head) and its out, o32, dO, dq, dk, dv rows,
// and gives a window its ids row (``lay.ids``). ``lay.head(...)`` binds one
// (window bw, head h); its members stage the tiles (stage_q, stage_kv: the
// forward's and phase A's; stage_do: phase A's dO; stage_keys, stage_q_do:
// phase B's) and give element offsets (out: token t's channel h d in out,
// o32 and dO; in: in q and dq; store_dkv: dk and dv). ``Packed`` is K1's
// and K4's; ``Split`` (V1) and ``MapRows`` (V3) are in
// window_attention_qkv.cu; ``ProbeRows`` (P1 / P5, forward only) is in
// attn_half.cu, a grouped layout (``kGrouped``) whose ``store`` writes the
// head's output itself.

// qkv [BW*N, 3C] (q, k, v at channels 0, C, 2C, head h at h d), out [BW*N,
// C]: window bw's token t is row bw N + t of each; ids row bw % W. The
// kernels address it themselves (``kPacked``), as K1's and K4's kernels did
// before the other layouts came: its instantiations compile to the same code.
struct Packed {
  struct Head {};
  template <typename T>
  static __device__ __forceinline__ Head head(const T*, long long, int, int, int, int, int) {
    return {};
  }
  static __device__ __forceinline__ const int* ids(const int* ids, long long bw, int ids_rows,
                                                   int n) {
    return window_ids(ids, bw, ids_rows, n);
  }
};

template <typename L>
constexpr bool kPacked = std::is_same<L, Packed>::value;

// Whether layout L takes ``lay.wb`` windows to a block, in turn, and writes
// its own output (``Head::store``): the probes' ``ProbeRows`` (attn_half.cu).
template <typename L>
constexpr bool kGrouped = false;

// The forward's blocks an SM on layout L: kTiledMinBlocks, but 2 for a
// grouped layout (the probes', bf16, d <= 64), whose window loop and
// second pass spilled at the 168 registers that 3 blocks leave.
template <typename T, int D, typename L>
constexpr int kFwdMinBlocks = kGrouped<L> && D <= 64 ? 2 : kTiledMinBlocks<T, D>;

// p from the forward's kept row statistics (shift m, 1 / (the row sum + the
// policy's epsilon)).
__device__ __forceinline__ float kept_p(float s, float m, float rinv) {
  return __fmul_rn(expf(__fsub_rn(s, m)), rinv);
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

// dbqkv[col0 + channel] += the column sums over the block's 64 rows of a
// [16 x D] accumulator of each warp (rows at or past n held as 0 by the
// caller); red is kTiledWarps x D floats of shared memory.
template <int D>
__device__ __forceinline__ void add_column_sums(float* dbqkv, int col0, int d,
                                                const float (&acc)[D / 8][4], float* red,
                                                int warp, int lane) {
  const int t = lane & 3;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float v = acc[dt][e] + acc[dt][2 + e];
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      if (lane < 4) red[warp * D + 8 * dt + 2 * t + e] = v;
    }
  __syncthreads();
  for (int ch = threadIdx.x; ch < d; ch += kTiledThreads) {
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < kTiledWarps; ++w) v += red[w * D + ch];
    atomicAdd(&dbqkv[col0 + ch], v);
  }
}

// ---------------------------------------------------------------------------
// Forward: K1f's and K4f's attention launch
// ---------------------------------------------------------------------------

// One (window bw, head h, query tile q0) of the forward.
template <typename T, int D, typename P, typename L>
__device__ __forceinline__ void attention_tiled_fwd(
    const T* __restrict__ qkv, const float* __restrict__ bias, const int* __restrict__ ids,
    int ids_rows, T* __restrict__ ao, float* __restrict__ o32, float* __restrict__ stats,
    int n, int c, int heads, float scale, bool plain, const L& lay, long long bw, int h,
    int q0) {
  constexpr bool TC = kTensorCores<T>, PACKED = kPacked<L>;
  constexpr int LD = kLd<T, D>, NT = kTile / 8, DT = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);  // [kTile][LD] the block's queries
  T* kvs = qs + kTile * LD;                // [2 stages][K, V][kTile][LD]
  float* scratch = reinterpret_cast<float*>(kvs + 4 * kTile * LD);  // f32: [warps][16][kSp]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int d = c / heads;
  const long long c3 = 3LL * c;
  const T* head = qkv + bw * n * c3 + h * d;  // q of the window's token 0
  const auto at = lay.head(qkv, bw, h, n, c, d, heads);  // other layouts
  const int* id_row = lay.ids(ids, bw, ids_rows, n);
  const int i0 = q0 + 16 * warp + g, i1 = i0 + 8;  // this thread's rows
  const int id0 = id_row && i0 < n ? id_row[i0] : 0;
  const int id1 = id_row && i1 < n ? id_row[i1] : 0;
  const float* bias0 = bias && i0 < n ? bias_row(bias, h, n, i0) : nullptr;
  const float* bias1 = bias && i1 < n ? bias_row(bias, h, n, i1) : nullptr;
  float* sp = scratch + warp * 16 * kSp;

  if constexpr (PACKED) {
    stage_tile<T, D, P>(qs, head + q0 * c3, c3, min(kTile, n - q0), d, plain);
    stage_kv<T, D, P>(kvs, head, c3, c, n, 0, d, plain);  // one group with the queries
  } else {
    at.template stage_q<D, P>(qs, q0, min(kTile, n - q0), d, plain);
    at.template stage_kv<D, P>(kvs, n, 0, d, plain);
  }

  float m0 = P::kShift0, m1 = P::kShift0;  // the running shift
  float l0 = 0.f, l1 = 0.f;  // this thread's part of the running sums
  float o[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
  uint32_t qf[TC ? D / 16 : 1][4];

  const int ktiles = (n + kTile - 1) / kTile;
  for (int pass = 0; pass < kPasses<P>; ++pass) {
    if (pass) {  // kNormalized: 1 / the whole row sums, the key tiles again from tile 0
      l0 = 1.f / quad_sum(l0);
      l1 = 1.f / quad_sum(l1);
      if constexpr (PACKED)
        stage_kv<T, D, P>(kvs, head, c3, c, n, 0, d, plain);
      else
        at.template stage_kv<D, P>(kvs, n, 0, d, plain);
    }
    for (int kt = 0; kt < ktiles; ++kt) {
      const int k0 = kt * kTile, nk = min(kTile, n - k0);
      if (kt + 1 < ktiles) {  // the next tile's copy runs under this tile's products
        if constexpr (PACKED)
          stage_kv<T, D, P>(kvs, head, c3, c, n, kt + 1, d, plain);
        else
          at.template stage_kv<D, P>(kvs, n, kt + 1, d, plain);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const T* ks = kvs + (kt & 1) * 2 * kTile * LD;
      const T* vs = ks + kTile * LD;

      float s[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      if constexpr (TC) {
        if (kt == 0) {
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk) load_a<LD>(qf[kk], qs, 16 * warp, 16 * kk, lane);
        }
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
          for (int np = 0; np < NT / 2; ++np) {
            uint32_t b[4];
            load_b_nt<LD>(b, ks, 16 * np, 16 * kk, lane);
            mma_bf16(s[2 * np], qf[kk], b[0], b[1]);
            mma_bf16(s[2 * np + 1], qf[kk], b[2], b[3]);
          }
      } else {
        fma_nt<NT, D>(s, qs + 16 * warp * LD, ks, lane);
      }

      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = 8 * nt + 2 * t + e;
          if (j < nk) {
            s[nt][e] = P::score(s[nt][e], scale, id_row, id0, bias0, k0 + j);
            s[nt][2 + e] = P::score(s[nt][2 + e], scale, id_row, id1, bias1, k0 + j);
            mx0 = fmaxf(mx0, s[nt][e]);
            mx1 = fmaxf(mx1, s[nt][2 + e]);
          } else {  // the ragged tile's missing keys: p = 0
            s[nt][e] = s[nt][2 + e] = P::kProbs == Probs::kScaled ? 0.f : -INFINITY;
          }
        }
      if constexpr (P::kProbs == Probs::kScaled) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[nt][e] = P::scaled(s[nt][e]);
      } else if (pass == 0) {
        const float mn0 = fmaxf(m0, quad_max(mx0)), mn1 = fmaxf(m1, quad_max(mx1));
        // 1 while the max holds; 0 at K4's first tile (exp(-inf))
        const float alpha0 = expf(m0 - mn0), alpha1 = expf(m1 - mn1);
        m0 = mn0;
        m1 = mn1;
        float part0 = 0.f, part1 = 0.f;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            s[nt][e] = expf(s[nt][e] - mn0);
            s[nt][2 + e] = expf(s[nt][2 + e] - mn1);
            part0 += s[nt][e];
            part1 += s[nt][2 + e];
          }
        l0 = l0 * alpha0 + part0;
        l1 = l1 * alpha1 + part1;
#pragma unroll
        for (int dt = 0; dt < DT; ++dt) {
          o[dt][0] *= alpha0;
          o[dt][1] *= alpha0;
          o[dt][2] *= alpha1;
          o[dt][3] *= alpha1;
        }
      } else {  // kNormalized, second pass: p = exp(s - max) / sum before its
                // rounding, as exp(s - max) times 1 / sum (within an ulp)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            s[nt][e] = __fmul_rn(expf(s[nt][e] - m0), l0);
            s[nt][2 + e] = __fmul_rn(expf(s[nt][2 + e] - m1), l1);
          }
      }

      if (pass == kPasses<P> - 1) {
#pragma unroll
        for (int kc = 0; kc < kTile / 16; ++kc) {  // O += round_T(e) V, 16 keys a step
          if constexpr (TC) {
            uint32_t a[4];
            a_from_acc(a, s[2 * kc], s[2 * kc + 1]);
            mma_nn<D>(o, a, vs, 16 * kc, lane);
          } else {
            store_chunk(sp, s[2 * kc], s[2 * kc + 1], lane);
            __syncwarp();
            fma_nn<D, false>(o, sp, vs + 16 * kc * LD, lane);
            __syncwarp();
          }
        }
      }
      __syncthreads();  // every warp is done with this stage before it is refilled
    }
  }

  // O / (sum + eps) under the online form; the probes' O unscaled
  constexpr bool online = P::kProbs == Probs::kOnline;
  const float r0 = online ? 1.f / (quad_sum(l0) + P::kSumEps) : 1.f;
  const float r1 = online ? 1.f / (quad_sum(l1) + P::kSumEps) : 1.f;
  const long long base = bw * n;
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int ch = 8 * dt + 2 * t + e;
      if (ch >= d) continue;
      if (i0 < n) {
        long long to;
        if constexpr (PACKED)
          to = (base + i0) * c + h * d + ch;
        else
          to = at.out(i0) + ch;
        if constexpr (kGrouped<L>) {
          at.store(ao, to, o[dt][e] * r0);
        } else {
          ao[to] = from_f32<T>(o[dt][e] * r0);
          if (o32) o32[to] = o[dt][e] * r0;
        }
      }
      if (i1 < n) {
        long long to;
        if constexpr (PACKED)
          to = (base + i1) * c + h * d + ch;
        else
          to = at.out(i1) + ch;
        if constexpr (kGrouped<L>) {
          at.store(ao, to, o[dt][2 + e] * r1);
        } else {
          ao[to] = from_f32<T>(o[dt][2 + e] * r1);
          if (o32) o32[to] = o[dt][2 + e] * r1;
        }
      }
    }
  if (P::kKeepsStats && t == 0) {
    float* st = stats + ((bw * heads + h) * (long long)n) * 2;
    if (i0 < n) {
      st[2 * i0] = m0;
      st[2 * i0 + 1] = r0;
    }
    if (i1 < n) {
      st[2 * i1] = m1;
      st[2 * i1 + 1] = r1;
    }
  }
}

template <typename T, int D, typename P, typename L>
__global__ void __launch_bounds__(kTiledThreads, kFwdMinBlocks<T, D, L>) attention_tiled_mma_kernel(
    const T* __restrict__ qkv, const float* __restrict__ bias, const int* __restrict__ ids,
    int ids_rows, T* __restrict__ ao, float* __restrict__ o32, float* __restrict__ stats,
    int n, int c, int heads, float scale, bool plain, L lay) {
  const int qtiles = (n + kTile - 1) / kTile;
  const int q0 = (blockIdx.x % qtiles) * kTile;
  const int h = (blockIdx.x / qtiles) % heads;
  const long long bw = blockIdx.x / qtiles / heads;
  if constexpr (kGrouped<L>) {
    // the block's (head, query tile) of windows bw wb .. bw wb + wb - 1, in
    // turn: each window's last key tile ends on a barrier, after which its
    // staged tiles are free
    for (int slot = 0; slot < lay.wb; ++slot)
      attention_tiled_fwd<T, D, P>(qkv, bias, ids, ids_rows, ao, o32, stats, n, c, heads,
                                   scale, plain, lay, bw * lay.wb + slot, h, q0);
  } else {
    attention_tiled_fwd<T, D, P>(qkv, bias, ids, ids_rows, ao, o32, stats, n, c, heads, scale,
                                 plain, lay, bw, h, q0);
  }
}

template <typename T, int D>
constexpr size_t attention_tiled_fwd_smem() {
  return 5 * kTileBytes<T, D> + (kTensorCores<T> ? 0 : sizeof(float) * kTiledWarps * 16 * kSp);
}

// ---------------------------------------------------------------------------
// Backward phase A: query tiles -> dq, dbias, s1
// ---------------------------------------------------------------------------

template <typename T, int D, typename P, typename L>
__global__ void __launch_bounds__(kTiledThreads, kRowsMinBlocks<T, D, L>) attention_bwd_rows_mma_kernel(
    const T* __restrict__ qkv, const T* __restrict__ dao, const float* __restrict__ o,
    const float* __restrict__ stats, const float* __restrict__ bias,
    const int* __restrict__ ids, int ids_rows, T* __restrict__ dqkv,
    float* __restrict__ dbias, float* __restrict__ dbqkv, float* __restrict__ s1_out, int n,
    int c, int heads, float scale, bool plain, L lay) {
  constexpr bool TC = kTensorCores<T>, PACKED = kPacked<L>;
  constexpr int LD = kLd<T, D>, DT = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);  // [kTile][LD] the block's queries
  T* dos = qs + kTile * LD;                // [kTile][LD] their dO
  T* kvs = dos + kTile * LD;               // [2 stages][K, V][kTile][LD]
  float* scratch = reinterpret_cast<float*>(kvs + 4 * kTile * LD);  // f32: [warps][16][kSp]
  float* red = reinterpret_cast<float*>(kvs);  // [warps][D] after the last tile

  const int qtiles = (n + kTile - 1) / kTile;
  const int q0 = (blockIdx.x % qtiles) * kTile;
  const int h = (blockIdx.x / qtiles) % heads;
  const long long bw = blockIdx.x / qtiles / heads;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int d = c / heads;
  const long long c3 = 3LL * c, base = bw * n;
  const T* head = qkv + base * c3 + h * d;
  const auto at = lay.head(qkv, bw, h, n, c, d, heads);  // other layouts
  const int* id_row = lay.ids(ids, bw, ids_rows, n);
  const int i0 = q0 + 16 * warp + g, i1 = i0 + 8;
  const bool live0 = i0 < n, live1 = i1 < n;
  const int id0 = id_row && live0 ? id_row[i0] : 0;
  const int id1 = id_row && live1 ? id_row[i1] : 0;
  const float* bias0 = bias && live0 ? bias_row(bias, h, n, i0) : nullptr;
  const float* bias1 = bias && live1 ? bias_row(bias, h, n, i1) : nullptr;
  float* dbias0 = dbias && live0 ? bias_row(dbias, h, n, i0) : nullptr;
  float* dbias1 = dbias && live1 ? bias_row(dbias, h, n, i1) : nullptr;
  const long long srow = (bw * heads + h) * (long long)n;  // the head's first row statistics
  const float m0 = live0 ? stats[2 * (srow + i0)] : 0.f;
  const float rinv0 = live0 ? stats[2 * (srow + i0) + 1] : 0.f;
  const float m1 = live1 ? stats[2 * (srow + i1)] : 0.f;
  const float rinv1 = live1 ? stats[2 * (srow + i1) + 1] : 0.f;
  float* sp = scratch + warp * 16 * kSp;

  if constexpr (PACKED) {
    stage_tile<T, D, P>(qs, head + q0 * c3, c3, min(kTile, n - q0), d, plain);
    stage_tile<T, D, P>(dos, dao + (base + q0) * c + h * d, c, min(kTile, n - q0), d, plain);
    stage_kv<T, D, P>(kvs, head, c3, c, n, 0, d, plain);  // one group with Q and dO
  } else {
    at.template stage_q<D, P>(qs, q0, min(kTile, n - q0), d, plain);
    at.template stage_do<D, P>(dos, dao, q0, min(kTile, n - q0), d, plain);
    at.template stage_kv<D, P>(kvs, n, 0, d, plain);
  }

  float s1_0 = 0.f, s1_1 = 0.f;  // rowsum(p dp) = dO . o
  float dq[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) dq[dt][0] = dq[dt][1] = dq[dt][2] = dq[dt][3] = 0.f;
  uint32_t qf[TC ? D / 16 : 1][4], df[TC ? D / 16 : 1][4];

  const int ktiles = (n + kTile - 1) / kTile;
  for (int kt = 0; kt < ktiles; ++kt) {
    const int k0 = kt * kTile, nk = min(kTile, n - k0);
    if (kt + 1 < ktiles) {
      if constexpr (PACKED)
        stage_kv<T, D, P>(kvs, head, c3, c, n, kt + 1, d, plain);
      else
        at.template stage_kv<D, P>(kvs, n, kt + 1, d, plain);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (kt == 0) {
      // s1 of rows i0, i1: the FlashAttention identity on K1f's f32 o, each
      // lane of the quad a quarter of the channels, then across the quad
      const T* d0 = dos + (16 * warp + g) * LD;
      const T* d1 = d0 + 8 * LD;
      const float *o0, *o1;
      if constexpr (PACKED) {
        o0 = o + (base + i0) * c + h * d;
        o1 = o + (base + i1) * c + h * d;
      } else {
        o0 = o + at.out(i0);
        o1 = o + at.out(i1);
      }
      for (int ch = t; ch < d; ch += 4) {
        if (live0) s1_0 = fmaf(to_f32(d0[ch]), o0[ch], s1_0);
        if (live1) s1_1 = fmaf(to_f32(d1[ch]), o1[ch], s1_1);
      }
      s1_0 = quad_sum(s1_0);
      s1_1 = quad_sum(s1_1);
      if (t == 0) {
        if (live0) s1_out[srow + i0] = s1_0;
        if (live1) s1_out[srow + i1] = s1_1;
      }
      if constexpr (TC) {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          load_a<LD>(qf[kk], qs, 16 * warp, 16 * kk, lane);
          load_a<LD>(df[kk], dos, 16 * warp, 16 * kk, lane);
        }
      }
    }
    const T* ks = kvs + (kt & 1) * 2 * kTile * LD;
    const T* vs = ks + kTile * LD;

    for (int kc = 0; kc < kTile / 16; ++kc) {  // 16 keys a step
      if (16 * kc >= nk) break;  // the same for the whole block
      float sc[2][4] = {}, dp[2][4] = {};
      if constexpr (TC) {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          uint32_t b[4];
          load_b_nt<LD>(b, ks, 16 * kc, 16 * kk, lane);
          mma_bf16(sc[0], qf[kk], b[0], b[1]);
          mma_bf16(sc[1], qf[kk], b[2], b[3]);
          load_b_nt<LD>(b, vs, 16 * kc, 16 * kk, lane);
          mma_bf16(dp[0], df[kk], b[0], b[1]);
          mma_bf16(dp[1], df[kk], b[2], b[3]);
        }
      } else {
        fma_nt<2, D>(sc, qs + 16 * warp * LD, ks + 16 * kc * LD, lane);
        fma_nt<2, D>(dp, dos + 16 * warp * LD, vs + 16 * kc * LD, lane);
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = 16 * kc + 8 * nt + 2 * t + e, key = k0 + j;
          float ds0 = 0.f, ds1 = 0.f;
          if (j < nk) {
            if (live0) {
              const float p = kept_p(
                  P::score(sc[nt][e], scale, id_row, id0, bias0, key), m0, rinv0);
              ds0 = P::ds(p, dp[nt][e], s1_0);
              if (dbias0) atomicAdd(&dbias0[key], ds0);
            }
            if (live1) {
              const float p = kept_p(
                  P::score(sc[nt][2 + e], scale, id_row, id1, bias1, key), m1, rinv1);
              ds1 = P::ds(p, dp[nt][2 + e], s1_1);
              if (dbias1) atomicAdd(&dbias1[key], ds1);
            }
          }
          sc[nt][e] = ds0;
          sc[nt][2 + e] = ds1;
        }
      if constexpr (TC) {  // dq += round_T(ds) K
        uint32_t a[4];
        a_from_acc(a, sc[0], sc[1]);
        mma_nn<D>(dq, a, ks, 16 * kc, lane);
      } else {
        store_chunk(sp, sc[0], sc[1], lane);
        __syncwarp();
        fma_nn<D, false>(dq, sp, ks + 16 * kc * LD, lane);
        __syncwarp();
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[dt][e] = (e < 2 ? live0 : live1) ? dq[dt][e] * scale : 0.f;
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int ch = 8 * dt + 2 * t + e;
      if (ch >= d) continue;
      if constexpr (PACKED) {
        if (live0) dqkv[(base + i0) * c3 + h * d + ch] = from_f32<T>(dq[dt][e]);
        if (live1) dqkv[(base + i1) * c3 + h * d + ch] = from_f32<T>(dq[dt][2 + e]);
      } else {
        if (live0) dqkv[at.in(i0) + ch] = from_f32<T>(dq[dt][e]);
        if (live1) dqkv[at.in(i1) + ch] = from_f32<T>(dq[dt][2 + e]);
      }
    }
  if constexpr (P::kColumnSums)
    add_column_sums<D>(dbqkv, h * d, d, dq, red, warp, lane);  // the unrounded dq
}

template <typename T, int D>
constexpr size_t attention_bwd_rows_smem() {
  return 6 * kTileBytes<T, D> + (kTensorCores<T> ? 0 : sizeof(float) * kTiledWarps * 16 * kSp);
}

// ---------------------------------------------------------------------------
// Backward phase B: key tiles -> dk, dv
// ---------------------------------------------------------------------------

template <typename T, int D, typename P, typename L>
__global__ void __launch_bounds__(kTiledThreads, kTiledMinBlocks<T, D>) attention_bwd_keys_mma_kernel(
    const T* __restrict__ qkv, const T* __restrict__ dao, const float* __restrict__ stats,
    const float* __restrict__ s1, const float* __restrict__ bias,
    const int* __restrict__ ids, int ids_rows, T* __restrict__ dqkv,
    float* __restrict__ dbqkv, int n, int c, int heads, float scale, bool plain, L lay) {
  constexpr bool TC = kTensorCores<T>, PACKED = kPacked<L>;
  constexpr int LD = kLd<T, D>, DT = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);  // [kTile][LD] the block's keys
  T* vs = ks + kTile * LD;                 // [kTile][LD] their values
  T* qds = vs + kTile * LD;                // [2 stages][Q, dO][kTile][LD]
  float* sts = reinterpret_cast<float*>(qds + 4 * kTile * LD);  // [2 stages][kTile][3]
  float* scratch = sts + 2 * kTile * 3;    // f32: [warps][2][16][kSp]
  float* red = reinterpret_cast<float*>(qds);  // [warps][D] after the last tile

  const int ktiles = (n + kTile - 1) / kTile;
  const int k0 = (blockIdx.x % ktiles) * kTile;
  const int h = (blockIdx.x / ktiles) % heads;
  const long long bw = blockIdx.x / ktiles / heads;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int d = c / heads;
  const long long c3 = 3LL * c, base = bw * n;
  const T* head = qkv + base * c3 + h * d;
  const T* dhead = dao + base * c + h * d;
  const auto at = lay.head(qkv, bw, h, n, c, d, heads);  // other layouts
  const int* id_row = lay.ids(ids, bw, ids_rows, n);
  const long long srow = (bw * heads + h) * (long long)n;
  const int kw = 16 * warp;                  // the warp's first key in the tile
  const int j0 = k0 + kw + g, j1 = j0 + 8;   // this thread's key rows of dk, dv
  float* sp = scratch + warp * 2 * 16 * kSp;  // p, then ds

  if constexpr (PACKED) {
    stage_tile<T, D, P>(ks, head + k0 * c3 + c, c3, min(kTile, n - k0), d, plain);
    stage_tile<T, D, P>(vs, head + k0 * c3 + 2 * c, c3, min(kTile, n - k0), d, plain);
    stage_tile<T, D, P>(qds, head, c3, min(kTile, n), d, plain);
    stage_tile<T, D, P>(qds + kTile * LD, dhead, c, min(kTile, n), d, plain);
  } else {
    at.template stage_keys<D, P>(ks, vs, k0, min(kTile, n - k0), d, plain);
    at.template stage_q_do<D, P>(qds, qds + kTile * LD, dao, 0, min(kTile, n), d, plain);
  }
  cp_async_commit();
  for (int e = threadIdx.x; e < kTile; e += kTiledThreads) {
    const bool ok = e < n;
    sts[3 * e] = ok ? stats[2 * (srow + e)] : 0.f;
    sts[3 * e + 1] = ok ? stats[2 * (srow + e) + 1] : 0.f;
    sts[3 * e + 2] = ok ? s1[srow + e] : 0.f;
  }

  float dk[DT][4], dv[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[dt][e] = dv[dt][e] = 0.f;

  const int qtiles = (n + kTile - 1) / kTile;
  for (int qt = 0; qt < qtiles; ++qt) {
    const int q0 = qt * kTile, nq = min(kTile, n - q0);
    if (qt + 1 < qtiles) {
      const int q1 = q0 + kTile, nq1 = min(kTile, n - q1);
      T* next = qds + ((qt + 1) & 1) * 2 * kTile * LD;
      if constexpr (PACKED) {
        stage_tile<T, D, P>(next, head + q1 * c3, c3, nq1, d, plain);
        stage_tile<T, D, P>(next + kTile * LD, dhead + q1 * c, c, nq1, d, plain);
      } else {
        at.template stage_q_do<D, P>(next, next + kTile * LD, dao, q1, nq1, d, plain);
      }
      cp_async_commit();
      float* st = sts + ((qt + 1) & 1) * kTile * 3;
      for (int e = threadIdx.x; e < kTile; e += kTiledThreads) {
        const bool ok = e < nq1;
        st[3 * e] = ok ? stats[2 * (srow + q1 + e)] : 0.f;
        st[3 * e + 1] = ok ? stats[2 * (srow + q1 + e) + 1] : 0.f;
        st[3 * e + 2] = ok ? s1[srow + q1 + e] : 0.f;
      }
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* qs = qds + (qt & 1) * 2 * kTile * LD;
    const T* dos = qs + kTile * LD;
    const float* st = sts + (qt & 1) * kTile * 3;

    for (int mi = 0; mi < kTile / 16; ++mi) {  // 16 queries a step
      if (16 * mi >= nq) break;  // the same for the whole block
      // S and dp of queries 16 mi.. against the warp's 16 keys: phase A's
      // products, rows = queries
      float sc[2][4] = {}, dp[2][4] = {};
      if constexpr (TC) {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          uint32_t a[4], b[4];
          load_a<LD>(a, qs, 16 * mi, 16 * kk, lane);
          load_b_nt<LD>(b, ks, kw, 16 * kk, lane);
          mma_bf16(sc[0], a, b[0], b[1]);
          mma_bf16(sc[1], a, b[2], b[3]);
          load_a<LD>(a, dos, 16 * mi, 16 * kk, lane);
          load_b_nt<LD>(b, vs, kw, 16 * kk, lane);
          mma_bf16(dp[0], a, b[0], b[1]);
          mma_bf16(dp[1], a, b[2], b[3]);
        }
      } else {
        fma_nt<2, D>(sc, qs + 16 * mi * LD, ks + kw * LD, lane);
        fma_nt<2, D>(dp, dos + 16 * mi * LD, vs + kw * LD, lane);
      }
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {  // query rows g, g + 8 of the step
        const int il = 16 * mi + g + 8 * hr, i = q0 + il;
        const bool live = il < nq;
        const float* sti = st + 3 * il;
        const int id_i = id_row && live ? id_row[i] : 0;
        const float* bias_i = bias && live ? bias_row(bias, h, n, i) : nullptr;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int key = k0 + kw + 8 * nt + 2 * t + e;
            float p = 0.f, ds = 0.f;
            if (live && key < n) {  // phase B's p from the kept statistics
              p = kept_p(P::score(sc[nt][2 * hr + e], scale, id_row, id_i, bias_i, key),
                         sti[0], sti[1]);
              ds = P::ds(p, dp[nt][2 * hr + e], sti[2]);
            }
            sc[nt][2 * hr + e] = p;
            dp[nt][2 * hr + e] = ds;
          }
      }
      if constexpr (TC) {  // dv += round_T(p)^T dO, dk += round_T(ds)^T Q
        uint32_t a[4];
        a_from_acc_t(a, sc[0], sc[1]);
        mma_nn<D>(dv, a, dos, 16 * mi, lane);
        a_from_acc_t(a, dp[0], dp[1]);
        mma_nn<D>(dk, a, qs, 16 * mi, lane);
      } else {
        store_chunk(sp, sc[0], sc[1], lane);
        store_chunk(sp + 16 * kSp, dp[0], dp[1], lane);
        __syncwarp();
        fma_nn<D, true>(dv, sp, dos + 16 * mi * LD, lane);
        fma_nn<D, true>(dk, sp + 16 * kSp, qs + 16 * mi * LD, lane);
        __syncwarp();
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  const bool live0 = j0 < n, live1 = j1 < n;
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool live = e < 2 ? live0 : live1;
      dk[dt][e] = live ? dk[dt][e] * scale : 0.f;
      dv[dt][e] = live ? dv[dt][e] : 0.f;
    }
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int ch = 8 * dt + 2 * t + e;
      if (ch >= d) continue;
      if constexpr (PACKED) {
        if (live0) {
          T* row = dqkv + (base + j0) * c3 + h * d + ch;
          row[c] = from_f32<T>(dk[dt][e]);
          row[2 * c] = from_f32<T>(dv[dt][e]);
        }
        if (live1) {
          T* row = dqkv + (base + j1) * c3 + h * d + ch;
          row[c] = from_f32<T>(dk[dt][2 + e]);
          row[2 * c] = from_f32<T>(dv[dt][2 + e]);
        }
      } else {
        if (live0) at.store_dkv(dqkv, j0, ch, from_f32<T>(dk[dt][e]), from_f32<T>(dv[dt][e]));
        if (live1)
          at.store_dkv(dqkv, j1, ch, from_f32<T>(dk[dt][2 + e]), from_f32<T>(dv[dt][2 + e]));
      }
    }
  if constexpr (P::kColumnSums) {
    add_column_sums<D>(dbqkv, c + h * d, d, dk, red, warp, lane);  // the unrounded dk, dv
    __syncthreads();
    add_column_sums<D>(dbqkv, 2 * c + h * d, d, dv, red, warp, lane);
  }
}

template <typename T, int D>
constexpr size_t attention_bwd_keys_smem() {
  return 6 * kTileBytes<T, D> + sizeof(float) * 2 * kTile * 3 +
         (kTensorCores<T> ? 0 : sizeof(float) * kTiledWarps * 2 * 16 * kSp);
}

// ---------------------------------------------------------------------------
// Head dims above 128: the head dim in slabs
// ---------------------------------------------------------------------------
//
// Above 128 a head's accumulators (o; dq; dk and dv) no longer fit in a
// thread's registers beside S, nor its Q, K and V tiles in shared memory. So
// the slab kernels take the head dim in slabs of kSlab<T> channels (128 in
// bf16, 64 in f32), one block per (window, head, tile, output slab; and in
// phase B, dk or dv):
//   - the sums over d (S = Q K^T, dp = dO V^T) walk every slab, slabs outer
//     and 16-channel steps (f32: channels) inner, in one order in the
//     forward and both phases, so phases A and B rebuild the forward's p and
//     ds bit for bit, as the body above does;
//   - each block writes its output slab's channels of o (dq; dk, dv) and
//     their column sums (dbqkv);
//   - what is once per (window, head, tile), the row statistics (forward),
//     s1 and dbias's atomics (phase A), only slab 0's block writes.
// Each step stages one slab of the sums' operands (Q and K; and dO and V)
// into a ring of two stages, the next step's copy under this one's
// products, by cp.async or, where ``plain`` asks, plain loads; the output
// slab's tile (the forward's V, phase A's K, phase B's dO or Q) comes once
// for the step's rows. Q (and dO) are staged again for every key step: they
// are not held in registers or whole in shared memory. Every slab's block
// forms S anew, ceil(d / kSlab) times the products that one block a tile
// would form (phase B's dk and dv blocks once more): the price of d up to
// 8192 in one body. Only the online softmax (K1's and K4's policies) runs
// here; the probes stop at 64.
template <typename T>
constexpr int kSlab = kTensorCores<T> ? 128 : 64;
// Phase A's keys and phase B's queries a step: S and dp of a whole 64-row
// tile, held in registers beside dq (dk and dv) across the slabs, spilled
// at 255 registers. The output slab's tile of a step's rows is staged once
// per rows, with their second step (slabs >= 2: d > 128 >= kSlab) into one
// buffer, so that two blocks fit an SM's shared memory in bf16.
constexpr int kSlabStep = 32;

// Phase A's keys a step on layout L: kSlabStep, but 16 where a layout's
// phase A spills at 255 registers with 32 (``kSlabRowsSpill``, which the
// layout sets; window_attention_qkv.cu).
template <typename L, typename T>
constexpr bool kSlabRowsSpill = false;
template <typename T, typename L>
constexpr int kSlabKeys = kSlabRowsSpill<L, T> ? 16 : kSlabStep;

// Packed's head rows for the slab kernels (the other layouts' ``Head`` give
// the same members): q_row, k_row, v_row(t) point at token t's channel 0 of
// the head in q, k and v; out(t) is its element offset in out, o32, o and dO,
// in(t) in dqkv (dq); store_kv writes a channel of dk or dv.
template <typename T>
struct PackedRows {
  const T* head;       // q of the window's token 0, head h
  long long c3, base;  // 3C; the window's first row
  int c, hd;           // C; h d

  __device__ __forceinline__ const T* q_row(int t) const { return head + t * c3; }
  __device__ __forceinline__ const T* k_row(int t) const { return q_row(t) + c; }
  __device__ __forceinline__ const T* v_row(int t) const { return q_row(t) + 2 * c; }
  __device__ __forceinline__ long long out(int t) const { return (base + t) * c + hd; }
  __device__ __forceinline__ long long in(int t) const { return (base + t) * c3 + hd; }
  // channel ch of token t's dk (part 1) or dv (part 2)
  __device__ __forceinline__ void store_kv(T* dqkv, int part, int t, int ch, T v) const {
    dqkv[in(t) + part * c + ch] = v;
  }
};

// The rows of (window bw, head h) on layout L.
template <typename T, typename L>
__device__ __forceinline__ auto slab_rows(const L& lay, const T* qkv, long long bw, int h, int n,
                                          int c, int d, int heads) {
  if constexpr (kPacked<L>)
    return PackedRows<T>{qkv + bw * n * 3LL * c + h * d, 3LL * c, bw * n, c, h * d};
  else
    return lay.head(qkv, bw, h, n, c, d, heads);
}

// Copy channels [c0, c0 + dsl) of tokens t0 .. t0 + nrows - 1 of an operand
// (``row(t)``: token t's channel 0) into a staged [R][SD] tile; the tile's
// other rows and channels are zero-filled, as stage_tile fills them, by
// 16-byte cp.async copies or by plain loads.
template <typename T, int SD, typename P, int R = kTile, typename Row>
__device__ __forceinline__ void stage_slab(T* dst, const Row& row, int t0, int nrows, int c0,
                                           int dsl, bool plain) {
  constexpr int E = 16 / (int)sizeof(T), CPR = SD / E, LD = kLd<T, SD>;
  if (kPlainOnly<P> || (P::kPlainLoads && plain)) {
    for (int e = threadIdx.x; e < R * SD; e += kTiledThreads) {
      const int r = e / SD, ch = e % SD;
      dst[r * LD + ch] = r < nrows && ch < dsl ? row(t0 + r)[c0 + ch] : from_f32<T>(0.f);
    }
    return;
  }
  for (int e = threadIdx.x; e < R * CPR; e += kTiledThreads) {
    const int r = e / CPR, cc = e % CPR;
    const bool ok = r < nrows && cc * E < dsl;
    cp_async16(dst + r * LD + cc * E, ok ? row(t0 + r) + c0 + cc * E : row(t0), ok);
  }
}

// One key tile's online softmax step on S (``s``, the fragment layout of
// rows i0 = row0 g, i1 = i0 + 8 of a warp): score, the running shift m and
// sum l, e = exp(s - m) in place, o rescaled when m grows. As the forward
// above forms it (``Probs::kOnline``).
template <typename P, int NT, int DT>
__device__ __forceinline__ void online_step(float (&s)[NT][4], float (&o)[DT][4], float& m0,
                                            float& m1, float& l0, float& l1, int nk, int k0,
                                            float scale, const int* id_row, int id0, int id1,
                                            const float* bias0, const float* bias1, int t) {
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int j = 8 * nt + 2 * t + e;
      if (j < nk) {
        s[nt][e] = P::score(s[nt][e], scale, id_row, id0, bias0, k0 + j);
        s[nt][2 + e] = P::score(s[nt][2 + e], scale, id_row, id1, bias1, k0 + j);
        mx0 = fmaxf(mx0, s[nt][e]);
        mx1 = fmaxf(mx1, s[nt][2 + e]);
      } else {  // the ragged tile's missing keys: p = 0
        s[nt][e] = s[nt][2 + e] = -INFINITY;
      }
    }
  const float mn0 = fmaxf(m0, quad_max(mx0)), mn1 = fmaxf(m1, quad_max(mx1));
  const float alpha0 = expf(m0 - mn0);  // 1 while the max holds
  const float alpha1 = expf(m1 - mn1);
  m0 = mn0;
  m1 = mn1;
  float part0 = 0.f, part1 = 0.f;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      s[nt][e] = expf(s[nt][e] - mn0);
      s[nt][2 + e] = expf(s[nt][2 + e] - mn1);
      part0 += s[nt][e];
      part1 += s[nt][2 + e];
    }
  l0 = alpha0 * l0 + part0;
  l1 = alpha1 * l1 + part1;
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
    o[dt][0] *= alpha0;
    o[dt][1] *= alpha0;
    o[dt][2] *= alpha1;
    o[dt][3] *= alpha1;
  }
}

// acc[NT] += X Y^T over one staged slab: X's 16 rows from row x0 of xs, Y's
// 8 NT rows from row y0 of ys, the slab's channels in order (bf16: 16 a
// step; f32: one FMA chain).
template <typename T, int NT>
__device__ __forceinline__ void slab_nt(float (&acc)[NT][4], const T* xs, int x0, const T* ys,
                                        int y0, int lane) {
  constexpr int SD = kSlab<T>, LD = kLd<T, SD>;
  if constexpr (kTensorCores<T>) {
#pragma unroll
    for (int kk = 0; kk < SD / 16; ++kk) {
      uint32_t a[4];
      load_a<LD>(a, xs, x0, 16 * kk, lane);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t b[4];
        load_b_nt<LD>(b, ys, y0 + 16 * np, 16 * kk, lane);
        mma_bf16(acc[2 * np], a, b[0], b[1]);
        mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
      }
    }
  } else {
    fma_nt<NT, SD>(acc, xs + x0 * LD, ys + y0 * LD, lane);
  }
}

// acc += P Y over 16 depth rows from row0 of a staged slab Y: P the [16 x 16]
// chunk whose accumulators are v0, v1 (or its transpose, PT), rounded to T
// (bf16: in registers; f32: through the warp's scratch sp).
template <typename T, bool PT, int DT>
__device__ __forceinline__ void slab_nn(float (&acc)[DT][4], const float (&v0)[4],
                                        const float (&v1)[4], const T* ys, int row0, float* sp,
                                        int lane) {
  constexpr int SD = kSlab<T>;
  if constexpr (kTensorCores<T>) {
    uint32_t a[4];
    if constexpr (PT)
      a_from_acc_t(a, v0, v1);
    else
      a_from_acc(a, v0, v1);
    mma_nn<SD>(acc, a, ys, row0, lane);
  } else {
    store_chunk(sp, v0, v1, lane);
    __syncwarp();
    fma_nn<SD, PT>(acc, sp, ys + row0 * kLd<T, SD>, lane);
    __syncwarp();
  }
}

// The block's (window, head, tile, output slab) from blockIdx.x, slabs
// innermost: the blocks of one tile run side by side and share its rows in
// L2.
struct SlabBlock {
  long long bw;
  int h, r0, so;
};

__device__ __forceinline__ SlabBlock slab_block(int n, int heads, int slabs) {
  const int tiles = (n + kTile - 1) / kTile;
  const long long tile = blockIdx.x / slabs;
  return {tile / tiles / heads, (int)(tile / tiles % heads), (int)(tile % tiles) * kTile,
          (int)(blockIdx.x % slabs)};
}

// The forward on slabs: K1f's and K4f's attention launch at head dims above
// 128, with ``attention_tiled_fwd``'s outputs.
template <typename T, typename P, typename L>
__global__ void __launch_bounds__(kTiledThreads, 1) attention_slab_fwd_kernel(
    const T* __restrict__ qkv, const float* __restrict__ bias, const int* __restrict__ ids,
    int ids_rows, T* __restrict__ ao, float* __restrict__ o32, float* __restrict__ stats,
    int n, int c, int heads, float scale, bool plain, L lay) {
  static_assert(P::kProbs == Probs::kOnline, "the slab kernels take the online softmax");
  constexpr int SD = kSlab<T>, LD = kLd<T, SD>, NT = kTile / 8, DT = SD / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);  // [2 stages][Q, K][kTile][LD], one slab
  T* vring = ring + 4 * kTile * LD;          // [2][kTile][LD], V's output slab
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float* sp = reinterpret_cast<float*>(vring + 2 * kTile * LD) + warp * 16 * kSp;  // f32

  const int d = c / heads, slabs = (d + SD - 1) / SD;
  const SlabBlock blk = slab_block(n, heads, slabs);
  const long long bw = blk.bw;
  const int h = blk.h, q0 = blk.r0, nq = min(kTile, n - q0);
  const int co = blk.so * SD, dso = min(SD, d - co);  // the output slab's channels
  const auto rows = slab_rows<T>(lay, qkv, bw, h, n, c, d, heads);
  const auto q_row = [&](int r) { return rows.q_row(r); };
  const auto k_row = [&](int r) { return rows.k_row(r); };
  const auto v_row = [&](int r) { return rows.v_row(r); };
  const int* id_row = lay.ids(ids, bw, ids_rows, n);
  const int i0 = q0 + 16 * warp + g, i1 = i0 + 8;  // this thread's rows
  const int id0 = id_row && i0 < n ? id_row[i0] : 0;
  const int id1 = id_row && i1 < n ? id_row[i1] : 0;
  const float* bias0 = bias && i0 < n ? bias_row(bias, h, n, i0) : nullptr;
  const float* bias1 = bias && i1 < n ? bias_row(bias, h, n, i1) : nullptr;

  const int steps = (n + kTile - 1) / kTile * slabs;  // (key tile, slab), slabs inner
  const auto stage = [&](int step) {
    const int kt = step / slabs, sl = step % slabs, k0 = kt * kTile;
    const int nk = min(kTile, n - k0), c0 = sl * SD, dsl = min(SD, d - c0);
    T* st = ring + (step & 1) * 2 * kTile * LD;
    stage_slab<T, SD, P>(st, q_row, q0, nq, c0, dsl, plain);
    stage_slab<T, SD, P>(st + kTile * LD, k_row, k0, nk, c0, dsl, plain);
    if (sl == 0) stage_slab<T, SD, P>(vring + (kt & 1) * kTile * LD, v_row, k0, nk, co, dso, plain);
    cp_async_commit();
  };

  float m0 = P::kShift0, m1 = P::kShift0, l0 = 0.f, l1 = 0.f;
  float o[DT][4], s[NT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
  stage(0);
  for (int step = 0; step < steps; ++step) {
    const int kt = step / slabs, sl = step % slabs, k0 = kt * kTile;
    if (step + 1 < steps) {
      stage(step + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (sl == 0) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
    }
    const T* qs = ring + (step & 1) * 2 * kTile * LD;
    slab_nt<T>(s, qs, 16 * warp, qs + kTile * LD, 0, lane);  // S += Q K^T, one slab
    if (sl == slabs - 1) {
      online_step<P>(s, o, m0, m1, l0, l1, min(kTile, n - k0), k0, scale, id_row, id0, id1,
                     bias0, bias1, t);
      const T* vs = vring + (kt & 1) * kTile * LD;
#pragma unroll
      for (int kc = 0; kc < kTile / 16; ++kc)  // O += round_T(e) V, 16 keys a step
        slab_nn<T, false>(o, s[2 * kc], s[2 * kc + 1], vs, 16 * kc, sp, lane);
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  const float r0 = 1.f / (quad_sum(l0) + P::kSumEps);
  const float r1 = 1.f / (quad_sum(l1) + P::kSumEps);
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int ch = 8 * dt + 2 * t + e;
      if (ch >= dso) continue;
      if (i0 < n) {
        const long long to = rows.out(i0) + co + ch;
        ao[to] = from_f32<T>(o[dt][e] * r0);
        if (o32) o32[to] = o[dt][e] * r0;
      }
      if (i1 < n) {
        const long long to = rows.out(i1) + co + ch;
        ao[to] = from_f32<T>(o[dt][2 + e] * r1);
        if (o32) o32[to] = o[dt][2 + e] * r1;
      }
    }
  if (P::kKeepsStats && blk.so == 0 && t == 0) {  // once per (window, head, tile)
    float* st = stats + ((bw * heads + h) * (long long)n) * 2;
    if (i0 < n) {
      st[2 * i0] = m0;
      st[2 * i0 + 1] = r0;
    }
    if (i1 < n) {
      st[2 * i1] = m1;
      st[2 * i1 + 1] = r1;
    }
  }
}

template <typename T>
constexpr size_t attention_slab_fwd_smem() {
  return 6 * kTileBytes<T, kSlab<T>> +
         (kTensorCores<T> ? 0 : sizeof(float) * kTiledWarps * 16 * kSp);
}

// Phase A on slabs: dq's output slab, and (slab 0's block) s1 and dbias;
// kSlabKeys keys a step.
template <typename T, typename P, typename L>
__global__ void __launch_bounds__(kTiledThreads, 1) attention_slab_rows_kernel(
    const T* __restrict__ qkv, const T* __restrict__ dao, const float* __restrict__ o,
    const float* __restrict__ stats, const float* __restrict__ bias,
    const int* __restrict__ ids, int ids_rows, T* __restrict__ dqkv,
    float* __restrict__ dbias, float* __restrict__ dbqkv, float* __restrict__ s1_out, int n,
    int c, int heads, float scale, bool plain, L lay) {
  constexpr int SD = kSlab<T>, LD = kLd<T, SD>, KS = kSlabKeys<T, L>, NT = KS / 8, DT = SD / 8;
  constexpr int kStage = (2 * kTile + 2 * KS) * LD;  // Q, dO [kTile]; K, V [KS]
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);  // [2 stages][kStage], one slab
  T* ks = ring + 2 * kStage;                 // [KS][LD], K's output slab
  float* red = reinterpret_cast<float*>(ring);  // [warps][SD] after the last step
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float* sp = reinterpret_cast<float*>(ks + KS * LD) + warp * 16 * kSp;  // f32

  const int d = c / heads, slabs = (d + SD - 1) / SD;
  const SlabBlock blk = slab_block(n, heads, slabs);
  const long long bw = blk.bw;
  const int h = blk.h, q0 = blk.r0, nq = min(kTile, n - q0);
  const int co = blk.so * SD, dso = min(SD, d - co);
  const auto rows = slab_rows<T>(lay, qkv, bw, h, n, c, d, heads);
  const auto q_row = [&](int r) { return rows.q_row(r); };
  const auto k_row = [&](int r) { return rows.k_row(r); };
  const auto v_row = [&](int r) { return rows.v_row(r); };
  const auto do_row = [&](int r) { return dao + rows.out(r); };
  const int* id_row = lay.ids(ids, bw, ids_rows, n);
  const int i0 = q0 + 16 * warp + g, i1 = i0 + 8;
  const bool live0 = i0 < n, live1 = i1 < n;
  const int id0 = id_row && live0 ? id_row[i0] : 0;
  const int id1 = id_row && live1 ? id_row[i1] : 0;
  const float* bias0 = bias && live0 ? bias_row(bias, h, n, i0) : nullptr;
  const float* bias1 = bias && live1 ? bias_row(bias, h, n, i1) : nullptr;
  const bool adds_dbias = dbias && blk.so == 0;  // once per (window, head, tile), not per slab
  float* dbias0 = adds_dbias && live0 ? bias_row(dbias, h, n, i0) : nullptr;
  float* dbias1 = adds_dbias && live1 ? bias_row(dbias, h, n, i1) : nullptr;
  const long long srow = (bw * heads + h) * (long long)n;
  const float m0 = live0 ? stats[2 * (srow + i0)] : 0.f;
  const float rinv0 = live0 ? stats[2 * (srow + i0) + 1] : 0.f;
  const float m1 = live1 ? stats[2 * (srow + i1)] : 0.f;
  const float rinv1 = live1 ? stats[2 * (srow + i1) + 1] : 0.f;

  const int steps = (n + KS - 1) / KS * slabs;  // (KS keys, slab), slabs inner
  const auto stage = [&](int step) {
    const int u = step / slabs, sl = step % slabs, k0 = u * KS;
    const int nk = min(KS, n - k0), c0 = sl * SD, dsl = min(SD, d - c0);
    T* st = ring + (step & 1) * kStage;
    stage_slab<T, SD, P>(st, q_row, q0, nq, c0, dsl, plain);
    stage_slab<T, SD, P>(st + kTile * LD, do_row, q0, nq, c0, dsl, plain);
    stage_slab<T, SD, P, KS>(st + 2 * kTile * LD, k_row, k0, nk, c0, dsl, plain);
    stage_slab<T, SD, P, KS>(st + (2 * kTile + KS) * LD, v_row, k0, nk, c0, dsl, plain);
    if (sl == 1) stage_slab<T, SD, P, KS>(ks, k_row, k0, nk, co, dso, plain);
    cp_async_commit();
  };
  stage(0);

  // s1 of rows i0, i1: dO . o over the whole head (each lane of the quad a
  // quarter of the channels, then across the quad), in every slab's block
  float s1_0 = 0.f, s1_1 = 0.f;
  for (int ch = t; ch < d; ch += 4) {
    if (live0) s1_0 = fmaf(to_f32(dao[rows.out(i0) + ch]), o[rows.out(i0) + ch], s1_0);
    if (live1) s1_1 = fmaf(to_f32(dao[rows.out(i1) + ch]), o[rows.out(i1) + ch], s1_1);
  }
  s1_0 = quad_sum(s1_0);
  s1_1 = quad_sum(s1_1);
  if (blk.so == 0 && t == 0) {
    if (live0) s1_out[srow + i0] = s1_0;
    if (live1) s1_out[srow + i1] = s1_1;
  }

  float dq[DT][4], sc[NT][4], dp[NT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) dq[dt][0] = dq[dt][1] = dq[dt][2] = dq[dt][3] = 0.f;
  for (int step = 0; step < steps; ++step) {
    const int u = step / slabs, sl = step % slabs, k0 = u * KS, nk = min(KS, n - k0);
    if (step + 1 < steps) {
      stage(step + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (sl == 0) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[nt][e] = dp[nt][e] = 0.f;
    }
    const T* st = ring + (step & 1) * kStage;
    slab_nt<T>(sc, st, 16 * warp, st + 2 * kTile * LD, 0, lane);                     // S
    slab_nt<T>(dp, st + kTile * LD, 16 * warp, st + (2 * kTile + KS) * LD, 0, lane);  // dO V^T
    if (sl == slabs - 1) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = 8 * nt + 2 * t + e, key = k0 + j;
          float ds0 = 0.f, ds1 = 0.f;
          if (j < nk) {
            if (live0) {
              const float p = kept_p(P::score(sc[nt][e], scale, id_row, id0, bias0, key), m0,
                                     rinv0);
              ds0 = P::ds(p, dp[nt][e], s1_0);
              if (dbias0) atomicAdd(&dbias0[key], ds0);
            }
            if (live1) {
              const float p = kept_p(P::score(sc[nt][2 + e], scale, id_row, id1, bias1, key),
                                     m1, rinv1);
              ds1 = P::ds(p, dp[nt][2 + e], s1_1);
              if (dbias1) atomicAdd(&dbias1[key], ds1);
            }
          }
          sc[nt][e] = ds0;
          sc[nt][2 + e] = ds1;
        }
#pragma unroll
      for (int kc = 0; kc < KS / 16; ++kc)  // dq += round_T(ds) K, 16 keys a step
        if (16 * kc < nk) slab_nn<T, false>(dq, sc[2 * kc], sc[2 * kc + 1], ks, 16 * kc, sp, lane);
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[dt][e] = (e < 2 ? live0 : live1) ? dq[dt][e] * scale : 0.f;
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int ch = 8 * dt + 2 * t + e;
      if (ch >= dso) continue;
      if (live0) dqkv[rows.in(i0) + co + ch] = from_f32<T>(dq[dt][e]);
      if (live1) dqkv[rows.in(i1) + co + ch] = from_f32<T>(dq[dt][2 + e]);
    }
  if constexpr (P::kColumnSums)
    add_column_sums<SD>(dbqkv, h * d + co, dso, dq, red, warp, lane);  // the unrounded dq
}

template <typename T, typename L>
constexpr size_t attention_slab_rows_smem() {
  return sizeof(T) * (4 * kTile + 5 * kSlabKeys<T, L>) * kLd<T, kSlab<T>> +
         (kTensorCores<T> ? 0 : sizeof(float) * kTiledWarps * 16 * kSp);
}

// Phase B on slabs: a block per (window, head, tile of 64 keys, output
// slab, dk or dv), kSlabStep queries a step. dv = p^T dO takes S alone;
// dk = scale ds^T Q takes S and dp = dO V^T. One of them a block keeps 64
// accumulators a thread where both spilled at 255 registers; the price is
// S formed once more.
template <typename T, typename P, typename L>
__global__ void __launch_bounds__(kTiledThreads, 1) attention_slab_keys_kernel(
    const T* __restrict__ qkv, const T* __restrict__ dao, const float* __restrict__ stats,
    const float* __restrict__ s1, const float* __restrict__ bias,
    const int* __restrict__ ids, int ids_rows, T* __restrict__ dqkv,
    float* __restrict__ dbqkv, int n, int c, int heads, float scale, bool plain, L lay) {
  constexpr int SD = kSlab<T>, LD = kLd<T, SD>, DT = SD / 8, QS = kSlabStep, MI = QS / 16;
  constexpr int kStage = (2 * QS + 2 * kTile) * LD;  // Q, dO [QS]; K, V [kTile]
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);  // [2 stages][kStage], one slab
  T* y = ring + 2 * kStage;                  // [QS][LD]: dO's (dv) or Q's (dk) output slab
  float* sts = reinterpret_cast<float*>(y + QS * LD);  // [QS][3]: the rows' statistics, s1
  float* red = reinterpret_cast<float*>(ring);  // [warps][SD] after the last step
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float* sp = sts + QS * 3 + warp * 16 * kSp;  // f32: p or ds

  const int d = c / heads, slabs = (d + SD - 1) / SD;
  const SlabBlock blk = slab_block(n, heads, 2 * slabs);
  const bool dk_block = blk.so & 1;  // else dv
  const long long bw = blk.bw;
  const int h = blk.h, k0 = blk.r0, nk = min(kTile, n - k0);
  const int co = (blk.so >> 1) * SD, dso = min(SD, d - co);
  const auto rows = slab_rows<T>(lay, qkv, bw, h, n, c, d, heads);
  const auto q_row = [&](int r) { return rows.q_row(r); };
  const auto k_row = [&](int r) { return rows.k_row(r); };
  const auto v_row = [&](int r) { return rows.v_row(r); };
  const auto do_row = [&](int r) { return dao + rows.out(r); };
  const int* id_row = lay.ids(ids, bw, ids_rows, n);
  const long long srow = (bw * heads + h) * (long long)n;
  const int kw = 16 * warp;                 // the warp's first key in the tile
  const int j0 = k0 + kw + g, j1 = j0 + 8;  // this thread's key rows of dk or dv

  const int steps = (n + QS - 1) / QS * slabs;  // (QS queries, slab), slabs inner
  const auto stage = [&](int step) {
    const int u = step / slabs, sl = step % slabs, q0 = u * QS;
    const int nq = min(QS, n - q0), c0 = sl * SD, dsl = min(SD, d - c0);
    T* st = ring + (step & 1) * kStage;
    stage_slab<T, SD, P, QS>(st, q_row, q0, nq, c0, dsl, plain);
    stage_slab<T, SD, P>(st + 2 * QS * LD, k_row, k0, nk, c0, dsl, plain);
    if (dk_block) {
      stage_slab<T, SD, P, QS>(st + QS * LD, do_row, q0, nq, c0, dsl, plain);
      stage_slab<T, SD, P>(st + (2 * QS + kTile) * LD, v_row, k0, nk, c0, dsl, plain);
    }
    if (sl == 1) {
      if (dk_block)
        stage_slab<T, SD, P, QS>(y, q_row, q0, nq, co, dso, plain);
      else
        stage_slab<T, SD, P, QS>(y, do_row, q0, nq, co, dso, plain);
      for (int e = threadIdx.x; e < QS; e += kTiledThreads) {
        const bool ok = e < nq;
        sts[3 * e] = ok ? stats[2 * (srow + q0 + e)] : 0.f;
        sts[3 * e + 1] = ok ? stats[2 * (srow + q0 + e) + 1] : 0.f;
        sts[3 * e + 2] = ok ? s1[srow + q0 + e] : 0.f;
      }
    }
    cp_async_commit();
  };

  float acc[DT][4], sc[MI][2][4], dp[MI][2][4];  // acc: dk or dv
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  stage(0);
  for (int step = 0; step < steps; ++step) {
    const int u = step / slabs, sl = step % slabs, q0 = u * QS, nq = min(QS, n - q0);
    if (step + 1 < steps) {
      stage(step + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (sl == 0) {
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[mi][0][e] = sc[mi][1][e] = dp[mi][0][e] = dp[mi][1][e] = 0.f;
    }
    const T* st = ring + (step & 1) * kStage;
    // S (and, for dk, dp) of queries 16 mi.. against the warp's 16 keys, one
    // slab: phase A's products, rows = queries
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
      if (16 * mi < nq) {
        slab_nt<T>(sc[mi], st, 16 * mi, st + 2 * QS * LD, kw, lane);
        if (dk_block)
          slab_nt<T>(dp[mi], st + QS * LD, 16 * mi, st + (2 * QS + kTile) * LD, kw, lane);
      }
    if (sl == slabs - 1) {
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        if (16 * mi >= nq) break;  // the same for the whole block
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {  // query rows g, g + 8 of the step
          const int il = 16 * mi + g + 8 * hr, i = q0 + il;
          const bool live = il < nq;
          const float* row_st = sts + 3 * il;
          const int id_i = id_row && live ? id_row[i] : 0;
          const float* bias_i = bias && live ? bias_row(bias, h, n, i) : nullptr;
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int key = k0 + kw + 8 * nt + 2 * t + e;
              float v = 0.f;  // p (dv) or ds (dk)
              if (live && key < n) {  // p from the kept statistics
                v = kept_p(P::score(sc[mi][nt][2 * hr + e], scale, id_row, id_i, bias_i, key),
                           row_st[0], row_st[1]);
                if (dk_block) v = P::ds(v, dp[mi][nt][2 * hr + e], row_st[2]);
              }
              sc[mi][nt][2 * hr + e] = v;
            }
        }
        // dv += round_T(p)^T dO, or dk += round_T(ds)^T Q: the output slab
        slab_nn<T, true>(acc, sc[mi][0], sc[mi][1], y, 16 * mi, sp, lane);
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  const bool live0 = j0 < n, live1 = j1 < n;
  const float k = dk_block ? scale : 1.f;  // dk = scale ds^T Q
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = (e < 2 ? live0 : live1) ? k * acc[dt][e] : 0.f;
  const int part = dk_block ? 1 : 2;  // dk or dv in dqkv's q, k, v
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int ch = 8 * dt + 2 * t + e;
      if (ch >= dso) continue;
      if (live0) rows.store_kv(dqkv, part, j0, co + ch, from_f32<T>(acc[dt][e]));
      if (live1) rows.store_kv(dqkv, part, j1, co + ch, from_f32<T>(acc[dt][2 + e]));
    }
  if constexpr (P::kColumnSums)  // the unrounded dk or dv
    add_column_sums<SD>(dbqkv, part * c + h * d + co, dso, acc, red, warp, lane);
}

template <typename T>
constexpr size_t attention_slab_keys_smem() {
  return sizeof(T) * (4 * kTile + 5 * kSlabStep) * kLd<T, kSlab<T>> +
         sizeof(float) * kSlabStep * 3 +
         (kTensorCores<T> ? 0 : sizeof(float) * kTiledWarps * 16 * kSp);
}

// ---------------------------------------------------------------------------
// Launches
// ---------------------------------------------------------------------------

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// Windows to a block: ``lay.wb`` for a grouped layout, else 1.
template <typename L>
int windows_per_block(const L& lay) {
  if constexpr (kGrouped<L>)
    return lay.wb;
  else
    return 1;
}

// The slab kernels' launches (head dims above 128): a block per (window,
// head, tile, output slab).
template <typename T, typename P, typename L>
cudaError_t launch_attention_slabs(const T* qkv, const float* bias, const int* ids, int ids_rows,
                                   T* ao, float* o32, float* stats, long long bw, int n, int c,
                                   int heads, float scale, bool plain, const L& lay,
                                   cudaStream_t stream) {
  static_assert(!kGrouped<L>, "a grouped layout takes head dims up to 64");
  auto kernel = attention_slab_fwd_kernel<T, P, L>;
  constexpr size_t smem = attention_slab_fwd_smem<T>();
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int slabs = (c / heads + kSlab<T> - 1) / kSlab<T>;
  const long long blocks = bw * heads * ((n + kTile - 1) / kTile) * slabs;
  kernel<<<(unsigned)blocks, kTiledThreads, smem, stream>>>(qkv, bias, ids, ids_rows, ao, o32,
                                                           stats, n, c, heads, scale, plain,
                                                           lay);
  return cudaGetLastError();
}

template <typename T, typename P, typename L>
cudaError_t launch_attention_bwd_slabs(const T* qkv, const T* dao, const float* o,
                                       const float* stats, const float* bias, const int* ids,
                                       int ids_rows, float* s1, T* dqkv, float* dbias,
                                       float* dbqkv, long long bw, int n, int c, int heads,
                                       float scale, bool plain, const L& lay,
                                       cudaStream_t stream) {
  static_assert(!kGrouped<L>, "a grouped layout takes head dims up to 64");
  auto rows_kernel = attention_slab_rows_kernel<T, P, L>;
  auto keys_kernel = attention_slab_keys_kernel<T, P, L>;
  constexpr size_t rows_smem = attention_slab_rows_smem<T, L>();
  constexpr size_t keys_smem = attention_slab_keys_smem<T>();
  cudaError_t err = allow_smem(rows_kernel, rows_smem);
  if (err != cudaSuccess) return err;
  err = allow_smem(keys_kernel, keys_smem);
  if (err != cudaSuccess) return err;
  const int slabs = (c / heads + kSlab<T> - 1) / kSlab<T>;
  const long long blocks = bw * heads * ((n + kTile - 1) / kTile) * slabs;
  rows_kernel<<<(unsigned)blocks, kTiledThreads, rows_smem, stream>>>(
      qkv, dao, o, stats, bias, ids, ids_rows, dqkv, dbias, dbqkv, s1, n, c, heads, scale,
      plain, lay);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  keys_kernel<<<(unsigned)(2 * blocks), kTiledThreads, keys_smem, stream>>>(  // dk, dv apart
      qkv, dao, stats, s1, bias, ids, ids_rows, dqkv, dbqkv, n, c, heads, scale, plain, lay);
  return cudaGetLastError();
}

template <typename T, int D, typename P, typename L>
cudaError_t launch_attention_tiled_d(const T* qkv, const float* bias, const int* ids,
                                     int ids_rows, T* ao, float* o32, float* stats,
                                     long long bw, int n, int c, int heads, float scale,
                                     bool plain, const L& lay, cudaStream_t stream) {
  auto kernel = attention_tiled_mma_kernel<T, D, P, L>;
  constexpr size_t smem = attention_tiled_fwd_smem<T, D>();
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const long long blocks = bw / windows_per_block(lay) * heads * ((n + kTile - 1) / kTile);
  kernel<<<(unsigned)blocks, kTiledThreads, smem, stream>>>(qkv, bias, ids, ids_rows, ao, o32,
                                                           stats, n, c, heads, scale, plain,
                                                           lay);
  return cudaGetLastError();
}

// The key-tiled attention launch under policy P (K1f's by default) on
// layout L (Packed by default: qkv [BW*N, 3C] -> ao [BW*N, C] (T), o32
// [BW*N, C] (f32; may be null); other layouts take q and ao in qkv's and
// ao's place), stats [BW, H, N, 2] (shift, 1 / (sum + P::kSumEps); a policy
// that keeps them). Head dims 1 to 8192 (above 128 the slab kernels).
// ``plain`` stages rows by plain loads (``plain_loads``: required where rows
// are not whole, aligned 16-byte chunks).
template <typename T, typename P = K1Softmax, typename L = Packed>
cudaError_t launch_attention_tiled(const T* qkv, const float* bias, const int* ids,
                                   int ids_rows, T* ao, float* o32, float* stats, long long bw,
                                   int n, int c, int heads, float scale, cudaStream_t stream,
                                   bool plain = false, const L& lay = L()) {
  const int d = c / heads;
  if (d < 1 || d > kMaxSlabHeadDim) return cudaErrorInvalidValue;
  if constexpr (!P::kPlainLoads)
    if (plain)
      return launch_attention_tiled<T, PlainLoads<P>, L>(qkv, bias, ids, ids_rows, ao, o32,
                                                         stats, bw, n, c, heads, scale, stream,
                                                         plain, lay);
  if (d > kMaxHeadDim)
    return launch_attention_slabs<T, P>(qkv, bias, ids, ids_rows, ao, o32, stats, bw, n, c,
                                        heads, scale, plain, lay, stream);
  if (d <= 32)
    return launch_attention_tiled_d<T, 32, P>(qkv, bias, ids, ids_rows, ao, o32, stats, bw, n,
                                              c, heads, scale, plain, lay, stream);
  if (d <= 64)
    return launch_attention_tiled_d<T, 64, P>(qkv, bias, ids, ids_rows, ao, o32, stats, bw, n,
                                              c, heads, scale, plain, lay, stream);
  return launch_attention_tiled_d<T, 128, P>(qkv, bias, ids, ids_rows, ao, o32, stats, bw, n,
                                             c, heads, scale, plain, lay, stream);
}

template <typename T, int D, typename P, typename L>
cudaError_t launch_attention_bwd_tiled_d(const T* qkv, const T* dao, const float* o,
                                         const float* stats, const float* bias, const int* ids,
                                         int ids_rows, float* s1, T* dqkv, float* dbias,
                                         float* dbqkv, long long bw, int n, int c, int heads,
                                         float scale, bool plain, const L& lay,
                                         cudaStream_t stream) {
  auto rows_kernel = attention_bwd_rows_mma_kernel<T, D, P, L>;
  auto keys_kernel = attention_bwd_keys_mma_kernel<T, D, P, L>;
  constexpr size_t rows_smem = attention_bwd_rows_smem<T, D>();
  constexpr size_t keys_smem = attention_bwd_keys_smem<T, D>();
  cudaError_t err = allow_smem(rows_kernel, rows_smem);
  if (err != cudaSuccess) return err;
  err = allow_smem(keys_kernel, keys_smem);
  if (err != cudaSuccess) return err;
  const long long blocks = bw * heads * ((n + kTile - 1) / kTile);
  rows_kernel<<<(unsigned)blocks, kTiledThreads, rows_smem, stream>>>(
      qkv, dao, o, stats, bias, ids, ids_rows, dqkv, dbias, dbqkv, s1, n, c, heads, scale,
      plain, lay);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  keys_kernel<<<(unsigned)blocks, kTiledThreads, keys_smem, stream>>>(
      qkv, dao, stats, s1, bias, ids, ids_rows, dqkv, dbqkv, n, c, heads, scale, plain, lay);
  return cudaGetLastError();
}

// The key-tiled attention backward under policy P (K1b's by default) on
// layout L (Packed by default; others take q, dq in qkv's, dqkv's place),
// phases A and B: from qkv, dao (T), the forward's o (f32, out's layout) and
// stats [BW, H, N, 2], into dqkv [BW*N, 3C] (T), and added into the zeroed
// f32 dbias [H, N, N] (may be null: no bias) and, where P takes column sums,
// dbqkv [3C]; s1 [BW, H, N] f32 is scratch. Head dims and ``plain`` as the
// forward's.
template <typename T, typename P = K1Softmax, typename L = Packed>
cudaError_t launch_attention_bwd_tiled(const T* qkv, const T* dao, const float* o,
                                       const float* stats, const float* bias, const int* ids,
                                       int ids_rows, float* s1, T* dqkv, float* dbias,
                                       float* dbqkv, long long bw, int n, int c, int heads,
                                       float scale, cudaStream_t stream, bool plain = false,
                                       const L& lay = L()) {
  const int d = c / heads;
  if (d < 1 || d > kMaxSlabHeadDim) return cudaErrorInvalidValue;
  if constexpr (!P::kPlainLoads)
    if (plain)
      return launch_attention_bwd_tiled<T, PlainLoads<P>, L>(qkv, dao, o, stats, bias, ids,
                                                             ids_rows, s1, dqkv, dbias, dbqkv,
                                                             bw, n, c, heads, scale, stream,
                                                             plain, lay);
  if (d > kMaxHeadDim)
    return launch_attention_bwd_slabs<T, P>(qkv, dao, o, stats, bias, ids, ids_rows, s1, dqkv,
                                            dbias, dbqkv, bw, n, c, heads, scale, plain, lay,
                                            stream);
  if (d <= 32)
    return launch_attention_bwd_tiled_d<T, 32, P>(qkv, dao, o, stats, bias, ids, ids_rows, s1,
                                                  dqkv, dbias, dbqkv, bw, n, c, heads, scale,
                                                  plain, lay, stream);
  if (d <= 64)
    return launch_attention_bwd_tiled_d<T, 64, P>(qkv, dao, o, stats, bias, ids, ids_rows, s1,
                                                  dqkv, dbias, dbqkv, bw, n, c, heads, scale,
                                                  plain, lay, stream);
  return launch_attention_bwd_tiled_d<T, 128, P>(qkv, dao, o, stats, bias, ids, ids_rows, s1,
                                                 dqkv, dbias, dbqkv, bw, n, c, heads, scale,
                                                 plain, lay, stream);
}

}  // namespace
