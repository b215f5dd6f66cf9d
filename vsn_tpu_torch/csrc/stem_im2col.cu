// K5: the single-channel stem convolution (K5f) and its weight gradient
// (K5w), as implicit im2col GEMMs over the kernel's taps.
//
// Replaces vsn_tpu/ops/stem_im2col.py _fwd_pallas (:249) and _dw_pallas
// (:291):
//
//   K5f  y[b, zo, yo, xo, c] = sum_t xpad[b, zo*sz + dz, yo*sy + dy, xo*sx + dx] * W[t, c]
//   K5w  dW[t, c]            = sum_{b, zo, yo, xo} xpad[b, zo*sz + dz, ...] * g[b, zo, yo, xo, c]
//
// with t = (dz*kh + dy)*kw + dx (the kernel's DHWIO order, so dW comes out
// as [kd, kh, kw, 1, C]) and xpad the input zero-padded by (pz, py, px).
// Operands are rounded to the activation type, products summed in f32, y
// rounded once; dW is f32 (stem_im2col.py:359-362).
//
// What bounds them on this card: the ResNet stem at micro-batch 12 is
// 2*343*64 FLOP for each of 10.45M output tokens, 459 GFLOP, 0.46 ms at the
// bf16 tensor-core peak, against 1.34 GB of bf16 output (K5f) or cotangent
// (K5w), 0.40 ms at the HBM rate: balanced, both near 0.4-0.5 ms. On f32
// FMA the same products take at least 6.8 ms.
//
// Design. The TPU kernel builds the im2col matrix in VMEM from stride-2
// parity planes laid out z-on-sublanes, because of Mosaic's tiling rules.
// Here the matrix is never built: a block stages the input halo that a
// group of output rows (b, zo, yo0 ..) reads (kd planes x (rows-1)*sy + kh
// rows x the padded width) in shared memory, and the product operands are
// read from there by index.
//   bf16 (the models' type) runs on the tensor cores (mma.sync m16n8k16,
//   f32 accumulators; stem_fwd_mma_kernel, stem_dw_mma_kernel below). The
//   halo is bf16, a ring of kd + sz planes: a block walks a fixed run of
//   groups in zo order, so consecutive groups share kd - sz planes and
//   cp.async brings only the sz new ones (and, for K5w, the next group's
//   cotangent rows) while the current group is computed; each input row's
//   halo row is its own 16-byte chunks. K5f is tokens x taps x channels
//   with the taps as the depth; the wrapper lays the weights out as (dz,
//   dy, dx') rows with dx' = dx + f padded to 8 (``pad_taps``; the 7^3
//   stem: 49 x 8 = 392 rows, 400 with a zero chunk) so that a k16 step is
//   two (dz, dy) rows of 8 dx. f = px mod 2 at x-stride 2 puts each A
//   register's depth pair (2t, 2t+1) on input columns 2 xo + 2t - f - px,
//   an even x: one aligned 32-bit shared load. The output tile goes out
//   through shared memory as 16-byte chunks. K5w is taps x channels with
//   the tokens as the depth (16 token slots of one output row a k16 step):
//   a block sums its run into registers, writes that partial to a scratch
//   [blocks, taps, C], and a second kernel sums the blocks in order, so dW
//   has the same bits on every run, as the TPU's one revisited output block
//   does (it adds into that block on its sequential grid,
//   stem_im2col.py:314-322; blocks here run in no order, hence the
//   scratch). Its A registers pair two tokens, 2 elements apart at x-stride
//   2: two 16-bit loads each.
//   f32 keeps the FMA bodies (stem_fwd_kernel, stem_dw_kernel): a block
//   stages the halo as f32; K5f keeps the [taps, C] f32 weights (88 KB) in
//   shared memory and a thread sums 4 output columns x 8 channels over all
//   taps; K5w also stages the cotangent rows, a thread owns 8 taps x 8
//   channels of dW over its block's share of the row groups (split-K) and
//   adds them into dW with f32 atomics (an order that varies between runs).
//   A thread's 8 channels are c0..c0+3 and C/2+c0..C/2+c0+3, so that a
//   warp's float4 loads of a weight or cotangent row are conflict-free. On
//   bf16 operands they are chip_smoke.py's yardstick (``fma``).

#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kMaxSmem = 232448;  // bytes of shared memory a block may use
constexpr int kXT = 4;            // K5f: output columns per thread
constexpr int kTT = 8;            // K5w: taps per thread
constexpr int kCT = 8;            // channels per thread
constexpr int kMaxC = 64;         // output channels the kernels take
constexpr int kFwdTarget = 576;   // K5f threads per block to aim for
constexpr int kFwdMaxThreads = 768;
constexpr int kDwMaxThreads = 512;
constexpr int kDwRows = 4;        // K5w output rows per staged group

struct StemGeom {
  int b, d, h, w;     // input [B, D, H, W] (C_in = 1)
  int kd, kh, kw;     // kernel
  int sz, sy, sx;     // strides
  int pz, py, px;     // padding
  int c;              // output channels
  int od, oh, ow;     // output extents
  int rows;           // output rows (yo) per group
  int slab_rows;      // input rows a group reads: (rows - 1) * sy + kh
  int wp;             // staged input width
};

template <typename T> __device__ __forceinline__ void store4(T* p, float a, float b,
                                                            float c, float d);
template <> __device__ __forceinline__ void store4<float>(float* p, float a, float b,
                                                          float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
template <> __device__ __forceinline__ void store4<__nv_bfloat16>(__nv_bfloat16* p, float a,
                                                                  float b, float c, float d) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(a, b);
  __nv_bfloat162 hi = __floats2bfloat162_rn(c, d);
  uint2 u;
  u.x = *reinterpret_cast<unsigned*>(&lo);
  u.y = *reinterpret_cast<unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

// (bi, zo, yo0) of row group ``grp``.
__device__ __forceinline__ void decode_group(const StemGeom& g, long long grp, int& bi,
                                             int& zo, int& yo0) {
  const int ygroups = (g.oh + g.rows - 1) / g.rows;
  yo0 = (int)(grp % ygroups) * g.rows;
  zo = (int)((grp / ygroups) % g.od);
  bi = (int)(grp / ((long long)ygroups * g.od));
}

// x_s[dz][r][xp] = xpad[bi, zo*sz + dz, yo0*sy + r, xp] as f32, zero outside
// the input.
template <typename T>
__device__ void stage_halo(const T* __restrict__ x, float* x_s, const StemGeom& g, int bi,
                           int zo, int yo0) {
  const int n = g.kd * g.slab_rows * g.wp;
#pragma unroll 4
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int xp = i % g.wp;
    const int r = (i / g.wp) % g.slab_rows;
    const int dz = i / (g.wp * g.slab_rows);
    const int z = zo * g.sz - g.pz + dz;
    const int y = yo0 * g.sy - g.py + r;
    const int xx = xp - g.px;
    float v = 0.f;
    if (z >= 0 && z < g.d && y >= 0 && y < g.h && xx >= 0 && xx < g.w)
      v = to_f32<T>(x[(((long long)bi * g.d + z) * g.h + y) * g.w + xx]);
    x_s[i] = v;
  }
}

template <typename T, int SX>
__global__ void __launch_bounds__(kFwdMaxThreads) stem_fwd_kernel(const T* __restrict__ x,
                                                                  const float* __restrict__ wt,
                                                                  T* __restrict__ y,
                                                                  StemGeom g) {
  extern __shared__ __align__(16) float smem[];
  const int taps = g.kd * g.kh * g.kw;
  float* w_s = smem;               // [taps][C], rounded to T
  float* x_s = smem + taps * g.c;  // the halo of one row group
  for (int i = threadIdx.x; i < taps * g.c; i += blockDim.x) w_s[i] = round_to<T>(wt[i]);

  const int ctiles = g.c / kCT;
  const int per_row = ((g.ow + kXT - 1) / kXT) * ctiles;
  const int r = threadIdx.x / per_row;  // output row within the group
  const int t = threadIdx.x % per_row;
  const int xo0 = (t / ctiles) * kXT;
  const int c0 = (t % ctiles) * 4, c1 = c0 + g.c / 2;
  const long long ngroups = (long long)g.b * g.od * ((g.oh + g.rows - 1) / g.rows);

  for (long long grp = blockIdx.x; grp < ngroups; grp += gridDim.x) {
    int bi, zo, yo0;
    decode_group(g, grp, bi, zo, yo0);
    __syncthreads();  // the previous group is done with x_s (and w_s is staged)
    stage_halo<T>(x, x_s, g, bi, zo, yo0);
    __syncthreads();
    const int yo = yo0 + r;
    if (r >= g.rows || yo >= g.oh) continue;
    float acc[kXT][kCT];
#pragma unroll
    for (int k = 0; k < kXT; ++k)
#pragma unroll
      for (int j = 0; j < kCT; ++j) acc[k][j] = 0.f;
    for (int dz = 0; dz < g.kd; ++dz) {
      for (int dy = 0; dy < g.kh; ++dy) {
        const float* xrow = x_s + (dz * g.slab_rows + r * g.sy + dy) * g.wp + xo0 * SX;
        const float* wrow = w_s + (dz * g.kh + dy) * g.kw * g.c;
        for (int dx = 0; dx < g.kw; ++dx) {
          const float4 wa = *reinterpret_cast<const float4*>(wrow + dx * g.c + c0);
          const float4 wb = *reinterpret_cast<const float4*>(wrow + dx * g.c + c1);
          const float wv[kCT] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
          for (int k = 0; k < kXT; ++k) {
            const float xv = xrow[dx + k * SX];
#pragma unroll
            for (int j = 0; j < kCT; ++j) acc[k][j] = fmaf(xv, wv[j], acc[k][j]);
          }
        }
      }
    }
    T* out = y + (((long long)bi * g.od + zo) * g.oh + yo) * (long long)g.ow * g.c;
#pragma unroll
    for (int k = 0; k < kXT; ++k) {
      if (xo0 + k >= g.ow) break;
      T* o = out + (long long)(xo0 + k) * g.c;
      store4<T>(o + c0, acc[k][0], acc[k][1], acc[k][2], acc[k][3]);
      store4<T>(o + c1, acc[k][4], acc[k][5], acc[k][6], acc[k][7]);
    }
  }
}

template <typename T, int SX>
__global__ void __launch_bounds__(kDwMaxThreads) stem_dw_kernel(const T* __restrict__ x,
                                                                const T* __restrict__ gy,
                                                                float* __restrict__ dw,
                                                                StemGeom g,
                                                                long long groups_per_block) {
  extern __shared__ __align__(16) float smem[];
  const int taps = g.kd * g.kh * g.kw;
  const int row_elems = g.ow * g.c;
  float* g_s = smem;                        // [rows][ow][C] of the cotangent
  float* x_s = smem + g.rows * row_elems;   // the halo of one row group

  const int ctiles = g.c / kCT;
  const int tt = threadIdx.x / ctiles;
  const int c0 = (threadIdx.x % ctiles) * 4, c1 = c0 + g.c / 2;
  const bool active = tt * kTT < taps;
  int off[kTT];  // halo offset of each of the thread's taps at xo = 0
#pragma unroll
  for (int k = 0; k < kTT; ++k) {
    const int tap = min(tt * kTT + k, taps - 1);  // past the end: summed, dropped
    const int dz = tap / (g.kh * g.kw), dy = (tap / g.kw) % g.kh, dx = tap % g.kw;
    off[k] = (dz * g.slab_rows + dy) * g.wp + dx;
  }
  float acc[kTT][kCT];
#pragma unroll
  for (int k = 0; k < kTT; ++k)
#pragma unroll
    for (int j = 0; j < kCT; ++j) acc[k][j] = 0.f;

  const long long ngroups = (long long)g.b * g.od * ((g.oh + g.rows - 1) / g.rows);
  const long long g0 = blockIdx.x * groups_per_block;
  const long long g1 = g0 + groups_per_block < ngroups ? g0 + groups_per_block : ngroups;
  for (long long grp = g0; grp < g1; ++grp) {
    int bi, zo, yo0;
    decode_group(g, grp, bi, zo, yo0);
    const int nrows = min(g.rows, g.oh - yo0);
    __syncthreads();  // the previous group is done with g_s and x_s
    stage_halo<T>(x, x_s, g, bi, zo, yo0);
    // the group's cotangent rows are contiguous from token (bi, zo, yo0, 0)
    const T* grow = gy + (((long long)bi * g.od + zo) * g.oh + yo0) * (long long)row_elems;
    const int n = nrows * row_elems;
#pragma unroll 4
    for (int i = threadIdx.x; i < n; i += blockDim.x) g_s[i] = to_f32<T>(grow[i]);
    __syncthreads();
    if (!active) continue;
    for (int r = 0; r < nrows; ++r) {
      const float* xr = x_s + r * g.sy * g.wp;
      const float* gr = g_s + r * row_elems;
      for (int xo = 0; xo < g.ow; ++xo) {
        const float4 ga = *reinterpret_cast<const float4*>(gr + xo * g.c + c0);
        const float4 gb = *reinterpret_cast<const float4*>(gr + xo * g.c + c1);
        const float gv[kCT] = {ga.x, ga.y, ga.z, ga.w, gb.x, gb.y, gb.z, gb.w};
#pragma unroll
        for (int k = 0; k < kTT; ++k) {
          const float xv = xr[off[k] + xo * SX];
#pragma unroll
          for (int j = 0; j < kCT; ++j) acc[k][j] = fmaf(xv, gv[j], acc[k][j]);
        }
      }
    }
  }
  if (!active) return;
#pragma unroll
  for (int k = 0; k < kTT; ++k) {
    const int tap = tt * kTT + k;
    if (tap >= taps) break;
    float* d = dw + (long long)tap * g.c;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      atomicAdd(d + c0 + j, acc[k][j]);
      atomicAdd(d + c1 + j, acc[k][4 + j]);
    }
  }
}

// ---------------------------------------------------------------------------
// The tensor-core bodies (bf16): bf16 mma.sync.m16n8k16, f32 accumulators.

constexpr int kFwdWarps = 8;        // K5f: most warps a block
constexpr int kFwdTiles = 4;        // K5f: m16 tiles (tokens) a warp owns
constexpr int kDwWarps = 8;         // K5w: most warps a block
constexpr int kDwTiles = 4;         // K5w: m16 tiles (taps) a warp owns
constexpr int kNTiles = 8;          // n8 tiles: 64 channels, C < 64 zero-padded
constexpr int kCPad = kNTiles * 8;  // channels of a staged row
constexpr int kFwdTokens = kFwdWarps * kFwdTiles * 16;  // K5f: tokens a group
constexpr int kDwMaxTaps = kDwWarps * kDwTiles * 16;    // K5w: taps it takes
constexpr int kReduceThreads = 256;

// Geometry of the tensor-core bodies. s.rows, s.slab_rows and s.wp keep
// their meaning (output rows a group, input rows a group reads, halo row
// length); a halo row holds x = -lpad .. s.wp - lpad - 1 of one input row,
// zero outside the input. The halo is a ring of ``nslot`` planes: padded
// input plane zp = z + pz of the current run sits in slot zp % nslot.
struct MmaGeom {
  StemGeom s;
  int f;       // K5f: zero depth slots in front of dx (see the note at the top)
  int kw8;     // K5f: depth slots a (dz, dy) row, kw + f rounded up to 8
  int chunks;  // K5f: 8-slot depth chunks, an even number (the last may be zero)
  int lpad;    // halo columns left of x = 0, a multiple of 8
  int owp;     // K5w: token slots an output row, ow rounded up to 16
  int nslot;   // planes in the ring: kd + sz
  int vec;     // stage the halo by cp.async: w % 8 == 0 and x 16-byte aligned
  int warps;   // warps a block
};

// Group ``grp`` of a run: (bi, yo0) fixed along a run of consecutive zo, so
// that the next group reuses kd - sz of the ring's planes.
__device__ __forceinline__ void decode_run(const StemGeom& g, long long grp, int& bi, int& zo,
                                           int& yo0) {
  const int ygroups = (g.oh + g.rows - 1) / g.rows;
  zo = (int)(grp % g.od);
  const long long rest = grp / g.od;
  yo0 = (int)(rest % ygroups) * g.rows;
  bi = (int)(rest / ygroups);
}

// Stage ``count`` padded planes from zp0 of the halo of rows (bi, yo0 ..)
// into their ring slots: h[(slot * slab_rows + r) * wp + e] = xpad[bi, zp,
// yo0*sy + r, e - lpad], zero outside the input. A warp copies whole rows:
// 16-byte chunks by cp.async (a chunk lies wholly inside or outside the
// input, since lpad and w are multiples of 8), or element by element when
// the rows are not 16-byte aligned.
__device__ void stage_planes(const __nv_bfloat16* __restrict__ x, __nv_bfloat16* h,
                             const MmaGeom& m, int bi, int yo0, int zp0, int count) {
  const StemGeom& g = m.s;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int row = warp; row < count * g.slab_rows; row += m.warps) {
    const int j = row / g.slab_rows, r = row - j * g.slab_rows;
    const int z = zp0 + j - g.pz, y = yo0 * g.sy - g.py + r;
    const bool in = z >= 0 && z < g.d && y >= 0 && y < g.h;
    const __nv_bfloat16* src = x + (((long long)bi * g.d + (in ? z : 0)) * g.h + (in ? y : 0)) * g.w;
    __nv_bfloat16* dst = h + (((zp0 + j) % m.nslot) * g.slab_rows + r) * g.wp;
    if (m.vec) {
      for (int q = lane; q < g.wp / 8; q += 32) {
        const int xx = q * 8 - m.lpad;
        const bool ok = in && xx >= 0 && xx < g.w;
        cp_async16(dst + q * 8, ok ? src + xx : x, ok);
      }
    } else {
      for (int e = lane; e < g.wp; e += 32) {
        const int xx = e - m.lpad;
        dst[e] = in && xx >= 0 && xx < g.w ? src[xx] : __float2bfloat16(0.f);
      }
    }
  }
}

// Two halo elements as one A register: (e, e + 1) at x-stride 2, where e is
// even and the pair is one aligned 32-bit load; two 16-bit loads at stride 1.
template <int SX>
__device__ __forceinline__ uint32_t depth_pair(const __nv_bfloat16* h, int e) {
  if constexpr (SX == 2) {
    return *reinterpret_cast<const uint32_t*>(h + e);
  } else {
    const unsigned short* p = reinterpret_cast<const unsigned short*>(h + e);
    return (uint32_t)p[0] | ((uint32_t)p[1] << 16);
  }
}

// Two halo elements SX apart (two consecutive tokens at one tap) as one A
// register, the first in the low half.
template <int SX>
__device__ __forceinline__ uint32_t token_pair(const __nv_bfloat16* h, int e) {
  const unsigned short* p = reinterpret_cast<const unsigned short*>(h);
  return (uint32_t)p[e] | ((uint32_t)p[e + SX] << 16);
}

// The element of row ``row``, channel chunk ``cc`` of a staged [rows][64]
// tile whose 16-byte chunks are swizzled by the row (conflict-free ldmatrix).
__device__ __forceinline__ int swz(int row, int cc) { return row * kCPad + ((cc ^ (row & 7)) << 3); }

// K5f. A block keeps the weights, rounded to bf16 by the wrapper in the
// padded depth order (``pad_taps``: depth row (dz*kh + dy)*kw8 + dx + f),
// in shared memory for its whole life, and walks a fixed run of row groups
// (b, zo, yo0 .. yo0 + rows - 1) in zo order: while it computes one group,
// cp.async brings the sz input planes that the next one adds to the ring.
// A warp owns 4 m16 tiles of the group's tokens (the tokens of its rows in
// order) x all 64 channels; each k16 step covers two (dz, dy) depth chunks
// of 8 dx slots. The A registers of a token are read straight from the
// halo (no im2col tile is built); the B fragments, by ldmatrix.trans, serve
// the warp's 4 tiles. The tile is rounded to bf16, staged per warp through
// shared memory and stored as 16-byte chunks of contiguous tokens.
template <int SX>
__global__ void __launch_bounds__(kFwdWarps * 32, 1)
    stem_fwd_mma_kernel(const __nv_bfloat16* __restrict__ x,
                        const __nv_bfloat16* __restrict__ wp,
                        __nv_bfloat16* __restrict__ y, MmaGeom m,
                        long long groups_per_block) {
  extern __shared__ __align__(16) unsigned char stem_smem[];
  const StemGeom& g = m.s;
  const int krows = m.chunks * 8;
  __nv_bfloat16* w_s = reinterpret_cast<__nv_bfloat16*>(stem_smem);  // [krows][64]
  int* choff = reinterpret_cast<int*>(w_s + krows * kCPad);          // [chunks]
  __nv_bfloat16* h_s = reinterpret_cast<__nv_bfloat16*>(choff + ((m.chunks + 3) & ~3));
  __nv_bfloat16* o_s = h_s + m.nslot * g.slab_rows * g.wp;  // [warps][16][64]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;

  for (int i = threadIdx.x; i < krows * 8; i += blockDim.x) {
    const int k = i >> 3, cc = i & 7;
    const bool ok = cc * 8 < g.c;
    cp_async16(w_s + swz(k, cc), ok ? wp + (long long)k * g.c + cc * 8 : wp, ok);
  }
  // the halo element of each of the lane's tokens (rows gq, gq + 8 of its 4
  // tiles) in plane dz = 0, row dy = 0, slot 0: even at x-stride 2, since
  // f + px is
  const int tokens = g.rows * g.ow;
  int base[kFwdTiles][2];
#pragma unroll
  for (int mt = 0; mt < kFwdTiles; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int tok = min(16 * (warp * kFwdTiles + mt) + gq + 8 * hf, tokens - 1);
      const int r = tok / g.ow, xo = tok - r * g.ow;
      base[mt][hf] = r * g.sy * g.wp + SX * xo + 2 * tq + m.lpad - m.f - g.px;
    }

  const int per = m.kw8 / 8, fresh = min(g.sz, g.kd);
  const long long ngroups = (long long)g.b * g.od * ((g.oh + g.rows - 1) / g.rows);
  const long long g0 = blockIdx.x * groups_per_block;
  const long long g1 = g0 + groups_per_block < ngroups ? g0 + groups_per_block : ngroups;
  if (g0 < g1) {
    int bi, zo, yo0;
    decode_run(g, g0, bi, zo, yo0);
    stage_planes(x, h_s, m, bi, yo0, zo * g.sz, g.kd);
  }
  cp_async_commit();
  __nv_bfloat16* os = o_s + warp * 16 * kCPad;
  for (long long grp = g0; grp < g1; ++grp) {
    int bi, zo, yo0;
    decode_run(g, grp, bi, zo, yo0);
    const bool cont = grp + 1 < g1 && zo + 1 < g.od;  // the next group shares planes
    if (cont) stage_planes(x, h_s, m, bi, yo0, (zo + 1) * g.sz + g.kd - fresh, fresh);
    cp_async_commit();
    cp_async_wait<1>();
    for (int c = threadIdx.x; c < m.chunks; c += blockDim.x) {
      // the zero chunk that evens the count reads chunk 0's values: a plane
      // of this group, finite (a slot of the ring it does not use may not be)
      const int ch = c < g.kd * g.kh * per ? c : 0;
      const int dzdy = ch / per, dz = dzdy / g.kh;
      choff[c] = (((zo * g.sz + dz) % m.nslot) * g.slab_rows + dzdy - dz * g.kh) * g.wp +
                 (ch - dzdy * per) * 8;
    }
    __syncthreads();  // this group's planes (and the weights, the offsets) are in
    const int ntok = min(g.rows, g.oh - yo0) * g.ow;
    if (warp * kFwdTiles * 16 < ntok) {
      float acc[kFwdTiles][kNTiles][4];
#pragma unroll
      for (int mt = 0; mt < kFwdTiles; ++mt)
#pragma unroll
        for (int n = 0; n < kNTiles; ++n)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[mt][n][j] = 0.f;
      for (int s = 0; s < m.chunks / 2; ++s) {
        const int c0 = choff[2 * s], c1 = choff[2 * s + 1];
        uint32_t b[kNTiles / 2][4];
#pragma unroll
        for (int nb = 0; nb < kNTiles / 2; ++nb)
          ldsm_x4_t(b[nb], w_s + swz(16 * s + (lane & 15), 2 * nb + (lane >> 4)));
#pragma unroll
        for (int mt = 0; mt < kFwdTiles; ++mt) {
          const uint32_t a[4] = {depth_pair<SX>(h_s, base[mt][0] + c0),
                                 depth_pair<SX>(h_s, base[mt][1] + c0),
                                 depth_pair<SX>(h_s, base[mt][0] + c1),
                                 depth_pair<SX>(h_s, base[mt][1] + c1)};
#pragma unroll
          for (int n = 0; n < kNTiles; ++n)
            mma_bf16(acc[mt][n], a, b[n >> 1][(n & 1) * 2], b[n >> 1][(n & 1) * 2 + 1]);
        }
      }
      // rounded once; per tile: staged through shared memory, stored as
      // 16-byte chunks (a group's tokens are contiguous in y)
      __nv_bfloat16* out = y + ((((long long)bi * g.od + zo) * g.oh + yo0) * g.ow) * g.c;
#pragma unroll
      for (int mt = 0; mt < kFwdTiles; ++mt) {
#pragma unroll
        for (int n = 0; n < kNTiles; ++n) {
          *reinterpret_cast<uint32_t*>(os + swz(gq, n) + 2 * tq) =
              pack_bf16(acc[mt][n][0], acc[mt][n][1]);
          *reinterpret_cast<uint32_t*>(os + swz(gq + 8, n) + 2 * tq) =
              pack_bf16(acc[mt][n][2], acc[mt][n][3]);
        }
        __syncwarp();
        const int tok0 = 16 * (warp * kFwdTiles + mt);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int id = lane + 32 * j, row = id >> 3, cc = id & 7;
          if (tok0 + row < ntok && cc * 8 < g.c)
            *reinterpret_cast<uint4*>(out + (long long)(tok0 + row) * g.c + cc * 8) =
                *reinterpret_cast<const uint4*>(os + swz(row, cc));
        }
        __syncwarp();
      }
    }
    __syncthreads();  // every warp is done with this group's planes and offsets
    if (grp + 1 < g1 && !cont) {  // a new run: all kd planes, after the compute
      decode_run(g, grp + 1, bi, zo, yo0);
      stage_planes(x, h_s, m, bi, yo0, zo * g.sz, g.kd);
      cp_async_commit();
    }
  }
  cp_async_wait<0>();
}

// K5w. dW[t, c] = sum_tok im2col[t, tok] * g[tok, c] with M = the taps
// (DHWIO order, the last m16 tile ragged), N = the channels, K = the
// tokens, in k16 steps of 16 token slots of one output row (a row's slots
// past ow are zero cotangent rows). A block owns a fixed run of row groups
// (zo order, as K5f's, with the same ring of input planes) and keeps its
// taps x 64 partial in registers (a warp 4 m16 tiles x 64 channels) over
// all of them; each group's cotangent rows (bf16, cp.async, swizzled) and
// new planes are staged while the previous group is computed. The A
// registers pair two tokens at one tap (two 16-bit loads from the halo),
// the B fragments come by ldmatrix.trans from the cotangent rows. The block
// writes its partial to part[block] (the padded tap rows dropped);
// stem_dw_reduce_kernel sums the blocks in order.
template <int SX>
__global__ void __launch_bounds__(kDwWarps * 32, 1)
    stem_dw_mma_kernel(const __nv_bfloat16* __restrict__ x,
                       const __nv_bfloat16* __restrict__ gy, float* __restrict__ part,
                       MmaGeom m, long long groups_per_block) {
  extern __shared__ __align__(16) unsigned char stem_smem[];
  const StemGeom& g = m.s;
  const int slots = g.rows * m.owp;
  __nv_bfloat16* h_s = reinterpret_cast<__nv_bfloat16*>(stem_smem);  // the ring
  __nv_bfloat16* g_s = h_s + m.nslot * g.slab_rows * g.wp;            // [2][slots][64]
  int* poff = reinterpret_cast<int*>(g_s + 2 * slots * kCPad);        // [kd]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int taps = g.kd * g.kh * g.kw;

  // each of the lane's taps (rows gq, gq + 8 of its 4 tiles): its plane dz
  // and its halo element within the plane at token (0, 0); taps past the
  // last read the last one's values
  int tin[kDwTiles][2], tdz[kDwTiles][2];
#pragma unroll
  for (int mt = 0; mt < kDwTiles; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int tap = min(16 * (warp * kDwTiles + mt) + gq + 8 * hf, taps - 1);
      const int dz = tap / (g.kh * g.kw), dy = (tap / g.kw) % g.kh, dx = tap % g.kw;
      tdz[mt][hf] = dz;
      tin[mt][hf] = dy * g.wp + m.lpad + dx - g.px;
    }
  float acc[kDwTiles][kNTiles][4];
#pragma unroll
  for (int mt = 0; mt < kDwTiles; ++mt)
#pragma unroll
    for (int n = 0; n < kNTiles; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mt][n][j] = 0.f;

  const int fresh = min(g.sz, g.kd);
  const long long ngroups = (long long)g.b * g.od * ((g.oh + g.rows - 1) / g.rows);
  const long long g0 = blockIdx.x * groups_per_block;
  const long long g1 = g0 + groups_per_block < ngroups ? g0 + groups_per_block : ngroups;

  // stage the cotangent rows of group ``grp`` into buffer ``buf``
  auto stage_g = [&](long long grp, int buf) {
    int bi, zo, yo0;
    decode_run(g, grp, bi, zo, yo0);
    const int nrows = min(g.rows, g.oh - yo0);
    const __nv_bfloat16* grow =
        gy + ((((long long)bi * g.od + zo) * g.oh + yo0) * g.ow) * g.c;
    for (int r = 0; r < nrows; ++r) {  // slot r*owp + xo; owp is a multiple of 16
      __nv_bfloat16* gb = g_s + (buf * slots + r * m.owp) * kCPad;
      const __nv_bfloat16* gr = grow + (long long)r * g.ow * g.c;
      for (int i = threadIdx.x; i < m.owp * 8; i += blockDim.x) {
        const int xo = i >> 3, cc = i & 7;
        const bool ok = xo < g.ow && cc * 8 < g.c;
        cp_async16(gb + swz(xo, cc), ok ? gr + xo * g.c + cc * 8 : gy, ok);
      }
    }
  };

  if (g0 < g1) {
    int bi, zo, yo0;
    decode_run(g, g0, bi, zo, yo0);
    stage_planes(x, h_s, m, bi, yo0, zo * g.sz, g.kd);
    stage_g(g0, 0);
  }
  cp_async_commit();
  const bool active = warp * kDwTiles * 16 < taps;
  for (long long grp = g0; grp < g1; ++grp) {
    const int buf = (int)((grp - g0) & 1);
    int bi, zo, yo0;
    decode_run(g, grp, bi, zo, yo0);
    const bool cont = grp + 1 < g1 && zo + 1 < g.od;  // the next group shares planes
    if (grp + 1 < g1) stage_g(grp + 1, buf ^ 1);
    if (cont) stage_planes(x, h_s, m, bi, yo0, (zo + 1) * g.sz + g.kd - fresh, fresh);
    cp_async_commit();
    cp_async_wait<1>();
    for (int dz = threadIdx.x; dz < g.kd; dz += blockDim.x)
      poff[dz] = ((zo * g.sz + dz) % m.nslot) * g.slab_rows * g.wp;
    __syncthreads();  // this group's planes, cotangent rows and plane offsets are in
    const int nrows = min(g.rows, g.oh - yo0);
    if (active) {
      const __nv_bfloat16* gb = g_s + buf * slots * kCPad;
      int toff[kDwTiles][2];
#pragma unroll
      for (int mt = 0; mt < kDwTiles; ++mt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) toff[mt][hf] = tin[mt][hf] + poff[tdz[mt][hf]];
      for (int r = 0; r < nrows; ++r) {
        for (int k0 = 0; k0 < m.owp; k0 += 16) {
          uint32_t b[kNTiles / 2][4];
#pragma unroll
          for (int nb = 0; nb < kNTiles / 2; ++nb)
            ldsm_x4_t(b[nb], gb + swz(r * m.owp + k0 + (lane & 15), 2 * nb + (lane >> 4)));
          const int tok = r * g.sy * g.wp + SX * (k0 + 2 * tq);
#pragma unroll
          for (int mt = 0; mt < kDwTiles; ++mt) {
            if (16 * (warp * kDwTiles + mt) >= taps) break;
            const int e0 = toff[mt][0] + tok, e1 = toff[mt][1] + tok;
            const uint32_t a[4] = {token_pair<SX>(h_s, e0), token_pair<SX>(h_s, e1),
                                   token_pair<SX>(h_s, e0 + 8 * SX),
                                   token_pair<SX>(h_s, e1 + 8 * SX)};
#pragma unroll
            for (int n = 0; n < kNTiles; ++n)
              mma_bf16(acc[mt][n], a, b[n >> 1][(n & 1) * 2], b[n >> 1][(n & 1) * 2 + 1]);
          }
        }
      }
    }
    __syncthreads();  // every warp is done with this group's planes and buffer
    if (grp + 1 < g1 && !cont) {  // a new run: all kd planes, after the compute
      decode_run(g, grp + 1, bi, zo, yo0);
      stage_planes(x, h_s, m, bi, yo0, zo * g.sz, g.kd);
      cp_async_commit();
    }
  }
  cp_async_wait<0>();
  float* pb = part + (long long)blockIdx.x * taps * g.c;
#pragma unroll
  for (int mt = 0; mt < kDwTiles; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int tap = 16 * (warp * kDwTiles + mt) + gq + 8 * hf;
      if (tap >= taps) continue;  // a padded tap row, or a warp with none
#pragma unroll
      for (int n = 0; n < kNTiles; ++n) {
        const int c = 8 * n + 2 * tq;
        if (c < g.c)
          *reinterpret_cast<float2*>(pb + (long long)tap * g.c + c) =
              make_float2(acc[mt][n][2 * hf], acc[mt][n][2 * hf + 1]);
      }
    }
}

// dw[i] = sum over blocks b = 0, 1, ... of part[b][i], in that order: the
// same bits on every run.
__global__ void __launch_bounds__(kReduceThreads)
    stem_dw_reduce_kernel(const float* __restrict__ part, float* __restrict__ dw, int blocks,
                          int n) {
  const int i = blockIdx.x * kReduceThreads + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int b = 0; b < blocks; ++b) s += part[(long long)b * n + i];
  dw[i] = s;
}

int round_up(int v, int m) { return (v + m - 1) / m * m; }

size_t halo_floats(const StemGeom& g) { return (size_t)g.kd * g.slab_rows * g.wp; }

// Blocks for ``work`` independent pieces: at most as many as fit on the card
// at once, so that a block's staged weights serve many pieces.
template <typename Kernel>
cudaError_t resident_blocks(Kernel kernel, int threads, size_t smem, long long work,
                            int* blocks) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long cap = (long long)sms * per_sm;
  *blocks = (int)std::max(1LL, std::min(work, cap));
  return cudaSuccess;
}

template <typename T, int SX>
cudaError_t launch_fwd(const void* x, const float* w, void* y, StemGeom g, cudaStream_t s) {
  const int taps = g.kd * g.kh * g.kw;
  const int xtiles = (g.ow + kXT - 1) / kXT;
  const int per_row = xtiles * (g.c / kCT);
  if (per_row > kFwdMaxThreads) return cudaErrorInvalidValue;
  g.wp = (xtiles * kXT - 1) * SX + g.kw;  // the last tile's reads stay in the halo
  size_t smem = 0;
  for (g.rows = std::max(1, std::min(g.oh, kFwdTarget / per_row));; --g.rows) {
    g.slab_rows = (g.rows - 1) * g.sy + g.kh;
    smem = sizeof(float) * ((size_t)taps * g.c + halo_floats(g));
    if (smem <= (size_t)kMaxSmem || g.rows == 1) break;
  }
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  const int threads = round_up(per_row * g.rows, 32);
  const long long groups = (long long)g.b * g.od * ((g.oh + g.rows - 1) / g.rows);
  int blocks = 0;
  cudaError_t err = resident_blocks(stem_fwd_kernel<T, SX>, threads, smem, groups, &blocks);
  if (err != cudaSuccess) return err;
  stem_fwd_kernel<T, SX><<<blocks, threads, smem, s>>>(
      static_cast<const T*>(x), w, static_cast<T*>(y), g);
  return cudaGetLastError();
}

template <typename T, int SX>
cudaError_t launch_dw(const void* x, const void* gy, float* dw, StemGeom g, cudaStream_t s) {
  const int taps = g.kd * g.kh * g.kw;
  const int threads = round_up(((taps + kTT - 1) / kTT) * (g.c / kCT), 32);
  if (threads > kDwMaxThreads) return cudaErrorInvalidValue;
  g.wp = (g.ow - 1) * SX + g.kw;
  size_t smem = 0;
  for (g.rows = std::min(g.oh, kDwRows);; --g.rows) {
    g.slab_rows = (g.rows - 1) * g.sy + g.kh;
    smem = sizeof(float) * ((size_t)g.rows * g.ow * g.c + halo_floats(g));
    if (smem <= (size_t)kMaxSmem || g.rows == 1) break;
  }
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  const long long groups = (long long)g.b * g.od * ((g.oh + g.rows - 1) / g.rows);
  int blocks = 0;
  cudaError_t err = resident_blocks(stem_dw_kernel<T, SX>, threads, smem, groups, &blocks);
  if (err != cudaSuccess) return err;
  const long long per_block = (groups + blocks - 1) / blocks;
  blocks = (int)((groups + per_block - 1) / per_block);
  stem_dw_kernel<T, SX><<<blocks, threads, smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(gy), dw, g, per_block);
  return cudaGetLastError();
}

// K5f's tensor-core body: the tap layout of ``pad_taps`` (ops/stem_im2col.py),
// as many rows a group as 8 warps of 4 m16 tiles take (7 rows of the ResNet
// stem's 72 tokens), one block an SM, each with a fixed run of groups.
size_t fwd_mma_smem(const MmaGeom& m) {
  return sizeof(__nv_bfloat16) * ((size_t)m.chunks * 8 * kCPad +
                                  (size_t)m.nslot * m.s.slab_rows * m.s.wp +
                                  (size_t)m.warps * 16 * kCPad) +
         sizeof(int) * (size_t)round_up(m.chunks, 4);
}

template <int SX>
cudaError_t launch_fwd_mma(const void* x, const void* w, void* y, StemGeom g, cudaStream_t s) {
  if (g.ow > kFwdTokens) return cudaErrorInvalidValue;
  MmaGeom m{};
  m.f = SX == 2 ? g.px % 2 : 0;
  m.kw8 = round_up(g.kw + m.f, 8);
  m.chunks = round_up(g.kd * g.kh * (m.kw8 / 8), 2);
  m.lpad = round_up(m.f + g.px, 8);
  m.nslot = g.kd + g.sz;
  g.wp = round_up(m.lpad + SX * (g.ow - 1) + m.kw8 - m.f - g.px, 8);
  m.vec = g.w % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  size_t smem = 0;
  for (g.rows = std::min(g.oh, kFwdTokens / g.ow);; --g.rows) {
    g.slab_rows = (g.rows - 1) * g.sy + g.kh;
    m.s = g;
    m.warps = ((g.rows * g.ow + 15) / 16 + kFwdTiles - 1) / kFwdTiles;
    smem = fwd_mma_smem(m);
    if (smem <= (size_t)kMaxSmem || g.rows == 1) break;
  }
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  const long long groups = (long long)g.b * g.od * ((g.oh + g.rows - 1) / g.rows);
  int blocks = 0;
  cudaError_t err =
      resident_blocks(stem_fwd_mma_kernel<SX>, m.warps * 32, smem, groups, &blocks);
  if (err != cudaSuccess) return err;
  const long long per_block = (groups + blocks - 1) / blocks;
  blocks = (int)((groups + per_block - 1) / per_block);
  stem_fwd_mma_kernel<SX><<<blocks, m.warps * 32, smem, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<__nv_bfloat16*>(y), m, per_block);
  return cudaGetLastError();
}

// K5w's tensor-core body and its reduction. ``rows`` (output rows a group)
// and ``blocks`` come from the wrapper (``dw_plan``), which sized ``part``
// [blocks, taps, C] by them; a plan whose blocks would not each own a group,
// or whose staging does not fit, is refused.
template <int SX>
cudaError_t launch_dw_mma(const void* x, const void* gy, float* dw, float* part, int rows,
                          int blocks, StemGeom g, cudaStream_t s) {
  const int taps = g.kd * g.kh * g.kw;
  if (taps > kDwMaxTaps || rows < 1 || rows > g.oh || blocks < 1 ||
      reinterpret_cast<uintptr_t>(gy) % 16 != 0)
    return cudaErrorInvalidValue;
  MmaGeom m{};
  m.owp = round_up(g.ow, 16);
  m.lpad = round_up(g.px, 8);
  m.nslot = g.kd + g.sz;
  g.wp = round_up(m.lpad + SX * (m.owp - 1) + g.kw - g.px, 8);
  g.rows = rows;
  g.slab_rows = (rows - 1) * g.sy + g.kh;
  m.s = g;
  m.vec = g.w % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  m.warps = ((taps + 15) / 16 + kDwTiles - 1) / kDwTiles;
  const size_t smem = sizeof(__nv_bfloat16) * ((size_t)m.nslot * g.slab_rows * g.wp +
                                               2 * (size_t)rows * m.owp * kCPad) +
                      sizeof(int) * (size_t)round_up(g.kd, 4);
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  const long long groups = (long long)g.b * g.od * ((g.oh + rows - 1) / rows);
  const long long per_block = (groups + blocks - 1) / blocks;
  if ((groups + per_block - 1) / per_block != blocks) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(stem_dw_mma_kernel<SX>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  stem_dw_mma_kernel<SX><<<blocks, m.warps * 32, smem, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(gy), part, m,
      per_block);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int n = taps * g.c;
  stem_dw_reduce_kernel<<<(n + kReduceThreads - 1) / kReduceThreads, kReduceThreads, 0, s>>>(
      part, dw, blocks, n);
  return cudaGetLastError();
}

StemGeom make_geom(int b, int d, int h, int w, int kd, int kh, int kw, int sz, int sy, int sx,
                   int pz, int py, int px, int c, int od, int oh, int ow) {
  StemGeom g{};
  g.b = b;
  g.d = d;
  g.h = h;
  g.w = w;
  g.kd = kd;
  g.kh = kh;
  g.kw = kw;
  g.sz = sz;
  g.sy = sy;
  g.sx = sx;
  g.pz = pz;
  g.py = py;
  g.px = px;
  g.c = c;
  g.od = od;
  g.oh = oh;
  g.ow = ow;
  return g;
}

bool supported(const StemGeom& g) {
  return g.c % kCT == 0 && g.c <= kMaxC && (g.sx == 1 || g.sx == 2) && g.b > 0 && g.od > 0 &&
         g.oh > 0 && g.ow > 0;
}

}  // namespace

// K5f. x [B, D, H, W] of the activation type (bf16 if bf16, else f32), y
// [B, od, oh, ow, C] of the activation type. bf16: w is the bf16 weight
// operand in ``pad_taps``'s layout ([rows, C], rows a multiple of 16) and
// the tensor-core body runs; with ``fma`` (bf16 only) w is [kd*kh*kw, C]
// f32, rounded on load, and the FMA body runs; f32: w is [kd*kh*kw, C] f32
// and the FMA body runs. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a shape the kernel does not take (C a multiple
// of 8 up to 64; the tensor-core body up to 512 output columns).
extern "C" int vsn_stem_conv_fwd(int bf16, int fma, const void* x, const void* w, void* y,
                                 int b, int d, int h, int wd, int kd, int kh, int kw, int sz,
                                 int sy, int sx, int pz, int py, int px, int c, int od, int oh,
                                 int ow, void* stream) {
  const StemGeom g = make_geom(b, d, h, wd, kd, kh, kw, sz, sy, sx, pz, py, px, c, od, oh, ow);
  if (!supported(g) || (fma && !bf16)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wt = static_cast<const float*>(w);
  cudaError_t err;
  if (bf16 && !fma)
    err = sx == 2 ? launch_fwd_mma<2>(x, w, y, g, s) : launch_fwd_mma<1>(x, w, y, g, s);
  else if (bf16)
    err = sx == 2 ? launch_fwd<__nv_bfloat16, 2>(x, wt, y, g, s)
                  : launch_fwd<__nv_bfloat16, 1>(x, wt, y, g, s);
  else
    err = sx == 2 ? launch_fwd<float, 2>(x, wt, y, g, s) : launch_fwd<float, 1>(x, wt, y, g, s);
  return (int)err;
}

// K5w. x as K5f, g [B, od, oh, ow, C] of the activation type (16-byte
// aligned for bf16), dw [kd*kh*kw, C] f32. bf16: the tensor-core body
// writes its blocks' partials to ``part`` [blocks, kd*kh*kw, C] f32 (rows
// output rows a group, both from the wrapper's plan) and the reduction
// kernel writes dw. With ``fma`` (bf16) or f32: the FMA body adds into dw,
// zeroed by the caller; part, rows and blocks are unused.
extern "C" int vsn_stem_conv_dw(int bf16, int fma, const void* x, const void* gy, void* dw,
                                void* part, int rows, int blocks, int b, int d, int h, int wd,
                                int kd, int kh, int kw, int sz, int sy, int sx, int pz, int py,
                                int px, int c, int od, int oh, int ow, void* stream) {
  const StemGeom g = make_geom(b, d, h, wd, kd, kh, kw, sz, sy, sx, pz, py, px, c, od, oh, ow);
  if (!supported(g) || (fma && !bf16)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* out = static_cast<float*>(dw);
  float* scratch = static_cast<float*>(part);
  cudaError_t err;
  if (bf16 && !fma)
    err = sx == 2 ? launch_dw_mma<2>(x, gy, out, scratch, rows, blocks, g, s)
                  : launch_dw_mma<1>(x, gy, out, scratch, rows, blocks, g, s);
  else if (bf16)
    err = sx == 2 ? launch_dw<__nv_bfloat16, 2>(x, gy, out, g, s)
                  : launch_dw<__nv_bfloat16, 1>(x, gy, out, g, s);
  else
    err = sx == 2 ? launch_dw<float, 2>(x, gy, out, g, s) : launch_dw<float, 1>(x, gy, out, g, s);
  return (int)err;
}
