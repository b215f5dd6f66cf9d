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
//
// What bounds them on this card: the ResNet stem at micro-batch 12 is
// 2*343*64 FLOP for each of 10.45M output tokens, 459 GFLOP, against 1.34 GB
// of bf16 output; on tensor cores that is compute-bound at 0.46 ms. These
// kernels run the products as FMA on f32 registers (operands already rounded
// to the activation type, f32 accumulation, as the TPU kernel's MXU dot),
// so their floor is the f32 FMA rate, about 6.8 ms each.
//
// Design. The TPU kernel builds the im2col matrix in VMEM from stride-2
// parity planes laid out z-on-sublanes, because of Mosaic's tiling rules.
// Here the matrix is never built: a block stages the input halo that a
// group of R output rows (b, zo, yo0 .. yo0+R-1) reads (kd planes x
// (R-1)*sy + kh rows x the padded width, f32) in shared memory, and every
// thread reads its taps from there by index.
//   K5f keeps the [taps, C] weights in shared memory for the block's whole
//   life (343 x 64 f32 = 88 KB) and walks over row groups; a thread sums 4
//   output columns x 8 channels over all taps and stores them once, rounded.
//   K5w also stages the R cotangent rows; a thread owns 8 taps x 8 channels
//   of dW and sums them over every token of its block's share of the row
//   groups (split-K), then adds its partials into dW with one f32 atomicAdd
//   per element. The TPU kernel adds into one revisited output block on its
//   sequential grid instead; here the order of the adds varies between runs.
// A thread's 8 channels are c0..c0+3 and C/2+c0..C/2+c0+3, so that a warp's
// float4 loads of a weight or cotangent row are conflict-free.

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

// K5f. x [B, D, H, W] of the activation type (bf16 if bf16, else f32), w
// [kd*kh*kw, C] f32 (rounded to the activation type on load), y
// [B, od, oh, ow, C] of the activation type. Returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for a shape the kernel does
// not take (C a multiple of 8 up to 64).
extern "C" int vsn_stem_conv_fwd(int bf16, const void* x, const void* w, void* y, int b, int d,
                                 int h, int wd, int kd, int kh, int kw, int sz, int sy, int sx,
                                 int pz, int py, int px, int c, int od, int oh, int ow,
                                 void* stream) {
  const StemGeom g = make_geom(b, d, h, wd, kd, kh, kw, sz, sy, sx, pz, py, px, c, od, oh, ow);
  if (!supported(g)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wt = static_cast<const float*>(w);
  cudaError_t err;
  if (bf16)
    err = sx == 2 ? launch_fwd<__nv_bfloat16, 2>(x, wt, y, g, s)
                  : launch_fwd<__nv_bfloat16, 1>(x, wt, y, g, s);
  else
    err = sx == 2 ? launch_fwd<float, 2>(x, wt, y, g, s) : launch_fwd<float, 1>(x, wt, y, g, s);
  return (int)err;
}

// K5w. x as K5f, g [B, od, oh, ow, C] of the activation type, dw
// [kd*kh*kw, C] f32, zeroed by the caller; the kernel adds into it.
extern "C" int vsn_stem_conv_dw(int bf16, const void* x, const void* gy, void* dw, int b, int d,
                                int h, int wd, int kd, int kh, int kw, int sz, int sy, int sx,
                                int pz, int py, int px, int c, int od, int oh, int ow,
                                void* stream) {
  const StemGeom g = make_geom(b, d, h, wd, kd, kh, kw, sz, sy, sx, pz, py, px, c, od, oh, ow);
  if (!supported(g)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* out = static_cast<float*>(dw);
  cudaError_t err;
  if (bf16)
    err = sx == 2 ? launch_dw<__nv_bfloat16, 2>(x, gy, out, g, s)
                  : launch_dw<__nv_bfloat16, 1>(x, gy, out, g, s);
  else
    err = sx == 2 ? launch_dw<float, 2>(x, gy, out, g, s) : launch_dw<float, 1>(x, gy, out, g, s);
  return (int)err;
}
