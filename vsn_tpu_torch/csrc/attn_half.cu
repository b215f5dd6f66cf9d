// K1f: the Swin attention half-block, forward.
//
//   out = lam * x + gains[s] * proj(window_attention(qkv(LN(x))))
//
// Replaces vsn_tpu/ops/swin_block_kernels.py _attn_half_fwd (Pallas kernel
// _attn_fwd_kernel, heads in _heads_attention_fwd), which keeps one whole
// window in TPU VMEM per program.
//
// What bounds it here. One window's [N, N] f32 score matrix is 254 KB at
// N = 252 and whole-window qkv is 290 KB at C = 192 (bf16); both exceed the
// 227 KB of shared memory a block may use, so a window cannot stay on chip
// the way it stays in VMEM. And the head merge before proj needs every head
// of a window at once. The work is therefore split into three launches on
// the caller's stream, each with data that fits:
//
//   1. LN1 + qkv projection: LayerNorm-prologue GEMM (common.cuh) writing
//      qkv [BW*N, 3C] in the activation type. The TPU kernel rounds q, k, v
//      to that type before its products, so storing them rounded loses
//      nothing.
//   2. Attention on the key-tiled body of attn_tiled.cuh (the
//      FlashAttention-2 form on bf16 mma.sync), one block per (window,
//      head, tile of 64 query rows), which also writes each row's softmax
//      statistics and (bf16) an f32 copy of the attention output for K1b;
//   3. proj + bias + per-sample gain + residual: GEMM epilogue (common.cuh).
//
// Launch 2 has two bodies, chosen by head dim in the caller: the key-tiled
// one wherever it takes the head dim (multiples of 16 up to 128: Swin's
// d = 32 windows of N = 252 and 150, ViT's d = 64, vsn_tpu/models/vit3d.py
// _fused_attn_half, one window of N = 811 tokens per sample), and the
// whole-window one below for other head dims up to 32 (none of the
// presets; the attention probes run it as their variants): one block per
// (window, head), K and V of the head (N x 32 f32, 65 KB) in shared memory,
// each warp taking query rows and keeping that row's N scores in shared
// memory (never the whole [N, N] matrix), writing the head's slice of the
// merged output ao.
//
// The residual modes (_attn_fwd_kernel :271-288) touch launches 1 and 3
// only: with gamma (in-band LayerScale) launch 3's epilogue is ``lam * x +
// gains[s] * ((acc + bproj) * gamma)`` (common.cuh LS_EPI); with post_norm
// launch 1 reads raw x (no LayerNorm prologue), launch 3 writes the f32
// branch proj(ao) + bproj, and a fourth launch, the post-norm row kernel
// (common.cuh), forms ``lam * x + gains[s] * (LN1(branch) [* gamma])`` over
// whole rows. The attention launch is the same in every mode; under
// post_norm K1b's backward reads the ao it leaves in ao_buf.
//
// Launches 1 and 3 are common.cuh's GEMM: bf16 mma.sync on the tensor
// cores with f32 accumulation under bf16 activations, FMA under f32. The
// whole-window attention body is FMA with f32 accumulation on operands
// rounded to the activation type. The qkv and ao intermediates round-trip
// through device memory; fusing them away is later performance work.
//
// Softmax semantics (swin_block_kernels.py:210-221): the shift is
// max(rowmax, 0), not the plain rowmax; the row sum gets +1e-30, so a fully
// masked row gives 0, not NaN; 1/sum multiplies the [N, d] head output; the
// region mask is additive -1e9 where ids differ. The key loop runs over the
// N real keys only, so no padded key slot exists to add anything.
//
// Indexing: ids row = bw % W (W = 1 means one row for every window); the
// residual gain of window bw is gains[bw / nW] (windows are sample-major).
//
// The attention-ablation probes (scripts/perf_probe_attn_ablate.py ``build``
// and perf_probe_attn_ablate2.py ``build_slot``, P1 and P5) run this file's
// three launches as compile-time variants, so that their times split K1f's
// own: ``vsn_probe_attn_half`` below. K1f is the default instantiation
// (SM_K1, packed qkv, one window per block).

#include "attn_tiled.cuh"
#include "common.cuh"

namespace {

constexpr int kAttnWarps = 8;

// Softmax of one score row u[0..n) (held per warp in shared memory):
//   SM_K1     e = exp(s - max(rowmax, 0)), p = round(e); the output is
//             scaled by 1 / (sum e + 1e-30) after the PV product (K1f);
//   SM_PLAIN  p = round(exp(s - rowmax) / sum): normalized before the
//             rounding, no output scale (the probes' softmax);
//   SM_SCALE  p = round(0.001 s): no exp, no sum (the ``nosm`` probe).
enum Softmax { SM_K1 = 0, SM_PLAIN = 1, SM_SCALE = 2 };

// One (window, head) of the attention launch: K and V of the head staged in
// shared memory, query rows taken by warp. T is qkv's and ao's element type
// and the type every product operand is rounded to. ATTN_ONLY reads q = k =
// v from one [rows, C] buffer (no projections) and writes out = x + ao in
// f32, cast once to TX, instead of ao.
template <typename T, int SM, bool ATTN_ONLY, typename TX>
__device__ __forceinline__ void window_head_attention(
    const T* __restrict__ qkv, const float* __restrict__ bias,
    const int* __restrict__ ids, int ids_rows, T* __restrict__ ao, int n,
    int c, int heads, float scale, long long bw, int h,
    const TX* __restrict__ x, TX* __restrict__ out, float* smem) {
  const int d = c / heads;
  float* ks = smem;                      // [n][d + 1]  (padded: no bank conflicts)
  float* vs = ks + n * (d + 1);          // [n][d]
  float* qs = vs + n * d;                // [warps][32]
  float* us = qs + kAttnWarps * 32;      // [warps][n]  one row of scores
  int* ids_s = reinterpret_cast<int*>(us + kAttnWarps * n);  // [n]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long base = bw * n;
  const int c3 = ATTN_ONLY ? c : 3 * c;  // qkv's row stride
  const int ko = ATTN_ONLY ? 0 : c;      // k's and v's column offsets
  const int vo = ATTN_ONLY ? 0 : 2 * c;

  for (int e = tid; e < n * d; e += blockDim.x) {
    const int j = e / d, cc = e % d;
    const T* row = qkv + (base + j) * c3 + h * d + cc;
    ks[j * (d + 1) + cc] = to_f32(row[ko]);
    vs[j * d + cc] = to_f32(row[vo]);
  }
  if (ids) {
    const int* id_row = ids + (bw % ids_rows) * n;
    for (int j = tid; j < n; j += blockDim.x) ids_s[j] = id_row[j];
  }
  __syncthreads();

  float* q = qs + warp * 32;
  float* u = us + warp * n;
  const float* bias_h = bias ? bias + (long long)h * n * n : nullptr;
  for (int i = warp; i < n; i += kAttnWarps) {
    if (lane < d) q[lane] = to_f32(qkv[(base + i) * c3 + h * d + lane]);
    __syncwarp();
    const int id_i = ids ? ids_s[i] : 0;
    float mx = -INFINITY;
    for (int j = lane; j < n; j += 32) {
      const float* kr = ks + j * (d + 1);
      float dot = 0.f;
      for (int cc = 0; cc < d; ++cc) dot = fmaf(q[cc], kr[cc], dot);
      float s = dot * scale;
      if (ids) s += (ids_s[j] != id_i) ? kNegInf : 0.f;
      if (bias_h) s += bias_h[(long long)i * n + j];
      u[j] = s;
      mx = fmaxf(mx, s);
    }
    if (SM == SM_SCALE)
      for (int j = lane; j < n; j += 32) u[j] = round_to<T>(0.001f * u[j]);
    else
      mx = SM == SM_K1 ? fmaxf(warp_max(mx), 0.f) : warp_max(mx);
    float sum = 0.f;
    if (SM != SM_SCALE) {
      for (int j = lane; j < n; j += 32) {
        const float e = expf(u[j] - mx);
        sum += e;
        u[j] = SM == SM_K1 ? round_to<T>(e) : e;  // u.astype(cdt) before PV
      }
      sum = warp_sum(sum);
      if (SM == SM_PLAIN)
        for (int j = lane; j < n; j += 32) u[j] = round_to<T>(u[j] / sum);
    }
    __syncwarp();
    if (lane < d) {
      float o = 0.f;
      for (int j = 0; j < n; ++j) o = fmaf(u[j], vs[j * d + lane], o);
      const long long at = (base + i) * c + h * d + lane;
      if (ATTN_ONLY)
        out[at] = from_f32<TX>(to_f32(x[at]) + o);
      else
        ao[at] = from_f32<T>(SM == SM_K1 ? o * (1.f / (sum + 1e-30f)) : o);
    }
    __syncwarp();
  }
}

// One block per (group of wb windows, head), taking the group's windows in
// turn. K1f (SM_K1) keeps one window per block and calls the body once: a
// window loop whose bound the compiler cannot see changed K1f's registers
// (40 -> 61) and its code.
template <typename T, int SM = SM_K1, bool ATTN_ONLY = false, typename TX = T>
__global__ void __launch_bounds__(kAttnWarps * 32) window_attention_kernel(
    const T* __restrict__ qkv, const float* __restrict__ bias,
    const int* __restrict__ ids, int ids_rows, T* __restrict__ ao, int n,
    int c, int heads, float scale, int wb, const TX* __restrict__ x,
    TX* __restrict__ out) {
  extern __shared__ float smem[];
  const long long group = blockIdx.x / heads;
  const int h = blockIdx.x % heads;
  if (SM == SM_K1) {
    window_head_attention<T, SM, ATTN_ONLY, TX>(qkv, bias, ids, ids_rows, ao, n, c,
                                                heads, scale, group, h, x, out, smem);
    return;
  }
  for (int slot = 0; slot < wb; ++slot) {
    const long long bw = group * wb + slot;
    if (slot) __syncthreads();  // every warp is done with the last window's K, V
    window_head_attention<T, SM, ATTN_ONLY, TX>(qkv, bias, ids, ids_rows, ao, n, c,
                                                heads, scale, bw, h, x, out, smem);
  }
}

size_t attention_smem_bytes(int n, int d) {
  return sizeof(float) * ((size_t)n * (d + 1) + (size_t)n * d + kAttnWarps * 32 +
                          (size_t)kAttnWarps * n) +
         sizeof(int) * (size_t)n;
}

template <typename T, int SM, bool ATTN_ONLY, typename TX>
cudaError_t launch_attention(const T* qkv, const float* bias, const int* ids,
                             int ids_rows, T* ao, long long bw, int n, int c,
                             int heads, float scale, int wb, const TX* x, TX* out,
                             cudaStream_t stream) {
  auto kernel = window_attention_kernel<T, SM, ATTN_ONLY, TX>;
  const size_t smem = attention_smem_bytes(n, c / heads);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)(bw / wb * heads), kAttnWarps * 32, smem, stream>>>(
      qkv, bias, ids, ids_rows, ao, n, c, heads, scale, wb, x, out);
  return cudaGetLastError();
}

template <typename T>
int attn_half_fwd(int tiled, const T* x, const float* ln_w, const float* ln_b,
                  const float* qkv_w, const float* qkv_b, const float* bias,
                  const int* ids, int ids_rows, const float* proj_w,
                  const float* proj_b, const float* gains, const float* gamma,
                  int post_norm, T* qkv_buf, T* ao_buf, float* o32, float* row_stats,
                  float* branch32, T* out, long long bw, int n, int c, int heads, long long rows_per_sample,
                  float scale, float lam, cudaStream_t stream) {
  const long long rows = bw * n;

  GemmParams<T> g1 = {};
  g1.a = x;
  g1.ln_w = post_norm ? nullptr : ln_w;
  g1.ln_b = ln_b;
  g1.w = qkv_w;
  g1.bias = qkv_b;
  g1.out = qkv_buf;
  g1.m = rows;
  g1.n = 3 * c;
  g1.k = c;
  cudaError_t err = launch_gemm<T, EPI_BIAS>(g1, stream);
  if (err != cudaSuccess) return (int)err;

  err = tiled ? launch_attention_tiled<T>(qkv_buf, bias, ids, ids_rows, ao_buf, o32,
                                          row_stats, bw, n, c, heads, scale, stream)
              : launch_attention<T, SM_K1, false, T>(qkv_buf, bias, ids, ids_rows, ao_buf,
                                                     bw, n, c, heads, scale, 1, nullptr,
                                                     nullptr, stream);
  if (err != cudaSuccess) return (int)err;

  GemmParams<T> g3 = {};
  g3.a = ao_buf;
  g3.w = proj_w;
  g3.bias = proj_b;
  g3.resid = x;
  g3.gains = gains;
  g3.rows_per_sample = rows_per_sample;
  g3.lam = lam;
  g3.gamma = gamma;
  g3.out = out;
  g3.out32 = branch32;
  g3.m = rows;
  g3.n = c;
  g3.k = c;
  if (post_norm) {
    err = launch_gemm<T, EPI_F32>(g3, stream);
    if (err != cudaSuccess) return (int)err;
    return (int)launch_postnorm_fwd<T>(branch32, x, ln_w, ln_b, gamma, gains,
                                       rows_per_sample, lam, out, rows, c, stream);
  }
  if (gamma) return (int)launch_gemm<T, EPI_RESIDUAL, false, LS_EPI>(g3, stream);
  return (int)launch_gemm<T, EPI_RESIDUAL>(g3, stream);
}

// The probes' variants (perf_probe_attn_ablate.py ``kernel``: ``variant``;
// perf_probe_attn_ablate2.py ``slot_kernel``: "full" is PROBE_FULL, "lin"
// PROBE_LINEAR_ONLY).
enum Probe {
  PROBE_FULL = 0,         // LN -> qkv -> attention -> proj -> x + branch
  PROBE_NOLN = 1,         // y = x
  PROBE_NOSM = 2,         // p = 0.001 s
  PROBE_NOBIAS = 3,       // no bias add
  PROBE_LINEAR_ONLY = 4,  // ao = q slice of qkv: no attention launch
  PROBE_ATTN_ONLY = 5,    // q = k = v = LN(x), branch = ao in f32: no GEMMs
};

// The probes' function: LayerNorm without affine (w = 1, b = 0 in f32 is
// exact), no linear biases, no ids, no gains (gains = 1 and lam = 1 make
// EPI_RESIDUAL's lam * x + gains * branch exactly x + branch), weights in
// the (in, out) layout (W_KN), every product operand rounded to bf16 for
// either activation type TX. qkv, ao (and attn_only's y) are bf16 buffers:
// the probes round them to bf16 before their every use.
template <typename TX>
int probe_attn_half(int variant, int wb, const TX* x, const float* wqkv,
                    const float* bias, const float* wproj, const float* unit,
                    __nv_bfloat16* qkv_buf, __nv_bfloat16* ao_buf, float* stats,
                    TX* out, long long bw, int n, int c, int heads, float scale,
                    cudaStream_t stream) {
  using B = __nv_bfloat16;
  const long long rows = bw * n;
  const float* ones = unit;      // [c] of 1: LayerNorm scale, gains
  const float* zeros = unit + c;  // [c] of 0: LayerNorm shift
  cudaError_t err;
  if (variant == PROBE_ATTN_ONLY) {
    err = launch_ln_rows<TX, B>(x, ones, zeros, ao_buf, stats, rows, c, stream);
    if (err != cudaSuccess) return (int)err;
    return (int)launch_attention<B, SM_PLAIN, true, TX>(ao_buf, bias, nullptr, 1,
                                                        nullptr, bw, n, c, heads,
                                                        scale, wb, x, out, stream);
  }
  GemmParams<B, TX> g1 = {};
  g1.a = x;
  g1.ln_w = variant == PROBE_NOLN ? nullptr : ones;
  g1.ln_b = zeros;
  g1.w = wqkv;
  g1.out = qkv_buf;
  g1.m = rows;
  g1.n = 3 * c;
  g1.k = c;
  err = launch_gemm<B, EPI_BIAS, true>(g1, stream);
  if (err != cudaSuccess) return (int)err;

  if (variant != PROBE_LINEAR_ONLY) {
    const float* b = variant == PROBE_NOBIAS ? nullptr : bias;
    err = variant == PROBE_NOSM
              ? launch_attention<B, SM_SCALE, false, B>(qkv_buf, b, nullptr, 1, ao_buf,
                                                        bw, n, c, heads, scale, wb,
                                                        nullptr, nullptr, stream)
              : launch_attention<B, SM_PLAIN, false, B>(qkv_buf, b, nullptr, 1, ao_buf,
                                                        bw, n, c, heads, scale, wb,
                                                        nullptr, nullptr, stream);
    if (err != cudaSuccess) return (int)err;
  }

  GemmParams<B, B, TX> g3 = {};
  g3.a = variant == PROBE_LINEAR_ONLY ? qkv_buf : ao_buf;
  g3.lda = variant == PROBE_LINEAR_ONLY ? 3 * c : 0;
  g3.w = wproj;
  g3.resid = x;
  g3.gains = ones;
  g3.rows_per_sample = rows;
  g3.lam = 1.f;
  g3.out = out;
  g3.m = rows;
  g3.n = c;
  g3.k = c;
  return (int)launch_gemm<B, EPI_RESIDUAL, true>(g3, stream);
}

}  // namespace

// Returns cudaGetLastError() of the first launch that failed, else 0.
// is_bf16 selects bf16 activations (else f32); parameters are f32.
// bias and ids may be null (no relative-position bias / no region mask).
// tiled selects the key-tiled attention launch (head dims that are
// multiples of 16 up to 128, any N) over the whole-window one (other head
// dims up to 32, K and V of a window in shared memory); the caller chooses
// by head dim.
// The tiled launch also writes row_stats [BW, H, N, 2] f32 (each row's
// softmax shift and 1 / (sum + 1e-30)) and, with bf16 activations, o32
// [BW*N, C], the attention output in f32 (null for f32 activations, whose
// ao_buf is f32): K1b's inputs beside ao_buf. gamma [C] (in-band
// LayerScale) may be null; post_norm moves LN1 onto the branch and needs
// branch32, an f32 [BW*N, C] scratch (else null).
extern "C" int vsn_attn_half_fwd(int tiled, int is_bf16, const void* x, const float* ln_w,
                                 const float* ln_b, const float* qkv_w,
                                 const float* qkv_b, const float* bias,
                                 const int* ids, int ids_rows,
                                 const float* proj_w, const float* proj_b,
                                 const float* gains, const float* gamma, int post_norm,
                                 void* qkv_buf, void* ao_buf, float* o32, float* row_stats,
                                 float* branch32, void* out, long long bw, int n, int c,
                                 int heads, long long rows_per_sample, float scale,
                                 float lam, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return attn_half_fwd<__nv_bfloat16>(
        tiled, static_cast<const __nv_bfloat16*>(x), ln_w, ln_b, qkv_w, qkv_b, bias, ids,
        ids_rows, proj_w, proj_b, gains, gamma, post_norm,
        static_cast<__nv_bfloat16*>(qkv_buf), static_cast<__nv_bfloat16*>(ao_buf), o32,
        row_stats, branch32, static_cast<__nv_bfloat16*>(out), bw, n, c, heads,
        rows_per_sample, scale, lam, s);
  return attn_half_fwd<float>(tiled, static_cast<const float*>(x), ln_w, ln_b, qkv_w, qkv_b,
                              bias, ids, ids_rows, proj_w, proj_b, gains, gamma, post_norm,
                              static_cast<float*>(qkv_buf), static_cast<float*>(ao_buf),
                              nullptr, row_stats, branch32, static_cast<float*>(out), bw, n,
                              c, heads, rows_per_sample, scale, lam, s);
}

// K1f's key-tiled attention launch alone (the attention of ``tiled`` above):
// qkv [BW*N, 3C] -> ao [BW*N, C], o32 and row_stats as there.
extern "C" int vsn_attention_tiled_fwd(int is_bf16, const void* qkv, const float* bias,
                                       const int* ids, int ids_rows, void* ao, float* o32,
                                       float* row_stats, long long bw, int n, int c,
                                       int heads, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)launch_attention_tiled<__nv_bfloat16>(
        static_cast<const __nv_bfloat16*>(qkv), bias, ids, ids_rows,
        static_cast<__nv_bfloat16*>(ao), o32, row_stats, bw, n, c, heads, scale, s);
  return (int)launch_attention_tiled<float>(static_cast<const float*>(qkv), bias, ids,
                                            ids_rows, static_cast<float*>(ao), nullptr,
                                            row_stats, bw, n, c, heads, scale, s);
}

// The attention probes P1 / P5 (``probe_attn_half``). is_bf16 selects bf16 x
// and out (else f32); wqkv [C, 3C], bias [H, N, N], wproj [C, C] and unit
// ([1] * C + [0] * C) are f32. qkv_buf is bf16 [BW*N, 3C], ao_buf bf16
// [BW*N, C], stats f32 [BW*N, 2] (used by attn_only). wb windows per block
// of the attention launch (BW divisible by wb).
extern "C" int vsn_probe_attn_half(int variant, int wb, int is_bf16, const void* x,
                                   const float* wqkv, const float* bias,
                                   const float* wproj, const float* unit,
                                   void* qkv_buf, void* ao_buf, float* stats,
                                   void* out, long long bw, int n, int c, int heads,
                                   float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* qb = static_cast<__nv_bfloat16*>(qkv_buf);
  auto* ab = static_cast<__nv_bfloat16*>(ao_buf);
  if (is_bf16)
    return probe_attn_half<__nv_bfloat16>(
        variant, wb, static_cast<const __nv_bfloat16*>(x), wqkv, bias, wproj, unit,
        qb, ab, stats, static_cast<__nv_bfloat16*>(out), bw, n, c, heads, scale, s);
  return probe_attn_half<float>(variant, wb, static_cast<const float*>(x), wqkv, bias,
                                wproj, unit, qb, ab, stats, static_cast<float*>(out),
                                bw, n, c, heads, scale, s);
}
