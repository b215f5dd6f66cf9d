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
//      FlashAttention-2 form on bf16 mma.sync) at every head dim from 1 to
//      128, one block per (window, head, tile of 64 query rows), which also
//      writes each row's softmax statistics and (bf16) an f32 copy of the
//      attention output for K1b;
//   3. proj + bias + per-sample gain + residual: GEMM epilogue (common.cuh).
//
// The residual modes (_attn_fwd_kernel :271-288) touch launches 1 and 3
// only: with gamma (in-band LayerScale) launch 3's epilogue is ``lam * x +
// gains[s] * ((acc + bproj) * gamma)`` (common.cuh LS_EPI); with post_norm
// launch 1 reads raw x (no LayerNorm prologue), launch 3 writes the f32
// branch proj(ao) + bproj, and a fourth launch, the post-norm row kernel
// (common.cuh), forms ``lam * x + gains[s] * (LN1(branch) [* gamma])`` over
// whole rows. The attention launch is the same in every mode; K1b's
// backward reads the ao, row statistics and f32 o it leaves.
//
// Launches 1 and 3 are common.cuh's GEMM: bf16 mma.sync on the tensor
// cores with f32 accumulation under bf16 activations, FMA under f32. The
// qkv and ao intermediates round-trip through device memory; fusing them
// away is later performance work.
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
// three launches with the attention launch on the same tiled body under the
// probes' softmax policies and layout (below), so that their times split
// K1f's own: ``vsn_probe_attn_half``.

#include "attn_tiled.cuh"
#include "common.cuh"

namespace {

template <typename T>
int attn_half_fwd(const T* x, const float* ln_w, const float* ln_b, const float* qkv_w,
                  const float* qkv_b, const float* bias, const int* ids, int ids_rows,
                  const float* proj_w, const float* proj_b, const float* gains,
                  const float* gamma, int post_norm, T* qkv_buf, T* ao_buf, float* o32,
                  float* row_stats, float* branch32, T* out, long long bw, int n, int c,
                  int heads, long long rows_per_sample, float scale, float lam,
                  cudaStream_t stream) {
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

  err = launch_attention_tiled<T>(qkv_buf, bias, ids, ids_rows, ao_buf, o32, row_stats, bw, n,
                                  c, heads, scale, stream, plain_loads<T>(c / heads, {qkv_buf}));
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

// The probes' softmax policies on the tiled body (attn_tiled.cuh ``Probs``),
// forward only, keeping no statistics. The score is dot * scale + bias (the
// probes pass no ids); the shift is the plain row max.
//
// ProbeSoftmax, the probes' SM_PLAIN (full2d, noln, nobias, attn_only; P5's
// "full"): p = round(exp(s - rowmax) / rowsum), normalized before its
// rounding, O not scaled: two passes over the key tiles in one launch, the
// first for each row's max and sum, the second for p and O += p V.
struct ProbeSoftmax {
  static constexpr float kShift0 = -INFINITY;
  static constexpr float kSumEps = 0.f;
  static constexpr bool kColumnSums = false;
  static constexpr bool kPlainLoads = true;
  static constexpr Probs kProbs = Probs::kNormalized;
  static constexpr bool kKeepsStats = false;

  static __device__ __forceinline__ float score(float acc, float scale, const int*, int,
                                                const float* bias_i, int j) {
    const float s = __fmul_rn(acc, scale);
    return bias_i ? __fadd_rn(s, bias_i[j]) : s;
  }
};

// ProbeScaled, the probes' SM_SCALE (nosm): p = round(0.001 s), no max, no
// sum, one pass.
struct ProbeScaled : ProbeSoftmax {
  static constexpr Probs kProbs = Probs::kScaled;

  static __device__ __forceinline__ float scaled(float s) { return __fmul_rn(0.001f, s); }
};

// The probes' layout: q, k, v of window bw's token t at row bw N + t of
// qkv [BW*N, 3C] (columns 0, C, 2C; head h at h d), ao [BW*N, C] as
// Packed's; or, ATTN_ONLY, q = k = v = the LayerNorm'd rows y [BW*N, C]
// (column h d), with out = TX(x + o) in place of ao, o in f32, cast once.
// wb windows to a block, taken in turn (P5; P1 at 1).
template <typename TX, bool ATTN_ONLY>
struct ProbeRows {
  const TX* x;  // ATTN_ONLY: x and out [BW*N, C]
  TX* out;
  int wb;

  template <typename T>
  struct Head {
    const T* q;      // the head's q of the window's token 0
    long long row0;  // the window's token 0 in out: (bw N) C + h d
    int c;
    const TX* x;
    TX* y;           // out

    template <int D, typename P>
    __device__ __forceinline__ void stage_q(T* dst, int t0, int nrows, int d, bool plain) const {
      const long long ld = ATTN_ONLY ? c : 3LL * c;
      stage_tile<T, D, P>(dst, q + t0 * ld, ld, nrows, d, plain);
    }
    template <int D, typename P>
    __device__ __forceinline__ void stage_kv(T* kvs, int n, int kt, int d, bool plain) const {
      constexpr int LD = kLd<T, D>;
      const long long ld = ATTN_ONLY ? c : 3LL * c, k = ATTN_ONLY ? 0 : c;  // v at 2 k
      T* dst = kvs + (kt & 1) * 2 * kTile * LD;
      const T* src = q + kt * kTile * ld;
      const int nk = min(kTile, n - kt * kTile);
      stage_tile<T, D, P>(dst, src + k, ld, nk, d, plain);
      stage_tile<T, D, P>(dst + kTile * LD, src + 2 * k, ld, nk, d, plain);
      cp_async_commit();
    }
    __device__ __forceinline__ long long out(int t) const { return row0 + (long long)t * c; }
    // element ``to`` of the head's output (out(t) + channel): ao, or out =
    // x + o
    __device__ __forceinline__ void store(T* ao, long long to, float o) const {
      if constexpr (ATTN_ONLY)
        y[to] = from_f32<TX>(to_f32(x[to]) + o);
      else
        ao[to] = from_f32<T>(o);
    }
  };

  template <typename T>
  __device__ __forceinline__ Head<T> head(const T* qkv, long long bw, int h, int n, int c, int d,
                                          int) const {
    return {qkv + bw * n * (ATTN_ONLY ? c : 3LL * c) + h * d, bw * n * c + h * d, c, x, out};
  }
  __device__ __forceinline__ const int* ids(const int*, long long, int, int) const {
    return nullptr;
  }
};

template <typename TX, bool ATTN_ONLY>
constexpr bool kGrouped<ProbeRows<TX, ATTN_ONLY>> = true;

// The probes' attention launch under policy P on layout L: the tiled body at
// head dims up to 64 (D = 32, 64; the probes' windows are Swin-T's stage-1
// d = 32), bf16 qkv (or attn_only's y) at any offset.
template <typename P, typename L>
cudaError_t probe_attention(const __nv_bfloat16* qkv, const float* bias, __nv_bfloat16* ao,
                            long long bw, int n, int c, int heads, float scale, const L& lay,
                            cudaStream_t stream) {
  using B = __nv_bfloat16;
  const int d = c / heads;
  const bool plain = plain_loads<B>(d, {qkv});
  if (d < 1 || d > 64) return cudaErrorInvalidValue;
  if (d <= 32)
    return launch_attention_tiled_d<B, 32, P>(qkv, bias, nullptr, 1, ao, nullptr, nullptr, bw,
                                              n, c, heads, scale, plain, lay, stream);
  return launch_attention_tiled_d<B, 64, P>(qkv, bias, nullptr, 1, ao, nullptr, nullptr, bw, n,
                                            c, heads, scale, plain, lay, stream);
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
    const ProbeRows<TX, true> lay = {x, out, wb};
    return (int)probe_attention<ProbeSoftmax>(ao_buf, bias, nullptr, bw, n, c, heads, scale,
                                              lay, stream);
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
    const ProbeRows<B, false> lay = {nullptr, nullptr, wb};
    err = variant == PROBE_NOSM
              ? probe_attention<ProbeScaled>(qkv_buf, b, ao_buf, bw, n, c, heads, scale, lay,
                                             stream)
              : probe_attention<ProbeSoftmax>(qkv_buf, b, ao_buf, bw, n, c, heads, scale, lay,
                                              stream);
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
// The attention launch takes every head dim from 1 to 128 (C / heads) at any
// N; it also writes row_stats [BW, H, N, 2] f32 (each row's softmax shift
// and 1 / (sum + 1e-30)) and, with bf16 activations, o32 [BW*N, C], the
// attention output in f32 (null for f32 activations, whose ao_buf is f32):
// K1b's inputs beside ao_buf. gamma [C] (in-band LayerScale) may be null;
// post_norm moves LN1 onto the branch and needs branch32, an f32 [BW*N, C]
// scratch (else null).
extern "C" int vsn_attn_half_fwd(int is_bf16, const void* x, const float* ln_w,
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
        static_cast<const __nv_bfloat16*>(x), ln_w, ln_b, qkv_w, qkv_b, bias, ids, ids_rows,
        proj_w, proj_b, gains, gamma, post_norm, static_cast<__nv_bfloat16*>(qkv_buf),
        static_cast<__nv_bfloat16*>(ao_buf), o32, row_stats, branch32,
        static_cast<__nv_bfloat16*>(out), bw, n, c, heads, rows_per_sample, scale, lam, s);
  return attn_half_fwd<float>(static_cast<const float*>(x), ln_w, ln_b, qkv_w, qkv_b, bias,
                              ids, ids_rows, proj_w, proj_b, gains, gamma, post_norm,
                              static_cast<float*>(qkv_buf), static_cast<float*>(ao_buf),
                              nullptr, row_stats, branch32, static_cast<float*>(out), bw, n,
                              c, heads, rows_per_sample, scale, lam, s);
}

// K1f's key-tiled attention launch alone (launch 2 above): qkv [BW*N, 3C]
// -> ao [BW*N, C], o32 and row_stats as there; qkv may lie at any offset.
extern "C" int vsn_attention_tiled_fwd(int is_bf16, const void* qkv, const float* bias,
                                       const int* ids, int ids_rows, void* ao, float* o32,
                                       float* row_stats, long long bw, int n, int c,
                                       int heads, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)launch_attention_tiled<__nv_bfloat16>(
        static_cast<const __nv_bfloat16*>(qkv), bias, ids, ids_rows,
        static_cast<__nv_bfloat16*>(ao), o32, row_stats, bw, n, c, heads, scale, s,
        plain_loads<__nv_bfloat16>(c / heads, {qkv}));
  return (int)launch_attention_tiled<float>(static_cast<const float*>(qkv), bias, ids,
                                            ids_rows, static_cast<float*>(ao), nullptr,
                                            row_stats, bw, n, c, heads, scale, s,
                                            plain_loads<float>(c / heads, {qkv}));
}

// The attention probes P1 / P5 (``probe_attn_half``). is_bf16 selects bf16 x
// and out (else f32); wqkv [C, 3C], bias [H, N, N], wproj [C, C] and unit
// ([1] * C + [0] * C) are f32. qkv_buf is bf16 [BW*N, 3C], ao_buf bf16
// [BW*N, C], stats f32 [BW*N, 2] (attn_only's LayerNorm rows). wb windows
// per block of the attention launch (BW divisible by wb); head dims up to 64.
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
