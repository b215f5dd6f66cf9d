// The GEMM and weight-gradient launches of K1 / K1b / K2 / K2b alone
// (common.cuh ``launch_gemm``, ``launch_wgrad``), bound through plain C entry
// points for the card's launch-level checks and chip_smoke.py's GEMM phase.
// K1f (attn_half.cu), K1b (attn_half_bwd.cu), K2f (ln_mlp.cu) and K2b
// (ln_mlp_bwd.cu) make the same launches inside their own calls; nothing
// else of the port calls these entry points.
//
// Replaces, as one launch each, the products of
// vsn_tpu/ops/swin_block_kernels.py that the TPU runs inside its fused
// kernels (``_mmw`` :246, _mlp_fwd_kernel / _mlp_bwd_kernel :857-966); the
// source note of common.cuh says what bounds them on this card and what the
// tensor-core bodies do about it.
//
// The entry points take exactly the instantiations that K1, K2 and the
// attention probes launch (epilogue, LayerScale flags, W_KN, A's and out's
// types); any other combination returns cudaErrorInvalidValue without a
// launch. ``fma`` launches the FMA body on bf16 operands, the body every bf16
// GEMM took before the tensor-core one: chip_smoke.py times it beside the
// tensor-core body on the same call, as a yardstick that no path launches.

#include "common.cuh"

namespace {

struct GemmArgs {
  const void* a;
  long long lda;
  const float* a_gain;
  long long rows_per_sample;
  const float* ln_w;
  const float* ln_b;
  const float* w;
  const float* bias;
  const void* resid;
  const float* gains;
  float lam;
  const float* gamma;
  void* out;
  float* out32;
  long long m;
  int n;
  int k;
};

template <typename T, typename TA, typename TO, int EPI, bool W_KN, int LS>
int gemm_one(const GemmArgs& g, int fma, cudaStream_t s) {
  GemmParams<T, TA, TO> p = {};
  p.a = static_cast<const TA*>(g.a);
  p.lda = g.lda;
  p.a_gain = g.a_gain;
  p.rows_per_sample = g.rows_per_sample;
  p.ln_w = g.ln_w;
  p.ln_b = g.ln_b;
  p.w = g.w;
  p.bias = g.bias;
  p.resid = static_cast<const TO*>(g.resid);
  p.gains = g.gains;
  p.lam = g.lam;
  p.gamma = g.gamma;
  p.out = static_cast<TO*>(g.out);
  p.out32 = g.out32;
  p.m = g.m;
  p.n = g.n;
  p.k = g.k;
  return (int)(fma ? launch_gemm_fma<T, EPI, W_KN, LS>(p, s)
                   : launch_gemm<T, EPI, W_KN, LS>(p, s));
}

// The forward products (W as [N, K]), A and out of type T.
template <typename T>
int gemm_forward(int epi, int ls, const GemmArgs& g, int fma, cudaStream_t s) {
  if (ls == LS_EPI)
    return epi == EPI_RESIDUAL ? gemm_one<T, T, T, EPI_RESIDUAL, false, LS_EPI>(g, fma, s)
                               : (int)cudaErrorInvalidValue;
  if (ls) return (int)cudaErrorInvalidValue;
  switch (epi) {
    case EPI_BIAS: return gemm_one<T, T, T, EPI_BIAS, false, 0>(g, fma, s);
    case EPI_GELU: return gemm_one<T, T, T, EPI_GELU, false, 0>(g, fma, s);
    case EPI_RESIDUAL: return gemm_one<T, T, T, EPI_RESIDUAL, false, 0>(g, fma, s);
    case EPI_GELU_GRAD: return gemm_one<T, T, T, EPI_GELU_GRAD, false, 0>(g, fma, s);
    case EPI_F32: return gemm_one<T, T, T, EPI_F32, false, 0>(g, fma, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The data gradients (W_KN: W read as [K, N]), out of type T; A of type TA
// (T, or the f32 buffers dy / dh1 under bf16).
template <typename T, typename TA>
int gemm_data_grad(int epi, int ls, const GemmArgs& g, int fma, cudaStream_t s) {
  constexpr bool kTaT = std::is_same<TA, T>::value;
  if (ls == LS_PRO && kTaT) {
    if (epi == EPI_BIAS) return gemm_one<T, TA, T, EPI_BIAS, true, LS_PRO>(g, fma, s);
    if (epi == EPI_MUL_F32) return gemm_one<T, TA, T, EPI_MUL_F32, true, LS_PRO>(g, fma, s);
  }
  if (ls) return (int)cudaErrorInvalidValue;
  switch (epi) {
    case EPI_BIAS: return gemm_one<T, TA, T, EPI_BIAS, true, 0>(g, fma, s);
    case EPI_MUL_F32: return gemm_one<T, TA, T, EPI_MUL_F32, true, 0>(g, fma, s);
    case EPI_F32: return gemm_one<T, TA, T, EPI_F32, true, 0>(g, fma, s);
    case EPI_ADD_RESID: return gemm_one<T, TA, T, EPI_ADD_RESID, true, 0>(g, fma, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// One GEMM launch (common.cuh GemmParams, argument for argument). is_bf16
// selects T = bf16 (else f32); under bf16, ta_f32 reads A as f32 and to_f32
// gives resid and out as f32 (the probes' proj). epi is an ``Epilogue``, ls a
// set of ``LayerScaleFlags``, w_kn reads W as [K, N]. Pointers that the
// epilogue and prologue do not read may be null; lda = 0 means K. Returns
// cudaGetLastError() of the launch, or cudaErrorInvalidValue for a
// combination that K1, K2 and the probes do not launch.
extern "C" int vsn_gemm(int is_bf16, int ta_f32, int to_f32, int epi, int ls, int w_kn,
                        int fma, const void* a, long long lda, const float* a_gain,
                        long long rows_per_sample, const float* ln_w, const float* ln_b,
                        const float* w, const float* bias, const void* resid,
                        const float* gains, float lam, const float* gamma, void* out,
                        float* out32, long long m, int n, int k, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const GemmArgs g = {a, lda, a_gain, rows_per_sample, ln_w, ln_b, w, bias, resid,
                      gains, lam, gamma, out, out32, m, n, k};
  using B = __nv_bfloat16;
  if (!is_bf16) {
    if (ta_f32 || to_f32 || fma) return (int)cudaErrorInvalidValue;
    return w_kn ? gemm_data_grad<float, float>(epi, ls, g, 0, s)
                : gemm_forward<float>(epi, ls, g, 0, s);
  }
  if (!w_kn) return ta_f32 || to_f32 ? (int)cudaErrorInvalidValue
                                     : gemm_forward<B>(epi, ls, g, fma, s);
  if (epi == EPI_RESIDUAL && !ls && !ta_f32)  // the probes' proj (any lda)
    return to_f32 ? gemm_one<B, B, float, EPI_RESIDUAL, true, 0>(g, fma, s)
                  : gemm_one<B, B, B, EPI_RESIDUAL, true, 0>(g, fma, s);
  if (to_f32) return (int)cudaErrorInvalidValue;
  return ta_f32 ? gemm_data_grad<B, float>(epi, ls, g, fma, s)
                : gemm_data_grad<B, B>(epi, ls, g, fma, s);
}

// One weight-gradient launch: out [n1, n2] += sum_m round_T(g_m a[m, n1]) *
// b[m, n2], into the zeroed f32 out; a_gain [m / rows_per_sample] may be
// null. is_bf16 selects T = bf16 (else f32), ta_f32 an f32 A under bf16.
extern "C" int vsn_wgrad(int is_bf16, int ta_f32, int fma, const void* a,
                         const float* a_gain, long long rows_per_sample, const void* b,
                         float* out, long long m, int n1, int n2, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using B = __nv_bfloat16;
  if (!is_bf16) {
    if (ta_f32 || fma) return (int)cudaErrorInvalidValue;
    const WgradParams<float, float> p = {static_cast<const float*>(a), a_gain,
                                         rows_per_sample, static_cast<const float*>(b),
                                         out, m, n1, n2, 0};
    return (int)launch_wgrad(p, s);
  }
  if (ta_f32) {
    const WgradParams<B, float> p = {static_cast<const float*>(a), a_gain, rows_per_sample,
                                     static_cast<const B*>(b), out, m, n1, n2, 0};
    return (int)(fma ? launch_wgrad_fma(p, s) : launch_wgrad(p, s));
  }
  const WgradParams<B, B> p = {static_cast<const B*>(a), a_gain, rows_per_sample,
                               static_cast<const B*>(b), out, m, n1, n2, 0};
  return (int)(fma ? launch_wgrad_fma(p, s) : launch_wgrad(p, s));
}
