// K2f: the Swin MLP half-block, forward.
//
//   out = lam * x + gains[row / rows_per_sample] * fc2(gelu_erf(fc1(LN(x))))
//
// Replaces vsn_tpu/ops/swin_block_kernels.py _ln_mlp_fwd (Pallas kernel
// _mlp_fwd_kernel), which runs LN2 + fc1 + GELU + fc2 + residual on row
// tiles held in TPU VMEM.
//
// What bounds it here: the two products, 16 C^2 operations per row, against
// about 22 C bytes of bf16 traffic per row (x, the [rows, 4C] hidden written
// and read back, the residual, out): 70 operations a byte at Swin's C = 96,
// under the H100's ~295, so the bytes at stage 1; the products from C = 384
// (ViT). Both launches are common.cuh's GEMM, on the tensor cores (bf16
// mma.sync) under bf16. The hidden activation is what does not fit on chip:
// a 128-row tile of it is 393 KB in f32 at C = 192 and 1.5 MB at C = 768.
// So the kernel runs two launches of the LayerNorm-prologue GEMM:
//
//   1. LN2 + fc1 + exact-erf GELU, writing hidden [rows, 4C] rounded to the
//      activation type (the TPU kernel rounds it there before fc2 too);
//   2. fc2 + bias + per-row sample gain + residual, formed in f32, cast once.
//
// The residual modes (_mlp_fwd_kernel :862-878): with gamma (in-band
// LayerScale) launch 2's epilogue is ``lam * x + gains[s] * ((acc + b2) *
// gamma)`` (common.cuh LS_EPI); with post_norm launch 1 reads raw x (no
// LayerNorm prologue) and launch 2 writes the f32 branch fc2(...) + b2, so
// that a third launch, the post-norm row kernel (common.cuh), takes its
// LayerNorm statistics over whole rows and forms ``lam * x + gains[s] *
// (LN2(branch) [* gamma])``.
//
// The hidden round trip through device memory is the first thing to fuse
// away in performance work. GELU is erff: the TPU kernel's A-S polynomial
// exists only because Mosaic has no erf. The per-row gain index replaces the
// TPU's per-sample tile padding (mlp_tiling), which was a VMEM device and
// not semantics.

#include "common.cuh"

namespace {

template <typename T>
int ln_mlp_fwd(const T* x, const float* ln_w, const float* ln_b, const float* fc1_w,
               const float* fc1_b, const float* fc2_w, const float* fc2_b,
               const float* gains, const float* gamma, int post_norm, T* hidden,
               float* branch32, T* out, long long rows, int c, int hid,
               long long rows_per_sample, float lam, cudaStream_t stream) {
  GemmParams<T> g1 = {};
  g1.a = x;
  g1.ln_w = post_norm ? nullptr : ln_w;
  g1.ln_b = ln_b;
  g1.w = fc1_w;
  g1.bias = fc1_b;
  g1.out = hidden;
  g1.m = rows;
  g1.n = hid;
  g1.k = c;
  cudaError_t err = launch_gemm<T, EPI_GELU>(g1, stream);
  if (err != cudaSuccess) return (int)err;

  GemmParams<T> g2 = {};
  g2.a = hidden;
  g2.w = fc2_w;
  g2.bias = fc2_b;
  g2.resid = x;
  g2.gains = gains;
  g2.rows_per_sample = rows_per_sample;
  g2.lam = lam;
  g2.gamma = gamma;
  g2.out = out;
  g2.out32 = branch32;
  g2.m = rows;
  g2.n = c;
  g2.k = hid;
  if (post_norm) {
    err = launch_gemm<T, EPI_F32>(g2, stream);
    if (err != cudaSuccess) return (int)err;
    return (int)launch_postnorm_fwd<T>(branch32, x, ln_w, ln_b, gamma, gains,
                                       rows_per_sample, lam, out, rows, c, stream);
  }
  if (gamma) return (int)launch_gemm<T, EPI_RESIDUAL, false, LS_EPI>(g2, stream);
  return (int)launch_gemm<T, EPI_RESIDUAL>(g2, stream);
}

}  // namespace

// Returns cudaGetLastError() of the first launch that failed, else 0.
// gamma [C] f32 (in-band LayerScale) may be null; post_norm moves LN2 onto
// the branch and needs branch32, an f32 [rows, C] scratch (else null).
extern "C" int vsn_ln_mlp_fwd(int is_bf16, const void* x, const float* ln_w,
                              const float* ln_b, const float* fc1_w,
                              const float* fc1_b, const float* fc2_w,
                              const float* fc2_b, const float* gains, const float* gamma,
                              int post_norm, void* hidden, float* branch32, void* out,
                              long long rows, int c, int hid, long long rows_per_sample,
                              float lam, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return ln_mlp_fwd<__nv_bfloat16>(
        static_cast<const __nv_bfloat16*>(x), ln_w, ln_b, fc1_w, fc1_b, fc2_w, fc2_b,
        gains, gamma, post_norm, static_cast<__nv_bfloat16*>(hidden), branch32,
        static_cast<__nv_bfloat16*>(out), rows, c, hid, rows_per_sample, lam, s);
  return ln_mlp_fwd<float>(static_cast<const float*>(x), ln_w, ln_b, fc1_w, fc1_b,
                           fc2_w, fc2_b, gains, gamma, post_norm,
                           static_cast<float*>(hidden), branch32,
                           static_cast<float*>(out), rows, c, hid, rows_per_sample,
                           lam, s);
}
