// Tensor-core building blocks shared by the port's hand-written kernels:
// cp.async staging, ldmatrix fragment loads and mma.sync.m16n8k16 on bf16
// operands with f32 accumulators. The key-tiled attention body
// (attn_tiled.cuh) and the GEMM bodies (common.cuh) both build on them.
//
// Fragment layout of m16n8k16 (PTX ISA, "Matrix fragments for mma.m16n8k16"):
// a thread holds accumulator rows g = lane / 4 and g + 8, columns 2 t and
// 2 t + 1 (t = lane % 4) of its 8-column tile; its A fragment a[0..3] holds
// rows (g, g + 8) x depth (2 t, 2 t + 1) of depth 0-7 (a[0], a[1]) and of
// depth 8-15 (a[2], a[3]); its B fragment b0 / b1 depth 2 t, 2 t + 1 of
// column g, for depth 0-7 / 8-15.
//
// Everything here has internal linkage (anonymous namespace), as in
// common.cuh.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace {

template <typename T>
constexpr bool kTensorCores = std::is_same<T, __nv_bfloat16>::value;

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s)
               : "memory");
}

// c += a b: m16n8k16, bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 rounded to bf16 (nearest even), lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The transpose of an 8 x 8 bf16 matrix held one row pair a lane.
__device__ __forceinline__ uint32_t transpose_8x8(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}

// The A fragment (16 rows x 16 columns from row0, col0) of a staged tile.
template <int LD>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const __nv_bfloat16* tile, int row0,
                                       int col0, int lane) {
  ldsm_x4(a, tile + (row0 + (lane & 15)) * LD + col0 + (lane >> 4) * 8);
}

// B fragments of two 8-column tiles of a product X Y^T: Y's rows row0..row0+15
// are the columns, channels col0..col0+15 the depth. b[0], b[1] belong to the
// first 8 rows, b[2], b[3] to the next.
template <int LD>
__device__ __forceinline__ void load_b_nt(uint32_t (&b)[4], const __nv_bfloat16* tile,
                                          int row0, int col0, int lane) {
  ldsm_x4(b, tile + (row0 + (lane & 7) + ((lane >> 4) << 3)) * LD + col0 +
                 ((lane >> 3) & 1) * 8);
}

// B fragments of two 8-column tiles of a product X Y: Y's rows row0..row0+15
// are the depth, channels col0..col0+15 the columns.
template <int LD>
__device__ __forceinline__ void load_b_nn(uint32_t (&b)[4], const __nv_bfloat16* tile,
                                          int row0, int col0, int lane) {
  ldsm_x4_t(b, tile + (row0 + (lane & 15)) * LD + col0 + (lane >> 4) * 8);
}

// The A fragment (16 rows x 16 depth from row0, depth0) of the transpose of
// a staged tile that holds the depth as rows and the product's rows as
// columns ([depth][rows], rows contiguous): the weight gradient's A^T, read
// k-major.
template <int LD>
__device__ __forceinline__ void load_a_t(uint32_t (&a)[4], const __nv_bfloat16* tile,
                                         int depth0, int row0, int lane) {
  ldsm_x4_t(a, tile + (depth0 + (lane & 7) + ((lane >> 4) << 3)) * LD + row0 +
                   ((lane >> 3) & 1) * 8);
}

}  // namespace
