// P2-P4: the copy probes, out = x over [BW, N, C] bf16 windows.
//
// Replaces scripts/perf_probe_attn_ablate2.py ``copy_kernel`` (pallas_call
// at :128 with one window per program, P2, and at :145 with 8, P4) and
// ``copy_ops_kernel`` (:135, P3: the weights declared as operands and never
// read). They time what moving the stage-1 activations in and out costs
// without any compute: the floor under K1f and the P1 / P5 probes.
//
// What bounds it: bytes only (x read once, out written once). One block per
// group of wb windows copies the group's contiguous wb * N * C elements in
// 16-byte vectors, neighbouring threads on neighbouring addresses: the TPU
// program's granularity, which the probe measures. The HBM rate wants
// about 2 MB in flight (3.35 TB/s at ~0.6 us), more than one 16-byte load
// a thread of 256 gives P4's 216 blocks (under 1 MB): blocks of 1024
// threads, each issuing kCopyInFlight independent loads before their
// stores (P4: 28 MB in flight), plain loads and stores. The operand
// pointers of P3 are kernel arguments that no thread reads, as the TPU
// kernel's unused VMEM blocks.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCopyThreads = 1024;
constexpr int kCopyInFlight = 8;  // 16-byte loads a thread before their stores

__global__ void __launch_bounds__(kCopyThreads) copy_windows_kernel(
    const uint4* __restrict__ x, uint4* __restrict__ out, long long vec_per_group,
    const float* wqkv, const float* bias, const float* wproj) {
  const long long base = (long long)blockIdx.x * vec_per_group;
  const uint4* src = x + base;
  uint4* dst = out + base;
  for (long long e = threadIdx.x; e < vec_per_group; e += kCopyThreads * kCopyInFlight) {
    uint4 v[kCopyInFlight];
#pragma unroll
    for (int u = 0; u < kCopyInFlight; ++u)
      if (e + u * kCopyThreads < vec_per_group) v[u] = src[e + u * kCopyThreads];
#pragma unroll
    for (int u = 0; u < kCopyInFlight; ++u)
      if (e + u * kCopyThreads < vec_per_group) dst[e + u * kCopyThreads] = v[u];
  }
}

}  // namespace

// out = x for bf16 x [bw, n, c] (n * c a multiple of 8, both 16-byte
// aligned), wb windows per block (bw divisible by wb). wqkv, bias and wproj
// may be null; they are passed to the kernel and not read. Returns
// cudaGetLastError() of the launch.
extern "C" int vsn_probe_copy(const void* x, void* out, long long bw, int n, int c,
                              int wb, const float* wqkv, const float* bias,
                              const float* wproj, void* stream) {
  const long long vec_per_group = (long long)wb * n * c / 8;  // 8 bf16 per uint4
  copy_windows_kernel<<<(unsigned)(bw / wb), kCopyThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(x), static_cast<uint4*>(out), vec_per_group, wqkv,
      bias, wproj);
  return (int)cudaGetLastError();
}
