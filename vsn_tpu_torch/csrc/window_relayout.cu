// K3: the window-layout movers, one gather kernel over a row map.
//
// Replaces vsn_tpu/ops/window_relayout.py _s2w_impl, _w2w_impl and
// _w2s_impl (three Pallas kernels):
//
//   spatial_to_windows   dst = partition(roll3d(src, roll))           S -> W
//   windows_to_windows   dst = partition(roll3d(reverse(src), roll))  W -> W
//   windows_to_spatial   dst = roll3d(reverse(src), roll)             W -> S
//
// with roll3d(x, r)[p] = x[(p - r) mod dims] (torch.roll / jnp.roll), and
// their adjoints (the opposite move with the roll negated).
//
// What bounds it: pure data movement, one read and one write of every byte,
// so device-memory bandwidth; the map adds 4 bytes a row. The TPU kernels
// split every axis into static-size pieces because a TPU DMA needs static
// extents. Here the permutation of one sample's rows is a host-built int32
// map (ops/window_relayout.py ``relayout_map``: for each destination row of
// a sample, its source row), cached per geometry and device, so the device
// does no index arithmetic beyond one map read a row and no integer
// division at all. A block is a 2-D grid of threads: threadIdx.x walks the
// 16-byte chunks of a row (C = 96 bf16 is 12), threadIdx.y the rows, and
// each thread moves the same chunk of kRows rows, all loads issued before
// the stores. A block's destination rows are consecutive; ww of them (a
// window row) come from at most two runs of consecutive source rows (the
// roll wraps at most once), so reads come in runs of 576-1152 bytes at
// Swin-T's stage 1. Rows or pointers that 16 bytes do not divide move by
// 4- or 1-byte chunks.
//
// Layouts, per sample (b): spatial S is [D, H, W, C]; windows W is
// [nWd, nWh, nWw, wd, wh, ww, C] flattened to [nW, N, C] (window_partition
// order, sample-major across the batch). Both hold D * H * W rows a sample.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRelayoutThreads = 256;
constexpr int kRelayoutRows = 4;  // rows a thread moves, loads in flight

template <typename V>
__global__ void __launch_bounds__(kRelayoutThreads) relayout_map_kernel(
    const V* __restrict__ src, V* __restrict__ dst, const int* __restrict__ map, int rows,
    int chunks) {
  const size_t sample = (size_t)blockIdx.y * (unsigned)rows * (unsigned)chunks;
  src += sample;
  dst += sample;
  const int row0 = (int)blockIdx.x * (int)(blockDim.y * kRelayoutRows) + (int)threadIdx.y;
  for (int c = threadIdx.x; c < chunks; c += blockDim.x) {
    V v[kRelayoutRows];
#pragma unroll
    for (int i = 0; i < kRelayoutRows; ++i) {
      const int r = row0 + i * (int)blockDim.y;
      if (r < rows) v[i] = src[(unsigned)__ldg(map + r) * (unsigned)chunks + c];
    }
#pragma unroll
    for (int i = 0; i < kRelayoutRows; ++i) {
      const int r = row0 + i * (int)blockDim.y;
      if (r < rows) dst[(unsigned)r * (unsigned)chunks + c] = v[i];
    }
  }
}

template <typename V>
cudaError_t launch_relayout(const void* src, void* dst, const int* map, long long batch,
                            int rows, long long row_bytes, int lanes, cudaStream_t stream) {
  const long long chunks = row_bytes / (long long)sizeof(V);
  const int per_block = kRelayoutThreads / lanes;  // rows a block step covers
  if (lanes < 1 || lanes > kRelayoutThreads || lanes > chunks || batch > 65535 ||
      (long long)rows * chunks >= (1LL << 32))
    return cudaErrorInvalidValue;
  const dim3 block(lanes, per_block);
  const long long rows_per_block = (long long)per_block * kRelayoutRows;
  const dim3 grid((unsigned)((rows + rows_per_block - 1) / rows_per_block), (unsigned)batch);
  relayout_map_kernel<V><<<grid, block, 0, stream>>>(static_cast<const V*>(src),
                                                     static_cast<V*>(dst), map, rows,
                                                     (int)chunks);
  return cudaGetLastError();
}

}  // namespace

// Moves batch samples of rows rows each (row_bytes bytes a row) from src to
// dst: dst row r of a sample is src row map[r] of the same sample. chunk
// (16, 4 or 1) is the bytes a thread moves at once, which must divide
// row_bytes and both base addresses; lanes (<= 256, <= the chunks of a
// row) are the threads on one row (threadIdx.x), 256 / lanes rows a block
// step. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int vsn_window_relayout(const void* src, void* dst, const int* map,
                                   long long batch, int rows, long long row_bytes, int chunk,
                                   int lanes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned long long align =
      (unsigned long long)row_bytes | (uintptr_t)src | (uintptr_t)dst;
  if (chunk < 1 || align % (unsigned)chunk) return (int)cudaErrorInvalidValue;
  switch (chunk) {
    case 16: return (int)launch_relayout<uint4>(src, dst, map, batch, rows, row_bytes, lanes, s);
    case 4:
      return (int)launch_relayout<uint32_t>(src, dst, map, batch, rows, row_bytes, lanes, s);
    case 1:
      return (int)launch_relayout<uint8_t>(src, dst, map, batch, rows, row_bytes, lanes, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
