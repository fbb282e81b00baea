// Shared tile walk of the three JOIN-AGG kernels: write every row of a
// (num_rows, d) float32 output once, each row reducing the run of edges
// whose sorted key equals the row index.
//
// The TPU kernels (repro/kernels/segment_sum.py, coo_spmm.py,
// segment_reduce.py) turn this scatter into one-hot matmuls because a
// TPU has no cheap scatter.  On Hopper the keys arrive sorted (grouped-CSR
// order, DESIGN.md §7), so each output row's edges are one contiguous run
// that a binary search finds: no atomics, no zero fill, and a fixed
// summation order (edge order), which is what makes results bit-identical
// from run to run.
//
// Bound on this card: bytes.  Every output element is written once and
// every edge row is read once, against O(1) arithmetic per byte.  The
// design keeps both streams coalesced: one block owns a tile of
// consecutive output rows, i.e. a contiguous slab of `rows * d` floats;
// its threads first find the tile's edge range by two binary searches
// over the whole key array and each row's run start by a search inside
// that (usually tiny) range, kept in shared memory; then consecutive
// threads take consecutive output elements, so stores are contiguous and
// edge-row loads (`data[e * d + c]`) are contiguous along c.
//
// Preconditions (the Python wrappers check all but the first two, which
// would need a pass over the data):
//   * keys ascending; keys outside [0, num_rows) are dropped (they sort
//     to the two ends of the array, where no row's search reaches them);
//   * no NaN in the reduced values;
//   * int64 keys and indices, float32 values, all contiguous on one card;
//   * 0 < d < 2^31.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace repro_torch {

constexpr int kThreads = 256;
// output floats one block writes per tile; rows per tile = kTileElems / d
constexpr int64_t kTileElems = 4096;
constexpr int64_t kMaxTileRows = 2048;  // bounds the shared run-start array
constexpr int64_t kMaxBlocks = 4096;    // grid-stride over tiles beyond this

__device__ __forceinline__ int64_t lower_bound(const int64_t* __restrict__ keys,
                                               int64_t lo, int64_t hi,
                                               int64_t value) {
  while (lo < hi) {
    const int64_t mid = lo + ((hi - lo) >> 1);
    if (keys[mid] < value) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__device__ __forceinline__ float positive_inf() { return __int_as_float(0x7f800000); }
__device__ __forceinline__ float negative_inf() { return __int_as_float(0xff800000); }

// Op supplies `static float identity()` and
// `float operator()(float acc, int64_t edge, uint32_t column) const`.
template <class Op>
__global__ void __launch_bounds__(kThreads)
segmented_rows(const int64_t* __restrict__ keys, int64_t n, int64_t num_rows,
               int64_t d, int64_t rows_per_tile, Op op, float* __restrict__ out) {
  extern __shared__ int64_t starts[];  // rows_per_tile + 1 run starts
  __shared__ int64_t range[2];
  const int64_t num_tiles = (num_rows + rows_per_tile - 1) / rows_per_tile;
  const uint32_t width = static_cast<uint32_t>(d);
  for (int64_t tile = blockIdx.x; tile < num_tiles; tile += gridDim.x) {
    const int64_t s0 = tile * rows_per_tile;
    const int64_t left = num_rows - s0;
    const int64_t rows = left < rows_per_tile ? left : rows_per_tile;
    if (threadIdx.x < 2) {
      range[threadIdx.x] = lower_bound(keys, 0, n, s0 + threadIdx.x * rows);
    }
    __syncthreads();
    const int64_t e_lo = range[0];
    const int64_t e_hi = range[1];
    for (int64_t r = threadIdx.x; r <= rows; r += blockDim.x) {
      starts[r] = lower_bound(keys, e_lo, e_hi, s0 + r);
    }
    __syncthreads();
    const uint32_t elems = static_cast<uint32_t>(rows) * width;
    float* __restrict__ dst = out + s0 * d;
    for (uint32_t f = threadIdx.x; f < elems; f += blockDim.x) {
      const uint32_t r = f / width;
      const uint32_t c = f - r * width;
      const int64_t end = starts[r + 1];
      float acc = Op::identity();
      for (int64_t e = starts[r]; e < end; ++e) {
        acc = op(acc, e, c);
      }
      dst[f] = acc;
    }
    __syncthreads();  // starts/range are rewritten by the next tile
  }
}

template <class Op>
cudaError_t launch_segmented_rows(int device, const int64_t* keys, int64_t n,
                                  int64_t num_rows, int64_t d, Op op, float* out,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) {
    return err;
  }
  if (num_rows <= 0 || d <= 0) {
    return cudaSuccess;
  }
  int64_t rows_per_tile = kTileElems / d;
  if (rows_per_tile < 1) rows_per_tile = 1;
  if (rows_per_tile > kMaxTileRows) rows_per_tile = kMaxTileRows;
  const int64_t num_tiles = (num_rows + rows_per_tile - 1) / rows_per_tile;
  const int grid = static_cast<int>(num_tiles < kMaxBlocks ? num_tiles : kMaxBlocks);
  const size_t smem = static_cast<size_t>(rows_per_tile + 1) * sizeof(int64_t);
  segmented_rows<Op><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      keys, n, num_rows, d, rows_per_tile, op, out);
  return cudaGetLastError();
}

}  // namespace repro_torch
