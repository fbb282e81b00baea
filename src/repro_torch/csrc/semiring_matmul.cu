// semiring_matmul for Hopper: C[i, j] = ⊕_k A[i, k] ⊗ B[k, j] for A (m, kd),
// B (kd, n) and C (m, n), all float32 row-major, over one of four
// semirings:
//
//   add_mul (0):  (+, x),   identity 0
//   max_add (1):  (max, +), identity -inf
//   min_add (2):  (min, +), identity +inf
//   or_and  (3):  any(A > 0 and B > 0) as 0/1, identity 0
//
// The reduction runs over k in ascending order, one step per k, and every
// step rounds on its own (__fmul_rn then __fadd_rn: no fused multiply-add,
// no tensor cores, no TF32), so the result is the bits of the plain
// version's k-ordered loop.  max/min propagate NaN as torch.maximum and
// torch.minimum do.
//
// Replaces the TPU kernel repro/kernels/semiring_matmul.py:
// _semiring_matmul_kernel, which keeps the MXU for add_mul and lowers the
// other semirings to VPU k-slices inside the same VMEM blocking.  Here
// every semiring shares one classic shared-memory tiling: a block of
// 16 x 16 threads owns a 64 x 64 tile of C, each thread a 4 x 4 grid of it
// (rows ty + 16 i, columns tx + 16 j) kept in registers; A and B pass
// through shared memory kDepth = 16 values of k at a time.  Ragged edges
// are bounds checks: out-of-range loads read 0 and are never used, so no
// padded copy of A or B exists.
//
// Bound on this card: operations.  2 m n kd float32 operations against
// (m kd + kd n + m n) * 4 bytes; only the card's float32 rate outside the
// tensor cores computes these semirings exactly, and add_mul without
// fused multiply-adds reaches at most half of it.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;
constexpr int kDepth = 16;
constexpr int kSide = 16;             // threads per tile side
constexpr int kPer = kTile / kSide;   // outputs per thread per side
constexpr int kThreads = kSide * kSide;

struct AddMul {
  __device__ static float identity() { return 0.0f; }
  __device__ static float step(float acc, float a, float b) {
    return __fadd_rn(acc, __fmul_rn(a, b));
  }
};

struct MaxAdd {
  __device__ static float identity() { return __int_as_float(0xff800000); }
  __device__ static float step(float acc, float a, float b) {
    const float v = __fadd_rn(a, b);
    return (v > acc || v != v) ? v : acc;
  }
};

struct MinAdd {
  __device__ static float identity() { return __int_as_float(0x7f800000); }
  __device__ static float step(float acc, float a, float b) {
    const float v = __fadd_rn(a, b);
    return (v < acc || v != v) ? v : acc;
  }
};

struct OrAnd {
  __device__ static float identity() { return 0.0f; }
  __device__ static float step(float acc, float a, float b) {
    return (a > 0.0f && b > 0.0f) ? 1.0f : acc;
  }
};

template <class S>
__global__ void __launch_bounds__(kThreads)
semiring_matmul_kernel(const float* __restrict__ a, const float* __restrict__ b,
                       float* __restrict__ c, int64_t m, int64_t n, int64_t kd,
                       int64_t tiles_n) {
  __shared__ float as[kDepth][kTile + 1];  // as[kk][row]; +1 spreads the stores
  __shared__ float bs[kDepth][kTile];      // bs[kk][col]
  const int tx = threadIdx.x % kSide;
  const int ty = threadIdx.x / kSide;
  const int64_t row0 = (blockIdx.x / tiles_n) * kTile;
  const int64_t col0 = (blockIdx.x % tiles_n) * kTile;

  float acc[kPer][kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      acc[i][j] = S::identity();
    }
  }

  for (int64_t k0 = 0; k0 < kd; k0 += kDepth) {
    // A tile: consecutive threads along k (A's contiguous axis)
    for (int t = threadIdx.x; t < kTile * kDepth; t += kThreads) {
      const int r = t / kDepth;
      const int kk = t % kDepth;
      const int64_t gr = row0 + r;
      const int64_t gk = k0 + kk;
      as[kk][r] = (gr < m && gk < kd) ? a[gr * kd + gk] : 0.0f;
    }
    // B tile: consecutive threads along n (B's contiguous axis)
    for (int t = threadIdx.x; t < kDepth * kTile; t += kThreads) {
      const int kk = t / kTile;
      const int col = t % kTile;
      const int64_t gk = k0 + kk;
      const int64_t gc = col0 + col;
      bs[kk][col] = (gk < kd && gc < n) ? b[gk * n + gc] : 0.0f;
    }
    __syncthreads();
    const int depth = kd - k0 < kDepth ? static_cast<int>(kd - k0) : kDepth;
    for (int kk = 0; kk < depth; ++kk) {
      float av[kPer];
      float bv[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        av[i] = as[kk][ty + kSide * i];
        bv[i] = bs[kk][tx + kSide * i];
      }
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          acc[i][j] = S::step(acc[i][j], av[i], bv[j]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int64_t gr = row0 + ty + kSide * i;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int64_t gc = col0 + tx + kSide * j;
      if (gr < m && gc < n) {
        c[gr * n + gc] = acc[i][j];
      }
    }
  }
}

template <class S>
cudaError_t launch(const float* a, const float* b, float* c, int64_t m, int64_t n,
                   int64_t kd, cudaStream_t stream) {
  const int64_t tiles_m = (m + kTile - 1) / kTile;
  const int64_t tiles_n = (n + kTile - 1) / kTile;
  if (tiles_m * tiles_n >= (int64_t{1} << 31)) {
    return cudaErrorInvalidConfiguration;
  }
  semiring_matmul_kernel<S><<<static_cast<unsigned>(tiles_m * tiles_n), kThreads, 0,
                              stream>>>(a, b, c, m, n, kd, tiles_n);
  return cudaGetLastError();
}

}  // namespace

// semiring: 0 = add_mul, 1 = max_add, 2 = min_add, 3 = or_and; any other
// value returns cudaErrorInvalidValue.
extern "C" int repro_semiring_matmul(int device, const float* a, const float* b,
                                     int64_t m, int64_t kd, int64_t n, int semiring,
                                     float* c, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  if (m <= 0 || n <= 0) {
    return static_cast<int>(cudaSuccess);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (semiring) {
    case 0:
      return static_cast<int>(launch<AddMul>(a, b, c, m, n, kd, s));
    case 1:
      return static_cast<int>(launch<MaxAdd>(a, b, c, m, n, kd, s));
    case 2:
      return static_cast<int>(launch<MinAdd>(a, b, c, m, n, kd, s));
    case 3:
      return static_cast<int>(launch<OrAnd>(a, b, c, m, n, kd, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
