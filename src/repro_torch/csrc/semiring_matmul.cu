// semiring_matmul for Hopper: C[i, j] = ⊕_k A[i, k] ⊗ B[k, j] for A (m, kd),
// B (kd, n) and C (m, n), all float32 row-major, over one of four
// semirings:
//
//   add_mul (0):  (+, x),   identity 0
//   max_add (1):  (max, +), identity -inf
//   min_add (2):  (min, +), identity +inf
//   or_and  (3):  any(A > 0 and B > 0) as 0/1, identity 0
//
// Every output element is folded over k in ascending order, one step per
// k, with one accumulator and no split of k: add_mul's step is one fused
// multiply-add (__fmaf_rn, one rounding), max_add's and min_add's an add
// then max.NaN / min.NaN (NaN propagates as torch.maximum / torch.minimum
// do).  No tensor cores, no TF32.  The plain version
// (kernels/ref.py:semiring_matmul) takes the same steps, so the two agree
// bit for bit on any data (a zero max/min of +0 and -0 may differ in sign,
// which the repository's comparisons count as equal).
//
// Replaces the TPU kernel repro/kernels/semiring_matmul.py:
// _semiring_matmul_kernel, which keeps the MXU for add_mul and lowers the
// other semirings to VPU k-slices inside the same VMEM blocking.
//
// Bound on this card: operations.  m n kd steps against (m kd + kd n + m n)
// * 4 bytes.  add_mul's step is one FMA instruction (128 per clock per SM:
// 0.2564 ms at 2048^3); a tropical step is two (an add and a max/min, the
// latter at 64 per clock per SM), so its floor is twice that; or_and packs
// 32 values of k into one word and folds words with one logic instruction.
//
// Design, for every semiring alike (one template):
// * A block of 256 threads owns a BM x BN tile of C (128 x 128 or 128 x 64);
//   8 warps as 4 x 2, each warp 4 x 8 lanes, each lane GM x GN groups of
//   4 x 4 outputs (rows 16 apart, columns 32 apart) in registers.  Per k a
//   lane reads its A and B values as 16-byte shared loads, conflict-free
//   (a warp's lanes read 4 and 8 consecutive vectors), against GM GN 16
//   steps; the loads for k + 1 are issued before the steps of k.
// * A passes through registers and is stored k-major (transposed) in
//   shared memory; B goes straight to shared memory with cp.async.  Two
//   shared stages of BK values of k: the loads of stage t + 1 are issued
//   before stage t's steps and land after them, one __syncthreads a stage.
//   At 128 x 128 a thread needs about 128 registers, so two blocks (16
//   warps) share an SM: 256 blocks at 2048^2 fill the 264 slots in one wave.
// * Global accesses are VEC floats wide (16, 8 or 4 bytes) as the
//   alignment of a, b, kd and n allows (kernels/ops.py:matmul_plan).
// * Ragged edges add no step that changes a value: past kd, A reads the
//   semiring's pad (0, -inf, +inf, 0) and B reads 0, whose step is the
//   identity; rows and columns past m and n are never stored.
// * or_and: two pre-pass kernels pack a > 0 along k into 32-bit words, A as
//   (m, k_steps) and B as (k_steps, ldb), zero past kd and n; the same tile
//   loop then folds acc |= a & b over words and writes acc != 0 as 0 / 1.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarpsM = 4;  // warps down a block tile
constexpr int kWarpsN = 2;  // warps across a block tile
constexpr int kStages = 2;

struct AddMul {
  using T = float;
  __device__ static float identity() { return 0.0f; }
  __device__ static float pad() { return 0.0f; }  // 0 x 0 + acc == acc
  __device__ static float step(float acc, float a, float b) { return __fmaf_rn(a, b, acc); }
  __device__ static float result(float acc) { return acc; }
};

struct MaxAdd {
  using T = float;
  __device__ static float identity() { return __int_as_float(0xff800000); }
  __device__ static float pad() { return __int_as_float(0xff800000); }
  __device__ static float step(float acc, float a, float b) {
    const float v = __fadd_rn(a, b);
    float r;
    asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(acc), "f"(v));
    return r;
  }
  __device__ static float result(float acc) { return acc; }
};

struct MinAdd {
  using T = float;
  __device__ static float identity() { return __int_as_float(0x7f800000); }
  __device__ static float pad() { return __int_as_float(0x7f800000); }
  __device__ static float step(float acc, float a, float b) {
    const float v = __fadd_rn(a, b);
    float r;
    asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(acc), "f"(v));
    return r;
  }
  __device__ static float result(float acc) { return acc; }
};

struct OrAnd {  // on packed words: bit t of word w is k = 32 w + t
  using T = uint32_t;
  __device__ static uint32_t identity() { return 0u; }
  __device__ static uint32_t pad() { return 0u; }
  __device__ static uint32_t step(uint32_t acc, uint32_t a, uint32_t b) { return acc | (a & b); }
  __device__ static float result(uint32_t acc) { return acc != 0u ? 1.0f : 0.0f; }
};

template <class T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

template <int Bytes>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int src_bytes = valid ? Bytes : 0;  // 0: fill the destination with zeros
  if constexpr (Bytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
                 "r"(src_bytes)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst), "l"(gmem),
                 "n"(Bytes), "r"(src_bytes)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Block b owns rows [BM (b / tiles_n), +BM) and columns [BN (b % tiles_n),
// +BN) of C.  `n` is B's row length (columns the loads may read); C has
// `n_out` <= n columns.  A's row length is kd.
template <class S, int BM, int BN, int BK, int VEC>
__global__ void __launch_bounds__(kThreads, BN == 128 ? 2 : 3)
tiled_kernel(const typename S::T* __restrict__ a, const typename S::T* __restrict__ b,
             float* __restrict__ c, int64_t m, int64_t n, int64_t kd, int64_t n_out,
             int64_t tiles_n) {
  using T = typename S::T;
  using V = Pack<T, VEC>;
  constexpr int GM = BM / 64;                     // 4-row groups of a lane
  constexpr int GN = BN / 64;                     // 4-column groups of a lane
  constexpr int A_PIECES = BM * BK / VEC / kThreads;
  constexpr int B_TOTAL = BK * BN / VEC;          // VEC-wide pieces of a B stage
  constexpr int B_PIECES = (B_TOTAL + kThreads - 1) / kThreads;
  constexpr int B_ROW = BN / VEC;                 // pieces of one B row
  static_assert(BM == 128 && (BN == 128 || BN == 64), "tile");
  static_assert(A_PIECES * VEC * kThreads == BM * BK, "A stage splits into whole pieces");
  static_assert(kThreads % B_ROW == 0, "a thread's B pieces share one column");

  __shared__ __align__(16) T as[kStages][BK][BM];  // k-major
  __shared__ __align__(16) T bs[kStages][BK][BN];

  const int tid = threadIdx.x;
  const int64_t row0 = (blockIdx.x / tiles_n) * BM;
  const int64_t col0 = (blockIdx.x % tiles_n) * BN;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int tr = (warp / kWarpsN) * (BM / kWarpsM) + (lane / 8) * 4;
  const int tc = (warp % kWarpsN) * (BN / kWarpsN) + (lane % 8) * 4;

  // A pieces: row ar of the tile, k offsets (p / BM) * VEC for p = tid + i * 256
  const int ar = tid % BM;
  const bool a_row_ok = row0 + ar < m;
  const T* a_row = a + (a_row_ok ? (row0 + ar) * kd : 0);
  // B pieces: column bc of the tile, rows p / B_ROW
  const int bc = (tid % B_ROW) * VEC;
  const bool b_col_ok = col0 + bc < n;

  V ra[A_PIECES];
  auto load_a = [&](int64_t k0) {
#pragma unroll
    for (int i = 0; i < A_PIECES; ++i) {
      const int kv = ((tid + i * kThreads) / BM) * VEC;
      const int64_t k = k0 + kv;
      if (a_row_ok && k < kd) {
        ra[i] = *reinterpret_cast<const V*>(a_row + k);
      } else {
#pragma unroll
        for (int j = 0; j < VEC; ++j) ra[i].v[j] = S::pad();
      }
    }
  };
  auto store_a = [&](int buf) {
#pragma unroll
    for (int i = 0; i < A_PIECES; ++i) {
      const int kv = ((tid + i * kThreads) / BM) * VEC;
#pragma unroll
      for (int j = 0; j < VEC; ++j) as[buf][kv + j][ar] = ra[i].v[j];
    }
  };
  auto load_b = [&](int64_t k0, int buf) {
#pragma unroll
    for (int i = 0; i < B_PIECES; ++i) {
      const int p = tid + i * kThreads;
      if (B_TOTAL % kThreads == 0 || p < B_TOTAL) {
        const int br = p / B_ROW;
        const int64_t k = k0 + br;
        const bool ok = b_col_ok && k < kd;
        cp_async<static_cast<int>(VEC * sizeof(T))>(&bs[buf][br][bc],
                                                    ok ? b + k * n + col0 + bc : b, ok);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  T acc[GM * 4][GN * 4];
#pragma unroll
  for (int i = 0; i < GM * 4; ++i) {
#pragma unroll
    for (int j = 0; j < GN * 4; ++j) acc[i][j] = S::identity();
  }

  const int64_t stages = (kd + BK - 1) / BK;
  if (stages > 0) {
    load_a(0);
    load_b(0, 0);
    store_a(0);
    cp_async_wait_all();
    __syncthreads();
  }
  for (int64_t t = 0; t < stages; ++t) {
    const int buf = static_cast<int>(t & 1);
    const bool more = t + 1 < stages;
    if (more) {
      load_a((t + 1) * BK);
      load_b((t + 1) * BK, buf ^ 1);
    }
    // fragments of step kk + 1 load while step kk folds
    T av[2][GM * 4];
    T bv[2][GN * 4];
    auto frag = [&](int slot, int kk) {
#pragma unroll
      for (int i = 0; i < GM; ++i) {
        const Pack<T, 4> x = *reinterpret_cast<const Pack<T, 4>*>(&as[buf][kk][tr + 16 * i]);
#pragma unroll
        for (int e = 0; e < 4; ++e) av[slot][4 * i + e] = x.v[e];
      }
#pragma unroll
      for (int j = 0; j < GN; ++j) {
        const Pack<T, 4> x = *reinterpret_cast<const Pack<T, 4>*>(&bs[buf][kk][tc + 32 * j]);
#pragma unroll
        for (int e = 0; e < 4; ++e) bv[slot][4 * j + e] = x.v[e];
      }
    };
    frag(0, 0);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      if (kk + 1 < BK) frag((kk + 1) & 1, kk + 1);
#pragma unroll
      for (int i = 0; i < GM * 4; ++i) {
#pragma unroll
        for (int j = 0; j < GN * 4; ++j)
          acc[i][j] = S::step(acc[i][j], av[kk & 1][i], bv[kk & 1][j]);
      }
    }
    if (more) {
      store_a(buf ^ 1);
      cp_async_wait_all();
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < GM * 4; ++i) {
    const int64_t row = row0 + tr + 16 * (i / 4) + i % 4;
    if (row < m) {
#pragma unroll
      for (int j = 0; j < GN * 4; ++j) {
        const int64_t col = col0 + tc + 32 * (j / 4) + j % 4;
        if (col < n_out) c[row * n_out + col] = S::result(acc[i][j]);
      }
    }
  }
}

// or_and pre-pass: words[r, w] bit t = a[r, 32 w + t] > 0 for a (rows, kd);
// one warp per word (row_words words a row, zero past kd).
__global__ void __launch_bounds__(kThreads)
pack_rows_kernel(const float* __restrict__ a, uint32_t* __restrict__ words, int64_t rows,
                 int64_t kd, int64_t row_words) {
  const int64_t g = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t word = g / 32;
  const int lane = static_cast<int>(g % 32);
  if (word >= rows * row_words) {
    return;  // whole warps: a warp's 32 lanes share one word
  }
  const int64_t r = word / row_words;
  const int64_t k = (word % row_words) * 32 + lane;
  const bool bit = k < kd && a[r * kd + k] > 0.0f;
  const uint32_t bits = __ballot_sync(0xffffffffu, bit);
  if (lane == 0) {
    words[word] = bits;
  }
}

// or_and pre-pass: words[w, j] bit t = b[32 w + t, j] > 0 for b (kd, n);
// one thread per word, k_words rows of ldw words (zero past kd and n).
__global__ void __launch_bounds__(kThreads)
pack_cols_kernel(const float* __restrict__ b, uint32_t* __restrict__ words, int64_t kd,
                 int64_t n, int64_t k_words, int64_t ldw) {
  const int64_t g = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (g >= k_words * ldw) {
    return;
  }
  const int64_t w = g / ldw;
  const int64_t j = g % ldw;
  uint32_t bits = 0u;
  if (j < n) {
    for (int t = 0; t < 32 && w * 32 + t < kd; ++t) {
      bits |= static_cast<uint32_t>(b[(w * 32 + t) * n + j] > 0.0f) << t;
    }
  }
  words[g] = bits;
}

}  // namespace

// kernels/ops.py:MatmulPlan, field for field.
struct ReproMatmulPlan {
  int64_t block_m;
  int64_t block_n;
  int64_t block_k;
  int64_t vec;       // floats (or words) per global access: 4, 2 or 1
  int64_t k_steps;   // steps of the tile loop: kd, or packed words per row (or_and)
  int64_t ldb;       // B's row length in the tile loop: n, or n rounded up to 4 (or_and)
  int64_t tiles_m;
  int64_t tiles_n;
  int64_t blocks;
  int64_t smem_bytes;
};

namespace {

struct Args {
  const void* a;
  const void* b;
  float* c;
  int64_t m;
  int64_t n;  // B's row length
  int64_t kd;
  int64_t n_out;
  int64_t tiles_n;
  int64_t blocks;
  cudaStream_t stream;
};

template <class S, int BM, int BN, int BK, int VEC>
cudaError_t launch_tiled(const Args& x) {
  using T = typename S::T;
  tiled_kernel<S, BM, BN, BK, VEC><<<static_cast<unsigned>(x.blocks), kThreads, 0, x.stream>>>(
      static_cast<const T*>(x.a), static_cast<const T*>(x.b), x.c, x.m, x.n, x.kd, x.n_out,
      x.tiles_n);
  return cudaGetLastError();
}

template <class S, int BM, int BN, int BK>
cudaError_t by_vec(const Args& x, int64_t vec) {
  switch (vec) {
    case 4:
      return launch_tiled<S, BM, BN, BK, 4>(x);
    case 2:
      return launch_tiled<S, BM, BN, BK, 2>(x);
    case 1:
      return launch_tiled<S, BM, BN, BK, 1>(x);
    default:
      return cudaErrorInvalidValue;
  }
}

// The block tiles a plan may name (kernels/ops.py:MATMUL_TILES).
template <class S>
cudaError_t by_tile(const Args& x, const ReproMatmulPlan& p) {
  if (p.block_m == 128 && p.block_n == 128 && p.block_k == 16) return by_vec<S, 128, 128, 16>(x, p.vec);
  if (p.block_m == 128 && p.block_n == 128 && p.block_k == 8) return by_vec<S, 128, 128, 8>(x, p.vec);
  if (p.block_m == 128 && p.block_n == 64 && p.block_k == 16) return by_vec<S, 128, 64, 16>(x, p.vec);
  return cudaErrorInvalidValue;
}

template <>
cudaError_t by_tile<OrAnd>(const Args& x, const ReproMatmulPlan& p) {
  if (p.vec != 4) return cudaErrorInvalidValue;  // packed rows are padded to 4 words
  if (p.block_m == 128 && p.block_n == 128 && p.block_k == 16) return launch_tiled<OrAnd, 128, 128, 16, 4>(x);
  if (p.block_m == 128 && p.block_n == 128 && p.block_k == 8) return launch_tiled<OrAnd, 128, 128, 8, 4>(x);
  if (p.block_m == 128 && p.block_n == 64 && p.block_k == 16) return launch_tiled<OrAnd, 128, 64, 16, 4>(x);
  return cudaErrorInvalidValue;
}

bool aligned(const void* p, int64_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % static_cast<uintptr_t>(bytes) == 0;
}

int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

// The plan kernels/ops.py:matmul_plan makes for these operands, or false.
bool plan_fits(const ReproMatmulPlan& p, const void* a, const void* b, int64_t m, int64_t kd,
               int64_t n, bool packed) {
  if (p.block_m <= 0 || p.block_n <= 0 || p.block_k <= 0) return false;
  const int64_t k_steps = packed ? 4 * ceil_div(ceil_div(kd, 32), 4) : kd;
  const int64_t ldb = packed ? 4 * ceil_div(n, 4) : n;
  const int64_t elem = 4;  // float or uint32
  const bool vec_ok = (p.vec == 1 || p.vec == 2 || p.vec == 4) && aligned(a, p.vec * elem) &&
                      aligned(b, p.vec * elem) && k_steps % p.vec == 0 && ldb % p.vec == 0;
  return vec_ok && p.k_steps == k_steps && p.ldb == ldb &&
         p.tiles_m == ceil_div(m, p.block_m) && p.tiles_n == ceil_div(n, p.block_n) &&
         p.blocks == p.tiles_m * p.tiles_n && p.blocks < (int64_t{1} << 31) &&
         p.smem_bytes == kStages * p.block_k * (p.block_m + p.block_n) * elem;
}

}  // namespace

// semiring: 0 = add_mul, 1 = max_add, 2 = min_add, 3 = or_and.  or_and needs
// scratch a_words (m, plan.k_steps) and b_words (plan.k_steps, plan.ldb) of
// uint32, 16-byte aligned; the others ignore them.  Returns
// cudaErrorInvalidValue for an unknown semiring or a plan that does not fit
// the operands.
extern "C" int repro_semiring_matmul(int device, const float* a, const float* b, int64_t m,
                                     int64_t kd, int64_t n, int semiring, float* c,
                                     const ReproMatmulPlan* plan, uint32_t* a_words,
                                     uint32_t* b_words, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  if (m <= 0 || n <= 0) {
    return static_cast<int>(cudaSuccess);
  }
  if (semiring < 0 || semiring > 3 || plan == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const ReproMatmulPlan& p = *plan;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (semiring == 3) {
    if (!plan_fits(p, a_words, b_words, m, kd, n, true)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    if (p.k_steps > 0) {
      const int64_t row_threads = m * p.k_steps * 32;
      const int64_t col_threads = p.k_steps * p.ldb;
      const int64_t row_blocks = ceil_div(row_threads, kThreads);
      const int64_t col_blocks = ceil_div(col_threads, kThreads);
      if (row_blocks >= (int64_t{1} << 31) || col_blocks >= (int64_t{1} << 31)) {
        return static_cast<int>(cudaErrorInvalidConfiguration);
      }
      pack_rows_kernel<<<static_cast<unsigned>(row_blocks), kThreads, 0, s>>>(
          a, a_words, m, kd, p.k_steps);
      err = cudaGetLastError();
      if (err != cudaSuccess) {
        return static_cast<int>(err);
      }
      pack_cols_kernel<<<static_cast<unsigned>(col_blocks), kThreads, 0, s>>>(
          b, b_words, kd, n, p.k_steps, p.ldb);
      err = cudaGetLastError();
      if (err != cudaSuccess) {
        return static_cast<int>(err);
      }
    }
    const Args x{a_words, b_words, c, m, p.ldb, p.k_steps, n, p.tiles_n, p.blocks, s};
    return static_cast<int>(by_tile<OrAnd>(x, p));
  }
  if (!plan_fits(p, a, b, m, kd, n, false)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args x{a, b, c, m, n, kd, n, p.tiles_n, p.blocks, s};
  switch (semiring) {
    case 0:
      return static_cast<int>(by_tile<AddMul>(x, p));
    case 1:
      return static_cast<int>(by_tile<MaxAdd>(x, p));
    default:
      return static_cast<int>(by_tile<MinAdd>(x, p));
  }
}
