// Shared sorted-run tile walk of the JOIN-AGG hop kernels: write every
// row of a (num_rows, d) float32 output once, each row reducing the run of
// edges whose sorted key equals the row index.
//
// Replaces the scatter half of the TPU kernels
// repro/kernels/segment_sum.py:_segment_sum_kernel,
// segment_reduce.py:_segment_reduce_kernel and
// fused_hop.py:_fused_hop_kernel, which turn the scatter into one-hot
// matmuls because a TPU has no cheap scatter.  On Hopper the keys arrive
// sorted (grouped-CSR order, DESIGN.md §7), so each output row's edges are
// one contiguous run: no atomics, no separate zero fill.  The ops that
// gather one child row per edge (coo_spmm, one-child fused_hop hops of
// width >= 32) take the slab-major warp walk of gathered_rows.cuh instead,
// which reuses this file's block search and run marking.
//
// Bound on this card: bytes.  Every output element is written once and
// every edge row is read once, against O(1) arithmetic per byte.  The main
// path launches the walk in two regimes, and the design meets each:
//
//   * Leaf: ~500,000 edges into ~10^8 rows of d = 1 or 2, > 99.5 % empty;
//     the identity fill is the work.  Rows narrower than a warp take the
//     narrow walk: a tile of 16,384 output floats is one contiguous span,
//     which the block fills with the identity in 16-byte stores (a scalar
//     head and tail where the span does not start or end on 16 bytes, as a
//     slice of a larger output does) before it looks at a key, so the
//     stores overlap the search; then each run is reduced by the thread
//     that holds its first edge and overwrites its row.
//   * Chunk: a few thousand edges into a few hundred rows of d in the
//     thousands, ~10 edges per row; reading the edge rows is the work.
//     Wide rows take the row walk: each row splits into column slabs of at
//     most 1,024 floats over several blocks, so a few hundred rows fill
//     the card; shared memory holds each row's run bounds; a thread owns
//     1, 2 or 4 adjacent columns (16-byte loads and stores where d and both
//     pointers allow) and issues the loads of kUnroll edges of its run
//     before it folds them.
//
// Tile bounds come without serial search chains.  Each block owns one
// tile (and one column slab of it) and finds where the tile's edges begin
// by a cooperative search: every thread probes one key per round, about
// three rounds at 500,000 keys.  The tile's runs are then marked, not
// searched: one strided pass over its edges, in which an edge whose key
// differs from its predecessor's opens a run and one that differs from its
// successor's closes it, finds where the tile's edges end and (row walk)
// fills the run bounds in shared memory; rows no edge opens stay empty.  The launch shape (narrow
// or row walk, rows per tile, column slab) is a function of (n, num_rows,
// d) alone, computed by kernels/ops.py:walk_plan and passed in; the vector
// width also depends on the pointers' alignment.  The tile sizes are the
// fastest of tools/walk_sweep.py's candidates on an H100; larger tiles lost
// (a block walks its tile in barrier-separated phases, so fewer, longer
// blocks hide less latency).
//
// Bits are unchanged from the one-thread-per-element walk: each output
// element is still reduced by one thread, over its run in edge order, with
// the op's own fold (__fadd_rn, fminf, fmaxf, or the op's product and
// fold): wider loads and stores move the same values, and unrolling issues
// loads early but folds them in order.  fused_hop's hops with no child,
// with two or more, or with one child narrower than a warp keep their
// one-edge-at-a-time loop; they run on the row walk with one column per
// thread, or on the narrow walk.
//
// Preconditions (the Python wrappers check all but the first two, which
// would need a pass over the data):
//   * keys ascending; keys outside [0, num_rows) are dropped (they sort
//     to the two ends of the array, where no tile's range reaches them);
//   * no NaN in the reduced values;
//   * int64 keys and indices, float32 values, all contiguous on one card;
//   * 0 < d < 2^31 and n < 2^31 (run bounds are 32-bit offsets).
#pragma once

#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

// Launch shape; field for field kernels/ops.py:WalkPlan.
struct ReproWalkPlan {
  int64_t rows_per_tile;
  int64_t slab;             // columns per slab (a multiple of 4 when slabs > 1)
  int64_t slabs;
  int64_t blocks;           // tiles * slabs: block b walks slab b % slabs of tile b / slabs
  int64_t smem_bytes;       // row walk: two int32 run bounds per tile row
  int32_t narrow;           // 1: flat walk over the tile's output span
};

namespace repro_torch {

constexpr int kThreads = 256;
constexpr int kUnroll = 8;  // edge loads a thread issues before it folds them
constexpr int64_t kMaxSmem = 49152;  // dynamic shared memory without opting in

__device__ __forceinline__ float positive_inf() { return __int_as_float(0x7f800000); }
__device__ __forceinline__ float negative_inf() { return __int_as_float(0xff800000); }

// The op of segment_sum and segment_reduce: out[s, c] folds data[e, c] over
// the run.  Fold supplies `static float identity()` and `static float
// fold(float acc, float v)`.  The walk reads its rows itself, V columns at
// a time (kReadsRows marks the ops it may do that for).
template <class Fold>
struct RowOp {
  static constexpr bool kReadsRows = true;
  const float* data;
  int64_t d;

  __device__ static float identity() { return Fold::identity(); }
  __device__ static float fold(float acc, float v) { return Fold::fold(acc, v); }
};

template <class Op, class = void>
struct ReadsRows : std::false_type {};
template <class Op>
struct ReadsRows<Op, std::void_t<decltype(Op::kReadsRows)>> : std::true_type {};

template <int V> struct Vec;
template <> struct Vec<1> { using T = float; };
template <> struct Vec<2> { using T = float2; };
template <> struct Vec<4> { using T = float4; };

// lower_bound over keys[lo, hi) by the whole block; every thread calls it
// and gets the same answer.  Each round every thread probes one key.
__device__ inline int64_t block_lower_bound(const int64_t* __restrict__ keys, int64_t lo,
                                            int64_t hi, int64_t value) {
  const int64_t threads = blockDim.x;
  while (hi - lo > threads) {
    const int64_t stride = (hi - lo + threads - 1) / threads;
    const int64_t i = lo + threadIdx.x * stride;
    const int below = __syncthreads_count(i < hi && keys[i] < value);
    if (below == 0) {
      return lo;
    }
    const int64_t next_hi = lo + below * stride;
    lo += (below - 1) * stride + 1;
    hi = next_hi < hi ? next_hi : hi;
  }
  const int64_t i = lo + threadIdx.x;
  return lo + __syncthreads_count(i < hi && keys[i] < value);
}

// The op's fold over edges [e, end) of column col, one edge at a time (the
// loop of the fused_hop hops that stay on this walk).
template <class Op, class Column>
__device__ __forceinline__ float reduce_run(const Op& op, const Column& col, int64_t e,
                                            int64_t end) {
  float acc = Op::identity();
  for (; e < end; ++e) {
    acc = op(acc, e, col);
  }
  return acc;
}

// A RowOp's fold over edges [e, end) of columns [c, c + V): the loads of
// kUnroll edges first, then their folds in edge order.
template <int V, class Op>
__device__ __forceinline__ void reduce_rows(const Op& op, int64_t e, int64_t end,
                                            int64_t c, float (&acc)[V]) {
  using T = typename Vec<V>::T;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    acc[i] = Op::identity();
  }
  for (; e < end; e += kUnroll) {
    T v[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      if (e + j < end) {
        v[j] = __ldg(reinterpret_cast<const T*>(op.data + (e + j) * op.d + c));
      }
    }
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      if (e + j < end) {
        const float* lanes = reinterpret_cast<const float*>(&v[j]);
#pragma unroll
        for (int i = 0; i < V; ++i) {
          acc[i] = Op::fold(acc[i], lanes[i]);
        }
      }
    }
  }
}

template <class Op>
__device__ __forceinline__ float element(const Op& op, uint32_t c, int64_t e, int64_t end) {
  if (e == end) {
    return Op::identity();
  }
  if constexpr (ReadsRows<Op>::value) {
    float acc[1];
    reduce_rows<1>(op, e, end, c, acc);
    return acc[0];
  } else {
    return reduce_run(op, op.column(c), e, end);
  }
}

// Mark the runs of the tile of rows [s0, s0 + rows) whose first edge is
// e0, by the whole block; every thread calls it and gets the end of the
// tile's edges.  keys[e0..] are >= s0; those < s0 + rows belong here, a
// prefix of each batch because the keys are sorted.  With kBounds, an
// edge that opens row r's run stores first[r] and one that closes it
// stop[r], both relative to e0; the caller has zeroed both, so a row no
// edge opens keeps the empty run [0, 0).  The last __syncthreads_count
// orders these stores before any thread reads them.
template <bool kBounds>
__device__ inline int64_t mark_runs(const int64_t* __restrict__ keys, int64_t n, int64_t e0,
                                    int64_t s0, int64_t rows, int32_t* first, int32_t* stop) {
  int64_t e = e0;
  for (;;) {
    const int64_t i = e + threadIdx.x;
    int inside = 0;
    if (i < n) {
      const int64_t k = keys[i];
      if (k < s0 + rows) {
        inside = 1;
        if constexpr (kBounds) {
          const int64_t r = k - s0;
          const int32_t rel = static_cast<int32_t>(i - e0);
          if (i == e0 || keys[i - 1] != k) {
            first[r] = rel;
          }
          if (i + 1 == n || keys[i + 1] != k) {
            stop[r] = rel + 1;
          }
        }
      }
    }
    const int count = __syncthreads_count(inside);
    e += count;
    if (count < static_cast<int>(blockDim.x)) {
      return e;
    }
  }
}

// End of the run of key k that starts at edge i: the first edge in (i, e)
// whose key differs, found by galloping, or e.
__device__ __forceinline__ int64_t run_end(const int64_t* __restrict__ keys, int64_t i,
                                           int64_t e, int64_t k) {
  int64_t last = i;  // keys[last] == k
  int64_t step = 1;
  int64_t probe = i + 1;
  while (probe < e && keys[probe] == k) {
    last = probe;
    step <<= 1;
    probe = last + step;
  }
  int64_t lo = last + 1;
  int64_t hi = probe < e ? probe : e;
  while (lo < hi) {
    const int64_t mid = lo + ((hi - lo) >> 1);
    if (keys[mid] == k) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// V = 0: narrow walk.  The block first fills its tile's output span with
// the identity (16-byte stores), which needs no key, so the stores are in
// flight while the search runs; after the search's barriers, each run is
// reduced by the thread that holds its first edge, for all d columns, and
// overwrites its row.  No shared memory.
//
// V = 1, 2, 4: row walk.  Shared memory holds each tile row's run [first,
// stop) relative to the tile's first edge; a thread owns V adjacent
// columns of one row of the block's column slab.
//
// Op supplies `static float identity()`, `Column column(uint32_t c) const`
// (what an output column needs across the edge loop) and `float
// operator()(float acc, int64_t edge, const Column& col) const`; a RowOp
// supplies `identity`, `fold`, `data` and `d` instead.  The op is a
// __grid_constant__ parameter: its fields are read from the parameter
// bank and never copied per thread.  fused_hop's ops keep the 32
// registers they had before the walk grew, so that eight blocks share an
// SM.
template <class Op, int V>
__global__ void __launch_bounds__(kThreads, ReadsRows<Op>::value ? 1 : 8)
segmented_rows(const int64_t* __restrict__ keys, int64_t n, int64_t num_rows,
               int64_t d, const ReproWalkPlan plan, const __grid_constant__ Op op,
               float* __restrict__ out) {
  extern __shared__ int32_t first[];  // row walk: run [first[r], stop[r]) from e0
  const int64_t R = plan.rows_per_tile;
  int32_t* stop = first + R;
  const int64_t tile = blockIdx.x / plan.slabs;
  const int64_t slab = blockIdx.x - tile * plan.slabs;
  const uint32_t width = static_cast<uint32_t>(d);
  const int64_t s0 = tile * R;
  const int64_t rows = num_rows - s0 < R ? num_rows - s0 : R;
  float* __restrict__ dst = out + s0 * d;  // the tile's first row
  if constexpr (V == 0) {
    const float ident = Op::identity();
    const uint32_t count = static_cast<uint32_t>(rows) * width;
    const uint32_t misaligned = (reinterpret_cast<uintptr_t>(dst) >> 2) & 3u;
    const uint32_t head = misaligned == 0 ? 0 : (4 - misaligned < count ? 4 - misaligned : count);
    const uint32_t body = (count - head) >> 2;
    const uint32_t tail = count - head - 4 * body;
    for (uint32_t j = threadIdx.x; j < head + tail; j += blockDim.x) {
      dst[j < head ? j : 4 * body + j] = ident;
    }
    for (uint32_t j = threadIdx.x; j < body; j += blockDim.x) {
      *reinterpret_cast<float4*>(dst + head + 4 * j) = make_float4(ident, ident, ident, ident);
    }
  } else {
    for (int64_t r = threadIdx.x; r < rows; r += blockDim.x) {
      first[r] = 0;
      stop[r] = 0;
    }
  }
  const int64_t e0 = block_lower_bound(keys, 0, n, s0);  // its barriers order the above
  const int64_t e = mark_runs<V != 0>(keys, n, e0, s0, rows, first, stop);
  if constexpr (V == 0) {
    for (int64_t i = e0 + threadIdx.x; i < e; i += blockDim.x) {
      const int64_t k = keys[i];
      if (i == e0 || keys[i - 1] != k) {
        const int64_t end = run_end(keys, i, e, k);
        float* __restrict__ row = dst + (k - s0) * d;
        for (uint32_t c = 0; c < width; ++c) {
          row[c] = element(op, c, i, end);
        }
      }
    }
  } else {
    const int64_t c0 = slab * plan.slab;
    const int64_t c1 = c0 + plan.slab < d ? c0 + plan.slab : d;
    const uint32_t per_row = static_cast<uint32_t>((c1 - c0) / V);
    const uint32_t items = static_cast<uint32_t>(rows) * per_row;
    for (uint32_t j = threadIdx.x; j < items; j += blockDim.x) {
      const uint32_t r = j / per_row;
      const int64_t c = c0 + static_cast<int64_t>(j - r * per_row) * V;
      const int64_t st = e0 + first[r];
      const int64_t en = e0 + stop[r];
      float* __restrict__ at = dst + r * d + c;
      if constexpr (ReadsRows<Op>::value) {
        float acc[V];
        reduce_rows<V>(op, st, en, c, acc);
        if constexpr (V == 1) {
          *at = acc[0];
        } else if constexpr (V == 2) {
          *reinterpret_cast<float2*>(at) = make_float2(acc[0], acc[1]);
        } else {
          *reinterpret_cast<float4*>(at) = make_float4(acc[0], acc[1], acc[2], acc[3]);
        }
      } else {
        static_assert(V == 1, "ops that read no rows of their own run one column per thread");
        *at = element(op, static_cast<uint32_t>(c), st, en);
      }
    }
  }
}

__host__ inline bool aligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

// Whether the walk can run `p` (kernels/ops.py:walk_plan makes such plans);
// any other plan is refused with cudaErrorInvalidValue before a launch.
__host__ inline bool plan_fits(const ReproWalkPlan& p, int64_t n, int64_t num_rows,
                               int64_t d) {
  const int64_t smem = p.narrow ? 0 : 8 * p.rows_per_tile;
  if (n < 0 || n >= (int64_t{1} << 31) || p.rows_per_tile < 1 ||
      p.rows_per_tile > num_rows || p.slab < 1 || p.slabs < 1 ||
      p.smem_bytes != smem || p.smem_bytes > kMaxSmem) {
    return false;
  }
  if (p.slabs * p.slab < d || (p.slabs - 1) * p.slab >= d ||
      (p.slabs > 1 && p.slab % 4 != 0) || (p.narrow && p.slabs != 1)) {
    return false;
  }
  const int64_t tiles = (num_rows + p.rows_per_tile - 1) / p.rows_per_tile;
  return p.blocks == tiles * p.slabs && p.blocks < (int64_t{1} << 31) &&
         (p.narrow ? p.rows_per_tile * d : p.rows_per_tile * p.slab) < (int64_t{1} << 31);
}

template <class Op, int V>
cudaError_t launch_walk(const int64_t* keys, int64_t n, int64_t num_rows, int64_t d,
                        const ReproWalkPlan& plan, const Op& op, float* out,
                        cudaStream_t stream) {
  segmented_rows<Op, V><<<static_cast<unsigned>(plan.blocks), kThreads,
                          static_cast<size_t>(plan.smem_bytes), stream>>>(
      keys, n, num_rows, d, plan, op, out);
  return cudaGetLastError();
}

template <class Op>
cudaError_t launch_segmented_rows(int device, const int64_t* keys, int64_t n,
                                  int64_t num_rows, int64_t d, Op op, float* out,
                                  const ReproWalkPlan* plan, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) {
    return err;
  }
  if (num_rows <= 0 || d <= 0) {
    return cudaSuccess;
  }
  if (plan == nullptr || !plan_fits(*plan, n, num_rows, d)) {
    return cudaErrorInvalidValue;
  }
  const auto s = static_cast<cudaStream_t>(stream);
  if (plan->narrow) {
    return launch_walk<Op, 0>(keys, n, num_rows, d, *plan, op, out, s);
  }
  if constexpr (ReadsRows<Op>::value) {
    const bool even = d % 2 == 0 && plan->slab % 2 == 0;
    if (d % 4 == 0 && plan->slab % 4 == 0 && aligned(out, 16) && aligned(op.data, 16)) {
      return launch_walk<Op, 4>(keys, n, num_rows, d, *plan, op, out, s);
    }
    if (even && aligned(out, 8) && aligned(op.data, 8)) {
      return launch_walk<Op, 2>(keys, n, num_rows, d, *plan, op, out, s);
    }
  }
  return launch_walk<Op, 1>(keys, n, num_rows, d, *plan, op, out, s);
}

}  // namespace repro_torch
