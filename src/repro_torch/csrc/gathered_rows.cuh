// Slab-major warp walk of the hop kernels that gather: coo_spmm and the
// one-child fused_hop hops of width >= 32.  Every row s of a (num_rows, d)
// float32 output reduces, over the run of edges whose sorted key is s,
// one term per edge built from the row src[index(e)] of a (rows, d)
// operand (coo_spmm's dense matrix, fused_hop's child message) and the
// edge's weight.
//
// Bound on this card: bytes, and the order of the gathers decides how
// many.  At the main path's shape 499,948 edges gather rows of a
// (50000, 4500) float32 operand into 50,000 output rows: ~10 edges per
// output row and ~10 references to each operand row, from output rows
// spread over the whole key range.  Read straight from device memory the
// gathers move 9.0 GB, ten times the operand's 0.9 GB.  The walk keeps
// the operand in L2 instead:
//
//   * Column-slab-major order.  The output's d columns are cut into slabs
//     of W columns (kernels/ops.py:gather_plan), and the slab index is the
//     slow dimension of the grid: block b walks slab b / tiles of tile
//     b % tiles.  The card walks every output row of slab 0 before slab 1,
//     so the live part of the operand is its rows x W slab (25.6 MB at
//     W = 128 and 50,000 rows, against the 50 MB L2), and each operand
//     row's W-column piece is fetched from device memory about once per
//     slab, not once per edge.  The edge arrays are reread once per slab.
//   * A warp per (output row, slab).  Each lane owns 4 adjacent columns
//     of each 128-column chunk of the slab and reads and writes them in
//     the widest accesses that d and the operand's and output's alignment
//     allow: one 16-byte access, two of 8 bytes or four of 4.  The warp's
//     lanes load the run's next 32 edges together (the operand row index
//     and the weight, coalesced) and pass them on with __shfl_sync, so the
//     dependent index load is paid once per 32 edges.  Each lane then
//     starts the gathers of U edges (the plan's in_flight) before it folds
//     any.
//   * The output is written once, with streaming stores, so that it does
//     not evict the resident slab.  (An L2 evict_last policy on the
//     gathers made no difference in tools/walk_sweep.py and is not used.)
//
// Run bounds come as in segmented_rows.cuh: one cooperative search for
// the block's first edge, then one marking pass over its edges into
// shared memory.  A block's warps walk the rows of its tile, one row at
// a time each; a row that no edge reaches is written with the op's
// identity.
//
// Bits are unchanged from the one-thread-per-element walk: each output
// element is reduced by one lane, over its run in edge order, with the
// op's own fold; an edge whose operand row lies outside [0, rows)
// contributes nothing.
//
// Preconditions are those of segmented_rows.cuh: keys ascending, int64
// keys and indices, float32 values, all contiguous on one card,
// 0 < d < 2^31, n < 2^31.
#pragma once

#include "segmented_rows.cuh"

// Launch shape; field for field kernels/ops.py:GatherPlan.
struct ReproGatherPlan {
  int64_t slab;            // W: columns per slab, a multiple of 32
  int64_t slabs;
  int64_t rows_per_block;  // rows of one tile
  int64_t tiles;           // ceil(num_rows / rows_per_block)
  int64_t blocks;          // tiles * slabs
  int64_t smem_bytes;      // two int32 run bounds per row
  int32_t slab_major;      // 1: block b walks slab b / tiles of tile b % tiles;
                           // 0: slab b % slabs of tile b / slabs
  int32_t in_flight;       // U: edges whose gathers a lane starts before it folds them
  int32_t warps;           // per block; warp w walks rows w, w + warps, ... of the tile
};

namespace repro_torch {

constexpr int kGatherMaxWarps = 4;
constexpr int kGatherMaxThreads = 32 * kGatherMaxWarps;
constexpr int64_t kGatherMaxRows = 1024;
constexpr unsigned kFullWarp = 0xffffffffu;

// One edge as the lane that loads it for the warp holds it: the operand
// row as the edge names it (checked against the operand's rows only where
// the warp uses it, so that a load started early is not waited for) and
// NW per-edge weights.
template <int NW>
struct GatherEdge {
  int64_t row;
  float w[NW];

  // Lane `from`'s edge, for every lane of the warp.
  __device__ __forceinline__ GatherEdge from(int from) const {
    GatherEdge e;
    e.row = __shfl_sync(kFullWarp, row, from);
#pragma unroll
    for (int i = 0; i < NW; ++i) {
      e.w[i] = __shfl_sync(kFullWarp, w[i], from);
    }
    return e;
  }
};

// Columns c..c+live-1 (live <= 4) of the operand row at p = row + c, in
// accesses of A floats: one 16-byte load (A = 4), 8-byte loads (A = 2,
// d even and 8-byte aligned) or 4-byte loads (A = 1), through the
// read-only path.  A lane's first column is a multiple of 4, so with A = 2
// live is even.
template <int A>
__device__ __forceinline__ void gather(const float* __restrict__ p, float (&x)[4], int live) {
  if constexpr (A == 4) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    x[0] = v.x;
    x[1] = v.y;
    x[2] = v.z;
    x[3] = v.w;
  } else if constexpr (A == 2) {
    const float2 lo = __ldg(reinterpret_cast<const float2*>(p));
    x[0] = lo.x;
    x[1] = lo.y;
    if (live > 2) {
      const float2 hi = __ldg(reinterpret_cast<const float2*>(p + 2));
      x[2] = hi.x;
      x[3] = hi.y;
    }
  } else {
    static_assert(A == 1, "accesses of 1, 2 or 4 floats");
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (i < live) {
        x[i] = __ldg(p + i);
      }
    }
  }
}

// Columns c..c+live-1 of the output row at p = row + c, written once with
// streaming stores in accesses of A floats.
template <int A>
__device__ __forceinline__ void store(float* __restrict__ p, const float (&acc)[4], int live) {
  if constexpr (A == 4) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(acc[0], acc[1], acc[2], acc[3]));
  } else if constexpr (A == 2) {
    __stcs(reinterpret_cast<float2*>(p), make_float2(acc[0], acc[1]));
    if (live > 2) {
      __stcs(reinterpret_cast<float2*>(p + 2), make_float2(acc[2], acc[3]));
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (i < live) {
        __stcs(p + i, acc[i]);
      }
    }
  }
}

// Op supplies `const float* src` and `int64_t rows` (the operand, rows of
// d floats), `using Edge = GatherEdge<NW>`, `Edge edge(int64_t e) const`
// (edge e as one lane loads it, or row -1 for e = -1), `Lane
// lane(int64_t c) const` (what columns c..c+3 need across the run), `void
// scales(const Lane&, int64_t e, const Edge&, float (&s)[4]) const` (each
// column's weight for edge e), `static float identity()` and `static
// float fold(float acc, float s, float x)`.
template <class Op, int A, int U>
__global__ void __launch_bounds__(kGatherMaxThreads)
gathered_rows(const int64_t* __restrict__ keys, int64_t n, int64_t num_rows, int64_t d,
              const ReproGatherPlan plan, const __grid_constant__ Op op,
              float* __restrict__ out) {
  extern __shared__ int32_t first[];  // run [first[r], stop[r]) from e0
  const int64_t R = plan.rows_per_block;
  int32_t* stop = first + R;
  const int64_t b = blockIdx.x;
  const int64_t slab = plan.slab_major ? b / plan.tiles : b % plan.slabs;
  const int64_t tile = plan.slab_major ? b - slab * plan.tiles : b / plan.slabs;
  const int64_t s0 = tile * R;
  const int64_t rows = num_rows - s0 < R ? num_rows - s0 : R;
  for (int64_t r = threadIdx.x; r < rows; r += blockDim.x) {
    first[r] = 0;
    stop[r] = 0;
  }
  const int64_t e0 = block_lower_bound(keys, 0, n, s0);  // its barriers order the above
  mark_runs<true>(keys, n, e0, s0, rows, first, stop);
  const int lane = threadIdx.x & 31;
  const int64_t c0 = slab * plan.slab;
  const int64_t c1 = c0 + plan.slab < d ? c0 + plan.slab : d;
  const int64_t first_row = threadIdx.x >> 5;
  if (first_row >= rows) {
    return;
  }
  for (int64_t cc = c0; cc < c1; cc += 128) {
    const int64_t c = cc + 4 * lane;
    const int live = c1 - c < 4 ? static_cast<int>(c1 - c) : 4;  // <= 0: no columns
    const typename Op::Lane at = op.lane(c);
    for (int64_t w = first_row; w < rows; w += plan.warps) {
      const int64_t st = e0 + first[w];
      const int64_t en = e0 + stop[w];
      float acc[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[i] = Op::identity();
      }
      for (int64_t base = st; base < en; base += 32) {
        const int m = en - base < 32 ? static_cast<int>(en - base) : 32;
        const typename Op::Edge mine = op.edge(lane < m ? base + lane : -1);
        for (int j = 0; j < m; j += U) {
          float x[U][4];
          typename Op::Edge edge[U];
          bool use[U];  // the edge exists, its operand row is in range, the lane has columns
#pragma unroll
          for (int u = 0; u < U; ++u) {
            use[u] = false;
            if (j + u < m) {  // the same for every lane: all of them shuffle
              edge[u] = mine.from(j + u);
              use[u] = live > 0 && edge[u].row >= 0 && edge[u].row < op.rows;
              if (use[u]) {
                gather<A>(op.src + edge[u].row * d + c, x[u], live);
              }
            }
          }
#pragma unroll
          for (int u = 0; u < U; ++u) {
            if (use[u]) {
              float s[4];
              op.scales(at, base + j + u, edge[u], s);
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                if (A == 4 || i < live) {
                  acc[i] = Op::fold(acc[i], s[i], x[u][i]);
                }
              }
            }
          }
        }
      }
      if (live > 0) {
        store<A>(out + (s0 + w) * d + c, acc, live);
      }
    }
  }
}

// Whether the walk can run `p` (kernels/ops.py:gather_plan makes such
// plans); any other plan is refused with cudaErrorInvalidValue before a
// launch.
__host__ inline bool gather_plan_fits(const ReproGatherPlan& p, int64_t n, int64_t num_rows,
                                      int64_t d) {
  if (n < 0 || n >= (int64_t{1} << 31) || p.rows_per_block < 1 ||
      p.rows_per_block > kGatherMaxRows || p.rows_per_block > num_rows || p.warps < 1 ||
      p.warps > kGatherMaxWarps || p.warps > p.rows_per_block ||
      p.smem_bytes != 8 * p.rows_per_block || p.slab < 32 || p.slab % 32 != 0 ||
      p.slabs < 1 || p.slabs * p.slab < d || (p.slabs - 1) * p.slab >= d) {
    return false;
  }
  if ((p.in_flight != 1 && p.in_flight != 4 && p.in_flight != 8) ||
      (p.slab_major != 0 && p.slab_major != 1)) {
    return false;
  }
  const int64_t tiles = (num_rows + p.rows_per_block - 1) / p.rows_per_block;
  return p.tiles == tiles && p.blocks == tiles * p.slabs && p.blocks < (int64_t{1} << 31);
}

template <class Op, int A, int U>
cudaError_t launch_gather(const int64_t* keys, int64_t n, int64_t num_rows, int64_t d,
                          const ReproGatherPlan& plan, const Op& op, float* out,
                          cudaStream_t stream) {
  gathered_rows<Op, A, U><<<static_cast<unsigned>(plan.blocks),
                            static_cast<unsigned>(32 * plan.warps),
                            static_cast<size_t>(plan.smem_bytes), stream>>>(
      keys, n, num_rows, d, plan, op, out);
  return cudaGetLastError();
}

template <class Op, int A>
cudaError_t launch_gather_width(const int64_t* keys, int64_t n, int64_t num_rows, int64_t d,
                                const ReproGatherPlan& plan, const Op& op, float* out,
                                cudaStream_t stream) {
  switch (plan.in_flight) {
    case 1:
      return launch_gather<Op, A, 1>(keys, n, num_rows, d, plan, op, out, stream);
    case 4:
      return launch_gather<Op, A, 4>(keys, n, num_rows, d, plan, op, out, stream);
    default:
      return launch_gather<Op, A, 8>(keys, n, num_rows, d, plan, op, out, stream);
  }
}

template <class Op>
cudaError_t launch_gathered_rows(int device, const int64_t* keys, int64_t n, int64_t num_rows,
                                 int64_t d, Op op, float* out, const ReproGatherPlan* plan,
                                 void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) {
    return err;
  }
  if (num_rows <= 0 || d <= 0) {
    return cudaSuccess;
  }
  if (plan == nullptr || !gather_plan_fits(*plan, n, num_rows, d)) {
    return cudaErrorInvalidValue;
  }
  // Accesses as wide as d and both pointers' alignment allow.
  const auto s = static_cast<cudaStream_t>(stream);
  if (d % 4 == 0 && aligned(out, 16) && aligned(op.src, 16)) {
    return launch_gather_width<Op, 4>(keys, n, num_rows, d, *plan, op, out, s);
  }
  if (d % 2 == 0 && aligned(out, 8) && aligned(op.src, 8)) {
    return launch_gather_width<Op, 2>(keys, n, num_rows, d, *plan, op, out, s);
  }
  return launch_gather_width<Op, 1>(keys, n, num_rows, d, *plan, op, out, s);
}

}  // namespace repro_torch
