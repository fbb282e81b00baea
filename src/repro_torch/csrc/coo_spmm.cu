// coo_spmm for Hopper: out[r, c] = sum of vals[e] * dense[cols[e], c] over
// edges e with rows[e] == r, for every r in [0, num_rows).  Edges whose
// column lies outside [0, num_dense_rows) contribute nothing.
//
// Replaces the TPU kernel repro/kernels/coo_spmm.py:_coo_spmm_kernel,
// which gathers dense rows with a one-hot matmul per (m, e, k) grid cell
// and scatters them with a second one.  Here the gather is an indexed load
// of dense row cols[e] and the scatter is the sorted-run reduction of the
// slab-major warp walk in gathered_rows.cuh, so the (edges x width)
// gathered intermediate never exists.  Bound on this card: bytes (the
// dense rows the edges reference, read once, and num_rows*width floats
// written once); the walk's column-slab-major order keeps the slab of the
// dense matrix that the card is reading in L2, so that the ~10 edges that
// reference each dense row do not each fetch it from device memory.  The
// product is rounded before the sum (no fused multiply-add), as the plain
// version computes it.
#include "gathered_rows.cuh"

namespace {

struct SpmmGather {
  using Edge = repro_torch::GatherEdge<1>;
  struct Lane {};

  const float* src;  // dense, (rows, width)
  int64_t rows;
  const int64_t* cols;
  const float* vals;

  __device__ static float identity() { return 0.0f; }

  __device__ __forceinline__ Edge edge(int64_t e) const {
    if (e < 0) {
      return {-1, {0.0f}};
    }
    return {cols[e], {vals[e]}};
  }

  __device__ Lane lane(int64_t) const { return {}; }

  __device__ __forceinline__ void scales(const Lane&, int64_t, const Edge& edge,
                                         float (&s)[4]) const {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      s[i] = edge.w[0];
    }
  }

  __device__ static float fold(float acc, float s, float x) {
    return __fadd_rn(acc, __fmul_rn(s, x));
  }
};

}  // namespace

extern "C" int repro_coo_spmm(int device, const int64_t* rows, const int64_t* cols,
                              const float* vals, int64_t nnz, const float* dense,
                              int64_t num_dense_rows, int64_t width, int64_t num_rows,
                              float* out, const ReproGatherPlan* plan, void* stream) {
  return static_cast<int>(repro_torch::launch_gathered_rows(
      device, rows, nnz, num_rows, width, SpmmGather{dense, num_dense_rows, cols, vals}, out,
      plan, stream));
}
