// coo_spmm for Hopper: out[r, c] = sum of vals[e] * dense[cols[e], c] over
// edges e with rows[e] == r, for every r in [0, num_rows).  Edges whose
// column lies outside [0, num_dense_rows) contribute nothing.
//
// Replaces the TPU kernel repro/kernels/coo_spmm.py:_coo_spmm_kernel,
// which gathers dense rows with a one-hot matmul per (m, e, k) grid cell
// and scatters them with a second one.  Here the gather is an indexed load
// of dense row cols[e] and the scatter is the sorted-run reduction of
// segmented_rows.cuh, so the (edges x width) gathered intermediate never
// exists.  Bound on this card: bytes (the dense rows the edges reference,
// read once, and num_rows*width floats written once); the rows of one
// output row's run are read along c by consecutive threads, coalesced.
// The product is rounded before the sum (no fused multiply-add), as the
// plain version computes it.
#include "segmented_rows.cuh"

namespace {

struct SpmmRows {
  const int64_t* cols;
  const float* vals;
  const float* dense;
  int64_t num_dense_rows;
  int64_t width;

  __device__ uint32_t column(uint32_t c) const { return c; }
  __device__ static float identity() { return 0.0f; }

  __device__ __forceinline__ float operator()(float acc, int64_t e, uint32_t c) const {
    const int64_t col = cols[e];
    if (col < 0 || col >= num_dense_rows) {
      return acc;
    }
    return __fadd_rn(acc, __fmul_rn(vals[e], dense[col * width + c]));
  }
};

}  // namespace

extern "C" int repro_coo_spmm(int device, const int64_t* rows, const int64_t* cols,
                              const float* vals, int64_t nnz, const float* dense,
                              int64_t num_dense_rows, int64_t width, int64_t num_rows,
                              float* out, const ReproWalkPlan* plan,
                              void* stream) {
  return static_cast<int>(repro_torch::launch_segmented_rows(
      device, rows, nnz, num_rows, width,
      SpmmRows{cols, vals, dense, num_dense_rows, width}, out, plan, stream));
}
