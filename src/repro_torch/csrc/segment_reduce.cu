// segment_reduce for Hopper: out[s, c] = min (or max) of data[e, c] over
// edges e with ids[e] == s; a segment no edge maps to holds +inf (-inf).
//
// Replaces the TPU kernel
// repro/kernels/segment_reduce.py:_segment_reduce_kernel (an
// identity-or-inf selector matrix reduced on the VPU per grid cell).  Here
// the ids are sorted, so each segment reduces one contiguous run of rows;
// see segmented_rows.cuh for the tile walk and why it is bound by bytes
// (n*d floats read, num_segments*d floats written, once each).
#include "segmented_rows.cuh"

namespace {

struct Min {
  __device__ static float identity() { return repro_torch::positive_inf(); }
  __device__ static float fold(float acc, float v) { return fminf(acc, v); }
};

struct Max {
  __device__ static float identity() { return repro_torch::negative_inf(); }
  __device__ static float fold(float acc, float v) { return fmaxf(acc, v); }
};

using MinRows = repro_torch::RowOp<Min>;
using MaxRows = repro_torch::RowOp<Max>;

}  // namespace

// kind: 0 = min, 1 = max; any other value returns cudaErrorInvalidValue.
extern "C" int repro_segment_reduce(int device, const float* data, const int64_t* ids,
                                    int64_t n, int64_t d, int64_t num_segments,
                                    int kind, float* out,
                                    const ReproWalkPlan* plan, void* stream) {
  if (kind == 0) {
    return static_cast<int>(repro_torch::launch_segmented_rows(
        device, ids, n, num_segments, d, MinRows{data, d}, out, plan, stream));
  }
  if (kind == 1) {
    return static_cast<int>(repro_torch::launch_segmented_rows(
        device, ids, n, num_segments, d, MaxRows{data, d}, out, plan, stream));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
