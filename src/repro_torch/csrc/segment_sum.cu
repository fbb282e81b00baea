// segment_sum for Hopper: out[s, c] = sum of data[e, c] over edges e with
// ids[e] == s, for every s in [0, num_segments).
//
// Replaces the TPU kernel repro/kernels/segment_sum.py:_segment_sum_kernel
// (one-hot MXU matmul per segment-tile x row-tile grid cell).  Here the
// ids are sorted, so each segment sums one contiguous run of rows in edge
// order; see segmented_rows.cuh for the tile walk and why it is bound by
// bytes (n*d floats read, num_segments*d floats written, once each).
#include "segmented_rows.cuh"

namespace {

struct SumRows {
  const float* data;
  int64_t d;

  __device__ static float identity() { return 0.0f; }

  __device__ __forceinline__ float operator()(float acc, int64_t e, uint32_t c) const {
    return __fadd_rn(acc, data[e * d + c]);
  }
};

}  // namespace

extern "C" int repro_segment_sum(int device, const float* data, const int64_t* ids,
                                 int64_t n, int64_t d, int64_t num_segments,
                                 float* out, void* stream) {
  return static_cast<int>(repro_torch::launch_segmented_rows(
      device, ids, n, num_segments, d, SumRows{data, d}, out, stream));
}
