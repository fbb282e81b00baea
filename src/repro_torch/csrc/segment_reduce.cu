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

struct MinRows {
  const float* data;
  int64_t d;

  __device__ uint32_t column(uint32_t c) const { return c; }
  __device__ static float identity() { return repro_torch::positive_inf(); }

  __device__ __forceinline__ float operator()(float acc, int64_t e, uint32_t c) const {
    return fminf(acc, data[e * d + c]);
  }
};

struct MaxRows {
  const float* data;
  int64_t d;

  __device__ uint32_t column(uint32_t c) const { return c; }
  __device__ static float identity() { return repro_torch::negative_inf(); }

  __device__ __forceinline__ float operator()(float acc, int64_t e, uint32_t c) const {
    return fmaxf(acc, data[e * d + c]);
  }
};

}  // namespace

// kind: 0 = min, 1 = max; any other value returns cudaErrorInvalidValue.
extern "C" int repro_segment_reduce(int device, const float* data, const int64_t* ids,
                                    int64_t n, int64_t d, int64_t num_segments,
                                    int kind, float* out, void* stream) {
  if (kind == 0) {
    return static_cast<int>(repro_torch::launch_segmented_rows(
        device, ids, n, num_segments, d, MinRows{data, d}, out, stream));
  }
  if (kind == 1) {
    return static_cast<int>(repro_torch::launch_segmented_rows(
        device, ids, n, num_segments, d, MaxRows{data, d}, out, stream));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
