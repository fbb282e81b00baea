// fused_hop for Hopper: one whole JOIN-AGG decomposition-tree hop in one
// launch.  For every output row s and column f = u * k + c (u the
// mixed-radix index over the children's widths, last child fastest; c the
// channel):
//
//   sum:      out[s, f] = sum over edges e with key[e] == s of
//                         w[e, c] * msg_0[idx_0[e], col_0(u) * k + c] * ...
//   min/max:  out[s, u] = min/max over the same edges of
//                         w[e] + msg_0[idx_0[e], col_0(u)] + ...
//
// products (sums) taken in child order; an output row no edge reaches
// holds 0 (sum) or +inf/-inf (min/max).  An edge whose key lies outside
// [0, num_segments) or whose index into some child lies outside that
// child's rows contributes nothing.
//
// Replaces the TPU kernel repro/kernels/fused_hop.py:_fused_hop_kernel
// (with _gather_sum and _gather_minmax).  That body gathers child rows
// with one-hot MXU matmuls and keeps a parallel finiteness mask so that a
// one-hot product never meets a ±inf identity (0 * inf = nan).  Both are
// TPU workarounds and are gone: here the hop is one more op of the
// sorted-run walks.  A hop with exactly one child and an output row of 32
// floats or more runs the slab-major warp walk of gathered_rows.cuh
// (repro_fused_hop_one_child below), which keeps the slab of the child's
// message that the card is reading in L2; every other hop runs the
// sorted-run tile walk of segmented_rows.cuh.  Each output element loads
// its children's values by index, multiplies (adds) them with
// __fmul_rn/__fadd_rn — no fused multiply-add, so the bits equal the
// three-dispatch path of gather, product and segment_sum — and reduces
// them over its key run in edge order.  The ±inf identities of one kind
// all carry one sign, so plain addition carries them and no mask is
// needed.  The edge-sized (edges x width * k) product that the
// three-dispatch path writes and reads back never exists.
//
// Bound on this card: bytes.  Every output element is written once; each
// edge reads its key, weight and child indices once per output tile (or
// column slab) and the referenced child message rows along the output
// row, coalesced across consecutive threads.  Operations per byte stay
// O(children).
//
// The children travel by value inside the kernel's parameter (at most
// kMaxChildren = 64 of 32 bytes: about 2 KiB of the 4 KiB parameter
// limit).  Hops of up to three children, which are what acyclic queries
// produce, run an instantiation that decodes each output column's child
// offsets once per output element into registers; more children decode
// per edge.
#include "gathered_rows.cuh"

// One child as the C caller passes it (kernels/fused_hop.py:_Child).
struct ReproFusedChild {
  const float* msg;    // (rows, width * k) row-major
  const int64_t* idx;  // (n,) edge -> child row
  int64_t rows;
  int64_t width;
};

namespace {

constexpr int kMaxChildren = 64;
constexpr int kDynamic = -1;  // child count read at run time

enum Kind { kSum = 0, kMin = 1, kMax = 2 };

struct Child {
  const float* msg;
  const int64_t* idx;
  int64_t rows;
  uint32_t width;
  uint32_t stride;  // product of the widths of the children after this one
};

template <int NC, int K>
struct FusedHop {
  const float* weights;  // (n, k)
  uint32_t k;
  int nchild;
  Child children[kMaxChildren];

  struct Column {
    uint32_t c;                      // channel
    uint32_t u;                      // index over the children's widths
    uint32_t off[NC > 0 ? NC : 1];   // per child: col_i(u) * k + c
  };

  __device__ static float identity() {
    if constexpr (K == kSum) {
      return 0.0f;
    } else if constexpr (K == kMin) {
      return repro_torch::positive_inf();
    } else {
      return repro_torch::negative_inf();
    }
  }

  __device__ __forceinline__ Column column(uint32_t f) const {
    Column col;
    col.c = f % k;
    col.u = f / k;
    if constexpr (NC > 0) {
      uint32_t u = col.u;
#pragma unroll
      for (int i = NC - 1; i >= 0; --i) {
        const uint32_t w = children[i].width;
        const uint32_t q = u / w;
        col.off[i] = (u - q * w) * k + col.c;
        u = q;
      }
    }
    return col;
  }

  __device__ __forceinline__ float combine(float v, float m) const {
    if constexpr (K == kSum) {
      return __fmul_rn(v, m);
    } else {
      return __fadd_rn(v, m);
    }
  }

  __device__ __forceinline__ float operator()(float acc, int64_t e,
                                              const Column& col) const {
    float v = weights[e * k + col.c];
    if constexpr (NC == kDynamic) {
      for (int i = 0; i < nchild; ++i) {
        const Child& ch = children[i];
        const int64_t r = ch.idx[e];
        if (r < 0 || r >= ch.rows) {
          return acc;
        }
        const uint32_t ci = (col.u / ch.stride) % ch.width;
        v = combine(v, ch.msg[r * ch.width * k + ci * k + col.c]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        const Child& ch = children[i];
        const int64_t r = ch.idx[e];
        if (r < 0 || r >= ch.rows) {
          return acc;
        }
        v = combine(v, ch.msg[r * ch.width * k + col.off[i]]);
      }
    }
    if constexpr (K == kSum) {
      return __fadd_rn(acc, v);
    } else if constexpr (K == kMin) {
      return fminf(acc, v);
    } else {
      return fmaxf(acc, v);
    }
  }
};

// A one-child hop on the slab-major warp walk.  Output column f takes
// channel f % k of the edge's weight row and column f of the child's row
// (col_0(u) * k + c = f), so no column is decoded.  With KC = 1 or 2
// channels the lane that loads an edge loads its k weights too and the
// warp passes them on with the child row (k = 2: one 8-byte load, where
// the weights are 8-byte aligned); a lane's first column is a multiple of
// 4, so with k = 2 its columns take channels 0, 1, 0, 1.  Other k, and
// unaligned k = 2 weights (KC = 0), load each column's weight.
template <int K, int KC>
struct OneChild {
  using Edge = repro_torch::GatherEdge<KC == 2 ? 2 : 1>;
  struct Lane {
    uint32_t ch[4];  // KC = 0: channel of each of the lane's columns
  };

  const float* src;  // the child's message, (rows, d)
  int64_t rows;
  const int64_t* idx;
  const float* weights;  // (n, k)
  uint32_t k;

  __device__ static float identity() { return FusedHop<1, K>::identity(); }

  __device__ __forceinline__ Edge edge(int64_t e) const {
    Edge edge{-1, {}};
    if (e >= 0) {
      edge.row = idx[e];
      if constexpr (KC == 1) {
        edge.w[0] = weights[e];
      } else if constexpr (KC == 2) {
        const float2 w = *reinterpret_cast<const float2*>(weights + 2 * e);
        edge.w[0] = w.x;
        edge.w[1] = w.y;
      }
    }
    return edge;
  }

  __device__ __forceinline__ Lane lane(int64_t c) const {
    Lane at{};
    if constexpr (KC == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        at.ch[i] = static_cast<uint32_t>((c + i) % k);
      }
    }
    return at;
  }

  __device__ __forceinline__ void scales(const Lane& at, int64_t e, const Edge& edge,
                                         float (&s)[4]) const {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if constexpr (KC == 1) {
        s[i] = edge.w[0];
      } else if constexpr (KC == 2) {
        s[i] = edge.w[i % 2];
      } else {
        s[i] = __ldg(weights + e * k + at.ch[i]);
      }
    }
  }

  __device__ static float fold(float acc, float s, float x) {
    if constexpr (K == kSum) {
      return __fadd_rn(acc, __fmul_rn(s, x));
    } else if constexpr (K == kMin) {
      return fminf(acc, __fadd_rn(s, x));
    } else {
      return fmaxf(acc, __fadd_rn(s, x));
    }
  }
};

template <int K, int KC>
cudaError_t launch_one_child(int device, const int64_t* keys, int64_t n, const float* weights,
                             uint32_t k, const ReproFusedChild& child, int64_t num_segments,
                             float* out, const ReproGatherPlan* plan, void* stream) {
  return repro_torch::launch_gathered_rows(
      device, keys, n, num_segments, child.width * k,
      OneChild<K, KC>{child.msg, child.rows, child.idx, weights, k}, out, plan, stream);
}

template <int NC, int K>
cudaError_t launch(int device, const int64_t* keys, int64_t n, const float* weights,
                   uint32_t k, const Child* children, int nchild, int64_t num_segments,
                   int64_t width, float* out, const ReproWalkPlan* plan, void* stream) {
  FusedHop<NC, K> op{};
  op.weights = weights;
  op.k = k;
  op.nchild = nchild;
  for (int i = 0; i < nchild; ++i) {
    op.children[i] = children[i];
  }
  return repro_torch::launch_segmented_rows(device, keys, n, num_segments,
                                            width * k, op, out, plan, stream);
}

template <int K>
cudaError_t launch_kind(int device, const int64_t* keys, int64_t n,
                        const float* weights, uint32_t k, const Child* children,
                        int nchild, int64_t num_segments, int64_t width, float* out,
                        const ReproWalkPlan* plan, void* stream) {
  switch (nchild) {
    case 0:
      return launch<0, K>(device, keys, n, weights, k, children, nchild, num_segments,
                          width, out, plan, stream);
    case 1:
      return launch<1, K>(device, keys, n, weights, k, children, nchild, num_segments,
                          width, out, plan, stream);
    case 2:
      return launch<2, K>(device, keys, n, weights, k, children, nchild, num_segments,
                          width, out, plan, stream);
    case 3:
      return launch<3, K>(device, keys, n, weights, k, children, nchild, num_segments,
                          width, out, plan, stream);
    default:
      return launch<kDynamic, K>(device, keys, n, weights, k, children, nchild,
                                 num_segments, width, out, plan, stream);
  }
}

}  // namespace

// kind: 0 = sum, 1 = min, 2 = max.  Returns cudaErrorInvalidValue for an
// unknown kind, k < 1, more than 64 children, a child width < 1 or an
// output row of 2^31 floats or more.
extern "C" int repro_fused_hop(int device, const int64_t* keys, int64_t n,
                               const float* weights, int64_t k,
                               const ReproFusedChild* children, int nchild,
                               int64_t num_segments, int kind, float* out,
                               const ReproWalkPlan* plan, void* stream) {
  if (nchild < 0 || nchild > kMaxChildren || k < 1 || k >= (int64_t{1} << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Child packed[kMaxChildren];
  int64_t width = 1;
  for (int i = nchild - 1; i >= 0; --i) {
    if (children[i].width < 1) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    packed[i] = Child{children[i].msg, children[i].idx, children[i].rows,
                      static_cast<uint32_t>(children[i].width),
                      static_cast<uint32_t>(width)};
    width *= children[i].width;
    if (width * k >= (int64_t{1} << 31)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  const uint32_t k32 = static_cast<uint32_t>(k);
  switch (kind) {
    case kSum:
      return static_cast<int>(launch_kind<kSum>(device, keys, n, weights, k32, packed,
                                                nchild, num_segments, width, out, plan, stream));
    case kMin:
      return static_cast<int>(launch_kind<kMin>(device, keys, n, weights, k32, packed,
                                                nchild, num_segments, width, out, plan, stream));
    case kMax:
      return static_cast<int>(launch_kind<kMax>(device, keys, n, weights, k32, packed,
                                                nchild, num_segments, width, out, plan, stream));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// One hop with exactly one child on the slab-major warp walk: the same
// function as repro_fused_hop with nchild = 1, into rows of d = child
// width * k floats.  Returns cudaErrorInvalidValue for an unknown kind,
// k < 1 (or k != 1 for min/max), a child width < 1 or a plan the walk
// cannot take (ReproGatherPlan, kernels/ops.py:gather_plan).
extern "C" int repro_fused_hop_one_child(int device, const int64_t* keys, int64_t n,
                                         const float* weights, int64_t k,
                                         const ReproFusedChild* child, int64_t num_segments,
                                         int kind, float* out, const ReproGatherPlan* plan,
                                         void* stream) {
  if (k < 1 || k >= (int64_t{1} << 31) || child == nullptr || child->width < 1 ||
      child->width * k >= (int64_t{1} << 31) || (kind != kSum && k != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const uint32_t k32 = static_cast<uint32_t>(k);
  switch (kind) {
    case kSum:
      if (k == 1) {
        return static_cast<int>(launch_one_child<kSum, 1>(device, keys, n, weights, k32, *child,
                                                          num_segments, out, plan, stream));
      }
      if (k == 2 && repro_torch::aligned(weights, 8)) {
        return static_cast<int>(launch_one_child<kSum, 2>(device, keys, n, weights, k32, *child,
                                                          num_segments, out, plan, stream));
      }
      return static_cast<int>(launch_one_child<kSum, 0>(device, keys, n, weights, k32, *child,
                                                        num_segments, out, plan, stream));
    case kMin:
      return static_cast<int>(launch_one_child<kMin, 1>(device, keys, n, weights, k32, *child,
                                                        num_segments, out, plan, stream));
    case kMax:
      return static_cast<int>(launch_one_child<kMax, 1>(device, keys, n, weights, k32, *child,
                                                        num_segments, out, plan, stream));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
