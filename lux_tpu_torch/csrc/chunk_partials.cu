// Kernel B1 on Hopper: the per-chunk partial reduction.
//
// Replaces lux_tpu/ops/pallas_reduce.py::chunk_partials_pallas (body
// _partial_kernel), which the TPU runs as a masked [block_c, E, W]
// broadcast-reduce held in VMEM.  Same function, redesigned for the
// card:
//
//   out[c, w] = sum | min | max of vals[c, e] over every e with
//               rel[c, e] == w, and the reduce identity where no lane
//               matches (0; +inf / INT32_MAX for min; -inf / INT32_MIN
//               for max).  rel is int8: lanes 0..W-1, -1 = pad (any
//               value outside [0, W) matches nothing).
//
// Inputs: vals [C, E] float32 or int32, rel [C, E] int8, both
// row-major and contiguous; out [C, W] in the dtype of vals.  Any
// C >= 0, any E >= 1, 1 <= W <= 128.
//
// Bound: bytes.  One pass reads C*E*4 B of values and C*E*1 B of lane
// ids and writes C*W*4 B: C*E*5 + C*W*4 bytes over the card's
// 3.35 TB/s.  The compute is E*W compare-selects per chunk, the same
// work as the TPU's broadcast-compare.
//
// Design (simple, right, deterministic; not yet fast):
// - one block of 128 threads per chunk (grid-stride over chunks);
//   thread w owns output lane w and keeps its running value in a
//   register that starts at the identity;
// - the block stages the chunk's vals and rel into shared memory with
//   coalesced loads, kTileE entries at a time (E = 512: 2.5 KB);
// - every thread scans the staged run in ascending e and folds in the
//   entries whose rel == w, then stores once.  All threads read the
//   same shared address in a step, so shared memory broadcasts it and
//   there are no bank conflicts;
// - rel need not be sorted within a row (pair and paged rows are in
//   source order), and the float sum order is fixed: the result is
//   bit-identical from run to run;
// - min/max propagate NaN like jnp.min/jnp.max (fminf/fmaxf would drop
//   it; the reference's health watchdog relies on a NaN reaching the
//   state).
// The scan costs E*W compare-selects per chunk against E*5 bytes moved,
// so it sits well above the byte bound.  Next steps for a later change:
// shared-memory atomics (one pass over E per block instead of W), or a
// sorted-run segmented reduce on the tiled path, where rel is sorted.

#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;   // one thread per output lane, W <= 128
constexpr int kTileE = 1024;    // staged entries per piece
constexpr int64_t kMaxBlocks = 1 << 20;

enum Kind { kSum = 0, kMin = 1, kMax = 2 };

template <typename T> struct Limits;
template <> struct Limits<float> {
  __device__ static float lowest() { return -INFINITY; }
  __device__ static float highest() { return INFINITY; }
  __device__ static bool is_nan(float x) { return x != x; }
  __device__ static float add(float a, float b) { return a + b; }
};
template <> struct Limits<int32_t> {
  __device__ static int32_t lowest() { return INT32_MIN; }
  __device__ static int32_t highest() { return INT32_MAX; }
  __device__ static bool is_nan(int32_t) { return false; }
  // two's-complement wraparound, as the reference's int32 sums
  __device__ static int32_t add(int32_t a, int32_t b) {
    return (int32_t)((uint32_t)a + (uint32_t)b);
  }
};

template <typename T, int K> struct Op;
template <typename T> struct Op<T, kSum> {
  __device__ static T identity() { return T(0); }
  __device__ static T apply(T acc, T v) { return Limits<T>::add(acc, v); }
};
template <typename T> struct Op<T, kMin> {
  __device__ static T identity() { return Limits<T>::highest(); }
  // a NaN acc stays NaN (v < NaN is false); a NaN v replaces acc
  __device__ static T apply(T acc, T v) {
    return (v < acc || Limits<T>::is_nan(v)) ? v : acc;
  }
};
template <typename T> struct Op<T, kMax> {
  __device__ static T identity() { return Limits<T>::lowest(); }
  __device__ static T apply(T acc, T v) {
    return (v > acc || Limits<T>::is_nan(v)) ? v : acc;
  }
};

template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
chunk_partials_kernel(const T* __restrict__ vals,
                      const int8_t* __restrict__ rel, T* __restrict__ out,
                      int64_t C, int64_t E, int W) {
  __shared__ T s_vals[kTileE];
  __shared__ int8_t s_rel[kTileE];
  const int w = threadIdx.x;
  for (int64_t c = blockIdx.x; c < C; c += gridDim.x) {
    const T* vrow = vals + c * E;
    const int8_t* rrow = rel + c * E;
    T acc = Op<T, K>::identity();
    for (int64_t e0 = 0; e0 < E; e0 += kTileE) {
      const int n = (int)(E - e0 < kTileE ? E - e0 : kTileE);
      __syncthreads();  // every thread is done with the previous piece
      for (int i = threadIdx.x; i < n; i += kThreads) {
        s_vals[i] = vrow[e0 + i];
        s_rel[i] = rrow[e0 + i];
      }
      __syncthreads();
#pragma unroll 8
      for (int i = 0; i < n; ++i) {
        if (s_rel[i] == w) acc = Op<T, K>::apply(acc, s_vals[i]);
      }
    }
    if (w < W) out[c * W + w] = acc;
  }
}

template <typename T, int K>
void launch(const void* vals, const void* rel, void* out, int64_t C,
            int64_t E, int W, cudaStream_t stream) {
  const unsigned blocks = (unsigned)(C < kMaxBlocks ? C : kMaxBlocks);
  chunk_partials_kernel<T, K><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(vals), static_cast<const int8_t*>(rel),
      static_cast<T*>(out), C, E, W);
}

}  // namespace

// dtype: 0 = float32, 1 = int32.  kind: 0 = sum, 1 = min, 2 = max.
// Launches on `stream` and returns the cudaError_t of the launch
// (0 = success); it does not synchronise.
extern "C" int lux_chunk_partials(const void* vals, const void* rel,
                                  void* out, int64_t C, int64_t E,
                                  int64_t W, int32_t dtype, int32_t kind,
                                  void* stream) {
  if (C < 0 || E < 1 || W < 1 || W > kThreads || kind < 0 || kind > 2)
    return (int)cudaErrorInvalidValue;
  if (C == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int w = (int)W;
  if (dtype == 0) {
    if (kind == kSum) launch<float, kSum>(vals, rel, out, C, E, w, s);
    if (kind == kMin) launch<float, kMin>(vals, rel, out, C, E, w, s);
    if (kind == kMax) launch<float, kMax>(vals, rel, out, C, E, w, s);
  } else if (dtype == 1) {
    if (kind == kSum) launch<int32_t, kSum>(vals, rel, out, C, E, w, s);
    if (kind == kMin) launch<int32_t, kMin>(vals, rel, out, C, E, w, s);
    if (kind == kMax) launch<int32_t, kMax>(vals, rel, out, C, E, w, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
