// Kernel B1 over a trailing query axis, on Hopper.
//
// Query-batched programs (state [P, vpad, B]) give the per-chunk
// reduce a [C, E, B] payload.  The reference's Pallas kernel
// (lux_tpu/ops/pallas_reduce.py::chunk_partials_pallas) is scalar
// only; for a vector payload the reference computes this function
// with XLA's broadcast-compare (lux_tpu/ops/tiled.py:326
// ``chunk_partials``, :357).  On the card every dense reduce goes
// through B1, so this is B1's batched form:
//
//   out[c, w, b] = sum | min | max of vals[c, e, b] over every e with
//                  rel[c, e] == w, and the reduce identity where no
//                  lane matches (0; +inf / INT32_MAX for min; -inf /
//                  INT32_MIN for max).  rel is int8: lanes 0..W-1,
//                  -1 = pad (any value outside [0, W) matches nothing).
//
// Inputs: vals [C, E, B] float32 or int32, rel [C, E] int8, both
// row-major and contiguous; out [C, W, B] in the dtype of vals.  Any
// C >= 0, E >= 1, B >= 1, 1 <= W <= 128.
//
// Bound: bytes.  The function reads every lane id once (C*E B), every
// live entry's B values (C*E*B*4 B where the chunks are full) and
// writes C*W*B*4 B, at the card's 3.35 TB/s.  The arithmetic (one
// combine per live value) is far below that line.
//
// Design (a simple kernel that is right; its speed is later work):
// - one thread per (chunk, group of VEC query columns): VEC = 4 where
//   B % 4 == 0 and the bases are 16 B aligned (one 16 B load a
//   thread and edge; at B = 8 the two threads of a chunk read the
//   edge's 8 values as one 32 B sector), else VEC = 1.  The threads of
//   one chunk are neighbours in a warp and read the same lane ids in
//   the same instruction, which the card serves once: lane ids come
//   from memory once per edge, not once per query;
// - a thread walks its chunk's edges in ascending e, four at a time
//   (one 4 B load of four lane ids where E % 4 == 0 and the base is
//   aligned, else four 1 B loads), with the next four edges' loads in
//   flight while it folds the current four;
// - it folds a run of equal lanes in registers, starting from the
//   identity, and writes the run when the lane changes.  While the
//   lanes ascend (every tiled chunk: dst-sorted, pads at the tail) each
//   output lane is written exactly once, the lanes skipped between
//   runs get the identity, and nothing is read back.  At the first
//   lane that does not ascend the thread writes the identity to every
//   lane not written yet and from then on folds each run into its
//   lane with a read-modify-write.  A thread owns its columns of its
//   chunk's output, so no two threads ever write one word: no atomics,
//   and every (w, b) folds its values in ascending e, so three launches
//   give the same bits.
// min/max propagate NaN like jnp.min/jnp.max (the scalar kernel's
// rule); int32 sums wrap around.

#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxW = 128;
constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 1 << 20;

enum Kind { kSum = 0, kMin = 1, kMax = 2 };

template <typename T> struct Limits;
template <> struct Limits<float> {
  __device__ static float lowest() { return -INFINITY; }
  __device__ static float highest() { return INFINITY; }
  __device__ static bool is_nan(float x) { return x != x; }
  __device__ static float add(float a, float b) { return a + b; }
  __device__ static float from_bits(uint32_t x) { return __uint_as_float(x); }
  __device__ static uint32_t bits(float x) { return __float_as_uint(x); }
};
template <> struct Limits<int32_t> {
  __device__ static int32_t lowest() { return INT32_MIN; }
  __device__ static int32_t highest() { return INT32_MAX; }
  __device__ static bool is_nan(int32_t) { return false; }
  // two's-complement wraparound, as the reference's int32 sums
  __device__ static int32_t add(int32_t a, int32_t b) {
    return (int32_t)((uint32_t)a + (uint32_t)b);
  }
  __device__ static int32_t from_bits(uint32_t x) { return (int32_t)x; }
  __device__ static uint32_t bits(int32_t x) { return (uint32_t)x; }
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

// VEC query columns of one edge (or of one output lane).
template <typename T, int VEC> struct Vec {
  T x[VEC];
};

template <typename T, int VEC>
__device__ __forceinline__ Vec<T, VEC> load_vec(const T* p) {
  Vec<T, VEC> v;
  if (VEC == 4) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int j = 0; j < VEC; ++j) v.x[j] = Limits<T>::from_bits(w[j]);
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) v.x[j] = __ldg(p + j);
  }
  return v;
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* p, const Vec<T, VEC>& v) {
  if (VEC == 4) {
    uint4 raw;
    raw.x = Limits<T>::bits(v.x[0]);
    raw.y = Limits<T>::bits(v.x[1]);
    raw.z = Limits<T>::bits(v.x[2]);
    raw.w = Limits<T>::bits(v.x[3]);
    *reinterpret_cast<uint4*>(p) = raw;
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) p[j] = v.x[j];
  }
}

template <typename T, int K, int VEC>
__device__ __forceinline__ Vec<T, VEC> ident_vec() {
  Vec<T, VEC> v;
#pragma unroll
  for (int j = 0; j < VEC; ++j) v.x[j] = Op<T, K>::identity();
  return v;
}

template <typename T, int K, int VEC>
__device__ __forceinline__ void fold_into(Vec<T, VEC>& acc,
                                          const Vec<T, VEC>& v) {
#pragma unroll
  for (int j = 0; j < VEC; ++j) acc.x[j] = Op<T, K>::apply(acc.x[j], v.x[j]);
}

// Four edges e..e+3 of a chunk: lane ids (-1: pad, past E, or outside
// [0, W)) and the values of the edges inside the chunk.
template <typename T, int VEC> struct Group {
  int k[4];
  Vec<T, VEC> v[4];
};

template <typename T, int VEC, bool kAligned>
__device__ __forceinline__ void load_group(const int8_t* __restrict__ rrow,
                                           const T* __restrict__ vrow,
                                           int64_t e, int64_t E, int64_t B,
                                           int W, Group<T, VEC>& g) {
  if (kAligned) {
    const uint32_t r =
        e < E ? __ldg(reinterpret_cast<const unsigned int*>(rrow + e))
              : 0xffffffffu;
#pragma unroll
    for (int j = 0; j < 4; ++j) g.k[j] = (int)(int8_t)(r >> (8 * j));
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      g.k[j] = e + j < E ? (int)__ldg(rrow + e + j) : -1;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (g.k[j] >= W) g.k[j] = -1;
    if (e + j < E) g.v[j] = load_vec<T, VEC>(vrow + (e + j) * B);
  }
}

// The output of one thread: lanes [0, hi) are written while the lanes
// ascend; `ascending` turns false at the first lane that does not.
template <typename T, int K, int VEC> struct Out {
  T* row;        // out + c*W*B + b0
  int64_t B;
  int W;
  int hi;
  bool ascending;

  __device__ __forceinline__ void fill(int lo, int end) {
    const Vec<T, VEC> id = ident_vec<T, K, VEC>();
    for (int w = lo; w < end; ++w) store_vec<T, VEC>(row + w * B, id);
  }

  __device__ __forceinline__ void flush(int lane, const Vec<T, VEC>& run) {
    if (lane < 0) return;
    if (ascending && lane >= hi) {
      fill(hi, lane);
      store_vec<T, VEC>(row + lane * B, run);
      hi = lane + 1;
      return;
    }
    if (ascending) {           // the first lane that does not ascend
      fill(hi, W);
      hi = W;
      ascending = false;
    }
    Vec<T, VEC> acc;           // this thread's own earlier store
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc.x[j] = row[lane * B + j];
    fold_into<T, K, VEC>(acc, run);
    store_vec<T, VEC>(row + lane * B, acc);
  }
};

template <typename T, int K, int VEC, bool kAligned>
__global__ void __launch_bounds__(kThreads)
chunk_partials_batched_kernel(const T* __restrict__ vals,
                              const int8_t* __restrict__ rel,
                              T* __restrict__ out, int64_t C, int64_t E,
                              int64_t B, int W) {
  const int64_t G = B / VEC;                 // column groups a chunk
  const int64_t items = C * G;
  for (int64_t it = (int64_t)blockIdx.x * kThreads + threadIdx.x;
       it < items; it += (int64_t)gridDim.x * kThreads) {
    const int64_t c = it / G;
    const int64_t b0 = (it - c * G) * VEC;
    const int8_t* rrow = rel + c * E;
    const T* vrow = vals + c * E * B + b0;
    Out<T, K, VEC> o{out + c * (int64_t)W * B + b0, B, W, 0, true};
    int cur = -1;
    Vec<T, VEC> run = ident_vec<T, K, VEC>();
    Group<T, VEC> next;
    load_group<T, VEC, kAligned>(rrow, vrow, 0, E, B, W, next);
    for (int64_t e0 = 0; e0 < E; e0 += 4) {
      const Group<T, VEC> g = next;
      if (e0 + 4 < E)           // the next four edges' loads in flight
        load_group<T, VEC, kAligned>(rrow, vrow, e0 + 4, E, B, W, next);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = g.k[j];
        if (k < 0) continue;
        if (k != cur) {
          o.flush(cur, run);
          cur = k;
          run = ident_vec<T, K, VEC>();
        }
        fold_into<T, K, VEC>(run, g.v[j]);
      }
    }
    o.flush(cur, run);
    if (o.ascending) o.fill(o.hi, W);
  }
}

template <typename T, int K>
void launch(const void* vals, const void* rel, void* out, int64_t C,
            int64_t E, int64_t B, int W, cudaStream_t stream) {
  const bool vec4 = B % 4 == 0 && (uintptr_t)vals % 16 == 0 &&
                    (uintptr_t)out % 16 == 0;
  const bool aligned = E % 4 == 0 && (uintptr_t)rel % 4 == 0;
  const int64_t items = C * (vec4 ? B / 4 : B);
  const int64_t want = (items + kThreads - 1) / kThreads;
  const unsigned blocks = (unsigned)(want < kMaxBlocks ? want : kMaxBlocks);
  const T* v = static_cast<const T*>(vals);
  const int8_t* r = static_cast<const int8_t*>(rel);
  T* o = static_cast<T*>(out);
  if (vec4 && aligned)
    chunk_partials_batched_kernel<T, K, 4, true>
        <<<blocks, kThreads, 0, stream>>>(v, r, o, C, E, B, W);
  else if (vec4)
    chunk_partials_batched_kernel<T, K, 4, false>
        <<<blocks, kThreads, 0, stream>>>(v, r, o, C, E, B, W);
  else if (aligned)
    chunk_partials_batched_kernel<T, K, 1, true>
        <<<blocks, kThreads, 0, stream>>>(v, r, o, C, E, B, W);
  else
    chunk_partials_batched_kernel<T, K, 1, false>
        <<<blocks, kThreads, 0, stream>>>(v, r, o, C, E, B, W);
}

}  // namespace

// dtype: 0 = float32, 1 = int32.  kind: 0 = sum, 1 = min, 2 = max.
// Launches on `stream` and returns the cudaError_t of the launch
// (0 = success); it does not synchronise.
extern "C" int lux_chunk_partials_batched(const void* vals, const void* rel,
                                          void* out, int64_t C, int64_t E,
                                          int64_t B, int64_t W,
                                          int32_t dtype, int32_t kind,
                                          void* stream) {
  if (C < 0 || E < 1 || B < 1 || W < 1 || W > kMaxW || kind < 0 ||
      kind > 2)
    return (int)cudaErrorInvalidValue;
  if (C == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int w = (int)W;
  if (dtype == 0) {
    if (kind == kSum) launch<float, kSum>(vals, rel, out, C, E, B, w, s);
    if (kind == kMin) launch<float, kMin>(vals, rel, out, C, E, B, w, s);
    if (kind == kMax) launch<float, kMax>(vals, rel, out, C, E, B, w, s);
  } else if (dtype == 1) {
    if (kind == kSum) launch<int32_t, kSum>(vals, rel, out, C, E, B, w, s);
    if (kind == kMin) launch<int32_t, kMin>(vals, rel, out, C, E, B, w, s);
    if (kind == kMax) launch<int32_t, kMax>(vals, rel, out, C, E, B, w, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
