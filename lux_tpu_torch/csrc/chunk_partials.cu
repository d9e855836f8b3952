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
// Bound: bytes.  The function needs every lane id once (C*E B), the
// value of every entry that matches a lane (the card reads them in
// 32 B sectors: at least 4 B each) and writes C*W*4 B, over the card's
// 3.35 TB/s.  A pad's value is never needed, yet this kernel reads
// every value (C*E*5 + C*W*4 B): on the paged path, where 95% of the
// entries are pads, that is 7.2 GB where the function needs about 4.3.
// Skipping the pads makes each value load wait on its lane ids, and
// measured slower.  The arithmetic (one combine per live entry) is far
// below the byte line; the design keeps the work O(E) per chunk so
// that the loads, not the instructions, set the time (the TPU's
// broadcast-compare costs E*W compare-selects per chunk).
//
// Design:
// - one warp per chunk (per two or four chunks where E <= 384), 8
//   warps per block, grid-stride over chunks; a warp never waits on
//   another (no block-wide barrier, only __syncwarp).  The warp keeps
//   a W-lane accumulator per chunk in shared memory (512 B), starting
//   at the identity;
// - the warp walks a row in steps of 128 entries: thread t holds
//   entries 4t..4t+3 of the step.  Loads go out a group of four steps
//   at a time: four steps of one row (E = 512), or one step of each of
//   four rows (E = 128; two steps of two rows for E <= 384), so a warp
//   has four steps' loads in flight at either shape: a thread and
//   step, one 32-bit load of four rel bytes and one 16 B load of their
//   four values, both coalesced across the warp.  Rows with E % 4 != 0
//   or unaligned bases take scalar loads in the same kernel;
// - a thread folds its own four entries in ascending e into runs of
//   equal lanes, dropping pads first; a __ballot_sync skips a step
//   with no live entry (most of a paged row is pads);
// - sorted steps (every tiled chunk: dst-sorted edges, pads at the
//   tail; the check is a ballot, not an assumption): a segmented
//   inclusive scan of the threads' tail runs, five __shfl_up_sync
//   steps with segment heads found by a ballot; the thread that ends a
//   run of equal lanes, and the thread whose first run continues one,
//   write it to the accumulator.  Each lane is written once a step;
// - unsorted steps (pair rows are in source order): for each of a
//   thread's up to four runs in e order, __match_any_sync groups
//   the threads holding the same lane and the group's lowest thread
//   folds the members' values, staged in shared memory, in ascending
//   thread order;
// - steps fold into a row's accumulator in ascending order, then the
//   warp writes the row with 16 B stores (scalar stores where W % 4
//   != 0 or the row is not 16 B aligned).
// No atomics anywhere: the combine order depends only on the inputs,
// so float sums are bit-identical from run to run (not the bits of a
// left-to-right sum: the scan adds in a tree).  min/max propagate NaN
// like jnp.min/jnp.max (fminf/fmaxf would drop it; the reference's
// health watchdog relies on a NaN reaching the state); int32 sums
// wrap around.

#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxW = 128;              // rel is int8: lanes 0..127
constexpr int kWarps = 8;               // chunks per block step
constexpr int kThreads = kWarps * 32;
constexpr int kStep = 128;              // entries per warp step (32 x 4)
constexpr int kGroup = 4;               // steps whose loads go together
constexpr unsigned kFull = 0xffffffffu;
constexpr int64_t kMaxBlocks = 1 << 20;

enum Kind { kSum = 0, kMin = 1, kMax = 2 };

template <typename T> struct Limits;
template <> struct Limits<float> {
  __device__ static float lowest() { return -INFINITY; }
  __device__ static float highest() { return INFINITY; }
  __device__ static bool is_nan(float x) { return x != x; }
  __device__ static float add(float a, float b) { return a + b; }
  __device__ static float from_bits(uint32_t x) { return __uint_as_float(x); }
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

// A thread's four entries of one step: values and lanes (-1 = dead).
template <typename T> struct Quad {
  T v[4];
  int k[4];
};

// Lanes of entries e..e+3 of a row (-1: a pad, an entry past E, or a
// lane outside [0, W), which matches nothing).  Aligned rows (E % 4
// == 0) hold all four entries or none; other rows what lies inside.
template <typename T, bool kAligned>
__device__ __forceinline__ void load_lanes(const int8_t* __restrict__ rrow,
                                           int64_t e, int64_t E, int W,
                                           Quad<T>& q) {
  if (kAligned) {
    const uint32_t r =
        e < E ? __ldg(reinterpret_cast<const unsigned int*>(rrow + e))
              : 0xffffffffu;
#pragma unroll
    for (int j = 0; j < 4; ++j) q.k[j] = (int)(int8_t)(r >> (8 * j));
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      q.k[j] = e + j < E ? (int)__ldg(rrow + e + j) : -1;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (q.k[j] >= W) q.k[j] = -1;
}

// Values of entries e..e+3 that lie inside the row, pads included:
// reading them with the lane ids is faster than waiting on the lane
// ids to skip the pads (lux_tpu_torch/tools/b1_ab.py, skip_pads).
template <typename T, bool kAligned>
__device__ __forceinline__ void load_vals(const T* __restrict__ vrow,
                                          int64_t e, int64_t E, Quad<T>& q) {
  if (kAligned) {
    if (e < E) {
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(vrow + e));
      q.v[0] = Limits<T>::from_bits(raw.x);
      q.v[1] = Limits<T>::from_bits(raw.y);
      q.v[2] = Limits<T>::from_bits(raw.z);
      q.v[3] = Limits<T>::from_bits(raw.w);
    }
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (e + j < E) q.v[j] = __ldg(vrow + e + j);
  }
}

// The runs of equal lanes in a thread's four entries, in e order: up
// to three completed runs (sk/sv, -1 = none) and the tail run (tk/tv).
template <typename T> struct Runs {
  int sk[3];
  T sv[3];
  int tk, fk;                  // tail lane, first live lane (-1: none)
  T tv;
  bool asc;                    // the run lanes strictly ascend
};

template <typename T, int K>
__device__ __forceinline__ void fold(const Quad<T>& q, Runs<T>& r) {
  r.tk = -1;
  r.fk = -1;
  r.tv = Op<T, K>::identity();
  r.asc = true;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    int ck = -1;
    T cv = Op<T, K>::identity();
    if (q.k[j] >= 0) {
      if (q.k[j] == r.tk) {
        r.tv = Op<T, K>::apply(r.tv, q.v[j]);
      } else {
        if (r.tk >= 0) {
          r.asc = r.asc && q.k[j] > r.tk;
          ck = r.tk;
          cv = r.tv;
        } else {
          r.fk = q.k[j];
        }
        r.tk = q.k[j];
        r.tv = q.v[j];
      }
    }
    if (j > 0) {               // a run can only complete at entry 1..3
      r.sk[j - 1] = ck;
      r.sv[j - 1] = cv;
    }
  }
}

// One step of 128 entries folded into the warp's accumulator.
template <typename T, int K>
__device__ __forceinline__ void step(const Quad<T>& q, T* acc, T* stage,
                                     int lane) {
  Runs<T> r;
  fold<T, K>(q, r);
  const bool has = r.tk >= 0;
  const unsigned live = __ballot_sync(kFull, has);
  if (live == 0) return;                        // an all-pad step
  // each thread's key: its tail lane, or the tail lane of the nearest
  // live thread below it (-1: none), so that dead threads pass a run on
  const unsigned below = live & ((1u << lane) - 1);
  const int src = has ? lane : (below ? 31 - __clz(below) : lane);
  const int key = __shfl_sync(kFull, r.tk, src);
  const int head = has ? r.fk : key;
  int kprev = __shfl_up_sync(kFull, key, 1);
  if (lane == 0) kprev = -1;
  if (__all_sync(kFull, r.asc && head >= kprev)) {
    // sorted: segmented inclusive scan of the tail runs keyed on lane
    const unsigned starts = __ballot_sync(kFull, key != kprev);
    const unsigned upto = starts & ((2u << lane) - 1);
    const int seghead = upto ? 31 - __clz(upto) : 0;
    T s = has ? r.tv : Op<T, K>::identity();
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const T y = __shfl_up_sync(kFull, s, d);
      if (lane - d >= seghead) s = Op<T, K>::apply(y, s);
    }
    const T sprev = __shfl_up_sync(kFull, s, 1);
    const int hnext = __shfl_down_sync(kFull, head, 1);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const int k = r.sk[i];
      if (k >= 0) {
        // only the first completed run can continue the run below
        const T x = k == kprev ? Op<T, K>::apply(sprev, r.sv[i]) : r.sv[i];
        acc[k] = Op<T, K>::apply(acc[k], x);
      }
    }
    if (key >= 0 && (lane == 31 || hnext != key))
      acc[key] = Op<T, K>::apply(acc[key], s);
  } else {
    // unsorted: per run slot, group equal lanes; the lowest thread of
    // a group folds the members in ascending thread order
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = i < 3 ? r.sk[i] : r.tk;
      const unsigned m = __ballot_sync(kFull, k >= 0);
      if (m == 0) continue;
      if (k >= 0) {
        const unsigned grp = __match_any_sync(m, k);
        stage[lane] = i < 3 ? r.sv[i] : r.tv;
        __syncwarp(m);
        if (lane == __ffs(grp) - 1) {
          T a = acc[k];
          for (unsigned g = grp; g; g &= g - 1)
            a = Op<T, K>::apply(a, stage[__ffs(g) - 1]);
          acc[k] = a;
        }
      }
      __syncwarp();
    }
  }
}

// Rows a warp takes at once: one row of E > 384 (its steps four at a
// time), four rows of E <= 128 (one step each), else two rows (two
// steps each at a time).
__host__ __device__ inline int rows_per_group(int64_t E) {
  const int64_t spr = (E + kStep - 1) / kStep;
  return spr >= kGroup ? 1 : spr == 1 ? 4 : 2;
}

template <typename T, int K, bool kAligned>
__global__ void __launch_bounds__(kThreads)
chunk_partials_kernel(const T* __restrict__ vals,
                      const int8_t* __restrict__ rel, T* __restrict__ out,
                      int64_t C, int64_t E, int W) {
  __shared__ __align__(16) T s_acc[kWarps][kGroup][kMaxW];
  __shared__ T s_stage[kWarps][32];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  T* stage = s_stage[warp];
  // A group is kGroup steps whose loads go out together (see
  // rows_per_group).  Slot s of a group is step (s & (spg - 1)) of row
  // (s >> shift) of the warp's rows.
  const int rows = rows_per_group(E);
  const int spg = kGroup / rows;                         // steps a row
  const int shift = __ffs(spg) - 1;                      // log2(spg)
  for (int64_t c0 = ((int64_t)blockIdx.x * kWarps + warp) * rows; c0 < C;
       c0 += (int64_t)gridDim.x * kWarps * rows) {
    for (int r = 0; r < rows; ++r)
      for (int w = lane; w < W; w += 32)
        s_acc[warp][r][w] = Op<T, K>::identity();
    __syncwarp();
    for (int64_t e0 = 0; e0 < E; e0 += (int64_t)spg * kStep) {
      Quad<T> q[kGroup];
#pragma unroll
      for (int s = 0; s < kGroup; ++s) {
        const int64_t c = c0 + (s >> shift);
        // past the last row there is nothing to load
        const int64_t e =
            c < C ? e0 + (s & (spg - 1)) * kStep + 4 * lane : E;
        load_lanes<T, kAligned>(rel + c * E, e, E, W, q[s]);
        load_vals<T, kAligned>(vals + c * E, e, E, q[s]);
      }
#pragma unroll
      for (int s = 0; s < kGroup; ++s) {
        const int64_t c = c0 + (s >> shift);
        if (c < C && e0 + (s & (spg - 1)) * kStep < E) {  // warp-uniform
          step<T, K>(q[s], s_acc[warp][s >> shift], stage, lane);
          __syncwarp();
        }
      }
    }
    for (int r = 0; r < rows && c0 + r < C; ++r) {
      T* orow = out + (c0 + r) * W;
      const T* acc = s_acc[warp][r];
      if (W % 4 == 0 && (uintptr_t)orow % 16 == 0) {   // 16 B stores
        if (4 * lane < W)
          reinterpret_cast<uint4*>(orow)[lane] =
              reinterpret_cast<const uint4*>(acc)[lane];
      } else {
        for (int w = lane; w < W; w += 32) orow[w] = acc[w];
      }
    }
    __syncwarp();              // the next rows re-initialise s_acc
  }
}

template <typename T, int K>
void launch(const void* vals, const void* rel, void* out, int64_t C,
            int64_t E, int W, bool aligned, cudaStream_t stream) {
  const int64_t rows = rows_per_group(E);
  const int64_t want = ((C + rows - 1) / rows + kWarps - 1) / kWarps;
  const unsigned blocks = (unsigned)(want < kMaxBlocks ? want : kMaxBlocks);
  const T* v = static_cast<const T*>(vals);
  const int8_t* r = static_cast<const int8_t*>(rel);
  T* o = static_cast<T*>(out);
  if (aligned)
    chunk_partials_kernel<T, K, true><<<blocks, kThreads, 0, stream>>>(
        v, r, o, C, E, W);
  else
    chunk_partials_kernel<T, K, false><<<blocks, kThreads, 0, stream>>>(
        v, r, o, C, E, W);
}

}  // namespace

// dtype: 0 = float32, 1 = int32.  kind: 0 = sum, 1 = min, 2 = max.
// Launches on `stream` and returns the cudaError_t of the launch
// (0 = success); it does not synchronise.
extern "C" int lux_chunk_partials(const void* vals, const void* rel,
                                  void* out, int64_t C, int64_t E,
                                  int64_t W, int32_t dtype, int32_t kind,
                                  void* stream) {
  if (C < 0 || E < 1 || W < 1 || W > kMaxW || kind < 0 || kind > 2)
    return (int)cudaErrorInvalidValue;
  if (C == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int w = (int)W;
  // 16 B loads of vals and 4 B loads of rel need every row aligned
  const bool aligned = E % 4 == 0 && (uintptr_t)vals % 16 == 0 &&
                       (uintptr_t)rel % 4 == 0;
  if (dtype == 0) {
    if (kind == kSum) launch<float, kSum>(vals, rel, out, C, E, w, aligned, s);
    if (kind == kMin) launch<float, kMin>(vals, rel, out, C, E, w, aligned, s);
    if (kind == kMax) launch<float, kMax>(vals, rel, out, C, E, w, aligned, s);
  } else if (dtype == 1) {
    if (kind == kSum) launch<int32_t, kSum>(vals, rel, out, C, E, w, aligned, s);
    if (kind == kMin) launch<int32_t, kMin>(vals, rel, out, C, E, w, aligned, s);
    if (kind == kMax) launch<int32_t, kMax>(vals, rel, out, C, E, w, aligned, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
