// Kernel B1 over a trailing query axis, on Hopper.
//
// Query-batched programs (state [P, vpad, B]) give the per-chunk
// reduce a [C, E, B] payload.  The reference's Pallas kernel
// (lux_tpu/ops/pallas_reduce.py:63 ``chunk_partials_pallas``) is scalar
// only; for a vector payload the reference computes this function
// with XLA's broadcast-compare (lux_tpu/ops/tiled.py:326-363
// ``chunk_partials``).  On the card every dense reduce goes through
// B1, so this is B1's batched form:
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
// Bound: bytes.  The function reads every lane id once (C*E B), the B
// values of every entry whose lane is live and writes C*W*B*4 B, at the
// card's 3.35 TB/s; one combine per live value is far below that line.
// On the tiled chunks (dst-sorted, nearly full) the values dominate; on
// the paged rows (E = W = 128, ~94% pads, lanes in source order) the
// output does, and a pad's values are a whole 32 B sector at B = 8.
//
// Design (redesigned from one thread per chunk and column group walking
// its chunk serially, which left the time to one thread's chain of load
// latencies; tools/b1_ab.py --batched times the choices below):
// - the columns split into groups of BG <= 8 (8 where B % 8 == 0, 4
//   where B % 4 == 0, else the next power of two up to 8; a last group
//   may be partial); a work item is (chunk, column group) and one warp
//   takes an item at a time, grid-stride (one item a warp below 2^23
//   items), with no block-wide barrier;
// - a warp walks an item in steps of 32 * EPT entries, thread t holding
//   entries EPT * t onwards with their BG columns in registers: EPT =
//   8 / BG entries (1 at BG = 8, 2 at BG = 4, 4 below), eight values a
//   thread, so a step moves 1 KB at B = 8 and B = 4 alike.  Lane ids are
//   one byte a load; values go in 16 B loads where the groups are whole
//   and the bases aligned (a warp's load is one contiguous span when B
//   == BG).  A value is loaded only where its lane is live, so a pad
//   costs no value sector.  Loads run ahead of the fold: a step's
//   values one group of steps ahead, its lane ids two, across items;
// - a thread folds its own entries into runs of equal lanes in e order;
//   __ballot_sync skips a step with no live entry;
// - sorted steps (every tiled chunk: dst-sorted, pads at the tail; the
//   check is a ballot, not an assumption): a segmented inclusive scan
//   of the threads' tail runs across the warp over each of the BG
//   columns, five __shfl_up_sync levels with segment heads from a
//   ballot (keyed on lane; dead threads pass a run on).  The thread that
//   ends a run, and the thread whose first run continues one from below,
//   fold it into the warp's [W, BG] accumulator in shared memory, which
//   starts at the identity: each lane once a step;
// - unsorted steps (the paged rows: lanes in source order): per run
//   slot in e order, __match_any_sync groups the threads holding the
//   same lane; the group's lowest thread folds the members' values,
//   staged in shared memory, in ascending thread order;
// - steps fold into the accumulator in ascending order; when an item's
//   last step is folded the warp writes its [W, BG] output once, with
//   16 B stores where the groups are whole and the base aligned (so the
//   row is one contiguous span where B == BG), else scalar stores.
//   Nothing is read back from global memory.
// No atomics: every (w, b) folds in an order that depends only on the
// inputs, so launches give the same bits.  A run is summed in a tree
// (a thread's entries in e order, then the scan), runs and steps in
// ascending e; an f32 sum over n values in any such order is within
// (n - 1) * 2^-24 * sum|v| of the exact sum, inside E * 2^-23 * sum|v|.
// min/max give the same value in every order (NaN payloads and the
// sign of a zero aside) and propagate NaN like jnp.min/jnp.max; int32
// sums wrap around.  Shared memory: (W + 32) * BG * 4 B a warp, 40 KB a
// block at BG = 8, static.
//
// Build: 7 (BG, VEC) forms x 3 kinds x 2 dtypes are 42 kernels, which
// one nvcc takes about 24 s to compile.  The port's build
// (lux_tpu_torch/_kernels.py, PARTS) compiles this file once a kind,
// with -DLUX_PART=0, 1, 2 (sum, min, max), all at once, and links the
// three objects; part 0 holds the C entry point.  Without LUX_PART one
// translation unit holds everything (tools/b1_ab.py builds it so).

#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxW = 128;              // rel is int8: lanes 0..127
constexpr int kWarps = 8;               // warps a block
constexpr int kThreads = kWarps * 32;
constexpr int kMaxCols = 8;             // query columns a work item
constexpr int kStepValues = 8;          // values a thread holds a step
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

// The column groups of B query columns: BG columns an item (a power of
// two up to kMaxCols; the last group holds B - (groups - 1) * BG).
__host__ inline int group_cols(int64_t B) {
  if (B % 8 == 0) return 8;
  if (B % 4 == 0) return 4;
  if (B > 8) return 8;
  return B == 1 ? 1 : B == 2 ? 2 : B <= 4 ? 4 : 8;
}

// Entries a thread holds a step: kStepValues / BG values' worth, 1 to 4.
__host__ __device__ constexpr int entries_a_thread(int bg) {
  return kStepValues / bg < 1 ? 1 : kStepValues / bg > 4 ? 4
                                                          : kStepValues / bg;
}

// Where a warp is in its walk: item (chunk c, columns from b0) and step.
struct Cursor {
  int64_t item, c;
  int64_t b0;
  int s;

  __device__ __forceinline__ void set(int64_t it, int64_t groups, int bg) {
    item = it;
    s = 0;
    c = groups == 1 ? it : it / groups;
    b0 = (it - c * groups) * bg;
  }
  __device__ __forceinline__ void next(int spr, int64_t stride,
                                       int64_t groups, int bg) {
    if (++s == spr) set(item + stride, groups, bg);
  }
};

// One entry's (or output lane's) BG columns, aligned so that a copy of
// it to or from shared memory is one or two 16 B accesses.
template <typename T, int BG>
struct alignas(BG >= 4 ? 16 : 4 * BG) Cols {
  T x[BG];
};

// VEC = 4 / 2 words from one load or store.
template <int VEC> struct Word;
template <> struct Word<4> { using type = uint4; };
template <> struct Word<2> { using type = uint2; };

// The lane of entry e of the cursor's item: -1 for a pad or a lane
// outside [0, W), -2 where there is no entry (past E, or past the
// warp's items).
__device__ __forceinline__ int load_lane(const int8_t* __restrict__ rel,
                                         const Cursor& p, int64_t items,
                                         int64_t e, int64_t E, int W) {
  if (p.item >= items || e >= E) return -2;
  const int k = __ldg(rel + p.c * E + e);
  return k < W ? k : -1;
}

// Entry e's BG values where its lane is live (the rest keep what they
// held: the fold never reads them).
template <typename T, int BG, int VEC>
__device__ __forceinline__ void load_vals(const T* __restrict__ vals,
                                          const Cursor& p, int k, int64_t e,
                                          int64_t E, int64_t B,
                                          Cols<T, BG>& v) {
  if (k < 0) return;                    // a pad's values are never read
  const T* row = vals + (p.c * E + e) * B + p.b0;
  if constexpr (VEC > 1) {
    using W_ = typename Word<VEC>::type;
#pragma unroll
    for (int j = 0; j < BG; j += VEC)
      *reinterpret_cast<W_*>(v.x + j) =
          __ldg(reinterpret_cast<const W_*>(row + j));
  } else {
#pragma unroll
    for (int j = 0; j < BG; ++j)
      if (p.b0 + j < B) v.x[j] = __ldg(row + j);
  }
}

// A thread's step: its EPT consecutive entries' lanes and values.
template <typename T, int BG, int EPT>
struct Step {
  int k[EPT];
  Cols<T, BG> v[EPT];
};

template <typename T, int BG, int EPT>
__device__ __forceinline__ void load_lanes(const int8_t* __restrict__ rel,
                                           const Cursor& p, int64_t items,
                                           int64_t E, int W, int lane,
                                           Step<T, BG, EPT>& st) {
  const int64_t e = ((int64_t)p.s * 32 + lane) * EPT;
#pragma unroll
  for (int j = 0; j < EPT; ++j) st.k[j] = load_lane(rel, p, items, e + j, E, W);
}

template <typename T, int BG, int EPT, int VEC>
__device__ __forceinline__ void load_step(const T* __restrict__ vals,
                                          const Cursor& p, int64_t E,
                                          int64_t B, int lane,
                                          Step<T, BG, EPT>& st) {
  const int64_t e = ((int64_t)p.s * 32 + lane) * EPT;
#pragma unroll
  for (int j = 0; j < EPT; ++j)
    load_vals<T, BG, VEC>(vals, p, st.k[j], e + j, E, B, st.v[j]);
}

// The runs of equal lanes in a thread's EPT entries, in e order: up to
// EPT - 1 completed runs (sk/sv, -1 = none) and the tail run (tk/tv).
template <typename T, int BG, int EPT>
struct Runs {
  int sk[EPT > 1 ? EPT - 1 : 1];
  Cols<T, BG> sv[EPT > 1 ? EPT - 1 : 1];
  int tk, fk;                  // tail lane, first live lane (-1: none)
  Cols<T, BG> tv;
  bool asc;                    // the run lanes strictly ascend
};

template <typename T, int K, int BG>
__device__ __forceinline__ void fold_into(Cols<T, BG>& a,
                                          const Cols<T, BG>& v) {
#pragma unroll
  for (int j = 0; j < BG; ++j) a.x[j] = Op<T, K>::apply(a.x[j], v.x[j]);
}

template <typename T, int K, int BG, int EPT>
__device__ __forceinline__ void fold_runs(const Step<T, BG, EPT>& st,
                                          Runs<T, BG, EPT>& r) {
  r.tk = -1;
  r.fk = -1;
  r.asc = true;
#pragma unroll
  for (int j = 0; j < EPT - 1; ++j) r.sk[j] = -1;
#pragma unroll
  for (int j = 0; j < EPT; ++j) {
    const int k = st.k[j];
    if (k < 0) continue;
    if (k == r.tk) {
      fold_into<T, K, BG>(r.tv, st.v[j]);
    } else {
      if (r.tk >= 0) {         // the tail run completes at entry j - 1
        r.asc = r.asc && k > r.tk;
        if (EPT > 1 && j > 0) {
          r.sk[j - 1] = r.tk;
          r.sv[j - 1] = r.tv;
        }
      } else {
        r.fk = k;
      }
      r.tk = k;
      r.tv = st.v[j];
    }
  }
}

// One step of 32 * EPT entries (thread `lane` holds entries EPT * lane
// onwards) folded into the warp's accumulator acc [W].
template <typename T, int K, int BG, int EPT>
__device__ __forceinline__ void fold_step(const Step<T, BG, EPT>& st,
                                          Cols<T, BG>* acc,
                                          Cols<T, BG>* stage, int lane) {
  Runs<T, BG, EPT> r;
  fold_runs<T, K, BG, EPT>(st, r);
  const bool has = r.tk >= 0;
  const unsigned live = __ballot_sync(kFull, has);
  if (live == 0) return;                          // an all-pad step
  // each thread's key: its tail lane, or the tail lane of the nearest
  // live thread below it (-1: none), so that dead threads pass a run on
  const unsigned below = live & ((1u << lane) - 1);
  const int src = has ? lane : (below ? 31 - __clz(below) : lane);
  const int key = __shfl_sync(kFull, r.tk, src);
  const int head = has ? r.fk : key;
  int kprev = __shfl_up_sync(kFull, key, 1);
  if (lane == 0) kprev = -1;
  if (__all_sync(kFull, r.asc && head >= kprev)) {
    // sorted: a segmented inclusive scan of the tail runs, each column
    // keyed on lane, five levels
    const unsigned starts = __ballot_sync(kFull, key != kprev);
    const unsigned upto = starts & ((2u << lane) - 1);
    const int seghead = upto ? 31 - __clz(upto) : 0;
    Cols<T, BG> s;
#pragma unroll
    for (int j = 0; j < BG; ++j) s.x[j] = has ? r.tv.x[j] : Op<T, K>::identity();
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const bool take = lane - d >= seghead;
#pragma unroll
      for (int j = 0; j < BG; ++j) {
        const T y = __shfl_up_sync(kFull, s.x[j], d);
        if (take) s.x[j] = Op<T, K>::apply(y, s.x[j]);
      }
    }
    if constexpr (EPT > 1) {
      // a completed run ends here; only the first can continue the run
      // ending in the thread below, whose scan sprev holds it
      Cols<T, BG> sprev;
#pragma unroll
      for (int j = 0; j < BG; ++j) sprev.x[j] = __shfl_up_sync(kFull, s.x[j], 1);
#pragma unroll
      for (int i = 0; i < EPT - 1; ++i) {
        const int k = r.sk[i];
        if (k < 0) continue;
        Cols<T, BG> x = r.sv[i];
        if (k == kprev) {
          x = sprev;
          fold_into<T, K, BG>(x, r.sv[i]);
        }
        Cols<T, BG> a = acc[k];
        fold_into<T, K, BG>(a, x);
        acc[k] = a;
      }
    }
    const int hnext = __shfl_down_sync(kFull, head, 1);
    if (key >= 0 && (lane == 31 || hnext != key)) {   // a run ends here
      Cols<T, BG> a = acc[key];
      fold_into<T, K, BG>(a, s);
      acc[key] = a;
    }
  } else {
    // unsorted: per run slot in e order, the lowest thread of each group
    // of equal lanes folds the members in ascending thread order
#pragma unroll
    for (int i = 0; i < EPT; ++i) {
      const int k = i < EPT - 1 ? r.sk[i < EPT - 1 ? i : 0] : r.tk;
      const unsigned m = __ballot_sync(kFull, k >= 0);
      if (m == 0) continue;
      if (k >= 0) {
        const unsigned grp = __match_any_sync(m, k);
        stage[lane] = i < EPT - 1 ? r.sv[i < EPT - 1 ? i : 0] : r.tv;
        __syncwarp(m);
        if (lane == __ffs(grp) - 1) {
          Cols<T, BG> a = acc[k];
          for (unsigned g = grp; g; g &= g - 1)
            fold_into<T, K, BG>(a, stage[__ffs(g) - 1]);
          acc[k] = a;
        }
      }
      __syncwarp();            // the stage is read before it is rewritten
    }
  }
  __syncwarp();                // acc is written before the next step
}

template <typename T, int K, int BG>
__device__ __forceinline__ void init_acc(Cols<T, BG>* acc, int W, int lane) {
  Cols<T, BG> id;
#pragma unroll
  for (int j = 0; j < BG; ++j) id.x[j] = Op<T, K>::identity();
  for (int w = lane; w < W; w += 32) acc[w] = id;
}

// The item's [W, BG] output, written once: VEC words a store.
template <typename T, int BG, int VEC>
__device__ __forceinline__ void store_row(const Cols<T, BG>* acc,
                                          T* __restrict__ out,
                                          const Cursor& p, int64_t B, int W,
                                          int lane) {
  T* row = out + p.c * (int64_t)W * B + p.b0;
  const T* a = acc[0].x;
  if constexpr (VEC > 1) {
    using W_ = typename Word<VEC>::type;
    constexpr int kParts = BG / VEC;
    for (int i = lane; i < W * kParts; i += 32) {
      const int w = i / kParts, j = (i - w * kParts) * VEC;
      *reinterpret_cast<W_*>(row + w * B + j) =
          *reinterpret_cast<const W_*>(a + w * BG + j);
    }
  } else {
    for (int i = lane; i < W * BG; i += 32) {
      const int w = i / BG, j = i - w * BG;
      if (p.b0 + j < B) row[w * B + j] = a[i];
    }
  }
}

template <typename T, int K, int BG, int VEC>
__global__ void __launch_bounds__(kThreads)
chunk_partials_batched_kernel(const T* __restrict__ vals,
                              const int8_t* __restrict__ rel,
                              T* __restrict__ out, int64_t C, int64_t E,
                              int64_t B, int W, int64_t groups) {
  static_assert(BG <= kMaxCols && VEC <= 4 && BG % VEC == 0, "a group");
  constexpr int EPT = entries_a_thread(BG);
  // steps whose loads go out together
  constexpr int D = BG * EPT >= kStepValues ? 1 : kStepValues / (BG * EPT);
  __shared__ Cols<T, BG> s_acc[kWarps][kMaxW];
  __shared__ Cols<T, BG> s_stage[kWarps][32];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  Cols<T, BG>* acc = s_acc[warp];
  Cols<T, BG>* stage = s_stage[warp];
  const int64_t items = C * groups;
  const int64_t stride = (int64_t)gridDim.x * kWarps;
  const int spr = (int)((E + 32 * EPT - 1) / (32 * EPT));   // steps a row
  // three cursors over the same walk: lane ids two groups of steps
  // ahead of the fold, values one group ahead
  Cursor pr, pv, pf;
  pr.set((int64_t)blockIdx.x * kWarps + warp, groups, BG);
  pv = pr;
  pf = pr;
  Step<T, BG, EPT> sA[D], sB[D], sC[D];
#pragma unroll
  for (int j = 0; j < D; ++j) {
    load_lanes<T, BG, EPT>(rel, pr, items, E, W, lane, sA[j]);
    pr.next(spr, stride, groups, BG);
  }
#pragma unroll
  for (int j = 0; j < D; ++j) {
    load_lanes<T, BG, EPT>(rel, pr, items, E, W, lane, sB[j]);
    pr.next(spr, stride, groups, BG);
  }
#pragma unroll
  for (int j = 0; j < D; ++j) {
    load_step<T, BG, EPT, VEC>(vals, pv, E, B, lane, sA[j]);
    pv.next(spr, stride, groups, BG);
  }
  while (pf.item < items) {                       // warp-uniform
#pragma unroll
    for (int j = 0; j < D; ++j) {
      load_lanes<T, BG, EPT>(rel, pr, items, E, W, lane, sC[j]);
      pr.next(spr, stride, groups, BG);
    }
#pragma unroll
    for (int j = 0; j < D; ++j) {
      load_step<T, BG, EPT, VEC>(vals, pv, E, B, lane, sB[j]);
      pv.next(spr, stride, groups, BG);
    }
#pragma unroll
    for (int j = 0; j < D; ++j) {
      if (pf.item >= items) break;
      if (pf.s == 0) {
        init_acc<T, K, BG>(acc, W, lane);
        __syncwarp();
      }
      fold_step<T, K, BG, EPT>(sA[j], acc, stage, lane);
      if (pf.s == spr - 1) {                      // the item is folded
        store_row<T, BG, VEC>(acc, out, pf, B, W, lane);
        __syncwarp();                             // before the next init
      }
      pf.next(spr, stride, groups, BG);
    }
#pragma unroll
    for (int j = 0; j < D; ++j) {
      sA[j] = sB[j];
      sB[j] = sC[j];
    }
  }
}

template <typename T, int K, int BG, int VEC>
void launch_plan(const T* v, const int8_t* r, T* o, int64_t C, int64_t E,
                 int64_t B, int W, cudaStream_t stream) {
  const int64_t groups = (B + BG - 1) / BG;
  const int64_t want = (C * groups + kWarps - 1) / kWarps;  // a warp an item
  const unsigned blocks = (unsigned)(want < kMaxBlocks ? want : kMaxBlocks);
  chunk_partials_batched_kernel<T, K, BG, VEC>
      <<<blocks, kThreads, 0, stream>>>(v, r, o, C, E, B, W, groups);
}

template <typename T, int K>
void launch(const void* vals, const void* rel, void* out, int64_t C,
            int64_t E, int64_t B, int W, cudaStream_t stream) {
  const int bg = group_cols(B);
  // vector loads and stores: whole groups and bases on the vector's size
  const int vec = bg >= 4 ? 4 : bg;
  const bool vector = bg > 1 && B % bg == 0 &&
                      (uintptr_t)vals % (4 * vec) == 0 &&
                      (uintptr_t)out % (4 * vec) == 0;
  const T* v = static_cast<const T*>(vals);
  const int8_t* r = static_cast<const int8_t*>(rel);
  T* o = static_cast<T*>(out);
  if (bg == 8) {
    if (vector) launch_plan<T, K, 8, 4>(v, r, o, C, E, B, W, stream);
    else launch_plan<T, K, 8, 1>(v, r, o, C, E, B, W, stream);
  } else if (bg == 4) {
    if (vector) launch_plan<T, K, 4, 4>(v, r, o, C, E, B, W, stream);
    else launch_plan<T, K, 4, 1>(v, r, o, C, E, B, W, stream);
  } else if (bg == 2) {
    if (vector) launch_plan<T, K, 2, 2>(v, r, o, C, E, B, W, stream);
    else launch_plan<T, K, 2, 1>(v, r, o, C, E, B, W, stream);
  } else {
    launch_plan<T, K, 1, 1>(v, r, o, C, E, B, W, stream);
  }
}

// Kind K over either dtype (0 = float32, 1 = int32).
template <int K>
int launch_kind(const void* vals, const void* rel, void* out, int64_t C,
                int64_t E, int64_t B, int W, int32_t dtype,
                cudaStream_t stream) {
  if (dtype == 0) launch<float, K>(vals, rel, out, C, E, B, W, stream);
  else launch<int32_t, K>(vals, rel, out, C, E, B, W, stream);
  return (int)cudaGetLastError();
}

}  // namespace

#ifndef LUX_PART
#define LUX_PART -1             // one translation unit: every part
#endif

// The launch of each kind, defined in its own part of the build.
namespace lux_cpb {
int launch_sum(const void*, const void*, void*, int64_t, int64_t, int64_t,
               int, int32_t, cudaStream_t);
int launch_min(const void*, const void*, void*, int64_t, int64_t, int64_t,
               int, int32_t, cudaStream_t);
int launch_max(const void*, const void*, void*, int64_t, int64_t, int64_t,
               int, int32_t, cudaStream_t);
}  // namespace lux_cpb

#if LUX_PART < 0 || LUX_PART == 0
int lux_cpb::launch_sum(const void* vals, const void* rel, void* out,
                        int64_t C, int64_t E, int64_t B, int W,
                        int32_t dtype, cudaStream_t stream) {
  return launch_kind<kSum>(vals, rel, out, C, E, B, W, dtype, stream);
}
#endif
#if LUX_PART < 0 || LUX_PART == 1
int lux_cpb::launch_min(const void* vals, const void* rel, void* out,
                        int64_t C, int64_t E, int64_t B, int W,
                        int32_t dtype, cudaStream_t stream) {
  return launch_kind<kMin>(vals, rel, out, C, E, B, W, dtype, stream);
}
#endif
#if LUX_PART < 0 || LUX_PART == 2
int lux_cpb::launch_max(const void* vals, const void* rel, void* out,
                        int64_t C, int64_t E, int64_t B, int W,
                        int32_t dtype, cudaStream_t stream) {
  return launch_kind<kMax>(vals, rel, out, C, E, B, W, dtype, stream);
}
#endif

#if LUX_PART <= 0
// dtype: 0 = float32, 1 = int32.  kind: 0 = sum, 1 = min, 2 = max.
// Launches on `stream` and returns the cudaError_t of the launch
// (0 = success); it does not synchronise.
extern "C" int lux_chunk_partials_batched(const void* vals, const void* rel,
                                          void* out, int64_t C, int64_t E,
                                          int64_t B, int64_t W,
                                          int32_t dtype, int32_t kind,
                                          void* stream) {
  if (C < 0 || E < 1 || B < 1 || W < 1 || W > kMaxW || kind < 0 ||
      kind > 2 || dtype < 0 || dtype > 1)
    return (int)cudaErrorInvalidValue;
  if (C == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int w = (int)W;
  if (kind == kSum)
    return lux_cpb::launch_sum(vals, rel, out, C, E, B, w, dtype, s);
  if (kind == kMin)
    return lux_cpb::launch_min(vals, rel, out, C, E, B, w, dtype, s);
  return lux_cpb::launch_max(vals, rel, out, C, E, B, w, dtype, s);
}
#endif
