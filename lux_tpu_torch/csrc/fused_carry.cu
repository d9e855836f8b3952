// S8 on Hopper: per-chunk partial sums with the segmented carry fused
// in, so the [C, W] partials never go to device memory in between.
//
// Replaces scripts/profile_kernel.py::fused (body _fused_kernel), which
// the TPU runs as a sequential loop over the chunks of [bc, E] VMEM
// blocks: an [E, W] compare-select and a sublane sum for each chunk's
// partial row, then S7's carry on that row.  Same function:
//
//   part[c, w] = sum of vals[c, e] over every e with rel[c, e] == w
//   out[c, w]  = start[c] == 1 ? part[c, w] : out[c - 1, w] + part[c, w]
//
// with a carry of 0 before chunk 0.  Inputs: vals [C, E] float32, rel
// [C, E] int32 (lanes outside [0, W), the script's pad W among them,
// add nothing; rows need not be sorted), start [C] int32 (the script's
// [C, 1]), out [C, W]; row-major, contiguous; 1 <= W <= 128, any
// C >= 1, E >= 1.
//
// Bound: bytes.  vals and rel read once, start read once, out written
// once: C * (8 E + 4 + 4 W) bytes over the card's 3.35 TB/s; one add a
// live entry and one a partial.
//
// Design (simple and right; not tuned):
// 1. tile_kernel: a block of 256 threads takes a tile of kTile chunks.
//    The tile's chunks are contiguous rows, so the block walks its
//    kTile * E entries as one flat range: 16 B loads of vals and rel
//    (4 entries of one chunk, when E % 4 == 0), kBatch of them in
//    flight a thread; a thread adds runs of equal lanes among its 4
//    entries first, then one shared-memory atomicAdd a run into the
//    tile's [kTile, 128] partials (16 KB).  Scalar loads when E % 4 != 0.
//    Then one thread a lane scans the tile's partial rows from a carry
//    of 0 and writes them, with the tile's aggregate and first start.
// 2-3. resolve_kernel and apply_kernel as in S7 (carry_tiles.cuh).
// The shared atomics add a lane's runs in no fixed order, so f32
// results agree to a tolerance, not in bits, and may differ in the
// last bits from run to run (unlike B1, which has no atomics).

#include "carry_tiles.cuh"

namespace {

using carry_tiles::kNoStart;

constexpr int kTile = 32;      // chunks a tile
constexpr int kMaxW = 128;     // partial lanes in shared memory
constexpr int kThreads = 256;
constexpr int kBatch = 4;      // 16 B loads in flight a thread

__device__ __forceinline__ void add_runs(float* row, const float (&v)[4],
                                         const int (&r)[4], int W) {
  int cur = -1;
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int lane = r[j] >= 0 && r[j] < W ? r[j] : -1;
    if (lane == cur) {
      sum += v[j];
    } else {
      if (cur >= 0) atomicAdd(row + cur, sum);
      cur = lane;
      sum = v[j];
    }
  }
  if (cur >= 0) atomicAdd(row + cur, sum);
}

__global__ void __launch_bounds__(kThreads)
tile_kernel(const float* __restrict__ vals, const int32_t* __restrict__ rel,
            const int32_t* __restrict__ start, float* __restrict__ out,
            float* __restrict__ agg, int32_t* __restrict__ first, int64_t C,
            int64_t E, int W, int vec) {
  __shared__ float s_part[kTile * kMaxW];
  __shared__ int32_t s_start[kTile];
  __shared__ int32_t s_first;
  const int64_t t = blockIdx.x;
  const int64_t c0 = t * kTile;
  const int n = (int)(C - c0 < kTile ? C - c0 : kTile);
  for (int i = threadIdx.x; i < kTile * kMaxW; i += kThreads) s_part[i] = 0.f;
  if (threadIdx.x == 0) s_first = kNoStart;
  __syncthreads();
  if (threadIdx.x < n) {
    const int32_t s = start[c0 + threadIdx.x];
    s_start[threadIdx.x] = s;
    if (s == 1) atomicMin(&s_first, (int32_t)threadIdx.x);
  }
  const int64_t base = c0 * E;
  const int64_t total = (int64_t)n * E;
  if (vec) {
    // 4 entries a quad, all of one chunk since E % 4 == 0
    const float4* v4 = reinterpret_cast<const float4*>(vals + base);
    const int4* r4 = reinterpret_cast<const int4*>(rel + base);
    const int64_t quads = total / 4;
    for (int64_t q0 = threadIdx.x; q0 < quads; q0 += kBatch * kThreads) {
      float4 v[kBatch];
      int4 r[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int64_t q = q0 + (int64_t)j * kThreads;
        if (q < quads) {
          v[j] = __ldg(v4 + q);
          r[j] = __ldg(r4 + q);
        } else {
          r[j] = make_int4(-1, -1, -1, -1);
          v[j] = make_float4(0.f, 0.f, 0.f, 0.f);
        }
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int64_t q = q0 + (int64_t)j * kThreads;
        if (q < quads) {
          const float vv[4] = {v[j].x, v[j].y, v[j].z, v[j].w};
          const int rr[4] = {r[j].x, r[j].y, r[j].z, r[j].w};
          add_runs(s_part + (q * 4 / E) * kMaxW, vv, rr, W);
        }
      }
    }
  } else {
    for (int64_t e = threadIdx.x; e < total; e += kThreads) {
      const int lane = __ldg(rel + base + e);
      if (lane >= 0 && lane < W)
        atomicAdd(s_part + (e / E) * kMaxW + lane, __ldg(vals + base + e));
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) first[t] = s_first;
  if (threadIdx.x < W) {
    const int w = threadIdx.x;
    float acc = 0.f;
    for (int i = 0; i < n; ++i) {
      const float p = s_part[i * kMaxW + w];
      acc = s_start[i] == 1 ? p : acc + p;
      out[(c0 + i) * W + w] = acc;
    }
    agg[t * W + w] = acc;
  }
}

}  // namespace

// Launches the three passes on `stream` and returns the cudaError_t of
// the launches (0 = success); it does not synchronise.  agg [nT, W]
// f32, first [nT] int32 and cin [nT, W] f32 are scratch the caller
// allocates, nT = ceil(C / tile); `tile` must be this source's kTile.
extern "C" int lux_fused_carry(const void* vals, const void* rel,
                               const void* start, void* out, void* agg,
                               void* first, void* cin, int64_t C, int64_t E,
                               int W, int tile, void* stream) {
  if (C < 0 || E < 1 || W < 1 || W > kMaxW || tile != kTile)
    return (int)cudaErrorInvalidValue;
  if (C == 0) return 0;
  const int64_t nT = (C + kTile - 1) / kTile;
  const int vec = E % 4 == 0 && reinterpret_cast<uintptr_t>(vals) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(rel) % 16 == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  tile_kernel<<<(unsigned)nT, kThreads, 0, s>>>(
      static_cast<const float*>(vals), static_cast<const int32_t*>(rel),
      static_cast<const int32_t*>(start), static_cast<float*>(out),
      static_cast<float*>(agg), static_cast<int32_t*>(first), C, E, W, vec);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)carry_tiles::resolve_and_apply(
      static_cast<float*>(out), static_cast<const float*>(agg),
      static_cast<const int32_t*>(first), static_cast<float*>(cin), C, W,
      kTile, s);
}
