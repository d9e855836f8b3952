// Passes 2 and 3 of the tiled chained scan of csrc/fused_carry.cu (S8),
// its only user: csrc/carry.cu (S7) is one single-pass launch with
// decoupled look-back and includes nothing of this header.
//
// Pass 1 (in fused_carry.cu) scans each tile of rows on its own, from a
// carry of 0, and writes per tile:
//   agg[t, w]  the tile's value at its last row (the sum since the
//              tile's last start, or since the tile's first row);
//   first[t]   the index in the tile of its first start row, or
//              kNoStart when the tile has none.
// Pass 2 (resolve_kernel) turns those into each tile's carry-in: the
// value of the segment that enters the tile, 0 for tile 0.  Pass 3
// (apply_kernel) adds the carry-in to the tile's rows before its first
// start; every other row already holds its final value.

#pragma once

#include <cuda_runtime.h>

#include <stdint.h>

namespace carry_tiles {

constexpr int32_t kNoStart = 0x7fffffff;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kLanes = 128;        // apply: threads of a block, one a column
constexpr int kResolveWarps = 4;   // resolve: warps of a block, one a column

// One warp per column; lane l owns the contiguous range of tiles
// [l * per, (l + 1) * per), per = ceil(nT / 32).  Pass A folds the
// range's (has start, aggregate) pairs in order, kResolveBatch tiles'
// loads in flight before their adds; a segmented scan over the 32
// lanes (Hillis-Steele, 5 shuffle steps) gives each range its
// carry-in; pass B walks the range again and writes each tile's
// carry-in.  O(nT) loads a column, in 2 ceil(per / kResolveBatch)
// dependent steps a lane.
constexpr int kResolveBatch = 16;

__device__ __forceinline__ void load_tiles(const float* __restrict__ agg,
                                           const int32_t* __restrict__ first,
                                           int64_t b, int64_t t1, int W,
                                           int col, float (&a)[kResolveBatch],
                                           int (&f)[kResolveBatch]) {
#pragma unroll
  for (int j = 0; j < kResolveBatch; ++j) {
    const int64_t t = b + j;
    a[j] = t < t1 ? agg[t * W + col] : 0.f;
    f[j] = t < t1 ? first[t] != kNoStart : 0;
  }
}

__global__ void __launch_bounds__(kResolveWarps * 32)
resolve_kernel(const float* __restrict__ agg,
               const int32_t* __restrict__ first, float* __restrict__ cin,
               int64_t nT, int W) {
  const int lane = threadIdx.x & 31;
  const int col = blockIdx.x * kResolveWarps + (threadIdx.x >> 5);
  if (col >= W) return;  // the whole warp leaves together
  const int64_t per = (nT + 31) / 32;
  const int64_t t0 = lane * per;
  const int64_t t1 = t0 + per < nT ? t0 + per : nT;
  float av[kResolveBatch];
  int fv[kResolveBatch];
  int f = 0;
  float a = 0.f;
  for (int64_t b = t0; b < t1; b += kResolveBatch) {
    load_tiles(agg, first, b, t1, W, col, av, fv);
#pragma unroll
    for (int j = 0; j < kResolveBatch; ++j) {
      a = fv[j] ? av[j] : a + av[j];
      f |= fv[j];
    }
  }
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float a_up = __shfl_up_sync(kFull, a, d);
    const int f_up = __shfl_up_sync(kFull, f, d);
    if (lane >= d) {
      if (!f) a += a_up;
      f |= f_up;
    }
  }
  // a is now the value at the end of this lane's range (0 enters lane 0)
  const float up = __shfl_up_sync(kFull, a, 1);
  float c = lane == 0 ? 0.f : up;
  for (int64_t b = t0; b < t1; b += kResolveBatch) {
    load_tiles(agg, first, b, t1, W, col, av, fv);
#pragma unroll
    for (int j = 0; j < kResolveBatch; ++j) {
      if (b + j < t1) cin[(b + j) * W + col] = c;
      c = fv[j] ? av[j] : c + av[j];
    }
  }
}

// Grid (nT, ceil(W / 128)): block t adds its carry-in to the rows of
// tile t before the tile's first start (all of them when it has none).
__global__ void __launch_bounds__(kLanes)
apply_kernel(float* __restrict__ out, const float* __restrict__ cin,
             const int32_t* __restrict__ first, int64_t C, int W,
             int tile) {
  const int64_t t = blockIdx.x;
  const int col = blockIdx.y * kLanes + threadIdx.x;
  if (t == 0 || col >= W) return;  // tile 0's carry-in is 0
  const int64_t r0 = t * tile;
  int64_t n = C - r0 < tile ? C - r0 : tile;
  if (first[t] < n) n = first[t];
  if (n <= 0) return;
  const float c = cin[t * W + col];
  float* o = out + r0 * W + col;
  for (int64_t r = 0; r < n; ++r) o[r * W] += c;
}

// Passes 2 and 3 on `stream`; returns the cudaError_t of the launches.
inline cudaError_t resolve_and_apply(float* out, const float* agg,
                                     const int32_t* first, float* cin,
                                     int64_t C, int W, int tile,
                                     cudaStream_t stream) {
  const int64_t nT = (C + tile - 1) / tile;
  resolve_kernel<<<(W + kResolveWarps - 1) / kResolveWarps,
                   kResolveWarps * 32, 0, stream>>>(agg, first, cin, nT, W);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (nT > 1) {
    apply_kernel<<<dim3((unsigned)nT, (W + kLanes - 1) / kLanes), kLanes, 0,
                   stream>>>(out, cin, first, C, W, tile);
    err = cudaGetLastError();
  }
  return err;
}

}  // namespace carry_tiles
