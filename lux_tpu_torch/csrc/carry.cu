// S7 on Hopper: the segmented carry over per-chunk partials.
//
// Replaces scripts/profile_slotted.py::carry (body _carry_kernel),
// which the TPU runs as one sequential loop over the rows of [bc, 128]
// VMEM blocks, carrying a [1, 128] row in scratch from one grid step
// to the next.  Same function:
//
//   out[i, w] = start[i] == 1 ? part[i, w] : out[i - 1, w] + part[i, w]
//
// with a carry of 0 before row 0.  Inputs: part [C, W] float32, start
// [C] int32 (the script's [C, 1]), out [C, W]; row-major, contiguous.
// Any C >= 1 and W >= 1 (the script's W is 128).
//
// Bound: bytes.  part read once, start read once, out written once:
// C * (8 W + 4) bytes over the card's 3.35 TB/s; one add a value.
//
// Design (simple and right; not tuned): blocks run in no order on the
// card, so the TPU's carry from one grid step to the next becomes a
// tiled chained scan in three launches (carry_tiles.cuh):
// 1. tile_kernel: a block of 128 threads (one a column, rows of 512 B
//    read coalesced) scans a tile of kTile rows from a carry of 0,
//    16 rows' loads in flight before their 16 dependent adds, writes
//    those rows, the tile's aggregate and its first start;
// 2. resolve_kernel: each tile's carry-in, a warp segmented scan over
//    the tiles;
// 3. apply_kernel: adds the carry-in to the rows before each tile's
//    first start (about 1/p of a tile's rows when a row starts a
//    segment with probability p).
// f32 adds run in another order than the TPU's one sequential loop,
// so results agree to a tolerance, not in bits.  Single-pass decoupled
// look-back is later work.

#include "carry_tiles.cuh"

namespace {

using carry_tiles::kLanes;
using carry_tiles::kNoStart;

constexpr int kTile = 64;    // rows a tile
constexpr int kBatch = 16;   // loads in flight a thread

__global__ void __launch_bounds__(kLanes)
tile_kernel(const float* __restrict__ part, const int32_t* __restrict__ start,
            float* __restrict__ out, float* __restrict__ agg,
            int32_t* __restrict__ first, int64_t C, int W) {
  __shared__ int32_t s_start[kTile];
  __shared__ int32_t s_first;
  const int64_t t = blockIdx.x;
  const int64_t r0 = t * kTile;
  const int n = (int)(C - r0 < kTile ? C - r0 : kTile);
  if (threadIdx.x == 0) s_first = kNoStart;
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int32_t s = start[r0 + i];
    s_start[i] = s;
    if (s == 1) atomicMin(&s_first, i);
  }
  __syncthreads();
  if (threadIdx.x == 0 && blockIdx.y == 0) first[t] = s_first;
  const int col = blockIdx.y * kLanes + threadIdx.x;
  if (col >= W) return;
  const float* p = part + r0 * W + col;
  float* o = out + r0 * W + col;
  float acc = 0.f;
  for (int i0 = 0; i0 < n; i0 += kBatch) {
    float v[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
      v[j] = i0 + j < n ? __ldg(p + (int64_t)(i0 + j) * W) : 0.f;
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      if (i0 + j < n) {
        acc = s_start[i0 + j] == 1 ? v[j] : acc + v[j];
        o[(int64_t)(i0 + j) * W] = acc;
      }
    }
  }
  agg[t * W + col] = acc;
}

}  // namespace

// Launches the three passes on `stream` and returns the cudaError_t of
// the launches (0 = success); it does not synchronise.  agg [nT, W]
// f32, first [nT] int32 and cin [nT, W] f32 are scratch the caller
// allocates, nT = ceil(C / tile); `tile` must be this source's kTile.
extern "C" int lux_carry(const void* part, const void* start, void* out,
                         void* agg, void* first, void* cin, int64_t C, int W,
                         int tile, void* stream) {
  if (C < 0 || W < 1 || tile != kTile) return (int)cudaErrorInvalidValue;
  if (C == 0) return 0;
  const int64_t nT = (C + kTile - 1) / kTile;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  tile_kernel<<<dim3((unsigned)nT, (W + kLanes - 1) / kLanes), kLanes, 0,
                s>>>(static_cast<const float*>(part),
                     static_cast<const int32_t*>(start),
                     static_cast<float*>(out), static_cast<float*>(agg),
                     static_cast<int32_t*>(first), C, W);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)carry_tiles::resolve_and_apply(
      static_cast<float*>(out), static_cast<const float*>(agg),
      static_cast<const int32_t*>(first), static_cast<float*>(cin), C, W,
      kTile, s);
}
