// Kernel B2 on Hopper: the 128-lane shuffle of the paged gather.
//
// Replaces lux_tpu/ops/pagegather.py::_lane_shuffle_pallas (body
// _shuffle_kernel), which the TPU runs as take_along_axis along the
// 128-lane axis of [512 or 8, 128] VMEM blocks (tpu.dynamic_gather).
// Same function:
//
//   out[r, c] = rows[r, slot_lane[r, c] & 0x7F]
//
// Inputs: rows [R, 128] of 4-byte words (float32 or int32: the kernel
// moves bits, so NaN payloads and int32 values come through
// unchanged), slot_lane [R, 128] the packed uint32
// page_slot << 7 | lane (only the low 7 bits are read; bit 31 may be
// set), out [R, 128].  All row-major, contiguous and 16-byte aligned.
// Any R >= 0.
//
// Bound: bytes.  Each lane reads 4 B of rows and 4 B of slot_lane and
// writes 4 B of out: R * 128 * 12 bytes over the card's 3.35 TB/s.
// There is no arithmetic beyond a mask.
//
// Design (simple and right; not tuned):
// - one warp per row (a row is 512 B = 32 x 16 B): each thread loads
//   16 B of the row with one coalesced uint4 load and stages it in
//   shared memory; the warp's 32 loads cover the row;
// - after __syncwarp, each thread reads its 16 B of slot_lane (again
//   one coalesced uint4), masks the four lanes, reads the four words
//   from the staged row and stores 16 B of out;
// - 8 warps per block, grid-stride over rows, so a warp never waits
//   on another and a ragged last group just has idle warps.
// The staged reads land on random banks (2-4 way conflicts on
// average); the row and slot_lane traffic is what bounds it.

#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kW = 128;                  // lanes per row
constexpr int kVec = kW / 4;             // uint4 words per row (32)
constexpr int kWarps = 8;                // rows per block step
constexpr int kThreads = kWarps * 32;
constexpr int64_t kMaxBlocks = 1 << 20;
constexpr uint32_t kLaneMask = 0x7F;

__global__ void __launch_bounds__(kThreads)
lane_shuffle_kernel(const uint4* __restrict__ rows,
                    const uint4* __restrict__ slot_lane,
                    uint4* __restrict__ out, int64_t R) {
  __shared__ __align__(16) uint32_t s_rows[kWarps][kW];
  const int warp = threadIdx.x >> 5;
  const int q = threadIdx.x & 31;
  uint32_t* row = s_rows[warp];
  for (int64_t r = (int64_t)blockIdx.x * kWarps + warp; r < R;
       r += (int64_t)gridDim.x * kWarps) {
    const int64_t at = r * kVec + q;
    __syncwarp();  // the previous row's staged reads are done
    reinterpret_cast<uint4*>(row)[q] = __ldg(rows + at);
    const uint4 s = __ldg(slot_lane + at);
    __syncwarp();
    uint4 o;
    o.x = row[s.x & kLaneMask];
    o.y = row[s.y & kLaneMask];
    o.z = row[s.z & kLaneMask];
    o.w = row[s.w & kLaneMask];
    out[at] = o;
  }
}

}  // namespace

// Launches on `stream` and returns the cudaError_t of the launch
// (0 = success); it does not synchronise.
extern "C" int lux_lane_shuffle(const void* rows, const void* slot_lane,
                                void* out, int64_t R, void* stream) {
  if (R < 0) return (int)cudaErrorInvalidValue;
  if (R == 0) return 0;
  const int64_t want = (R + kWarps - 1) / kWarps;
  const unsigned blocks = (unsigned)(want < kMaxBlocks ? want : kMaxBlocks);
  lane_shuffle_kernel<<<blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(rows), static_cast<const uint4*>(slot_lane),
      static_cast<uint4*>(out), R);
  return (int)cudaGetLastError();
}
