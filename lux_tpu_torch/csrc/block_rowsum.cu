// S6 on Hopper: the sum of each bm-row block of a [R, 128] array.
//
// Replaces scripts/profile_vpu.py::redrow (body redrow_kern), which
// the TPU runs as a sublane reduce of one [1024, 128] VMEM block a
// grid step.  Same function:
//
//   out[b, j] = sum over i < bm of x[b*bm + i, j]
//
// Inputs: x [R, 128] float32, out [R / bm, 128] float32; row-major,
// contiguous, 16-byte aligned; R % bm == 0, bm >= 1.
//
// Bound: bytes.  x read once, out written once: (R + R / bm) * 512
// bytes over the card's 3.35 TB/s; one add an input element.
//
// Design (simple and right; not tuned): one CTA an output row, 256
// threads = 8 row lanes x 32 threads of float4 columns.  Lane l sums
// rows l, l + 8, l + 16, ... of its 16 B columns in that order (eight
// loads in flight a thread, unrolled), then a shared-memory tree folds
// the 8 lanes (4 + 4, 2 + 2, 1 + 1) in a fixed order.  No atomics, so
// two launches give the same bits.  At the script's shape (R / bm =
// 512 CTAs) each of 132 SMs holds 3 or 4 CTAs at once (116 hold 4), so
// the last quarter of the run has fewer SMs streaming; splitting a
// block over more CTAs is left to a later change.

#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kVecs = 32;        // float4 columns a row (128 floats)
constexpr int kLanes = 8;        // row lanes a CTA
constexpr int kThreads = kLanes * kVecs;

__device__ __forceinline__ void add4(float4& a, const float4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

__global__ void __launch_bounds__(kThreads)
block_rowsum_kernel(const float4* __restrict__ x, float4* __restrict__ out,
                    int bm) {
  __shared__ float4 part[kLanes][kVecs];
  const int lane = threadIdx.x / kVecs;
  const int q = threadIdx.x % kVecs;
  const float4* src = x + (int64_t)blockIdx.x * bm * kVecs + q;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
  for (int r = lane; r < bm; r += kLanes)
    add4(acc, __ldg(src + (int64_t)r * kVecs));
  part[lane][q] = acc;
  __syncthreads();
#pragma unroll
  for (int h = kLanes / 2; h > 0; h /= 2) {
    if (lane < h) add4(part[lane][q], part[lane + h][q]);
    __syncthreads();
  }
  if (lane == 0) out[(int64_t)blockIdx.x * kVecs + q] = part[0][q];
}

}  // namespace

// Launches on `stream` and returns the cudaError_t of the launch
// (0 = success); it does not synchronise.
extern "C" int lux_block_rowsum(const void* x, void* out, int64_t R, int bm,
                                void* stream) {
  if (R < 0 || bm < 1 || R % bm != 0) return (int)cudaErrorInvalidValue;
  if (R == 0) return 0;
  const int64_t rows = R / bm;
  if (rows > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  block_rowsum_kernel<<<(unsigned)rows, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(x), static_cast<float4*>(out), bm);
  return (int)cudaGetLastError();
}
