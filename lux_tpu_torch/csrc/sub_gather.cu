// S2 and S11 on Hopper: the sublane gather inside M-row blocks.
//
// Replaces scripts/profile_true.py::sub_shuffle and
// scripts/profile_shuffle.py::sub_gather (body sub_kernel in both),
// which the TPU runs as take_along_axis along the sublane axis of
// [M, 128] VMEM blocks (tpu.dynamic_gather), one block a grid step.
// Same function:
//
//   out[b*M + i, j] = x[b*M + idx[b*M + i, j], j]
//
// Inputs: x [R, 128] of 4-byte words (float32 or int32: the kernel
// moves bits, so NaN payloads come through unchanged), idx [R, 128]
// int32 in [0, M), out [R, 128]; row-major, contiguous, 16-byte
// aligned; R % M == 0 and 1 <= M <= kMaxM.  An id outside [0, M)
// writes 0: the kernel never reads outside its own block.
//
// Bound: bytes.  x and idx read once, out written once: R * 128 * 12
// bytes over the card's 3.35 TB/s.  No arithmetic.
//
// Design (simple and right; not tuned): an output word reads only its
// own column of its own block, so a CTA stages a column strip of whole
// blocks, x[rows, c0:c0+cw], in shared memory with coalesced 16 B loads,
// syncs, then reads idx and writes out over the same strip, 16 B a
// thread (four staged words a 16 B id load).  The strip is as wide as
// fits 32 KB: all 128 columns for M <= 64, with several blocks a CTA
// (64 rows; 63 for M = 3), and narrower for larger M, never below 8
// columns (32 B a row, one sector).  At M = 4,096 the 8-column strip
// is 128 KB of dynamic shared memory, one CTA of 1,024 threads an SM,
// whose load phase and gather phase do not overlap.  An M whose
// 8-column strip passes the 227 KB a block may hold (M > kMaxM) is
// refused.  The staged reads of one 16 B id hit four words of one
// column group: 2-4 way bank conflicts, below what bounds it.

#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kW = 128;                   // words a row
constexpr int kMinCols = 8;               // narrowest strip: 32 B a row
constexpr int kSmallRows = 64;            // rows a CTA when M <= 64
constexpr int kTargetBytes = 32 * 1024;   // strip size to aim for
constexpr int kMaxSmem = 232448;          // 227 KB, a block's opt-in limit
constexpr int kMaxM = kMaxSmem / (kMinCols * 4);   // 7,264 rows
constexpr int kSmallThreads = 256;
constexpr int kLargeThreads = 1024;

__global__ void __launch_bounds__(kLargeThreads)
sub_gather_kernel(const uint32_t* __restrict__ x,
                  const int32_t* __restrict__ idx,
                  uint32_t* __restrict__ out, int64_t n_blocks, int M,
                  int K, int cw) {
  extern __shared__ __align__(16) uint32_t strip[];   // [kb * M][cw]
  const int64_t b0 = (int64_t)blockIdx.x * K;         // first M-block
  const int kb = n_blocks - b0 < K ? (int)(n_blocks - b0) : K;
  const int vpr = cw / 4;                              // 16 B units a row
  const int units = kb * M * vpr;
  const int64_t row0 = b0 * M;
  const int c0 = blockIdx.y * cw;
  uint4* s4 = reinterpret_cast<uint4*>(strip);
#pragma unroll 4
  for (int u = threadIdx.x; u < units; u += blockDim.x) {
    const int r = u / vpr;
    const int64_t at = (row0 + r) * kW + c0 + 4 * (u - r * vpr);
    s4[u] = __ldg(reinterpret_cast<const uint4*>(x + at));
  }
  __syncthreads();
  const unsigned m = (unsigned)M;
#pragma unroll 4
  for (int u = threadIdx.x; u < units; u += blockDim.x) {
    const int r = u / vpr;
    const int v = u - r * vpr;
    const int64_t at = (row0 + r) * kW + c0 + 4 * v;
    const int4 id = __ldg(reinterpret_cast<const int4*>(idx + at));
    // this block's first staged row, at column group v
    const uint32_t* col = strip + (r / M) * M * cw + 4 * v;
    uint4 o;
    o.x = (unsigned)id.x < m ? col[id.x * cw + 0] : 0u;
    o.y = (unsigned)id.y < m ? col[id.y * cw + 1] : 0u;
    o.z = (unsigned)id.z < m ? col[id.z * cw + 2] : 0u;
    o.w = (unsigned)id.w < m ? col[id.w * cw + 3] : 0u;
    *reinterpret_cast<uint4*>(out + at) = o;
  }
}

}  // namespace

// Launches on `stream` and returns the cudaError_t of the launch
// (0 = success); it does not synchronise.
extern "C" int lux_sub_gather(const void* x, const void* idx, void* out,
                              int64_t R, int M, void* stream) {
  if (R < 0 || M < 1 || M > kMaxM || R % M != 0)
    return (int)cudaErrorInvalidValue;
  if (R == 0) return 0;
  int cw = kW;
  while (cw > kMinCols && (int64_t)M * cw * 4 > kTargetBytes) cw >>= 1;
  const int K = (cw == kW && M < kSmallRows) ? kSmallRows / M : 1;
  const int smem = K * M * cw * (int)sizeof(uint32_t);
  const int threads = smem > kTargetBytes ? kLargeThreads : kSmallThreads;
  const int64_t n_blocks = R / M;
  const int64_t ctas = (n_blocks + K - 1) / K;
  if (ctas > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        sub_gather_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  sub_gather_kernel<<<dim3((unsigned)ctas, kW / cw), threads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<const int32_t*>(idx),
      static_cast<uint32_t*>(out), n_blocks, M, K, cw);
  return (int)cudaGetLastError();
}
