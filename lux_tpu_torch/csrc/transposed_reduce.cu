// S3 and S12 on Hopper: the chunk reduce on the transposed layout.
//
// Replaces scripts/profile_v3.py::reduce_v3 (body kernel) and
// scripts/profile_true.py::v3, which the TPU runs on [E, 128] VMEM
// blocks, one chunk a lane: each program compares the whole block
// against wg output rows (scalar-broadcast compares) and sums down the
// sublanes.  Same function:
//
//   out[w, n] = sum of vals[e, n] over every e with rel[e, n] == w
//
// Inputs: vals [E, N] float32, rel [E, N] int32 (lanes outside [0, W)
// add nothing; columns need not be sorted), out [W, N]; row-major,
// contiguous; 1 <= W <= 128, E >= 1, any N >= 1.  An output row that
// no entry hits is 0.
//
// Bound: bytes.  vals and rel read once, out written once:
// (8 E + 4 W) * N bytes over the card's 3.35 TB/s; one add an entry.
//
// Design.  The TPU's wg (output rows a program) is a tiling of its
// grid, which reads each input block once at any wg; here a CTA owns
// all W output rows of its columns, so every input is read once and the
// launch does not depend on wg (the wrapper checks wg and passes none).
// - One thread a column, `cols` neighbouring columns a CTA (a warp
//   reads 128 B of a row) by `slices` slices of the E rows
//   (threadIdx.y): thread (x, y) adds rows [y slice, (y + 1) slice) of
//   its column into its own column of a [W x cols] f32 accumulator in
//   shared memory (no atomics, no bank conflicts).  The plan lives in
//   lux_tpu_torch/ops/transposed_reduce.py `plan` (default 64 columns
//   by 2 slices: 128 threads and 64 KB a CTA, 1,024 CTAs at the probe's
//   N = 65,536), which the CPU tests check.
// - Loads are streaming (evict-first), in batches of 16 rows, the next
//   batch issued before the current one's adds.  A load past the
//   slice's end is skipped by a branch, not a select: the select form
//   was 10% slower (PERF.md).
// - After a barrier, thread (x, y) writes rows y, y + slices, ... of
//   its column, each the sum of the slices' accumulators in slice
//   order.  No atomics: two launches give the same bits.  A column's
//   sum runs in row order within a slice, then over the slices (within
//   the probes' rtol 1e-5).
// - Measured on the card (PERF.md): the kernel takes about 1.05x the
//   time of its loads alone; register runs of equal lanes, one warp a
//   32-column strip, deeper or shallower batches, cached loads and a
//   shared-memory ring fed by bulk copies were each as fast or slower.

#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kMaxW = 128;
constexpr int kMaxThreads = 384;   // columns x slices a CTA
constexpr int kBatch = 16;         // rows' loads in a batch
constexpr int kMaxSmem = 227 * 1024;

__device__ __forceinline__ void load_rows(const float* __restrict__ v,
                                          const int32_t* __restrict__ r,
                                          int64_t e0, int64_t e1, int64_t N,
                                          float (&vv)[kBatch],
                                          int (&rr)[kBatch]) {
#pragma unroll
  for (int j = 0; j < kBatch; ++j) {
    const int64_t e = e0 + j;
    if (e < e1) {   // a branch, not selects: 10% faster (PERF.md)
      rr[j] = __ldcs(r + e * N);
      vv[j] = __ldcs(v + e * N);
    } else {
      rr[j] = -1;   // adds nothing: vv[j] is not read
    }
  }
}

// Adds a batch of rows into the thread's column of its accumulator
// (stride: the CTA's columns); lanes outside [0, W) add nothing.
__device__ __forceinline__ void add_rows(float* a, const float (&vv)[kBatch],
                                         const int (&rr)[kBatch], int W,
                                         int stride) {
#pragma unroll
  for (int j = 0; j < kBatch; ++j) {
    const unsigned k = (unsigned)rr[j];
    if (k < (unsigned)W) a[k * stride] += vv[j];
  }
}

// blockDim (C, K): thread (x, y) reads column blockIdx.x * C + x over
// rows [y slice, (y + 1) slice); acc [K][W][C]
__global__ void __launch_bounds__(kMaxThreads)
transposed_kernel(const float* __restrict__ vals,
                  const int32_t* __restrict__ rel, float* __restrict__ out,
                  int64_t E, int64_t N, int W, int slice) {
  extern __shared__ float acc[];
  const int C = blockDim.x;
  const int K = blockDim.y;
  const int64_t col = (int64_t)blockIdx.x * C + threadIdx.x;
  // a column past N reads column N - 1 (its sums are not written)
  const int64_t src = col < N ? col : N - 1;
  const int64_t e0 = (int64_t)threadIdx.y * slice;
  const int64_t e1 = e0 + slice < E ? e0 + slice : E;
  const float* v = vals + src;
  const int32_t* r = rel + src;
  float va[kBatch], vb[kBatch];
  int ra[kBatch], rb[kBatch];
  load_rows(v, r, e0, e1, N, va, ra);
  // the accumulator zeroed while the first batch is in flight
  float* a = acc + threadIdx.y * W * C + threadIdx.x;
  for (int k = 0; k < W; ++k) a[k * C] = 0.f;
  for (int64_t e = e0; e < e1; e += 2 * kBatch) {
    load_rows(v, r, e + kBatch, e1, N, vb, rb);
    add_rows(a, va, ra, W, C);
    load_rows(v, r, e + 2 * kBatch, e1, N, va, ra);
    add_rows(a, vb, rb, W, C);
  }
  __syncthreads();
  if (col >= N) return;
  // thread (x, y) writes rows y, y + K, ... of its column, each the sum
  // of the slices in slice order; a warp writes 128 B of a row
  for (int k = threadIdx.y; k < W; k += K) {
    float s = acc[k * C + threadIdx.x];
    for (int y = 1; y < K; ++y) s += acc[(y * W + k) * C + threadIdx.x];
    out[(int64_t)k * N + col] = s;
  }
}

}  // namespace

// Launches on `stream` and returns the cudaError_t of the launch
// (0 = success); it does not synchronise.  A CTA takes `cols`
// neighbouring columns and `slices` slices of `slice` rows (the last
// may be shorter): the slices must cover E, none empty.
extern "C" int lux_transposed_reduce(const void* vals, const void* rel,
                                     void* out, int64_t E, int64_t N, int W,
                                     int cols, int slices, int slice,
                                     void* stream) {
  if (E < 1 || N < 0 || W < 1 || W > kMaxW || cols < 1 || slices < 1 ||
      cols * slices > kMaxThreads || slice < 1 ||
      (int64_t)slices * slice < E || (int64_t)(slices - 1) * slice >= E)
    return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  const int64_t ctas = (N + cols - 1) / cols;
  if (ctas > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  const int smem = slices * W * cols * (int)sizeof(float);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        transposed_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  transposed_kernel<<<(unsigned)ctas, dim3(cols, slices), smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vals), static_cast<const int32_t*>(rel),
      static_cast<float*>(out), E, N, W, slice);
  return (int)cudaGetLastError();
}
