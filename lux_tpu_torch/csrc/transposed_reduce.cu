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
// Design (simple and right; not tuned): one thread a column, blocks of
// 128 columns; a block owns wg output rows (the script's wg, the rows
// a program writes) in a [wg x 128] f32 shared accumulator indexed
// acc[(rel - row0) * 128 + column], so neighbouring threads touch
// neighbouring banks and each thread only its own column: no atomics,
// no barrier.  The loop over e reads rows of 128 columns (512 B)
// coalesced, in batches of 16 rows: the next batch's loads are issued
// before the current batch's adds, so 32 rows are in flight.  The block
// then writes its [wg, 128] tile, zeros included.  wg = W (the
// default) reads the inputs once; a smaller wg takes W / wg blocks a
// column tile, each re-reading it, as the TPU's grid does (the row
// groups of a column tile are neighbours in the grid, so the re-reads
// mostly hit L2).  Each column's sum runs in e order, as the TPU's.

#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kCols = 128;     // columns a block, one a thread
constexpr int kMaxW = 128;
constexpr int kBatch = 16;     // rows' loads in flight a thread
constexpr int kMaxColTiles = 65535;

__device__ __forceinline__ void load_rows(const float* __restrict__ v,
                                          const int32_t* __restrict__ r,
                                          int64_t e0, int64_t E, int64_t N,
                                          float (&vv)[kBatch],
                                          int (&rr)[kBatch]) {
#pragma unroll
  for (int j = 0; j < kBatch; ++j) {
    const int64_t e = e0 + j;
    rr[j] = e < E ? __ldg(r + e * N) : -1;
    vv[j] = e < E ? __ldg(v + e * N) : 0.f;
  }
}

__device__ __forceinline__ void add_rows(float* a, const float (&vv)[kBatch],
                                         const int (&rr)[kBatch], int row0,
                                         int rows) {
#pragma unroll
  for (int j = 0; j < kBatch; ++j) {
    const unsigned k = (unsigned)(rr[j] - row0);
    if (k < (unsigned)rows) a[k * kCols] += vv[j];
  }
}

__global__ void __launch_bounds__(kCols)
transposed_kernel(const float* __restrict__ vals,
                  const int32_t* __restrict__ rel, float* __restrict__ out,
                  int64_t E, int64_t N, int W, int wg) {
  extern __shared__ float acc[];   // [wg][kCols]
  const int row0 = blockIdx.x * wg;
  const int rows = W - row0 < wg ? W - row0 : wg;
  const int64_t col = (int64_t)blockIdx.y * kCols + threadIdx.x;
  if (col >= N) return;
  float* a = acc + threadIdx.x;
  for (int j = 0; j < rows; ++j) a[j * kCols] = 0.f;
  const float* v = vals + col;
  const int32_t* r = rel + col;
  // two batches of loads in flight: the next one's issued before the
  // current one's adds
  float va[kBatch], vb[kBatch];
  int ra[kBatch], rb[kBatch];
  load_rows(v, r, 0, E, N, va, ra);
  for (int64_t e0 = 0; e0 < E; e0 += 2 * kBatch) {
    load_rows(v, r, e0 + kBatch, E, N, vb, rb);
    add_rows(a, va, ra, row0, rows);
    load_rows(v, r, e0 + 2 * kBatch, E, N, va, ra);
    add_rows(a, vb, rb, row0, rows);
  }
  float* o = out + (int64_t)row0 * N + col;
  for (int j = 0; j < rows; ++j) o[(int64_t)j * N] = a[j * kCols];
}

}  // namespace

// Launches on `stream` and returns the cudaError_t of the launch
// (0 = success); it does not synchronise.
extern "C" int lux_transposed_reduce(const void* vals, const void* rel,
                                     void* out, int64_t E, int64_t N, int W,
                                     int wg, void* stream) {
  if (E < 1 || N < 0 || W < 1 || W > kMaxW || wg < 1 || wg > W)
    return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  const int64_t col_tiles = (N + kCols - 1) / kCols;
  if (col_tiles > kMaxColTiles) return (int)cudaErrorInvalidValue;
  const int groups = (W + wg - 1) / wg;
  const int smem = wg * kCols * (int)sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        transposed_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  transposed_kernel<<<dim3(groups, (unsigned)col_tiles), kCols, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vals), static_cast<const int32_t*>(rel),
      static_cast<float*>(out), E, N, W, wg);
  return (int)cudaGetLastError();
}
