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
// int32, out [R, 128]; row-major, contiguous, 16-byte aligned;
// R % M == 0 and 1 <= M <= kMaxM.  An id outside [0, M) writes 0: the
// kernel never reads outside its own block.
//
// Bound: bytes.  x and idx read once, out written once: R * 128 * 12
// bytes over the card's 3.35 TB/s.  No arithmetic.
//
// What held the first design back (2.1x the bound at M = 512,
// 3.9x at M = 4,096, where torch.gather was faster): a CTA staged an
// 8- or 16-column strip of a block, and the grid ran the blocks
// fastest, so the CTAs in flight together read and wrote 32-64 B of
// each 512 B row, the rest of the row coming from CTAs launched much
// later: partial lines in L2 and in the memory's bursts.  At M = 4,096
// one 128 KB CTA filled an SM, and nothing overlapped its load phase
// with its gather phase.
//
// Design.  The host's plan (ops/sub_gather.py ``plan``) picks one of
// two kernels from M:
// - "staged" (8 < M <= 512).  An output word reads only its own column
//   of its own block, so a tile is a column strip x[rows, c0:c0+cw] of
//   whole blocks, copied into shared memory with cp.async, then
//   gathered: all 128 columns of 64 rows of blocks for M <= 64 (the
//   first design's path), or the widest strip of one block that fits
//   64 KB, 128 B a row at M = 512 (the first design took 16-column
//   strips of 32 KB), so that three CTAs share an SM and one's copy
//   overlaps another's gather.
//   The strips of one row range are neighbouring tiles, so the CTAs in
//   flight together read and write whole 512 B rows.
// - "direct" (M <= 8 and M > 512): nothing staged; a thread reads its
//   16 B of ids and its four words straight from x through L2, and
//   each warp writes a whole row.  At M = 4,096 it beats the staged
//   strip that fits a block (8 columns, 128 KB, one CTA an SM: 0.3122
//   against 0.3056 ms) and torch.gather (0.3272); its cost is L2's:
//   every 4 B word read moves a 32 B sector.
// The gather reads one 16 B id vector a thread and writes 16 B; the
// staged reads of its four words fall on a quarter of the banks (2-4
// way conflicts), under the bytes' time.  Measured in turns by
// lux_tpu_torch/tools/probe_ab.py, with what lost (PERF.md): two
// buffers in persistent CTAs, 16 B strips (their partial sectors took
// 2.5x), clusters sharing a block through distributed shared memory,
// ids loaded while the copy is in flight, and reads through L1.

#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kW = 128;                   // words a row
constexpr int kMinCols = 8;               // narrowest strip: 32 B a row
constexpr int kMaxSmem = 232448;          // 227 KB, a block's opt-in limit
constexpr int kMaxM = 7264;               // the wrapper's MAX_M
constexpr int kMaxThreads = 1024;

enum Mode { kStaged = 0, kDirect = 1 };

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

struct Tiles {
  int64_t n_blocks;   // R / M
  int M, K;           // rows a block, blocks a tile
  int cw, lg_vpr;     // strip columns; log2 of its 16 B units a row
  int strips;         // 128 / cw
  int64_t n_tiles;    // strips * ceil(n_blocks / K)
};

// Issue the copies of tile t into buf (cp.async, not yet committed).
__device__ __forceinline__ void load_tile(const Tiles& T,
                                          const uint32_t* __restrict__ x,
                                          int64_t t, uint32_t* buf) {
  const int64_t g = t / T.strips;
  const int c0 = (int)(t - g * T.strips) * T.cw;
  const int64_t b0 = g * T.K;
  const int kb = T.n_blocks - b0 < T.K ? (int)(T.n_blocks - b0) : T.K;
  const int64_t row0 = b0 * T.M;
  const int units = (kb * T.M) << T.lg_vpr;
  const int vmask = (1 << T.lg_vpr) - 1;
  for (int u = threadIdx.x; u < units; u += blockDim.x) {
    const int r = u >> T.lg_vpr;
    cp_async16(buf + 4 * u, x + (row0 + r) * kW + c0 + 4 * (u & vmask));
  }
}

// Write unit u (16 B: row u >> lg_vpr, columns 4 (u & vmask) + 0..3
// of the strip) of the tile at rows row0.., columns c0.. from its ids.
__device__ __forceinline__ void gather_unit(const Tiles& T,
                                            uint32_t* __restrict__ out,
                                            int64_t row0, int c0, int u,
                                            int4 id, const uint32_t* strip,
                                            unsigned m) {
  const int r = u >> T.lg_vpr;
  const int v = u & ((1 << T.lg_vpr) - 1);
  // this block's first staged row, at column group v
  const int rb = T.K == 1 ? 0 : (r / T.M) * T.M;
  const uint32_t* col = strip + rb * T.cw + 4 * v;
  uint4 o;
  o.x = (unsigned)id.x < m ? col[id.x * T.cw + 0] : 0u;
  o.y = (unsigned)id.y < m ? col[id.y * T.cw + 1] : 0u;
  o.z = (unsigned)id.z < m ? col[id.z * T.cw + 2] : 0u;
  o.w = (unsigned)id.w < m ? col[id.w * T.cw + 3] : 0u;
  *reinterpret_cast<uint4*>(out + (row0 + r) * kW + c0 + 4 * v) = o;
}

// "staged": one tile a CTA, copy then gather.
__global__ void __launch_bounds__(kMaxThreads)
staged_kernel(const uint32_t* __restrict__ x, const int32_t* __restrict__ idx,
              uint32_t* __restrict__ out, Tiles T) {
  extern __shared__ __align__(16) uint32_t strip[];
  const int64_t t = blockIdx.x;
  load_tile(T, x, t, strip);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  const int64_t g = t / T.strips;
  const int c0 = (int)(t - g * T.strips) * T.cw;
  const int64_t b0 = g * T.K;
  const int kb = T.n_blocks - b0 < T.K ? (int)(T.n_blocks - b0) : T.K;
  const int64_t row0 = b0 * T.M;
  const int units = (kb * T.M) << T.lg_vpr;
  const int vmask = (1 << T.lg_vpr) - 1;
  const unsigned m = (unsigned)T.M;
#pragma unroll 4
  for (int u = threadIdx.x; u < units; u += blockDim.x) {
    const int64_t at =
        (row0 + (u >> T.lg_vpr)) * kW + c0 + 4 * (u & vmask);
    gather_unit(T, out, row0, c0, u,
                __ldg(reinterpret_cast<const int4*>(idx + at)), strip, m);
  }
}

// "direct": no staging; a thread a 16 B unit of out, in row order.
__global__ void __launch_bounds__(256)
direct_kernel(const uint32_t* __restrict__ x, const int32_t* __restrict__ idx,
              uint32_t* __restrict__ out, int64_t R, int M) {
  const int64_t units = R * (kW / 4);
  const unsigned m = (unsigned)M;
  for (int64_t u = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; u < units;
       u += (int64_t)gridDim.x * blockDim.x) {
    const int64_t row = u >> 5;
    const int c = 4 * (int)(u & 31);
    // the block's first row; 32-bit division where the rows allow it
    const int64_t b0 = R <= 0x7FFFFFFF ? (int64_t)((unsigned)row / m * m)
                                       : row - row % M;
    const uint32_t* col = x + b0 * kW + c;
    const int4 id = __ldg(reinterpret_cast<const int4*>(idx) + u);
    uint4 o;
    o.x = (unsigned)id.x < m ? __ldg(col + (int64_t)id.x * kW + 0) : 0u;
    o.y = (unsigned)id.y < m ? __ldg(col + (int64_t)id.y * kW + 1) : 0u;
    o.z = (unsigned)id.z < m ? __ldg(col + (int64_t)id.z * kW + 2) : 0u;
    o.w = (unsigned)id.w < m ? __ldg(col + (int64_t)id.w * kW + 3) : 0u;
    reinterpret_cast<uint4*>(out)[u] = o;
  }
}

}  // namespace

// Launches on `stream` and returns the cudaError_t of the launch
// (0 = success); it does not synchronise.  The plan (mode, cw, K,
// threads) comes from ops/sub_gather.py's ``plan``; a plan the kernel
// cannot run is refused with cudaErrorInvalidValue.  K is the blocks a
// staged tile.
extern "C" int lux_sub_gather(const void* x, const void* idx, void* out,
                              int64_t R, int M, int mode, int cw, int K,
                              int threads, void* stream) {
  if (R < 0 || M < 1 || M > kMaxM || R % M != 0 || K < 1 ||
      threads < 32 || threads > kMaxThreads || threads % 32 != 0)
    return (int)cudaErrorInvalidValue;
  if (cw < kMinCols || cw > kW || (cw & (cw - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  if (R == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint32_t* xp = static_cast<const uint32_t*>(x);
  const int32_t* ip = static_cast<const int32_t*>(idx);
  uint32_t* op = static_cast<uint32_t*>(out);
  if (mode == kDirect) {
    const int64_t units = R * (kW / 4);
    int64_t grid = (units + 255) / 256;
    if (grid > 0x7FFFFFFF) grid = 0x7FFFFFFF;
    direct_kernel<<<(unsigned)grid, 256, 0, st>>>(xp, ip, op, R, M);
    return (int)cudaGetLastError();
  }
  if (mode != kStaged) return (int)cudaErrorInvalidValue;
  Tiles T;
  T.n_blocks = R / M;
  T.M = M;
  T.K = K;
  T.cw = cw;
  T.lg_vpr = 0;
  while ((4 << T.lg_vpr) < cw) ++T.lg_vpr;
  T.strips = kW / cw;
  T.n_tiles = (int64_t)T.strips * ((T.n_blocks + K - 1) / K);
  const int64_t smem = (int64_t)K * M * cw * 4;
  if (smem > kMaxSmem || T.n_tiles > 0x7FFFFFFF)
    return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        staged_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  staged_kernel<<<(unsigned)T.n_tiles, threads, (size_t)smem, st>>>(xp, ip,
                                                                    op, T);
  return (int)cudaGetLastError();
}
