// S9 on Hopper: the per-chunk reduce as a one-hot product on the
// tensor cores, with mma.sync issued by hand.
//
// Replaces scripts/profile_kernel.py::mxu (body _mxu_kernel), which the
// TPU runs as one [1, E] x [E, W] matrix-unit product a chunk, the
// [E, W] one-hot built from rel by a compare.  Same function:
//
//   out[c, w] = sum of vals[c, e] over every e with rel[c, e] == w
//
// Inputs: vals [C, E] float32 (finite: a pad's value meets a zero of
// the one-hot, and 0 * inf is NaN on both sides), rel [C, E] int32
// (lanes outside [0, W), the script's pad W among them, add nothing;
// rows need not be sorted), out [C, W]; row-major, contiguous;
// 1 <= W <= 128, any C >= 1, E >= 1.
//
// Form.  A [1, E] x [E, W] product leaves 15 of an mma's 16 rows
// empty, so each chunk is D[W x 8] = A^T[W x E] * B[E x 8]:
// - A[w, e] = (rel[e] == w), bf16 0 or 1, built in registers (exact);
// - B[e, 0..2] = hi, mid and lo, the three bf16 parts of vals[e]
//   (hi = bf16(v), mid = bf16(v - hi), lo = bf16(v - hi - mid): 24
//   bits of significand, so f32 values come through), columns 3-7 zero;
// - D accumulates in f32 across the chunk's k-steps and out[w] =
//   (D[w, 0] + D[w, 1]) + D[w, 2].
// One warp a chunk.  The warp stages kStage entries of its chunk at a
// time in shared memory: each lane loads 16 of them, coalesced (entry
// lane + 32 i), all 32 loads in flight at once, and stores the lane id
// (-1 outside [0, W)) and the value's three bf16 parts; a warp OR per
// pair of k-steps records which 16-lane m-tiles the step's entries hit.
// Then, for each k-step of 16 entries, the warp issues
// mma.sync.m16n8k16 (bf16 in, f32 accumulate) once for each m-tile of
// W that the step hits (sorted rows hit one or two of the eight), and
// none for the others, whose product is zero: the A fragment is the
// one-hot compare of the step's staged lane ids, the B fragment two
// 32-bit loads of staged parts.
//
// Bound: bytes on these shapes.  vals and rel read once, out written
// once: C * (8 E + 4 W) bytes over 3.35 TB/s; the mma work issued is
// 4,096 operations a (chunk, k-step, m-tile hit), at 989 TFLOP/s bf16.
//
// Precision: the one-hot products are exact, each part's sum is an f32
// accumulation in the tensor core, and the three parts' sums add in
// f32: agreement to a tolerance (rtol 1e-5), not in bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kWarps = 4;        // chunks a block
constexpr int kMTiles = 8;       // 16-lane m-tiles of W <= 128
constexpr int kStage = 512;      // entries a warp stages at a time
constexpr int kMaxW = 16 * kMTiles;
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kOne = 0x3F80u;   // bf16 1.0
constexpr int64_t kMaxBlocks = 1 << 20;

__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Part `k` (0 hi, 1 mid, 2 lo) of v as bf16 bits.
__device__ __forceinline__ uint32_t split_part(float v, int k) {
  const __nv_bfloat16 hi = __float2bfloat16_rn(v);
  if (k == 0) return __bfloat16_as_ushort(hi);
  const float r1 = v - __bfloat162float(hi);
  const __nv_bfloat16 mid = __float2bfloat16_rn(r1);
  if (k == 1) return __bfloat16_as_ushort(mid);
  return __bfloat16_as_ushort(__float2bfloat16_rn(r1 - __bfloat162float(mid)));
}

// Two one-hot bf16 elements in one register: low half entry r0, high r1.
__device__ __forceinline__ uint32_t onehot2(int r0, int r1, int w) {
  return (r0 == w ? kOne : 0u) | (r1 == w ? kOne << 16 : 0u);
}

__global__ void __launch_bounds__(kWarps * 32)
onehot_kernel(const float* __restrict__ vals, const int32_t* __restrict__ rel,
              float* __restrict__ out, int64_t C, int64_t E, int W) {
  __shared__ int32_t s_rel[kWarps][kStage];
  __shared__ __align__(4) uint16_t s_part[kWarps][3][kStage];
  __shared__ uint32_t s_hit[kWarps][kStage / 32];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;     // the fragment's group: A/D row, B column
  const int tig = lane & 3;    // thread in group: A column / B row pair
  int32_t* srel = s_rel[warp];
  // B's parts for this thread's column g (columns 3-7 are zero)
  const uint32_t* spart =
      reinterpret_cast<const uint32_t*>(s_part[warp][g < 3 ? g : 0]);
  for (int64_t c = (int64_t)blockIdx.x * kWarps + warp; c < C;
       c += (int64_t)gridDim.x * kWarps) {
    const float* v = vals + c * E;
    const int32_t* r = rel + c * E;
    float d[kMTiles][4];
#pragma unroll
    for (int mt = 0; mt < kMTiles; ++mt)
      d[mt][0] = d[mt][1] = d[mt][2] = d[mt][3] = 0.f;
    for (int64_t k0 = 0; k0 < E; k0 += kStage) {
      int rl[kStage / 32];
      float vv[kStage / 32];
#pragma unroll
      for (int i = 0; i < kStage / 32; ++i) {
        const int64_t e = k0 + lane + 32 * i;
        rl[i] = e < E ? __ldg(r + e) : -1;
        vv[i] = e < E ? __ldg(v + e) : 0.f;
      }
      __syncwarp();   // the previous stage's reads are done
#pragma unroll
      for (int i = 0; i < kStage / 32; ++i) {
        const int x = rl[i] >= 0 && rl[i] < W ? rl[i] : -1;
        const int at = lane + 32 * i;
        srel[at] = x;
#pragma unroll
        for (int k = 0; k < 3; ++k)
          s_part[warp][k][at] = (uint16_t)split_part(vv[i], k);
        // lanes 0-15 hold k-step 2 i, lanes 16-31 k-step 2 i + 1
        const uint32_t hit = __reduce_or_sync(
            kFull, x >= 0 ? 1u << ((x >> 4) + (lane >> 4) * 8) : 0u);
        if (lane == 0) s_hit[warp][i] = hit;
      }
      __syncwarp();
      const int steps = (int)((E - k0 < kStage ? E - k0 : kStage) + 15) / 16;
      for (int st = 0; st < steps; ++st) {
        const uint32_t hit = (s_hit[warp][st >> 1] >> ((st & 1) * 8)) & 0xFFu;
        if (!hit) continue;   // warp-uniform
        const int at = 16 * st + 2 * tig;
        const int2 lo = *reinterpret_cast<const int2*>(srel + at);
        const int2 hi = *reinterpret_cast<const int2*>(srel + at + 8);
        const uint32_t b0 = g < 3 ? spart[at >> 1] : 0u;
        const uint32_t b1 = g < 3 ? spart[(at + 8) >> 1] : 0u;
#pragma unroll
        for (int mt = 0; mt < kMTiles; ++mt) {
          if (!((hit >> mt) & 1u)) continue;
          const int w0 = mt * 16 + g;
          const int w1 = w0 + 8;
          mma_bf16(d[mt], onehot2(lo.x, lo.y, w0), onehot2(lo.x, lo.y, w1),
                   onehot2(hi.x, hi.y, w0), onehot2(hi.x, hi.y, w1), b0, b1);
        }
      }
    }
    // D[w, n]: thread tig 0 holds columns 0 and 1 of rows g and g + 8,
    // thread tig 1 column 2
    float* o = out + c * W;
#pragma unroll
    for (int mt = 0; mt < kMTiles; ++mt) {
      const float lo0 = __shfl_down_sync(kFull, d[mt][0], 1);
      const float lo8 = __shfl_down_sync(kFull, d[mt][2], 1);
      if (tig == 0) {
        const int w0 = mt * 16 + g;
        if (w0 < W) o[w0] = (d[mt][0] + d[mt][1]) + lo0;
        if (w0 + 8 < W) o[w0 + 8] = (d[mt][2] + d[mt][3]) + lo8;
      }
    }
  }
}

}  // namespace

// Launches on `stream` and returns the cudaError_t of the launch
// (0 = success); it does not synchronise.
extern "C" int lux_onehot_reduce(const void* vals, const void* rel,
                                 void* out, int64_t C, int64_t E, int W,
                                 void* stream) {
  if (C < 0 || E < 1 || W < 1 || W > kMaxW) return (int)cudaErrorInvalidValue;
  if (C == 0) return 0;
  const int64_t want = (C + kWarps - 1) / kWarps;
  const unsigned blocks = (unsigned)(want < kMaxBlocks ? want : kMaxBlocks);
  onehot_kernel<<<blocks, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vals), static_cast<const int32_t*>(rel),
      static_cast<float*>(out), C, E, W);
  return (int)cudaGetLastError();
}
