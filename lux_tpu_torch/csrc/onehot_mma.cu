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
// empty, so the lanes go into both the M and the N dimensions: lane
// w = 16 n + m, and each k-step of 16 entries issues three
// mma.sync.m16n8k16 (bf16 in, f32 accumulate), one a part p:
//   D_p[m, n] += A[m, e] * B_p[e, n],  A[m, e] = (rel[e] % 16 == m),
//   B_p[e, n] = part p of vals[e] where rel[e] / 16 == n, else 0,
// the parts being hi, mid and lo, the three bf16 parts of vals[e]
// (hi = bf16(v), mid = bf16(v - hi), lo = bf16(v - hi - mid): 24 bits
// of significand, so f32 values come through); out[16 n + m] =
// (D_hi + D_mid) + D_lo.  A lane outside [0, W) has no row in A.  A
// thread holds 12 accumulators (the earlier form, D[W x 8] over eight
// m-tiles, held 32, five of each eight columns zero), and every k-step
// issues the same three mma: no branches on which tiles a step hits.
//
// Bound: bytes.  vals and rel read once, out written once: C * (8 E +
// 4 W) bytes over 3.35 TB/s; the mma work is 3 x 4,096 operations a
// (chunk, k-step), at 989 TFLOP/s bf16: 29% of the bytes' time at the
// script's [81,920 x 512].
//
// What held the earlier designs back.  The first (0.4495 ms, 4.0x the
// bound, where one scatter_add took 0.3226): a warp loaded its chunk,
// then staged it, then computed, so its loads waited on its own
// compute; it rounded each value to bf16 six times where three do;
// each hit m-tile built its A fragment with eight compares and
// selects.  The second (copies in flight, fragments from bf16x2
// compares, the same D[W x 8] product) took 0.3395-0.3506 ms: with
// copies taken out it
// still took 0.2588, without its mma 0.3172.  Its 80 registers (32 of
// them accumulators) allowed 24 warps an SM, and each k-step branched
// on each of its eight m-tiles.
//
// Design.  Persistent CTAs of eight warps, three a multiprocessor; a
// warp walks its chunks 256 entries (a stage) at a time, with the next
// two stages' vals and rel in flight into a ring of two raw buffers in
// shared memory (cp.async, 16 B a lane where rows allow, no registers)
// while the tensor cores run the current one.  Staging turns each
// entry once into its lane % 16 and lane / 16 as bf16 (-1 outside
// [0, W)) and its three bf16 parts, two entries a conversion
// (cvt.rn.bf16x2.f32), in fragment order: one 16 B shared load (the
// same address across a group: a broadcast) gives a thread one plane's
// pairs for two k-steps.  Each k-step: six bf16x2 equality compares
// (__heq2 gives 1.0 or 0.0 a half: A itself, and B's mask of the
// thread's column), six bf16x2 products (a part times 1.0 or 0.0,
// exact) and three mma.  Two accumulator sets alternating by k-step
// parity, so that no mma waits on the one before it, measured 10%
// slower (more registers, fewer warps): the three parts' mma already
// interleave.
//
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kWarps = 8;          // warps a block, each its own chunks
// register budget: 85 a thread (72 used, no spills); three blocks an
// SM beat four (64 registers) and two by 1-2% in every turn (PERF.md)
constexpr int kBlocksPerSm = 3;
constexpr int kStage = 256;        // entries a warp stages at a time
constexpr int kSteps = kStage / 16;
constexpr int kPlane = kStage / 2; // words a plane: bf16 pairs
constexpr int kRaw = 2 * kStage;   // words a raw buffer: vals, rel
// a warp's shared memory, in words: two raw buffers and five planes
// (lane % 16 pairs; lane / 16 pairs; hi, mid, lo pairs)
constexpr int kWarpWords = 2 * kRaw + 5 * kPlane;
constexpr int kSmem = kWarps * kWarpWords * 4;
constexpr int kMaxW = 128;
constexpr int kParts = 3;

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

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ __nv_bfloat162 as_bf2(uint32_t v) {
  return *reinterpret_cast<__nv_bfloat162*>(&v);
}

// Both halves 1.0 where equal, 0.0 where not (bf16x2).
__device__ __forceinline__ uint32_t eq2(uint32_t a, uint32_t b) {
  return as_u32(__heq2(as_bf2(a), as_bf2(b)));
}

// a * b, both bf16x2: here a part times 1.0 or 0.0, so exact.
__device__ __forceinline__ uint32_t mul2(uint32_t a, uint32_t b) {
  return as_u32(__hmul2(as_bf2(a), as_bf2(b)));
}

// Two floats as a bf16 pair, a in the low half: one cvt.rn.bf16x2.f32.
__device__ __forceinline__ uint32_t pack2(float a, float b) {
  return as_u32(__floats2bfloat162_rn(a, b));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// Copy stage s of chunk c (if c < C) into raw: vals in words [0, 256),
// rel in [256, 512); entries past E are not copied (staging masks them).
__device__ __forceinline__ void issue_stage(uint32_t* raw,
                                            const float* __restrict__ vals,
                                            const int32_t* __restrict__ rel,
                                            int64_t c, int s, int64_t C,
                                            int64_t E, bool vec, int lane) {
  if (c < C) {
    const int64_t k0 = (int64_t)s * kStage;
    const int n = E - k0 < kStage ? (int)(E - k0) : kStage;
    const float* v = vals + c * E + k0;
    const int32_t* r = rel + c * E + k0;
    if (vec) {     // E % 4 == 0 and aligned rows: n % 4 == 0 too
#pragma unroll
      for (int i = 0; i < kStage / 128; ++i) {
        const int e = 4 * lane + 128 * i;
        if (e < n) {
          cp_async16(raw + e, v + e);
          cp_async16(raw + kStage + e, r + e);
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < kStage / 32; ++i) {
        const int e = lane + 32 * i;
        if (e < n) {
          cp_async4(raw + e, v + e);
          cp_async4(raw + kStage + e, r + e);
        }
      }
    }
  }
  cp_async_commit();   // an empty group past the warp's last chunk
}

// Turn lane's entries 8 lane .. 8 lane + 7 of the raw stage (n entries
// live) into the planes, in fragment order.
__device__ __forceinline__ void stage_planes(const uint32_t* raw, int n,
                                             int W, uint32_t* planes,
                                             int lane) {
  const int e0 = 8 * lane;
  const float4 va = *reinterpret_cast<const float4*>(raw + e0);
  const float4 vb = *reinterpret_cast<const float4*>(raw + e0 + 4);
  const int4 ra = *reinterpret_cast<const int4*>(raw + kStage + e0);
  const int4 rb = *reinterpret_cast<const int4*>(raw + kStage + e0 + 4);
  const float v[8] = {va.x, va.y, va.z, va.w, vb.x, vb.y, vb.z, vb.w};
  const int r[8] = {ra.x, ra.y, ra.z, ra.w, rb.x, rb.y, rb.z, rb.w};
  // k-step lane >> 1, pairs 4 (lane & 1) + q: word 16 (lane >> 2) +
  // 4 q + (lane & 3) of each plane (the compute loop's 16 B reads)
  const int at = 16 * (lane >> 2) + (lane & 3);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    float m[2], t[2], x[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = 2 * q + h;
      const bool live = e0 + j < n && r[j] >= 0 && r[j] < W;
      m[h] = live ? (float)(r[j] & 15) : -1.f;
      t[h] = live ? (float)(r[j] >> 4) : -1.f;
      x[h] = e0 + j < n ? v[j] : 0.f;     // stale words past E: 0
    }
    const uint32_t hi = pack2(x[0], x[1]);
    const float r0 = x[0] - __uint_as_float(hi << 16);
    const float r1 = x[1] - __uint_as_float(hi & 0xFFFF0000u);
    const uint32_t mid = pack2(r0, r1);
    const uint32_t lo = pack2(r0 - __uint_as_float(mid << 16),
                              r1 - __uint_as_float(mid & 0xFFFF0000u));
    planes[at + 4 * q] = pack2(m[0], m[1]);
    planes[kPlane + at + 4 * q] = pack2(t[0], t[1]);
    planes[2 * kPlane + at + 4 * q] = hi;
    planes[3 * kPlane + at + 4 * q] = mid;
    planes[4 * kPlane + at + 4 * q] = lo;
  }
}

__global__ void __launch_bounds__(kWarps * 32, kBlocksPerSm)
onehot_kernel(const float* __restrict__ vals, const int32_t* __restrict__ rel,
              float* __restrict__ out, int64_t C, int64_t E, int W) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;     // the fragment's group: A/D row, B column
  const int tig = lane & 3;    // thread in group: A column / B row pair
  uint32_t* raw = smem + warp * kWarpWords;         // two raw buffers
  const uint32_t* planes = raw + 2 * kRaw;
  // A rows g and g + 8, and B's column g, as bf16 pairs
  const uint32_t rg = pack2((float)g, (float)g);
  const uint32_t rg8 = pack2((float)(g + 8), (float)(g + 8));
  const bool vec = E % 4 == 0 && (uintptr_t)vals % 16 == 0 &&
                   (uintptr_t)rel % 16 == 0;
  const int n_st = (int)((E + kStage - 1) / kStage);
  const int64_t stride = (int64_t)gridDim.x * kWarps;
  // the current item (c, s) and the two whose copies are in flight
  int64_t c = (int64_t)blockIdx.x * kWarps + warp, c1 = c, c2;
  int s = 0, s1 = 0, s2;
  auto next = [&](int64_t& cc, int& ss) {
    if (++ss == n_st) { ss = 0; cc += stride; }
  };
  next(c1, s1);
  c2 = c1; s2 = s1;
  next(c2, s2);
  issue_stage(raw, vals, rel, c, s, C, E, vec, lane);
  issue_stage(raw + kRaw, vals, rel, c1, s1, C, E, vec, lane);
  float d[kParts][4];
  for (int i = 0; c < C; ++i) {
    uint32_t* buf = raw + (i & 1) * kRaw;
    const int64_t left = E - (int64_t)s * kStage;
    const int n = left < kStage ? (int)left : kStage;
    cp_async_wait1();   // every group but the newest: this stage's
    __syncwarp();       // ... from every lane; the last compute is done
    stage_planes(buf, n, W, raw + 2 * kRaw, lane);
    __syncwarp();
    issue_stage(buf, vals, rel, c2, s2, C, E, vec, lane);
    if (s == 0) {
#pragma unroll
      for (int p = 0; p < kParts; ++p)
        d[p][0] = d[p][1] = d[p][2] = d[p][3] = 0.f;
    }
    const int steps = (n + 15) / 16;
#pragma unroll
    for (int sp = 0; sp < kSteps / 2; ++sp) {
      if (2 * sp >= steps) break;
      // k-steps 2 sp (x: entries 2 tig, + 1; y: 2 tig + 8, + 9) and
      // 2 sp + 1 (z, w) of each plane
      const int at = 16 * sp + 4 * tig;
      const uint4 lm = *reinterpret_cast<const uint4*>(planes + at);
      const uint4 lt = *reinterpret_cast<const uint4*>(planes + kPlane + at);
      uint4 pv[kParts];
#pragma unroll
      for (int p = 0; p < kParts; ++p)
        pv[p] = *reinterpret_cast<const uint4*>(planes + (2 + p) * kPlane +
                                                at);
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const uint32_t mlo = k ? lm.z : lm.x, mhi = k ? lm.w : lm.y;
        const uint32_t tlo = k ? lt.z : lt.x, thi = k ? lt.w : lt.y;
        const uint32_t a0 = eq2(mlo, rg), a1 = eq2(mlo, rg8);
        const uint32_t a2 = eq2(mhi, rg), a3 = eq2(mhi, rg8);
        const uint32_t bl = eq2(tlo, rg), bh = eq2(thi, rg);
#pragma unroll
        for (int p = 0; p < kParts; ++p)
          mma_bf16(d[p], a0, a1, a2, a3,
                   mul2(k ? pv[p].z : pv[p].x, bl),
                   mul2(k ? pv[p].w : pv[p].y, bh));
      }
    }
    if (s + 1 == n_st) {
      // D[m, n] is lane 16 n + m: this thread holds rows g, g + 8 of
      // columns 2 tig, 2 tig + 1
      float* o = out + c * W;
      const int w[4] = {32 * tig + g, 32 * tig + 16 + g, 32 * tig + 8 + g,
                        32 * tig + 24 + g};
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (w[j] < W) o[w[j]] = (d[0][j] + d[1][j]) + d[2][j];
    }
    c = c1; s = s1;
    c1 = c2; s1 = s2;
    next(c2, s2);
  }
}

}  // namespace

// Launches on `stream` and returns the cudaError_t of the launch
// (0 = success); it does not synchronise.  Persistent grid: as many
// blocks as the card holds at once.
extern "C" int lux_onehot_reduce(const void* vals, const void* rel,
                                 void* out, int64_t C, int64_t E, int W,
                                 void* stream) {
  if (C < 0 || E < 1 || W < 1 || W > kMaxW) return (int)cudaErrorInvalidValue;
  if (C == 0) return 0;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(onehot_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, onehot_kernel, kWarps * 32, kSmem);
  if (err != cudaSuccess) return (int)err;
  const int64_t want = (C + kWarps - 1) / kWarps;
  const int64_t most = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
  const unsigned blocks = (unsigned)(want < most ? want : most);
  onehot_kernel<<<blocks, kWarps * 32, kSmem,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vals), static_cast<const int32_t*>(rel),
      static_cast<float*>(out), C, E, W);
  return (int)cudaGetLastError();
}
