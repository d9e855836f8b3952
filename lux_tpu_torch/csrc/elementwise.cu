// S4 and S5 on Hopper: the TPU probe scripts' elementwise bodies, one
// templated kernel.
//
// Replaces scripts/profile_true.py::chain (S4, body chain_kernel) and
// the `run` that scripts/profile_vpu.py::mk builds around a body (S5:
// `a + b`, chain10, cmpsel16, cmpmul16), which the TPU runs on
// [1024, 128] VMEM blocks on its vector unit.  Bodies, by the id the C
// entry takes (each element alone; the output has the first input's
// dtype):
//
//   0 add        a + b                                 f32, f32
//   1 chain10    10 x (a = a + b)                      f32, f32
//   2 chain10    the same in bf16: each add in f32,     bf16, bf16
//                rounded to bf16 (round to nearest even)
//   3 chain32    acc = v; 32 x (acc = acc * c + v),     f32 (one input)
//                c = 1.0000001f
//   4 cmpsel16   sum over wd < 16 of (r == wd ? v : 0)  f32, int32
//   5 cmpmul16   sum over wd < 16 of v * (r == wd)      f32, int32
//
// Every step rounds as torch's eager ops do, one op at a time:
// __fmul_rn and __fadd_rn keep -O3 from contracting chain32's step into
// an FMA, the 16 rounds stay 16 rounds (no select folding, so a NaN or
// -0.0 input gives the same bits), and bf16 rounds after every add.
// So each body is bit-equal to its plain PyTorch version on the card.
//
// Inputs: a, b (b may be a itself: the scripts' `x, x`; chain32 takes
// b = a and ignores it) and out, contiguous, 16-byte aligned, n
// elements each, any n >= 0.
//
// Bound: bytes.  Each distinct input read once and out written once:
// 8 n bytes for chain32 and for an aliased f32 pair, 12 n for two
// distinct 4-byte inputs, 4 n for an aliased bf16 pair, over the
// card's 3.35 TB/s.  The heaviest body, chain32, issues 64 f32
// instructions an element (no FMA), which at the card's published f32
// rate still take less than its bytes.
//
// Design.  A tile is kThreads x U 16 B vectors (4 f32 or 8 bf16 each;
// U = 1, and 2 for chain32, whose 32 dependent steps an element want
// more elements in flight); one CTA a tile, so the grid is
// ceil(n / V / tile) CTAs (the loop over tiles runs once unless
// kMaxBlocks caps the grid).  A thread issues its U loads of each
// input (one when b == a), neighbouring threads on neighbouring
// vectors, before its first store.  Loads go through the read-only
// path (`ld.global.nc`), stores are plain.  This measured fastest on
// the card (PERF.md): more vectors a thread, streaming (evict-first)
// hints, a persistent grid and a bulk-copy (TMA) ring through shared
// memory were each as fast or slower; `x + x` then runs at the speed of
// torch.add and of a plain copy (lux_tpu_torch/tools/probe_ab.py).  The n % V tail is done element by
// element by the first CTA.  bf16 chain10 adds two values with one
// `add.rn.bf16x2` (sm_90) and converts nothing: the f32 sum of two
// bf16 values rounded to bf16 equals their exact sum rounded once to
// bf16 (double rounding is innocuous for addition when 24 >= 2 x 8 +
// 2), so the bits equal torch's for every finite input; a NaN's
// payload may differ (tests/test_torch_kernel_plans.py checks the
// identity over every bf16 pattern of one operand).

#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 1;         // 16 B vectors a thread, but for chain32:
constexpr int kUnrollChain32 = 2;  // 32 dependent steps an element
constexpr int64_t kMaxBlocks = 0x7FFFFFFF;   // the grid's x limit
constexpr float kChainC = 1.0000001f;   // scripts/profile_true.py:171

struct Add {
  using A = float;
  using B = float;
  __device__ static float apply(float a, float b) { return __fadd_rn(a, b); }
};

struct Chain10 {
  using A = float;
  using B = float;
  __device__ static float apply(float a, float b) {
#pragma unroll
    for (int i = 0; i < 10; ++i) a = __fadd_rn(a, b);
    return a;
  }
};

// two bf16 sums, each the exact sum rounded once to nearest even
__device__ __forceinline__ uint32_t add_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// bf16 values ride as their 16 raw bits, two to a 32-bit word
struct Chain10Bf16 {
  using A = uint16_t;
  using B = uint16_t;
  __device__ static uint32_t apply2(uint32_t a, uint32_t b) {
#pragma unroll
    for (int i = 0; i < 10; ++i) a = add_bf16x2(a, b);
    return a;
  }
  __device__ static uint16_t apply(uint16_t a, uint16_t b) {
    return (uint16_t)apply2(a, b);    // the high halves add 0 + 0
  }
};

struct Chain32 {
  using A = float;
  using B = float;
  __device__ static float apply(float v, float) {
    float acc = v;
#pragma unroll
    for (int i = 0; i < 32; ++i) acc = __fadd_rn(__fmul_rn(acc, kChainC), v);
    return acc;
  }
};

struct CmpSel16 {
  using A = float;
  using B = int32_t;
  __device__ static float apply(float v, int32_t r) {
    float acc = 0.f;
#pragma unroll
    for (int wd = 0; wd < 16; ++wd) acc = __fadd_rn(acc, r == wd ? v : 0.f);
    return acc;
  }
};

struct CmpMul16 {
  using A = float;
  using B = int32_t;
  __device__ static float apply(float v, int32_t r) {
    float acc = 0.f;
#pragma unroll
    for (int wd = 0; wd < 16; ++wd)
      acc = __fadd_rn(acc, __fmul_rn(v, r == wd ? 1.f : 0.f));
    return acc;
  }
};

// 16 B vectors a thread, each loaded before the first store
template <class Body>
struct Unroll {
  static constexpr int value = kUnroll;
};

template <>
struct Unroll<Chain32> {
  static constexpr int value = kUnrollChain32;
};

// One 16 B vector of each input to one of the output, element by element
template <class Body>
__device__ __forceinline__ uint4 apply_vec(uint4 a, uint4 b) {
  using A = typename Body::A;
  using B = typename Body::B;
  constexpr int V = 16 / sizeof(A);
  union VA { uint4 u; A e[V]; };
  union VB { uint4 u; B e[V]; };
  VA va, vo;
  VB vb;
  va.u = a;
  vb.u = b;
#pragma unroll
  for (int k = 0; k < V; ++k) vo.e[k] = Body::apply(va.e[k], vb.e[k]);
  return vo.u;
}

template <>
__device__ __forceinline__ uint4 apply_vec<Chain10Bf16>(uint4 a, uint4 b) {
  return make_uint4(Chain10Bf16::apply2(a.x, b.x),
                    Chain10Bf16::apply2(a.y, b.y),
                    Chain10Bf16::apply2(a.z, b.z),
                    Chain10Bf16::apply2(a.w, b.w));
}

template <class Body>
__global__ void __launch_bounds__(kThreads)
elementwise_kernel(const typename Body::A* __restrict__ a,
                   const typename Body::B* __restrict__ b,
                   typename Body::A* __restrict__ out, int64_t n) {
  static_assert(sizeof(typename Body::A) == sizeof(typename Body::B),
                "inputs share one vector width");
  constexpr int V = 16 / sizeof(typename Body::A);
  constexpr int U = Unroll<Body>::value;
  constexpr int64_t kTile = (int64_t)kThreads * U;
  const bool same = static_cast<const void*>(a) == static_cast<const void*>(b);
  const uint4* a4 = reinterpret_cast<const uint4*>(a);
  const uint4* b4 = reinterpret_cast<const uint4*>(b);
  uint4* o4 = reinterpret_cast<uint4*>(out);
  const int64_t nvec = n / V;
  const int64_t tiles = (nvec + kTile - 1) / kTile;
  for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int64_t i0 = t * kTile + threadIdx.x;
    uint4 ua[U], ub[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int64_t i = i0 + u * kThreads;
      if (i < nvec) {
        ua[u] = __ldg(a4 + i);
        ub[u] = same ? ua[u] : __ldg(b4 + i);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int64_t i = i0 + u * kThreads;
      if (i < nvec) o4[i] = apply_vec<Body>(ua[u], ub[u]);
    }
  }
  const int64_t e = nvec * V + threadIdx.x;    // the tail, n % V elements
  if (blockIdx.x == 0 && e < n) out[e] = Body::apply(a[e], b[e]);
}

template <class Body>
int launch(const void* a, const void* b, void* out, int64_t n,
           cudaStream_t stream) {
  constexpr int V = 16 / sizeof(typename Body::A);
  constexpr int64_t kTile = (int64_t)kThreads * Unroll<Body>::value;
  int64_t blocks = (n / V + kTile - 1) / kTile;
  if (blocks < 1) blocks = 1;                  // the tail alone
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  elementwise_kernel<Body><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const typename Body::A*>(a),
      static_cast<const typename Body::B*>(b),
      static_cast<typename Body::A*>(out), n);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches body `body` (ids above) on `stream` and returns the
// cudaError_t of the launch (0 = success); it does not synchronise.
extern "C" int lux_elementwise(int body, const void* a, const void* b,
                               void* out, int64_t n, void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (body) {
    case 0: return launch<Add>(a, b, out, n, s);
    case 1: return launch<Chain10>(a, b, out, n, s);
    case 2: return launch<Chain10Bf16>(a, b, out, n, s);
    case 3: return launch<Chain32>(a, b, out, n, s);
    case 4: return launch<CmpSel16>(a, b, out, n, s);
    case 5: return launch<CmpMul16>(a, b, out, n, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
