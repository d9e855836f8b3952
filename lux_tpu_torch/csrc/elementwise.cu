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
// Design (simple and right; not tuned): a grid-stride loop over 16 B
// vectors (4 f32 or 8 bf16 a thread a step), one 16 B load of each
// input (one when b == a) and one 16 B store; the n % vector tail is
// done element by element after.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 4096;
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

// bf16 values ride as their 16 raw bits
struct Chain10Bf16 {
  using A = uint16_t;
  using B = uint16_t;
  __device__ static uint16_t apply(uint16_t a, uint16_t b) {
    const float fb = __bfloat162float(__ushort_as_bfloat16(b));
#pragma unroll
    for (int i = 0; i < 10; ++i) {
      const float s = __fadd_rn(__bfloat162float(__ushort_as_bfloat16(a)), fb);
      a = __bfloat16_as_ushort(__float2bfloat16_rn(s));
    }
    return a;
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

template <class Body>
__global__ void __launch_bounds__(kThreads)
elementwise_kernel(const typename Body::A* __restrict__ a,
                   const typename Body::B* __restrict__ b,
                   typename Body::A* __restrict__ out, int64_t n) {
  using A = typename Body::A;
  using B = typename Body::B;
  static_assert(sizeof(A) == sizeof(B), "inputs share one vector width");
  constexpr int V = 16 / sizeof(A);
  union VA { uint4 u; A e[V]; };
  union VB { uint4 u; B e[V]; };
  const bool same = static_cast<const void*>(a) == static_cast<const void*>(b);
  const int64_t nvec = n / V;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t t0 = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  for (int64_t i = t0; i < nvec; i += stride) {
    VA va, vo;
    VB vb;
    va.u = __ldg(reinterpret_cast<const uint4*>(a) + i);
    vb.u = same ? va.u : __ldg(reinterpret_cast<const uint4*>(b) + i);
#pragma unroll
    for (int k = 0; k < V; ++k) vo.e[k] = Body::apply(va.e[k], vb.e[k]);
    reinterpret_cast<uint4*>(out)[i] = vo.u;
  }
  const int64_t t = nvec * V + t0;     // the tail, n % V elements
  if (t < n) out[t] = Body::apply(a[t], b[t]);
}

template <class Body>
int launch(const void* a, const void* b, void* out, int64_t n,
           cudaStream_t stream) {
  constexpr int V = 16 / sizeof(typename Body::A);
  const int64_t work = n / V > n % V ? n / V : n % V;
  int64_t blocks = (work + kThreads - 1) / kThreads;
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
