// S7 on Hopper: the segmented carry over per-chunk partials, one
// single-pass launch (a chained scan with decoupled look-back: Merrill
// and Garland, "Single-pass Parallel Prefix Scan with Decoupled
// Look-back", NVIDIA NVR-2016-002).
//
// Replaces scripts/profile_slotted.py::carry (body _carry_kernel),
// which the TPU runs as one sequential loop over the rows of [bc, 128]
// VMEM blocks, carrying a [1, 128] row in scratch from one grid step
// to the next.  Same function:
//
//   out[i, w] = start[i] == 1 ? part[i, w] : out[i - 1, w] + part[i, w]
//
// with a carry of 0 before row 0.  Inputs: part [C, W] float32, start
// [C] int32 (the script's [C, 1]; only 1 marks a start), out [C, W];
// row-major, contiguous.  Any C >= 1 and W >= 1 (the script's W is
// 128); W > 128 runs as independent groups of 128 columns, each its
// own chained scan.
//
// Bound: bytes.  part read once, start read once, out written once:
// C * (8 W + 4) bytes over the card's 3.35 TB/s; one add a value.
//
// Design.  A CTA of kLanes threads (one a column: rows of 512 B read
// and written coalesced) scans tiles of kTile rows of one column group.
// Tiles come from an atomic ticket, not from blockIdx, so a CTA only
// ever waits on tiles whose CTAs have started; one CTA for each the
// card holds at once draws tickets until none are left.  A tile's rows
// are loaded into registers, scanned from a carry of 0, and the tile
// publishes a status:
//   P (inclusive), the value at its last row, at once when the tile
//     has a start (that value does not depend on the carry), and for
//     tile 0 (its carry is 0);
//   A (aggregate), its own sum, when it has none; then P = carry + A
//     as soon as it knows its carry.
// Rows from the tile's first start on are stored at once; rows before
// it keep their local values in shared memory, which frees the
// registers for the next tile's loads: they start before the
// look-back, so they run while it waits.  Warp 0 looks back over tiles
// t-1, t-2, ... to the first P, every tile between showing A, and all
// threads fold carry = ((P_s + A_{s+1}) + ...) + A_{t-1}; the rows
// before the first start get carry + local.  Every P is carry_in + A
// in that same order, so the carry has the same bits whichever of A or
// P a predecessor showed: two calls give the same words, as the
// three-pass design before it did.  f32 adds run in another order than
// the TPU's one sequential loop, so results agree with it to a
// tolerance, not in bits.  Thread 0 draws the next ticket before the
// scan and hands it on at the status barrier, so the atomic's round
// trip overlaps the scan.
//
// Statuses live in the caller's scratch (lux_carry_status_bytes), zeroed
// once when allocated and never again: a control block (the ticket and
// a count of finished calls), then a 64-bit flag a slot (a slot is a
// (tile, column group)) and two [slots, kLanes] f32 arrays, A and P
// apart so that a value a reader saw flagged never changes under it.
// A flag is (epoch << 2) | kind, the epoch being the count of calls
// before this one plus 1, read from the device, so a status left by an
// earlier call (or the zeros) is never taken for this call's; nothing
// comes from the host but the shapes, so a CUDA graph of calls replays.
// The CTA that draws a call's last ticket resets the ticket and counts
// the call.  Every thread writes its value, the CTA meets at a barrier,
// and thread 0 stores the flag with release semantics (the order a
// grid-wide sync relies on); flags are read with acquire semantics and
// values with strong (L2) loads, never through the read-only path.
// Calls that share a scratch must not overlap in time (the wrapper
// keeps one a stream); a status wait that lasts kWaitLimitNs traps, so
// a broken protocol raises an error instead of hanging the card.
//
// What holds it (NVIDIA H100 80GB HBM3, 700 W; PERF.md): at
// [57,664 x 128] it takes 1.7-1.8x the byte bound, and the local scan
// alone (loads, scan, stores; no status) about 87% of its time
// (`python3 -m lux_tpu_torch.tools.probe_ab --only carry --ablate`).

#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kTile = 64;       // rows a tile
constexpr int kLanes = 128;     // threads a CTA, one a column
constexpr int kFoldBatch = 4;   // look-back value loads in flight a thread
// a status wait longer than this is a fault: no tile this call waits on
// takes more than microseconds once its CTA has started
constexpr uint64_t kWaitLimitNs = 4000000000ull;
constexpr unsigned kFull = 0xffffffffu;
constexpr uint64_t kAggregate = 1;
constexpr uint64_t kInclusive = 2;
static_assert(kTile % 32 == 0 && kTile <= kLanes, "one thread a start");
constexpr int kMaskWords = kTile / 32;

struct Control {
  uint64_t calls;   // calls finished with this scratch
  uint32_t ticket;  // CTAs of the running call that have started
  uint32_t pad;
};

__device__ __forceinline__ uint64_t ld_acquire(const uint64_t* p) {
  uint64_t v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ uint64_t ld_strong(const uint64_t* p) {
  uint64_t v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ float ld_strong(const float* p) {
  float v;
  asm volatile("ld.relaxed.gpu.global.f32 %0, [%1];" : "=f"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ uint64_t now_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ void st_strong(uint64_t* p, uint64_t v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ void st_strong(uint32_t* p, uint32_t v) {
  asm volatile("st.relaxed.gpu.global.u32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ void st_release(uint64_t* p, uint64_t v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

// acq_rel: a CTA's read of `calls` before its draw is ordered before
// the last drawer's update of it
__device__ __forceinline__ uint32_t draw_ticket(uint32_t* p) {
  uint32_t old;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], %2;"
               : "=r"(old) : "l"(p), "r"(1u) : "memory");
  return old;
}

// Every thread writes its column's value; after the barrier thread 0's
// release store of the flag orders all of them before it (the barrier
// then the release, as a grid-wide sync orders a CTA's writes).
__device__ __forceinline__ void publish(float* value_at, float value,
                                        uint64_t* flag, uint64_t word) {
  *value_at = value;
  __syncthreads();
  if (threadIdx.x == 0) st_release(flag, word);
}

// Thread 0: the next ticket of this call.  Each CTA draws until it
// draws one past the call's last tile, so a call draws total +
// gridDim.x tickets; the CTA that draws the last one resets the ticket
// and counts the call.
__device__ __forceinline__ uint32_t next_ticket(Control* ctl, uint32_t total,
                                                uint64_t done) {
  const uint32_t v = draw_ticket(&ctl->ticket);
  if (v == total + gridDim.x - 1) {
    st_strong(&ctl->ticket, 0u);
    st_strong(&ctl->calls, done + 1);
  }
  return v;
}

// Start the loads of slot `slot`'s rows (thread x: column x, each row a
// 512 B coalesced read) into v, and the ballot of its starts into mask;
// rows past C and columns past W are 0.
__device__ __forceinline__ void load_tile(float (&v)[kTile], uint32_t* mask,
                                          const float* __restrict__ part,
                                          const int32_t* __restrict__ start,
                                          int slot, int64_t C, int W,
                                          int nG) {
  const int t = slot / nG;
  const int g = slot - t * nG;
  const int64_t r0 = (int64_t)t * kTile;
  const int n = (int)(C - r0 < kTile ? C - r0 : kTile);
  const int col = g * kLanes + threadIdx.x;
  if (threadIdx.x < kTile) {
    const bool s = (int)threadIdx.x < n && start[r0 + threadIdx.x] == 1;
    const uint32_t m = __ballot_sync(kFull, s);
    if ((threadIdx.x & 31) == 0) mask[threadIdx.x >> 5] = m;
  }
  const float* p = part + r0 * W + col;
  const bool live = col < W;
#pragma unroll
  for (int j = 0; j < kTile; ++j)
    v[j] = live && j < n ? __ldg(p + (int64_t)j * W) : 0.f;
}

__global__ void __launch_bounds__(kLanes)
carry_kernel(const float* __restrict__ part, const int32_t* __restrict__ start,
             float* __restrict__ out, unsigned char* status, int64_t slots,
             int64_t C, int W, int nG, uint32_t total) {
  __shared__ uint32_t s_first_ticket, s_next_ticket;
  __shared__ uint64_t s_done;
  __shared__ uint32_t s_mask[2][kMaskWords];  // this tile's starts, the next's
  __shared__ int s_from;
  __shared__ float s_pre[kTile * kLanes];  // rows before the first start

  Control* ctl = reinterpret_cast<Control*>(status);
  uint64_t* flags = reinterpret_cast<uint64_t*>(status + sizeof(Control));
  float* agg = reinterpret_cast<float*>(flags + slots);
  float* incl = agg + slots * kLanes;

  if (threadIdx.x == 0) {
    const uint64_t done = ld_strong(&ctl->calls);  // before the first draw
    s_done = done;
    s_first_ticket = next_ticket(ctl, total, done);
  }
  __syncthreads();
  const uint64_t done = s_done;
  const uint64_t epoch = done + 1;
  uint32_t ticket = s_first_ticket;
  float v[kTile];
  if (ticket < total)
    load_tile(v, s_mask[0], part, start, (int)ticket, C, W, nG);
  __syncthreads();
  for (int buf = 0; ticket < total; buf ^= 1) {
    // thread 0 draws the next ticket now and hands it on at the publish
    // barrier: the scan runs while the atomic is in flight
    uint32_t drawn = 0;
    if (threadIdx.x == 0) drawn = next_ticket(ctl, total, done);
    const int slot = (int)ticket;  // = tile * nG + group
    const int t = slot / nG;
    const int g = slot - t * nG;
    const int64_t r0 = (int64_t)t * kTile;
    const int n = (int)(C - r0 < kTile ? C - r0 : kTile);
    const int col = g * kLanes + threadIdx.x;
    const bool live = col < W;
    uint32_t mask[kMaskWords];
    int first = n;  // the tile's first start row, n when it has none
#pragma unroll
    for (int k = kMaskWords - 1; k >= 0; --k) {
      mask[k] = s_mask[buf][k];
      if (mask[k]) first = k * 32 + __ffs(mask[k]) - 1;
    }
    // local scan from a carry of 0; acc ends at row n - 1's value
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      if (j < n) acc = (mask[j >> 5] >> (j & 31)) & 1u ? v[j] : acc + v[j];
      v[j] = acc;
    }

    const bool has_start = first < n;
    float* agg_at = agg + (int64_t)slot * kLanes + threadIdx.x;
    float* incl_at = incl + (int64_t)slot * kLanes + threadIdx.x;
    if (threadIdx.x == 0) s_next_ticket = drawn;
    if (has_start || t == 0)
      publish(incl_at, has_start ? acc : 0.f + acc, flags + slot,
              (epoch << 2) | kInclusive);
    else
      publish(agg_at, acc, flags + slot, (epoch << 2) | kAggregate);
    const uint32_t next = s_next_ticket;

    // rows from the first start on are final: stored now; rows before
    // it wait in shared memory, so v is free for the next tile's loads,
    // which run during this tile's look-back
    float* o = out + r0 * W + col;
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      if (j < first) s_pre[j * kLanes + threadIdx.x] = v[j];
      else if (live && j < n) o[(int64_t)j * W] = v[j];
    }
    if (next < total)
      load_tile(v, s_mask[buf ^ 1], part, start, (int)next, C, W, nG);
    if (first > 0) {  // CTA-uniform: rows wait on the carry
      float carry = 0.f;
      if (t > 0) {
        if (threadIdx.x < 32) {
          // warp 0: lane l watches tile b - l; the window moves back 32
          // tiles while all 32 show A
          const int lane = threadIdx.x;
          int b = t - 1;
          for (;;) {
            const int u = b - lane;
            const uint64_t* f = flags + (u * nG + g);
            uint32_t fresh, inclusive;
            uint64_t since = 0;
            for (;;) {
              const uint64_t w = u >= 0 ? ld_acquire(f) : 0;
              const bool ok = u < 0 || (w >> 2) == epoch;
              fresh = __ballot_sync(kFull, ok);
              inclusive = __ballot_sync(kFull, u >= 0 && ok &&
                                                   (w & 3) == kInclusive);
              // every lane up to the first P (all 32 when none) has one
              const uint32_t need =
                  inclusive ? ((inclusive & (0u - inclusive)) << 1) - 1
                            : kFull;
              if ((fresh & need) == need) break;
              const uint64_t now = now_ns();
              if (since == 0) since = now;
              if (__any_sync(kFull, now - since > kWaitLimitNs)) __trap();
              __nanosleep(32);
            }
            if (inclusive) {
              if (lane == 0) s_from = b - (__ffs(inclusive) - 1);
              break;
            }
            b -= 32;
          }
        }
        __syncthreads();
        const int s = s_from;
        carry = ld_strong(incl + (int64_t)(s * nG + g) * kLanes +
                          threadIdx.x);
        for (int u0 = s + 1; u0 < t; u0 += kFoldBatch) {
          float a[kFoldBatch];
#pragma unroll
          for (int j = 0; j < kFoldBatch; ++j) {
            const int64_t at = (int64_t)((u0 + j) * nG + g) * kLanes;
            a[j] = u0 + j < t ? ld_strong(agg + at + threadIdx.x) : 0.f;
          }
#pragma unroll
          for (int j = 0; j < kFoldBatch; ++j)
            if (u0 + j < t) carry += a[j];
        }
      }
      if (!has_start && t > 0)
        publish(incl_at, carry + acc, flags + slot,
                (epoch << 2) | kInclusive);
      if (live) {
        for (int j = 0; j < first; ++j)
          o[(int64_t)j * W] = carry + s_pre[j * kLanes + threadIdx.x];
      }
    }
    __syncthreads();  // s_mask, s_from and s_next_ticket are reused
    ticket = next;
  }
}

// CTAs the kernel keeps resident on the current device: its SMs times
// the CTAs an SM holds (found once a device).
int resident_ctas() {
  static int cached[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (cached[dev] == 0) {
    int sms = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, carry_kernel,
                                                      kLanes, 0) !=
            cudaSuccess)
      return 0;
    cached[dev] = sms * per_sm;
  }
  return cached[dev];
}

}  // namespace

// Bytes of the status scratch for `slots` (tile, column group) slots;
// the caller zeroes it once.
extern "C" int64_t lux_carry_status_bytes(int64_t slots) {
  return (int64_t)sizeof(Control) +
         slots * (int64_t)(sizeof(uint64_t) + 2 * kLanes * sizeof(float));
}

// Launches the kernel on `stream` and returns the cudaError_t of the
// launch (0 = success); it does not synchronise.  `status` is the
// scratch of lux_carry_status_bytes(slots) bytes, slots >=
// ceil(C / tile) * ceil(W / 128); `tile` must be this source's kTile.
extern "C" int lux_carry(const void* part, const void* start, void* out,
                         void* status, int64_t slots, int64_t C, int W,
                         int tile, void* stream) {
  if (C < 0 || W < 1 || tile != kTile) return (int)cudaErrorInvalidValue;
  if (C == 0) return 0;
  const int64_t nG = (W + kLanes - 1) / kLanes;
  const int64_t total = (C + kTile - 1) / kTile * nG;
  if (total > 0x3fffffff || total > slots) return (int)cudaErrorInvalidValue;
  const int resident = resident_ctas();
  if (resident <= 0) return (int)cudaErrorInvalidValue;
  const int64_t grid = total < resident ? total : resident;
  carry_kernel<<<(unsigned)grid, kLanes, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(part), static_cast<const int32_t*>(start),
      static_cast<float*>(out), static_cast<unsigned char*>(status), slots, C,
      W, (int)nG, (uint32_t)total);
  return (int)cudaGetLastError();
}
