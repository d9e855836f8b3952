// Parallel radix argsort for the host prep pipeline.
//
// The framework's big host-side costs at billion-edge scale are int64
// key argsorts (pair_relabel's pair histogram, edges_to_csc's
// (dst, src) order, OwnerLayout's (src-part, dst-tile) order —
// PERF_NOTES round-3 #4); numpy's radix sort is single-threaded.
// This is a pthread LSD radix argsort over 8-bit digits: per pass,
// per-thread histograms over a block of the input, an exclusive scan
// over (digit, thread) for stable placement, then a scatter pass.
// One CPU runs at numpy-comparable speed; pod hosts with many cores
// scale near-linearly (the reference's converter leans on big host
// RAM + cores the same way, reference tools/converter.cc:85-98).
//
// C ABI (ctypes): lux_argsort_u64(keys, n, threads, perm_out).
// perm_out must hold n int64; keys are NOT modified.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <pthread.h>

namespace {

constexpr int kMaxThreads = 256;

struct PassArgs {
  const uint64_t* keys;       // key of ORIGINAL index i
  const int64_t* src;         // current permutation (input order)
  int64_t* dst;               // output permutation
  int64_t lo, hi;             // this thread's slice of src
  int shift;
  int64_t* hist;              // [256] this thread's digit histogram
  int64_t* offs;              // [256] this thread's placement offsets
};

void* hist_pass(void* p) {
  auto* a = static_cast<PassArgs*>(p);
  std::memset(a->hist, 0, 256 * sizeof(int64_t));
  for (int64_t i = a->lo; i < a->hi; i++) {
    a->hist[(a->keys[a->src[i]] >> a->shift) & 0xff]++;
  }
  return nullptr;
}

void* scatter_pass(void* p) {
  auto* a = static_cast<PassArgs*>(p);
  for (int64_t i = a->lo; i < a->hi; i++) {
    int64_t v = a->src[i];
    int d = (a->keys[v] >> a->shift) & 0xff;
    a->dst[a->offs[d]++] = v;
  }
  return nullptr;
}

}  // namespace

// ---------------------------------------------------------------------------
// Fused key+payload radix sort (round 4, PERF_NOTES "host prep").
//
// lux_argsort_u64 permutes an index array and re-reads keys[perm[i]]
// every pass — random reads that made it ~2x SLOWER than numpy at one
// thread; and every caller then pays one random GATHER per payload
// array (key[order], srcl[order], ...).  This entry sorts the keys
// IN PLACE and carries the payload arrays through the same stable
// permutation, so every pass is sequential reads + 256 bucketed write
// streams and the after-the-sort gathers disappear entirely.  One
// histogram scan up front computes all eight digit histograms at
// once; only non-trivial digits get a scatter pass (typical keys are
// bounded far under 2^64 — (src-part)*G+tile keys fit ~26 bits, so
// only 4 of 8 passes move data).
//
// The same host-prep role as the reference converter's big in-memory
// sort (reference tools/converter.cc:85-98), generalized to the
// relabel/owner pipelines.
//
// C ABI (ctypes):
//   lux_sort_kv_u64(keys, key_tmp, n, threads,
//                   n_pay, pay, pay_tmp, pay_size)
// keys/key_tmp: n u64 (key_tmp uninitialized scratch); pay/pay_tmp:
// n_pay pointers to payload arrays and equally-sized scratch;
// pay_size: per-payload element size (1/2/4/8).  All arrays are
// modified; on return keys and payloads hold the sorted order.

namespace {

constexpr int kMaxPay = 4;

struct KvPass {
  uint64_t* key_in;
  uint64_t* key_out;
  char* pay_in[kMaxPay];
  char* pay_out[kMaxPay];
  int n_pay;
  int pay_size[kMaxPay];
  int64_t lo, hi;
  int shift;
  int64_t* offs;              // [256] this thread's placement offsets
};

struct HistArgs {
  const uint64_t* keys;
  int64_t lo, hi;
  int shift;
  int64_t* hist;              // [256]
  uint64_t maxk;
};

void* kv_hist(void* p) {
  auto* a = static_cast<HistArgs*>(p);
  std::memset(a->hist, 0, 256 * sizeof(int64_t));
  for (int64_t i = a->lo; i < a->hi; i++)
    a->hist[(a->keys[i] >> a->shift) & 0xff]++;
  return nullptr;
}

void* kv_max(void* p) {
  auto* a = static_cast<HistArgs*>(p);
  uint64_t m = 0;
  for (int64_t i = a->lo; i < a->hi; i++)
    if (a->keys[i] > m) m = a->keys[i];
  a->maxk = m;
  return nullptr;
}

template <typename T>
inline void copy_one(char* dst, const char* src, int64_t di, int64_t si) {
  reinterpret_cast<T*>(dst)[di] =
      reinterpret_cast<const T*>(src)[si];
}

void* kv_scatter(void* p) {
  auto* a = static_cast<KvPass*>(p);
  for (int64_t i = a->lo; i < a->hi; i++) {
    uint64_t k = a->key_in[i];
    int64_t pos = a->offs[(k >> a->shift) & 0xff]++;
    a->key_out[pos] = k;
    for (int j = 0; j < a->n_pay; j++) {
      switch (a->pay_size[j]) {
        case 1: copy_one<uint8_t>(a->pay_out[j], a->pay_in[j], pos, i); break;
        case 2: copy_one<uint16_t>(a->pay_out[j], a->pay_in[j], pos, i); break;
        case 4: copy_one<uint32_t>(a->pay_out[j], a->pay_in[j], pos, i); break;
        default: copy_one<uint64_t>(a->pay_out[j], a->pay_in[j], pos, i);
      }
    }
  }
  return nullptr;
}

}  // namespace

extern "C" int lux_sort_kv_u64(uint64_t* keys, uint64_t* key_tmp,
                               int64_t n, int threads, int n_pay,
                               void** pay, void** pay_tmp,
                               const int32_t* pay_size) {
  if (n < 0 || threads < 1 || n_pay < 0 || n_pay > kMaxPay) return 1;
  for (int j = 0; j < n_pay; j++) {
    int s = pay_size[j];
    if (s != 1 && s != 2 && s != 4 && s != 8) return 2;
  }
  if (n == 0) return 0;
  if (threads > kMaxThreads) threads = kMaxThreads;
  int64_t chunk = (n + threads - 1) / threads;

  // per-thread records in zeroed fixed arrays (threads <= kMaxThreads)
  // and checked calloc'd histograms, not std::vector: GCC's analyzer
  // cannot prove a vector's data() non-null across the thread hand-off,
  // nor that a handle read after `created[t]` was written
  HistArgs ha[kMaxThreads] = {};
  pthread_t tid[kMaxThreads] = {};
  char created[kMaxThreads] = {};

  auto run_threads = [&](void* (*fn)(void*), auto* argv) {
    for (int t = 0; t < threads; t++) {
      if (threads <= 1 || pthread_create(&tid[t], nullptr, fn,
                                         &argv[t]) != 0) {
        fn(&argv[t]);
        created[t] = false;
      } else {
        created[t] = true;
      }
    }
    for (int t = 0; t < threads; t++)
      if (created[t]) pthread_join(tid[t], nullptr);
  };

  // pass count from the max key: high zero bytes never need a pass
  // (the common case — tile/part keys are bounded far under 2^64)
  uint64_t maxk = 0;
  {
    for (int t = 0; t < threads; t++) {
      int64_t lo = t * chunk;
      int64_t hi = lo + chunk < n ? lo + chunk : n;
      if (lo > n) lo = n;
      ha[t] = HistArgs{keys, lo, hi, 0, nullptr, 0};
    }
    run_threads(kv_max, ha);
    for (int t = 0; t < threads; t++)
      if (ha[t].maxk > maxk) maxk = ha[t].maxk;
  }
  int npass = 0;
  while (npass < 8 && (maxk >> (npass * 8)) != 0) npass++;

  uint64_t* kcur = keys;
  uint64_t* knxt = key_tmp;
  char* pcur[kMaxPay] = {};
  char* pnxt[kMaxPay] = {};
  for (int j = 0; j < n_pay; j++) {
    pcur[j] = static_cast<char*>(pay[j]);
    pnxt[j] = static_cast<char*>(pay_tmp[j]);
  }

  auto* hist = static_cast<int64_t*>(
      std::calloc(static_cast<size_t>(threads) * 256, sizeof(int64_t)));
  auto* offs = static_cast<int64_t*>(
      std::calloc(static_cast<size_t>(threads) * 256, sizeof(int64_t)));
  if (hist == nullptr || offs == nullptr) {
    std::free(hist);
    std::free(offs);
    return 3;
  }
  KvPass args[kMaxThreads] = {};

  for (int pass = 0; pass < npass; pass++) {
    int shift = pass * 8;
    // per-thread digit histogram of the CURRENT order (key-only scan)
    for (int t = 0; t < threads; t++) {
      int64_t lo = t * chunk;
      int64_t hi = lo + chunk < n ? lo + chunk : n;
      if (lo > n) lo = n;
      ha[t] = HistArgs{kcur, lo, hi, shift,
                       &hist[static_cast<size_t>(t) * 256], 0};
    }
    run_threads(kv_hist, ha);
    // all keys in one digit bucket => identity pass; skip the scatter
    bool trivial = false;
    for (int d = 0; d < 256 && !trivial; d++) {
      int64_t tot = 0;
      for (int t = 0; t < threads; t++)
        tot += hist[static_cast<size_t>(t) * 256 + d];
      if (tot == n) trivial = true;
    }
    if (trivial) continue;
    // exclusive scan in (digit, thread) order => stable placement
    int64_t run = 0;
    for (int d = 0; d < 256; d++) {
      for (int t = 0; t < threads; t++) {
        offs[static_cast<size_t>(t) * 256 + d] = run;
        run += hist[static_cast<size_t>(t) * 256 + d];
      }
    }
    for (int t = 0; t < threads; t++) {
      int64_t lo = t * chunk;
      int64_t hi = lo + chunk < n ? lo + chunk : n;
      if (lo > n) lo = n;
      args[t] = KvPass{};
      args[t].key_in = kcur;
      args[t].key_out = knxt;
      args[t].n_pay = n_pay;
      args[t].lo = lo;
      args[t].hi = hi;
      args[t].shift = shift;
      args[t].offs = &offs[static_cast<size_t>(t) * 256];
      for (int j = 0; j < n_pay; j++) {
        args[t].pay_in[j] = pcur[j];
        args[t].pay_out[j] = pnxt[j];
        args[t].pay_size[j] = pay_size[j];
      }
    }
    run_threads(kv_scatter, args);
    std::swap(kcur, knxt);
    for (int j = 0; j < n_pay; j++) std::swap(pcur[j], pnxt[j]);
  }

  // an odd number of scatter passes leaves the result in the scratch
  if (kcur != keys) {
    std::memcpy(keys, kcur, static_cast<size_t>(n) * sizeof(uint64_t));
    for (int j = 0; j < n_pay; j++)
      std::memcpy(pay[j], pcur[j],
                  static_cast<size_t>(n) * pay_size[j]);
  }
  std::free(hist);
  std::free(offs);
  return 0;
}

extern "C" int lux_argsort_u64(const uint64_t* keys, int64_t n,
                               int threads, int64_t* perm_out) {
  if (n < 0 || threads < 1) return 1;
  if (threads > kMaxThreads) threads = kMaxThreads;
  // uninitialized scratch (a vector would zero-fill 8 GB at scale)
  std::unique_ptr<int64_t[]> tmp(new int64_t[n]);
  int64_t* cur = perm_out;
  int64_t* nxt = tmp.get();
  for (int64_t i = 0; i < n; i++) cur[i] = i;

  // fixed per-thread arrays and checked calloc'd histograms, as in
  // lux_sort_kv_u64
  auto* hist = static_cast<int64_t*>(
      std::calloc(static_cast<size_t>(threads) * 256, sizeof(int64_t)));
  auto* offs = static_cast<int64_t*>(
      std::calloc(static_cast<size_t>(threads) * 256, sizeof(int64_t)));
  if (hist == nullptr || offs == nullptr) {
    std::free(hist);
    std::free(offs);
    return 3;
  }
  PassArgs args[kMaxThreads] = {};
  pthread_t tid[kMaxThreads] = {};
  char created[kMaxThreads] = {};
  int64_t chunk = (n + threads - 1) / threads;

  for (int pass = 0; pass < 8; pass++) {
    int shift = pass * 8;
    for (int t = 0; t < threads; t++) {
      int64_t lo = t * chunk;
      int64_t hi = lo + chunk < n ? lo + chunk : n;
      if (lo > n) lo = n;
      args[t] = PassArgs{keys, cur, nxt, lo, hi, shift,
                         &hist[static_cast<size_t>(t) * 256],
                         &offs[static_cast<size_t>(t) * 256]};
      // run inline on pthread_create failure (EAGAIN on loaded
      // hosts) — joining an uninitialized handle is UB
      if (threads <= 1 || pthread_create(&tid[t], nullptr, hist_pass,
                                         &args[t]) != 0) {
        hist_pass(&args[t]);
        created[t] = false;
      } else {
        created[t] = true;
      }
    }
    for (int t = 0; t < threads; t++)
      if (created[t]) pthread_join(tid[t], nullptr);
    // all keys in one digit bucket => the pass is the identity
    // permutation; skip the scatter (typical keys leave the top
    // bytes zero, halving the passes or better)
    bool trivial = false;
    for (int d = 0; d < 256 && !trivial; d++) {
      int64_t tot = 0;
      for (int t = 0; t < threads; t++)
        tot += hist[static_cast<size_t>(t) * 256 + d];
      if (tot == n) trivial = true;
    }
    if (trivial) continue;
    // exclusive scan in (digit, thread) order => stable placement
    int64_t run = 0;
    for (int d = 0; d < 256; d++) {
      for (int t = 0; t < threads; t++) {
        offs[static_cast<size_t>(t) * 256 + d] = run;
        run += hist[static_cast<size_t>(t) * 256 + d];
      }
    }
    for (int t = 0; t < threads; t++) {
      if (threads <= 1 || pthread_create(&tid[t], nullptr, scatter_pass,
                                         &args[t]) != 0) {
        scatter_pass(&args[t]);
        created[t] = false;
      } else {
        created[t] = true;
      }
    }
    for (int t = 0; t < threads; t++)
      if (created[t]) pthread_join(tid[t], nullptr);
    std::swap(cur, nxt);
  }
  // trivial-pass skips can leave the result in the scratch buffer
  if (cur != perm_out)
    std::memcpy(perm_out, cur, static_cast<size_t>(n) * sizeof(int64_t));
  std::free(hist);
  std::free(offs);
  return 0;
}
