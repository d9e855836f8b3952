// In-memory R-MAT graph builder (generation + dst-sorted CSC) for
// liblux_native.so.
//
// The framework's benchmark graphs are R-MAT (the reference's RMAT27
// family, reference README.md:86); generating tens of millions of
// edges plus the (dst, src) sort dominates benchmark setup in numpy
// (~90 s at scale 21), so this native path does the whole
// generate+sort+CSC build in C++ — the same role the reference gives
// its native tools for billion-edge inputs (SURVEY.md §2.4).
//
// RNG: splitmix64 (deterministic per seed; a different stream than the
// numpy generator, so graphs match in distribution, not bit-for-bit).

#include <algorithm>
#include <cstdint>
#include <vector>

namespace {

struct SplitMix64 {
  uint64_t s;
  explicit SplitMix64(uint64_t seed) : s(seed) {}
  uint64_t next() {
    uint64_t z = (s += 0x9e3779b97f4a7c15ull);
    z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ull;
    z = (z ^ (z >> 27)) * 0x94d049bb133111ebull;
    return z ^ (z >> 31);
  }
  // uniform double in [0, 1)
  double uniform() { return (next() >> 11) * 0x1.0p-53; }
  // uniform integer in [0, n)
  uint64_t below(uint64_t n) { return next() % n; }
};

}  // namespace

extern "C" int lux_rmat_csc(
    int scale, int edge_factor, uint64_t seed,
    double pa, double pb, double pc,
    uint64_t* row_ptrs /* [nv] END offsets */,
    uint32_t* col_idx /* [ne] sources, dst-sorted */,
    uint32_t* degrees /* [nv] out-degrees */) {
  if (scale <= 0 || scale > 31 || edge_factor <= 0) return 1;
  if (!(pa > 0.0) || !(pb >= 0.0) || !(pc >= 0.0) ||
      pa + pb + pc > 1.0)
    return 2;
  const uint64_t nv = 1ull << scale;
  const uint64_t ne = nv * (uint64_t)edge_factor;
  SplitMix64 rng(seed * 0x2545f4914f6cdd1dull + 0x9e3779b97f4a7c15ull);

  // vertex id scramble so the R-MAT skew is not correlated with id
  // order (mirrors the permutation in lux_tpu_torch/convert.py rmat_edges)
  std::vector<uint32_t> perm(nv);
  for (uint64_t v = 0; v < nv; v++) perm[v] = (uint32_t)v;
  for (uint64_t v = nv - 1; v > 0; v--)
    std::swap(perm[v], perm[rng.below(v + 1)]);

  // one u64 key per edge, dst in the high word => flat sort gives the
  // (dst, src) canonical order (same trick as converter.cc)
  std::vector<uint64_t> keys(ne);
  const double ab = pa + pb, abc = pa + pb + pc;
  for (uint64_t e = 0; e < ne; e++) {
    uint64_t src = 0, dst = 0;
    for (int bit = 0; bit < scale; bit++) {
      double r = rng.uniform();
      uint64_t sb = r >= ab ? 1 : 0;                    // quadrants c,d
      uint64_t db = ((r >= pa && r < ab) || r >= abc) ? 1 : 0;
      src = (src << 1) | sb;
      dst = (dst << 1) | db;
    }
    keys[e] = ((uint64_t)perm[dst] << 32) | perm[src];
  }
  std::sort(keys.begin(), keys.end());

  for (uint64_t v = 0; v < nv; v++) degrees[v] = 0;
  for (uint64_t e = 0; e < ne; e++) {
    col_idx[e] = (uint32_t)(keys[e] & 0xffffffffu);
    degrees[col_idx[e]]++;
  }
  uint64_t e = 0;
  for (uint64_t v = 0; v < nv; v++) {
    while (e < ne && (keys[e] >> 32) == v) e++;
    row_ptrs[v] = e;
  }
  return 0;
}
