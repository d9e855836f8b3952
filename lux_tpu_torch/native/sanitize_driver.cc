// Sanitizer exerciser for the native tools
// (tests/test_torch_native.py builds it with lux_tpu_torch.native's
// SANITIZE_FLAGS): runs the 3-edge smoke graph through the loader, a
// tiny R-MAT generation, the threaded radix sort and the clustering
// reorder, compiled with -fsanitize=address,undefined -Wall -Werror so
// memory errors and UB in loader.cc/rmat.cc/sort.cc/reorder.cc fail
// the test instead of corrupting a multi-GB load.  The ctypes .so
// cannot practically run under ASan from an unsanitized Python, so
// this driver calls the C API natively.
#include <cinttypes>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

extern "C" {
int lux_read_header(const char* path, uint32_t* nv, uint64_t* ne);
int lux_load_partition(const char* path, uint32_t nv, uint64_t ne,
                       uint32_t v0, uint32_t v1, int weighted,
                       uint32_t weight_size, uint64_t* e_lo,
                       uint64_t* e_hi, uint64_t* row_out,
                       uint32_t* col_out, void* weight_out,
                       int threads);
int lux_count_degrees(const char* path, uint32_t nv, uint64_t ne,
                      uint32_t* deg_out, int threads);
int lux_rmat_csc(int scale, int edge_factor, uint64_t seed, double pa,
                 double pb, double pc, uint64_t* row_ptrs,
                 uint32_t* col_idx, uint32_t* degrees);
int lux_sort_kv_u64(uint64_t* keys, uint64_t* key_tmp, int64_t n,
                    int threads, int n_pay, void** pay,
                    void** pay_tmp, const int32_t* pay_size);
int lux_argsort_u64(const uint64_t* keys, int64_t n, int threads,
                    int64_t* perm_out);
int lux_reorder_cluster(uint32_t nv, uint64_t ne, const uint32_t* src,
                        const uint32_t* dst, int hubs_first,
                        uint32_t* perm_out);
}

#define CHECK(cond)                                                \
  do {                                                             \
    if (!(cond)) {                                                 \
      std::fprintf(stderr, "sanitize_driver: FAILED %s (%s:%d)\n", \
                   #cond, __FILE__, __LINE__);                     \
      return 1;                                                    \
    }                                                              \
  } while (0)

static int smoke_loader(const char* path) {
  // the converter's 3-edge weighted smoke graph: dst-sorted edges
  // 2->0 (w=1), 0->1 (w=5), 1->2 (w=3)
  uint32_t nv = 0;
  uint64_t ne = 0;
  CHECK(lux_read_header(path, &nv, &ne) == 0);
  CHECK(nv == 3 && ne == 3);

  std::vector<uint32_t> deg(nv);
  CHECK(lux_count_degrees(path, nv, ne, deg.data(), 2) == 0);
  CHECK(deg[0] == 1 && deg[1] == 1 && deg[2] == 1);

  uint64_t e_lo = 0, e_hi = 0;
  CHECK(lux_load_partition(path, nv, ne, 0, nv, 1, 4, &e_lo, &e_hi,
                           nullptr, nullptr, nullptr, 2) == 0);
  CHECK(e_lo == 0 && e_hi == 3);
  std::vector<uint64_t> row(nv);
  std::vector<uint32_t> col(e_hi - e_lo);
  std::vector<int32_t> w(e_hi - e_lo);
  CHECK(lux_load_partition(path, nv, ne, 0, nv, 1, 4, &e_lo, &e_hi,
                           row.data(), col.data(), w.data(), 2) == 0);
  CHECK(row[2] == 3);
  CHECK(col[0] == 2 && col[1] == 0 && col[2] == 1);
  CHECK(w[0] == 1 && w[1] == 5 && w[2] == 3);
  return 0;
}

static int smoke_rmat() {
  const int scale = 6, ef = 4;
  const uint64_t nv = 1ull << scale, ne = nv * ef;
  std::vector<uint64_t> row(nv);
  std::vector<uint32_t> col(ne), deg(nv);
  CHECK(lux_rmat_csc(scale, ef, 7, 0.57, 0.19, 0.19, row.data(),
                     col.data(), deg.data()) == 0);
  CHECK(row[nv - 1] == ne);
  uint64_t dsum = 0;
  for (uint64_t v = 0; v < nv; v++) dsum += deg[v];
  CHECK(dsum == ne);
  for (uint64_t e = 0; e < ne; e++) CHECK(col[e] < nv);
  return 0;
}

static int smoke_sort() {
  const int64_t n = 4097;  // not a multiple of the radix chunking
  std::vector<uint64_t> keys(n), tmp(n);
  std::vector<int64_t> pay(n), ptmp(n);
  uint64_t x = 0x9e3779b97f4a7c15ull;
  for (int64_t i = 0; i < n; i++) {
    x ^= x << 13;
    x ^= x >> 7;
    x ^= x << 17;
    keys[i] = x % 1000;
    pay[i] = i;
  }
  std::vector<uint64_t> ref(keys);
  void* pays[1] = {pay.data()};
  void* ptmps[1] = {ptmp.data()};
  int32_t psize[1] = {8};
  CHECK(lux_sort_kv_u64(keys.data(), tmp.data(), n, 3, 1, pays,
                        ptmps, psize) == 0);
  for (int64_t i = 1; i < n; i++) CHECK(keys[i - 1] <= keys[i]);
  for (int64_t i = 0; i < n; i++)
    CHECK(ref[(uint64_t)pay[i]] == keys[i]);

  std::vector<int64_t> perm(n);
  CHECK(lux_argsort_u64(ref.data(), n, 3, perm.data()) == 0);
  for (int64_t i = 1; i < n; i++)
    CHECK(ref[perm[i - 1]] <= ref[perm[i]]);
  return 0;
}

static int smoke_reorder() {
  // end-to-end contract of the clustering reorder (reorder.cc): the
  // output is a BIJECTION of [0, nv) and relabeling preserves the
  // degree histogram exactly — checked on the 3-edge smoke graph and
  // on a 2-community R-MAT-free synthetic with an isolated vertex
  // (singleton clusters must still be emitted)
  {
    const uint32_t src3[3] = {2, 0, 1}, dst3[3] = {0, 1, 2};
    uint32_t perm[3];
    for (int hubs = 0; hubs <= 1; hubs++) {
      CHECK(lux_reorder_cluster(3, 3, src3, dst3, hubs, perm) == 0);
      uint32_t seen = 0;
      for (int i = 0; i < 3; i++) {
        CHECK(perm[i] < 3);
        seen |= 1u << perm[i];
      }
      CHECK(seen == 7);
    }
  }
  const uint32_t nv = 9;  // two triangles + a bridge + isolated v8
  const uint32_t src9[7] = {0, 1, 2, 4, 5, 6, 2};
  const uint32_t dst9[7] = {1, 2, 0, 5, 6, 4, 4};
  uint32_t perm[nv];
  // every mode (CM, hub-first, LPA communities) emits a bijection
  for (int mode = 0; mode <= 2; mode++) {
    CHECK(lux_reorder_cluster(nv, 7, src9, dst9, mode, perm) == 0);
    std::vector<uint32_t> mh(nv, 0);
    for (uint32_t i = 0; i < nv; i++) {
      CHECK(perm[i] < nv);
      mh[perm[i]]++;
    }
    for (uint32_t v = 0; v < nv; v++) CHECK(mh[v] == 1);
  }
  CHECK(lux_reorder_cluster(nv, 7, src9, dst9, 1, perm) == 0);
  std::vector<uint32_t> hits(nv, 0);
  for (uint32_t i = 0; i < nv; i++) {
    CHECK(perm[i] < nv);
    hits[perm[i]]++;
  }
  for (uint32_t v = 0; v < nv; v++) CHECK(hits[v] == 1);  // bijection
  // degree histogram preserved under the relabel: deg_new[i] must be
  // deg_old[perm[i]] for every slot, so the multiset is invariant
  std::vector<uint32_t> deg_old(nv, 0), deg_new(nv, 0), rank(nv);
  for (uint32_t i = 0; i < nv; i++) rank[perm[i]] = i;
  for (int e = 0; e < 7; e++) {
    deg_old[src9[e]]++;
    deg_old[dst9[e]]++;
    deg_new[rank[src9[e]]]++;
    deg_new[rank[dst9[e]]]++;
  }
  for (uint32_t i = 0; i < nv; i++)
    CHECK(deg_new[i] == deg_old[perm[i]]);
  // out-of-range edge, missing output, unknown mode: typed refusals
  const uint32_t bad_src[1] = {99}, bad_dst[1] = {0};
  CHECK(lux_reorder_cluster(nv, 1, bad_src, bad_dst, 0, perm) == -2);
  CHECK(lux_reorder_cluster(nv, 7, src9, dst9, 0, nullptr) == -1);
  CHECK(lux_reorder_cluster(nv, 7, src9, dst9, 3, perm) == -4);
  return 0;
}

int main(int argc, char** argv) {
  if (argc != 2) {
    std::fprintf(stderr, "usage: sanitize_driver SMOKE.lux\n");
    return 2;
  }
  if (smoke_loader(argv[1])) return 1;
  if (smoke_rmat()) return 1;
  if (smoke_sort()) return 1;
  if (smoke_reorder()) return 1;
  std::printf("sanitize_driver OK\n");
  return 0;
}
