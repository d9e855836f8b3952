// liblux_native — partition-slice loader for .lux files.
//
// Native equivalent of the reference's per-partition load tasks
// (reference pull_model.inl:288-319: each CPU task fseeko/freads its
// vertex range's row_ptr and col_idx slices).  Exposed as a C ABI for
// ctypes; multi-threaded chunked pread so multi-GB graph files load at
// disk/page-cache bandwidth instead of through Python.
//
// All functions return 0 on success, negative errno-style codes on
// failure.

#include <fcntl.h>
#include <pthread.h>
#include <unistd.h>

#include <cerrno>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr uint64_t kHeaderSize = 12;  // u32 nv + u64 ne

struct ReadJob {
  int fd;
  uint64_t off;
  uint64_t len;
  char* dst;
  int rc;
};

void* read_worker(void* p) {
  ReadJob* j = static_cast<ReadJob*>(p);
  uint64_t done = 0;
  while (done < j->len) {
    ssize_t r = pread(j->fd, j->dst + done, j->len - done, j->off + done);
    if (r < 0) {
      if (errno == EINTR) continue;
      j->rc = -errno;
      return nullptr;
    }
    if (r == 0) {  // unexpected EOF
      j->rc = -EIO;
      return nullptr;
    }
    done += (uint64_t)r;
  }
  j->rc = 0;
  return nullptr;
}

// Parallel chunked pread of [off, off+len) into dst.
int pread_parallel(int fd, uint64_t off, uint64_t len, void* dst,
                   int threads) {
  if (len == 0) return 0;
  if (threads < 1) threads = 1;
  if (threads > 64) threads = 64;
  uint64_t chunk = (len + threads - 1) / threads;
  std::vector<ReadJob> jobs;
  std::vector<pthread_t> tids;
  for (int t = 0; t < threads; t++) {
    uint64_t o = (uint64_t)t * chunk;
    if (o >= len) break;
    jobs.push_back({fd, off + o, std::min(chunk, len - o),
                    static_cast<char*>(dst) + o, 0});
  }
  tids.resize(jobs.size());
  for (size_t t = 1; t < jobs.size(); t++)
    pthread_create(&tids[t], nullptr, read_worker, &jobs[t]);
  read_worker(&jobs[0]);
  for (size_t t = 1; t < jobs.size(); t++) pthread_join(tids[t], nullptr);
  for (auto& j : jobs)
    if (j.rc) return j.rc;
  return 0;
}

}  // namespace

extern "C" {

// Read nv/ne from the header.
int lux_read_header(const char* path, uint32_t* nv, uint64_t* ne) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return -errno;
  char buf[kHeaderSize];
  ssize_t r = pread(fd, buf, kHeaderSize, 0);
  close(fd);
  if (r != (ssize_t)kHeaderSize) return r < 0 ? -errno : -EIO;
  std::memcpy(nv, buf, 4);
  std::memcpy(ne, buf + 4, 8);
  return 0;
}

// Load one partition's slices: vertex range [v0, v1), its row_ptrs
// (END offsets, e_hi - written into row_out[v1-v0]) and its col_idx
// slice [e_lo, e_hi) into col_out.  e_lo/e_hi are returned so the
// caller can size col_out with a first call passing col_out == NULL.
// weight_out, if non-NULL, receives the matching weight slice
// (weight_size = bytes per weight, 4 for i32/f32).
int lux_load_partition(const char* path, uint32_t nv, uint64_t ne,
                       uint32_t v0, uint32_t v1, int weighted,
                       uint32_t weight_size, uint64_t* e_lo,
                       uint64_t* e_hi, uint64_t* row_out,
                       uint32_t* col_out, void* weight_out, int threads) {
  if (v1 > nv || v0 > v1) return -EINVAL;
  int fd = open(path, O_RDONLY);
  if (fd < 0) return -errno;

  // Edge range: [row_ptrs[v0-1], row_ptrs[v1-1]).
  uint64_t lo = 0, hi = 0;
  if (v0 > 0) {
    if (pread(fd, &lo, 8, kHeaderSize + 8ull * (v0 - 1)) != 8) {
      close(fd);
      return -EIO;
    }
  }
  if (v1 > 0) {
    if (pread(fd, &hi, 8, kHeaderSize + 8ull * (v1 - 1)) != 8) {
      close(fd);
      return -EIO;
    }
  }
  *e_lo = lo;
  *e_hi = hi;
  if (col_out == nullptr) {  // size query only
    close(fd);
    return 0;
  }

  int rc = 0;
  if (row_out && v1 > v0)
    rc = pread_parallel(fd, kHeaderSize + 8ull * v0, 8ull * (v1 - v0),
                        row_out, threads);
  if (!rc && hi > lo)
    rc = pread_parallel(fd, kHeaderSize + 8ull * nv + 4ull * lo,
                        4ull * (hi - lo), col_out, threads);
  if (!rc && weighted && weight_out && hi > lo)
    rc = pread_parallel(
        fd, kHeaderSize + 8ull * nv + 4ull * ne + (uint64_t)weight_size * lo,
        (uint64_t)weight_size * (hi - lo), weight_out, threads);
  close(fd);
  return rc;
}

// Count out-degrees by streaming col_idx in parallel chunks (the
// reference recomputes degrees at load time the same way, single
// threaded: PullScanTask, pull_model.inl:322-345).
int lux_count_degrees(const char* path, uint32_t nv, uint64_t ne,
                      uint32_t* deg_out, int threads) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return -errno;
  std::memset(deg_out, 0, 4ull * nv);
  const uint64_t base = kHeaderSize + 8ull * nv;
  const uint64_t chunk_elems = 1ull << 22;
  std::vector<uint32_t> buf(chunk_elems);
  for (uint64_t e = 0; e < ne; e += chunk_elems) {
    uint64_t n = std::min(chunk_elems, ne - e);
    int rc = pread_parallel(fd, base + 4ull * e, 4ull * n, buf.data(),
                            threads);
    if (rc) {
      close(fd);
      return rc;
    }
    for (uint64_t i = 0; i < n; i++) {
      if (buf[i] >= nv) {
        close(fd);
        return -EINVAL;
      }
      deg_out[buf[i]]++;
    }
  }
  close(fd);
  return 0;
}

}  // extern "C"
