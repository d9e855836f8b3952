// lux_converter — text edge list -> .lux binary CSC.
//
// Native equivalent of the framework's Python converter
// (lux_tpu_torch/convert.py) for billion-edge inputs; produces byte-identical
// files.  Same on-disk format as the reference tool
// (reference tools/converter.cc:108-124, README.md:55-79):
//   nv u32 | ne u64 | row_ptrs u64[nv] (END offsets) |
//   col_idx u32[ne] (sources, dst-sorted) | [weights i32[ne]] |
//   degrees u32[nv]
//
// Design (not a translation of the reference): edges are packed into
// one u64 per edge (dst in the high word) so the sort is a flat
// primitive-key sort, weighted edges carry their payload through a
// parallel index sort, and all IO is buffered streaming.
//
// Usage: lux_converter -nv N -ne M -input edges.txt -output g.lux
//        [-weighted]

#include <algorithm>
#include <cinttypes>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <numeric>
#include <string>
#include <vector>

namespace {

struct Args {
  uint32_t nv = 0;
  uint64_t ne = 0;
  std::string input, output;
  bool weighted = false;
};

[[noreturn]] void usage(const char* msg) {
  std::fprintf(stderr,
               "error: %s\n"
               "usage: lux_converter -nv N -ne M -input edges.txt "
               "-output g.lux [-weighted]\n",
               msg);
  std::exit(2);
}

Args parse(int argc, char** argv) {
  Args a;
  for (int i = 1; i < argc; i++) {
    std::string f = argv[i];
    auto next = [&]() -> const char* {
      if (i + 1 >= argc) usage(("missing value for " + f).c_str());
      return argv[++i];
    };
    if (f == "-nv") a.nv = std::strtoul(next(), nullptr, 10);
    else if (f == "-ne") a.ne = std::strtoull(next(), nullptr, 10);
    else if (f == "-input") a.input = next();
    else if (f == "-output") a.output = next();
    else if (f == "-weighted") a.weighted = true;
    else usage(("unknown flag " + f).c_str());
  }
  if (!a.nv || a.input.empty() || a.output.empty())
    usage("-nv, -input and -output are required");
  return a;
}

void write_all(FILE* f, const void* p, size_t n) {
  if (std::fwrite(p, 1, n, f) != n) {
    std::perror("write");
    std::exit(1);
  }
}

}  // namespace

int main(int argc, char** argv) {
  Args args = parse(argc, argv);

  FILE* fin = std::fopen(args.input.c_str(), "r");
  if (!fin) { std::perror(args.input.c_str()); return 1; }

  // dst in the high 32 bits makes sort order = (dst, src): stable
  // per-destination source order matches the Python converter's
  // stable argsort by dst.
  std::vector<uint64_t> keys;
  std::vector<int32_t> weights;
  if (args.ne) keys.reserve(args.ne);
  std::vector<uint32_t> degrees(args.nv, 0);

  uint64_t lineno = 0;
  long src, dst, w;
  while (true) {
    int got = args.weighted ? std::fscanf(fin, "%ld %ld %ld", &src, &dst, &w)
                            : std::fscanf(fin, "%ld %ld", &src, &dst);
    if (got == EOF) break;
    if (got != (args.weighted ? 3 : 2)) {
      std::fprintf(stderr, "parse error near edge %" PRIu64 "\n", lineno);
      return 1;
    }
    if (src < 0 || dst < 0 || (uint64_t)src >= args.nv ||
        (uint64_t)dst >= args.nv) {
      std::fprintf(stderr, "edge %" PRIu64 " endpoint out of range\n",
                   lineno);
      return 1;
    }
    keys.push_back(((uint64_t)dst << 32) | (uint32_t)src);
    if (args.weighted) weights.push_back((int32_t)w);
    degrees[src]++;
    lineno++;
  }
  std::fclose(fin);
  uint64_t ne = keys.size();
  if (args.ne && args.ne != ne)
    std::fprintf(stderr, "warning: -ne %" PRIu64 " but read %" PRIu64
                 " edges\n", args.ne, ne);

  std::vector<uint32_t> worder;
  if (args.weighted) {
    // Sort an index permutation so weights follow their edges; stable
    // to keep input order within (dst, src) ties.
    worder.resize(ne);
    std::iota(worder.begin(), worder.end(), 0u);
    std::stable_sort(worder.begin(), worder.end(),
                     [&](uint32_t x, uint32_t y) { return keys[x] < keys[y]; });
    std::vector<uint64_t> sorted(ne);
    for (uint64_t e = 0; e < ne; e++) sorted[e] = keys[worder[e]];
    keys.swap(sorted);
  } else {
    std::sort(keys.begin(), keys.end());
  }

  FILE* fout = std::fopen(args.output.c_str(), "wb");
  if (!fout) { std::perror(args.output.c_str()); return 1; }
  write_all(fout, &args.nv, sizeof(uint32_t));
  write_all(fout, &ne, sizeof(uint64_t));

  // END offsets per destination, streamed in chunks.
  {
    std::vector<uint64_t> row_ptrs(args.nv);
    uint64_t e = 0;
    for (uint32_t v = 0; v < args.nv; v++) {
      while (e < ne && (keys[e] >> 32) == v) e++;
      row_ptrs[v] = e;
    }
    write_all(fout, row_ptrs.data(), sizeof(uint64_t) * args.nv);
  }
  {
    std::vector<uint32_t> col(1 << 20);
    uint64_t e = 0;
    while (e < ne) {
      size_t chunk = std::min<uint64_t>(col.size(), ne - e);
      for (size_t i = 0; i < chunk; i++)
        col[i] = (uint32_t)(keys[e + i] & 0xffffffffu);
      write_all(fout, col.data(), sizeof(uint32_t) * chunk);
      e += chunk;
    }
  }
  if (args.weighted) {
    std::vector<int32_t> wsorted(ne);
    for (uint64_t e = 0; e < ne; e++) wsorted[e] = weights[worder[e]];
    write_all(fout, wsorted.data(), sizeof(int32_t) * ne);
  }
  write_all(fout, degrees.data(), sizeof(uint32_t) * args.nv);
  std::fclose(fout);

  std::fprintf(stderr, "wrote %s: nv=%u ne=%" PRIu64 "%s\n",
               args.output.c_str(), args.nv, ne,
               args.weighted ? " (weighted)" : "");
  return 0;
}
