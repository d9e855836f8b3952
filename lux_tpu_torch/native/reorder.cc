// Page-aware clustering vertex reorder (ROADMAP item 1, round 16).
//
// The paged two-level gather (lux_tpu_torch/ops/pagegather.py) delivers
// edges at the modeled ~1.6 ns only when edges sharing a
// (dst tile, src page) actually cluster — and R-MAT under a plain
// degree sort does not (measured fill 6-12 vs break-even 23,
// PERF_NOTES round 15).  This pass manufactures that locality on the
// host, once, like the converter/sort beside it: a Cuthill-McKee
// style clustering BFS (the Rabbit-order/RCM family — Lux itself
// wins by choosing edge layouts matched to its memory hierarchy,
// reference README.md:33-38) that lays each traversed neighborhood
// contiguously, so a 128-vertex destination tile's in-edge sources
// concentrate into few 128-wide state pages.
//
// Three modes are exposed: 0 = classic ascending-degree
// Cuthill-McKee BFS; 1 = hub-first BFS (descending degree), which
// groups the power-law hubs' shared neighborhoods early; 2 = LABEL
// PROPAGATION communities (the Rabbit-order move: a few async LPA
// rounds recover cluster structure BFS leaks across — each vertex
// adopts its neighbors' most frequent label, ties to the smaller —
// then vertices lay out grouped by community, degree-major within).
// The Python hill-climb driver (lux_tpu_torch/reorder.py) scores all of
// them against the plan builder's measured page_fill objective and
// refines the winner.
//
// Output contract: perm_out[new_position] = old_id — the same
// direction as lux_tpu_torch.graph.degree_relabel's perm, and what the
// .perm sidecar stores (lux_tpu_torch/format.py).  The result is always a
// bijection of [0, nv): every vertex is visited exactly once
// (isolated vertices seed their own singleton clusters), checked
// end-to-end by the sanitize driver.
#include <algorithm>
#include <cstdint>
#include <vector>

extern "C" int lux_reorder_cluster(uint32_t nv, uint64_t ne,
                                   const uint32_t* src,
                                   const uint32_t* dst,
                                   int mode,
                                   uint32_t* perm_out) {
  if (perm_out == nullptr || (ne > 0 && (src == nullptr || dst == nullptr)))
    return -1;
  if (mode < 0 || mode > 2) return -4;
  if (nv == 0) return 0;
  const bool hubs_first = mode != 0;

  // undirected degree + adjacency CSR (both directions): the
  // clustering objective is symmetric — a page is good when its
  // vertices SHARE neighborhoods, regardless of edge direction
  std::vector<uint64_t> off(static_cast<size_t>(nv) + 1, 0);
  for (uint64_t e = 0; e < ne; e++) {
    if (src[e] >= nv || dst[e] >= nv) return -2;
    off[src[e] + 1]++;
    off[dst[e] + 1]++;
  }
  for (uint32_t v = 0; v < nv; v++) off[v + 1] += off[v];
  std::vector<uint32_t> adj(2 * ne);
  {
    std::vector<uint64_t> cur(off.begin(), off.end() - 1);
    for (uint64_t e = 0; e < ne; e++) {
      adj[cur[src[e]]++] = dst[e];
      adj[cur[dst[e]]++] = src[e];
    }
  }
  std::vector<uint64_t> deg(nv);
  for (uint32_t v = 0; v < nv; v++) deg[v] = off[v + 1] - off[v];

  if (mode == 2) {
    // label-propagation communities: async sweeps in degree-desc
    // order; each vertex adopts the most frequent label among its
    // neighbors (ties -> smaller label).  Converges in a handful of
    // rounds on clustered graphs; the final order groups vertices by
    // community (communities by first-touch of their final label),
    // degree-major within, so a community's members share state
    // pages — the objective the paged plan bins for.
    std::vector<uint32_t> labels(nv), sweep(nv);
    for (uint32_t v = 0; v < nv; v++) labels[v] = v;
    for (uint32_t v = 0; v < nv; v++) sweep[v] = v;
    std::stable_sort(sweep.begin(), sweep.end(),
                     [&](uint32_t a, uint32_t b) {
                       return deg[a] > deg[b];
                     });
    std::vector<uint32_t> nlab;
    const int kRounds = 8;
    for (int round = 0; round < kRounds; round++) {
      uint64_t changed = 0;
      for (uint32_t v : sweep) {
        if (off[v + 1] == off[v]) continue;
        nlab.clear();
        for (uint64_t i = off[v]; i < off[v + 1]; i++)
          nlab.push_back(labels[adj[i]]);
        std::sort(nlab.begin(), nlab.end());
        uint32_t best = nlab[0], cur = nlab[0];
        uint64_t best_n = 0, cur_n = 0;
        for (uint32_t l : nlab) {
          if (l == cur) {
            cur_n++;
          } else {
            cur = l;
            cur_n = 1;
          }
          if (cur_n > best_n) {
            best_n = cur_n;
            best = cur;
          }
        }
        if (best != labels[v]) {
          labels[v] = best;
          changed++;
        }
      }
      if (changed == 0) break;
    }
    // order: (community by first touch in degree-major sweep,
    // degree desc, id) — stable two-key sort via community rank
    std::vector<uint32_t> comm_rank(nv, 0);
    std::vector<uint8_t> seen(nv, 0);
    uint32_t next_comm = 0;
    for (uint32_t v : sweep) {
      uint32_t l = labels[v];
      if (!seen[l]) {
        seen[l] = 1;
        comm_rank[l] = next_comm++;
      }
    }
    std::vector<uint32_t> order(sweep);  // already degree-desc
    std::stable_sort(order.begin(), order.end(),
                     [&](uint32_t a, uint32_t b) {
                       return comm_rank[labels[a]]
                            < comm_rank[labels[b]];
                     });
    for (uint32_t i = 0; i < nv; i++) perm_out[i] = order[i];
    return 0;
  }

  // seed order: stable degree sort (descending for hub-first)
  std::vector<uint32_t> seeds(nv);
  for (uint32_t v = 0; v < nv; v++) seeds[v] = v;
  std::stable_sort(seeds.begin(), seeds.end(),
                   [&](uint32_t a, uint32_t b) {
                     return hubs_first ? deg[a] > deg[b]
                                       : deg[a] < deg[b];
                   });

  std::vector<uint8_t> visited(nv, 0);
  std::vector<uint32_t> queue;   // FIFO over the whole run: the BFS
  queue.reserve(nv);             // layout IS the output order
  std::vector<uint32_t> nbuf;    // per-vertex neighbor scratch
  size_t head = 0;
  for (uint32_t s : seeds) {
    if (visited[s]) continue;
    visited[s] = 1;
    queue.push_back(s);
    while (head < queue.size()) {
      uint32_t x = queue[head++];
      nbuf.clear();
      for (uint64_t i = off[x]; i < off[x + 1]; i++) {
        uint32_t n = adj[i];
        if (!visited[n]) {
          visited[n] = 1;   // mark at enqueue: adjacency may repeat
          nbuf.push_back(n);
        }
      }
      std::stable_sort(nbuf.begin(), nbuf.end(),
                       [&](uint32_t a, uint32_t b) {
                         return hubs_first ? deg[a] > deg[b]
                                           : deg[a] < deg[b];
                       });
      for (uint32_t n : nbuf) queue.push_back(n);
    }
  }
  if (queue.size() != nv) return -3;  // bijection violated (bug)
  for (uint32_t i = 0; i < nv; i++) perm_out[i] = queue[i];
  return 0;
}
