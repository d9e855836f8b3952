"""Edge list -> .lux conversion and the synthetic generators
(counterpart of lux_tpu/convert.py: ``edges_to_csc`` :22,
``convert_edge_list`` :60, ``rmat_edges`` :80, ``rmat_graph`` :107,
``netflix_like_edges`` :128, ``community_edges`` :176,
``community_graph`` :224).

``edges_to_csc`` produces the same canonical (dst, src) order as the
reference: one stable sort of the packed u64 key ``dst << 32 | src``
carrying the weights (``native.sort_kv``; under
``native.numpy_versions()``: numpy's stable argsort, the same
permutation), so both packages write byte-identical files for the same
edges.
"""

from __future__ import annotations

import numpy as np

from lux_tpu_torch import format as luxfmt
from lux_tpu_torch import native as _native


def edges_to_csc(src, dst, nv: int, weights=None):
    """Sort edges by (dst, src) and build CSC end-offset arrays.

    Returns (row_ptrs[u8 nv], col_idx[u4 ne] = sources, sorted_weights,
    out_degrees[u4 nv])."""
    src = np.asarray(src, dtype=np.uint32)
    dst = np.asarray(dst, dtype=np.uint32)
    if src.size and (int(src.max()) >= nv or int(dst.max()) >= nv):
        raise ValueError("edge endpoint out of range")
    key = dst.astype(np.uint64)
    key <<= np.uint64(32)
    np.bitwise_or(key, src, out=key)
    w_sorted = None
    if weights is not None:
        w_sorted = np.ascontiguousarray(weights)
        if np.shares_memory(w_sorted, weights):   # sort_kv permutes
            w_sorted = w_sorted.copy()            # in place
    _native.sort_kv(key, () if w_sorted is None else (w_sorted,))
    col_idx = key.astype(np.uint32)   # truncation keeps src
    del key
    counts = np.bincount(dst, minlength=nv).astype(np.uint64)
    row_ptrs = np.cumsum(counts, dtype=np.uint64)
    out_degrees = np.bincount(src, minlength=nv).astype(np.uint32)
    return row_ptrs, col_idx, w_sorted, out_degrees


def convert_edge_list(text_path: str, lux_path: str, nv: int,
                      weighted: bool = False):
    """Convert a text edge list (`src dst [weight]` per line) to .lux."""
    ncols = 3 if weighted else 2
    data = np.loadtxt(text_path, dtype=np.float64, ndmin=2)
    if data.size == 0:
        data = data.reshape(0, ncols)
    if data.shape[1] != ncols:
        raise ValueError(
            f"{text_path}: expected {ncols} columns "
            f"({'src dst weight' if weighted else 'src dst'}), "
            f"got {data.shape[1]}")
    src = data[:, 0].astype(np.uint32)
    dst = data[:, 1].astype(np.uint32)
    w = data[:, 2].astype(luxfmt.W_DTYPE) if weighted else None
    row_ptrs, col_idx, w_sorted, deg = edges_to_csc(src, dst, nv, w)
    luxfmt.write_lux(lux_path, row_ptrs, col_idx, w_sorted, deg)
    return row_ptrs, col_idx, w_sorted, deg


# R-MAT quadrant probabilities (the reference's defaults)
RMAT_A, RMAT_B, RMAT_C = 0.57, 0.19, 0.19


# R-MAT draws are cut into slices of at least this many edges, at most
# RMAT_MAX_SLICES of them, each drawn on a host thread of its own
RMAT_SLICE_EDGES = 1 << 16
RMAT_MAX_SLICES = 8


def rmat_cuts(ne: int) -> list:
    """The slice boundaries ``rmat_edges`` draws ``ne`` edges in: a rule
    of ``ne`` alone, so every host draws the same slices."""
    T = max(1, min(RMAT_MAX_SLICES, -(-ne // RMAT_SLICE_EDGES)))
    return [ne * k // T for k in range(T + 1)]


def rmat_edges(scale: int, edge_factor: int = 16, seed: int = 0):
    """R-MAT edge list (Chakrabarti et al., SDM'04): nv = 2**scale,
    ne = nv * edge_factor.  The same draws as the reference's
    ``rmat_edges`` for the same seed.  Returns (src, dst, nv).

    The reference draws ``scale`` passes of ``ne`` doubles from one
    PCG64 stream, then a permutation.  Each draw here is that same
    stream's: each slice of edges (``rmat_cuts``), on a host thread of
    its own, reads pass ``i``'s doubles from a PCG64 of the seed
    advanced to ``i * ne`` plus the slice's start (one 64-bit output a
    double), and the permutation from one advanced past every pass."""
    import os
    from concurrent.futures import ThreadPoolExecutor

    nv = 1 << scale
    ne = nv * edge_factor
    a, b, c = RMAT_A, RMAT_B, RMAT_C
    # ids fit uint32 (scale <= 32), updated in place
    src = np.zeros(ne, dtype=np.uint32)
    dst = np.zeros(ne, dtype=np.uint32)

    def draws(offset: int, n: int) -> np.ndarray:
        bg = np.random.PCG64(seed)
        bg.advance(offset)
        return np.random.Generator(bg).random(n)

    def fill(lo: int, hi: int) -> None:
        # one quadrant a draw: q = [r >= a] + [r >= a + b] + [r >= a + b
        # + c] in {0, 1, 2, 3}; the source bit is q >> 1, the
        # destination bit q & 1 (r in [a, a + b) or r >= a + b + c)
        s, d = src[lo:hi], dst[lo:hi]
        q = np.empty(hi - lo, dtype=np.uint8)
        hit = np.empty(hi - lo, dtype=bool)
        for i in range(scale):
            r = draws(i * ne + lo, hi - lo)
            np.greater_equal(r, a, out=hit)
            np.copyto(q, hit, casting="unsafe")
            np.greater_equal(r, a + b, out=hit)
            q += hit
            np.greater_equal(r, a + b + c, out=hit)
            q += hit
            del r
            s <<= 1
            s |= q >> 1
            d <<= 1
            d |= q & 1

    cuts = rmat_cuts(ne)
    with ThreadPoolExecutor(
            max_workers=min(len(cuts) - 1, os.cpu_count() or 1)) as ex:
        list(ex.map(fill, cuts[:-1], cuts[1:]))
    # permute vertex ids so the skew is not correlated with id order
    bg = np.random.PCG64(seed)
    bg.advance(scale * ne)
    perm = np.random.Generator(bg).permutation(nv).astype(np.uint32)
    return perm[src], perm[dst], nv


def rmat_graph(scale: int, edge_factor: int = 16, seed: int = 0,
               native: bool = False):
    """An R-MAT Graph.  ``native=False`` (the default): ``rmat_edges``'
    draws, the reference's graph for the same seed, sorted into CSC by
    ``edges_to_csc``.  ``native=True``: ``native.rmat_csc`` generates
    and sorts in C++, from another RNG stream: the same distribution,
    another graph."""
    from lux_tpu_torch.graph import Graph

    if native:
        row_ptrs, col_idx, degrees = _native.rmat_csc(scale, edge_factor,
                                                      seed)
        return Graph(nv=1 << scale, ne=int(col_idx.shape[0]),
                     row_ptrs=row_ptrs, col_idx=col_idx, weights=None,
                     out_degrees=degrees)
    src, dst, nv = rmat_edges(scale, edge_factor, seed)
    return Graph.from_edges(src, dst, nv)


def netflix_like_edges(n_users: int = 480_000, n_items: int = 17_700,
                       n_ratings: int = 100_000_000, seed: int = 0,
                       user_skew: float = 0.6, item_skew: float = 0.9):
    """A NetFlix-shaped weighted bipartite rating set (the reference's
    ColFilter workload): users [0, n_users), items [n_users, n_users +
    n_items), Zipf-like popularity on both sides, (user, item) pairs
    deduplicated, integer ratings 1..5 with the public dataset's
    marginal.  Every rating is an edge in both directions.  Returns
    (src, dst, weights, nv); the same draws as the reference's for the
    same arguments."""
    rng = np.random.default_rng(seed)

    def sample(n, skew, count):
        w = (np.arange(1, n + 1, dtype=np.float64)) ** -skew
        cdf = np.cumsum(w)
        cdf /= cdf[-1]
        return np.searchsorted(cdf, rng.random(count)).astype(np.uint32)

    users = sample(n_users, user_skew, n_ratings)
    items = sample(n_items, item_skew, n_ratings)
    # dedup (user, item) pairs: one u64 key sort + a boundary pass
    key = users.astype(np.uint64)
    key *= np.uint64(n_items)
    key += items
    _native.sort_kv(key, ())
    keep = np.ones(len(key), bool)
    keep[1:] = key[1:] != key[:-1]
    key = key[keep]
    users = (key // np.uint64(n_items)).astype(np.uint32)
    items = (key % np.uint64(n_items)).astype(np.uint32) + n_users
    w = rng.choice(np.arange(1, 6, dtype=np.int32), size=len(users),
                   p=[0.05, 0.10, 0.23, 0.34, 0.28])
    src = np.concatenate([users, items])
    dst = np.concatenate([items, users])
    weights = np.concatenate([w, w])
    return src, dst, weights, n_users + n_items


def community_edges(scale: int, edge_factor: int = 16,
                    community_scale: int = 8, p_in: float = 0.98,
                    seed: int = 0, scrambled: bool = True,
                    weighted: bool = False):
    """Planted-partition edge list: 2^scale vertices in communities of
    2^community_scale; each vertex draws ``edge_factor`` out-edges, a
    fraction ``p_in`` inside its own community, the rest uniform.  The
    locality-rich counterpart of R-MAT: under perfect clustering a
    paged row holds about 128 / (p_in + 128 (1 - p_in)) live lanes (~36
    at 0.98, ~10 at 0.9).  ``scrambled`` (default) relabels the
    vertices at random, so recovering the communities is the reorder
    pass's job (reorder.py); ``scrambled=False`` keeps them contiguous.
    Returns (src, dst, weights | None, nv) uint32 edge arrays; the same
    draws as the reference's for the same arguments."""
    if not 0.0 <= p_in <= 1.0:
        raise ValueError(f"p_in must be in [0, 1], got {p_in}")
    if community_scale > scale:
        raise ValueError(f"community_scale {community_scale} > "
                         f"scale {scale}")
    rng = np.random.default_rng(seed)
    nv = 1 << scale
    csize = 1 << community_scale
    ne = nv * edge_factor
    src = np.repeat(np.arange(nv, dtype=np.int64), edge_factor)
    comm = src // csize
    inside = rng.random(ne) < p_in
    dst = np.where(
        inside,
        comm * csize + rng.integers(0, csize, size=ne),
        rng.integers(0, nv, size=ne))
    if scrambled:
        shuf = rng.permutation(nv)
        src = shuf[src]
        dst = shuf[dst]
    w = (rng.integers(1, 6, size=ne).astype(np.int32)
         if weighted else None)
    return src.astype(np.uint32), dst.astype(np.uint32), w, nv


def community_graph(scale: int, edge_factor: int = 16,
                    community_scale: int = 8, p_in: float = 0.98,
                    seed: int = 0, scrambled: bool = True,
                    weighted: bool = False):
    """``community_edges`` as a Graph (dst-sorted CSC)."""
    from lux_tpu_torch.graph import Graph

    src, dst, w, nv = community_edges(
        scale, edge_factor, community_scale, p_in, seed,
        scrambled=scrambled, weighted=weighted)
    return Graph.from_edges(src, dst, nv, weights=w)


def uniform_random_edges(nv: int, ne: int, seed: int = 0):
    """Uniform random (src, dst) uint32 edge arrays (test-sized)."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, nv, size=ne, dtype=np.uint32)
    dst = rng.integers(0, nv, size=ne, dtype=np.uint32)
    return src, dst
