"""Edge list -> .lux conversion and the R-MAT generator (counterpart of
lux_tpu/convert.py:22, :60, :80, :107).

``edges_to_csc`` produces the same canonical (dst, src) order as the
reference: one stable numpy sort of the packed u64 key ``dst << 32 |
src`` (the reference's numpy fallback for its native radix sort), so
both packages write byte-identical files for the same edges.
"""

from __future__ import annotations

import numpy as np

from lux_tpu_torch import format as luxfmt


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
    order = np.argsort(key, kind="stable")
    col_idx = key[order].astype(np.uint32)   # truncation keeps src
    del key
    w_sorted = None
    if weights is not None:
        w_sorted = np.ascontiguousarray(np.asarray(weights)[order])
    del order
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


def rmat_edges(scale: int, edge_factor: int = 16, seed: int = 0):
    """R-MAT edge list (Chakrabarti et al., SDM'04): nv = 2**scale,
    ne = nv * edge_factor.  The same draws as the reference's
    ``rmat_edges`` for the same seed.  Returns (src, dst, nv)."""
    nv = 1 << scale
    ne = nv * edge_factor
    a, b, c = RMAT_A, RMAT_B, RMAT_C
    rng = np.random.default_rng(seed)
    src = np.zeros(ne, dtype=np.uint64)
    dst = np.zeros(ne, dtype=np.uint64)
    for _ in range(scale):
        r = rng.random(ne)
        src_bit = (r >= a + b).astype(np.uint64)
        dst_bit = ((r >= a) & (r < a + b) | (r >= a + b + c)).astype(np.uint64)
        src = (src << np.uint64(1)) | src_bit
        dst = (dst << np.uint64(1)) | dst_bit
    # permute vertex ids so the skew is not correlated with id order
    perm = rng.permutation(nv).astype(np.uint32)
    return perm[src.astype(np.uint32)], perm[dst.astype(np.uint32)], nv


def rmat_graph(scale: int, edge_factor: int = 16, seed: int = 0):
    """An R-MAT Graph through the numpy path (``rmat_edges`` +
    ``edges_to_csc``)."""
    from lux_tpu_torch.graph import Graph

    src, dst, nv = rmat_edges(scale, edge_factor, seed)
    return Graph.from_edges(src, dst, nv)


def uniform_random_edges(nv: int, ne: int, seed: int = 0):
    """Uniform random (src, dst) uint32 edge arrays (test-sized)."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, nv, size=ne, dtype=np.uint32)
    dst = rng.integers(0, nv, size=ne, dtype=np.uint32)
    return src, dst
