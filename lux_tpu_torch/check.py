"""Correctness audits (counterpart of lux_tpu/check.py:20-91, with
``check_colfilter`` :67):
host-side fixed-point checks over the edge list.  The reference's
``-check`` GPU tasks audit only fixed points per part (sssp_gpu.cu:
773-798, components_gpu.cu:788); device_check.py runs the same
audits on the engine's device."""

from __future__ import annotations

import dataclasses

import numpy as np

from lux_tpu_torch.graph import Graph


@dataclasses.dataclass(frozen=True)
class CheckResult:
    name: str
    violations: int
    checked: int
    # device audits report per-part counts, like the reference's
    # per-part [PASS]/[FAIL] prints (sssp_gpu.cu:837-842)
    per_part: tuple | None = None
    unit: str = "vertices"      # what ``checked`` counts

    @property
    def ok(self) -> bool:
        return self.violations == 0

    def __str__(self):
        tag = "PASS" if self.ok else "FAIL"
        s = (f"[{tag}] {self.name}: {self.violations} violations "
             f"over {self.checked} {self.unit}")
        if self.per_part is not None and not self.ok:
            failing = {p: c for p, c in enumerate(self.per_part) if c}
            s += f" (by part: {failing})"
        return s


def check_sssp(g: Graph, dist: np.ndarray,
               weighted: bool = False) -> CheckResult:
    """Fixed point: dist[dst] <= dist[src] + w for every edge
    (reference sssp_gpu.cu:792-796 with w = 1)."""
    src, dst = g.edge_arrays()
    if weighted:
        w = np.asarray(g.weights, dtype=np.float64)
        d = np.asarray(dist, dtype=np.float64)
    else:
        w = 1
        d = np.asarray(dist, dtype=np.int64)
    bad = int(np.count_nonzero(d[dst] > d[src] + w))
    return CheckResult("sssp triangle inequality", bad, g.ne, unit="edges")


def check_components(g: Graph, labels: np.ndarray) -> CheckResult:
    """Fixed point: labels[dst] >= labels[src] for every edge
    (reference components_gpu.cu:788)."""
    src, dst = g.edge_arrays()
    lab = np.asarray(labels, dtype=np.int64)
    bad = int(np.count_nonzero(lab[dst] < lab[src]))
    return CheckResult("components monotonicity", bad, g.ne, unit="edges")


def check_colfilter(g: Graph, state: np.ndarray) -> CheckResult:
    """Training audit: the learned factors must predict the ratings no
    worse than the uniform sqrt(1/K) init."""
    from lux_tpu_torch.apps.colfilter import K, rmse
    state = np.asarray(state)
    k = state.shape[1] if state.ndim > 1 else K
    init = np.full((g.nv, k), np.sqrt(1.0 / k), dtype=np.float64)
    bad = int(rmse(g, state) > rmse(g, init) + 1e-9)
    return CheckResult("colfilter rmse non-increase", bad, g.ne,
                       unit="edges")


def check_pagerank(g: Graph, norm_ranks: np.ndarray,
                   tol: float = 1e-6) -> CheckResult:
    """Residual audit: one more iteration moves every degree-normalized
    rank by less than ``tol`` — meaningful near convergence; with few
    iterations use a loose tol."""
    from lux_tpu_torch.apps.pagerank import ALPHA
    src, dst = g.edge_arrays()
    deg = g.out_degrees.astype(np.float64)
    state = np.asarray(norm_ranks, dtype=np.float64)
    acc = np.bincount(dst, weights=state[src], minlength=g.nv)
    pr = (1.0 - ALPHA) / g.nv + ALPHA * acc
    nxt = np.where(deg > 0, pr / np.maximum(deg, 1), pr)
    bad = int(np.count_nonzero(np.abs(nxt - state) > tol))
    return CheckResult(f"pagerank residual(tol={tol})", bad, g.nv)
