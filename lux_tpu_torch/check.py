"""Correctness audits (counterpart of lux_tpu/check.py:20-91 for
PageRank): host-side fixed-point checks over the edge list."""

from __future__ import annotations

import dataclasses

import numpy as np

from lux_tpu_torch.graph import Graph


@dataclasses.dataclass(frozen=True)
class CheckResult:
    name: str
    violations: int
    checked: int

    @property
    def ok(self) -> bool:
        return self.violations == 0

    def __str__(self):
        tag = "PASS" if self.ok else "FAIL"
        return (f"[{tag}] {self.name}: {self.violations} violations "
                f"over {self.checked} vertices")


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
