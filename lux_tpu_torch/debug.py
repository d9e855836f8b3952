"""Failure detection and numeric guards on segment boundaries
(counterpart of lux_tpu/debug.py).

``check_finite`` reads a state to the host and raises on NaN (or Inf);
``run_guarded`` / ``converge_guarded`` run the engines in segments with
that check at every boundary (segmented.py), and the push form also
detects a stalled frontier across segments.  These are the host-side
guards; the device-side watchdog is health.py.
"""

from __future__ import annotations

import numpy as np
import torch

from lux_tpu_torch import segmented


class GuardError(RuntimeError):
    """Base of the runtime guards' failures.  resilience.classify keys
    off the subclasses: DivergenceError (a NaN escape, possibly a
    transient corruption whose last checkpoint is clean) is retryable
    from a checkpoint; StallError (a deterministic livelock) is
    fatal."""


class DivergenceError(GuardError):
    pass


class StallError(GuardError):
    pass


def leaves(tree) -> list:
    """The array leaves of a state: a tensor or array, or a
    tuple / list / dict of them (dict keys in sorted order, as the
    reference's pytree flattening)."""
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in leaves(t)]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    return [tree]


def to_host(x) -> np.ndarray:
    """A leaf as host numpy, dtype and values kept (``.cpu()`` also
    waits for the device work behind it)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def check_finite(state, where: str = "state",
                 allow_inf: bool = False) -> None:
    """Raise DivergenceError if any floating leaf holds NaN (or Inf,
    unless ``allow_inf``: push labels use +inf as the unreached
    sentinel).  Reads to the host: call on segment boundaries."""
    for i, leaf in enumerate(leaves(state)):
        arr = to_host(leaf)
        if not np.issubdtype(arr.dtype, np.floating):
            continue
        bad = np.isnan(arr) if allow_inf else ~np.isfinite(arr)
        if bad.any():
            kind = "NaN" if allow_inf else "non-finite"
            raise DivergenceError(
                f"{where}: leaf {i} has {int(bad.sum())} {kind} values "
                f"(dtype {arr.dtype}, shape {arr.shape})")


def run_guarded(eng, state, num_iters: int, segment: int = 50,
                where: str = "pull run"):
    """Pull-engine run with a finite check every ``segment``
    iterations; raises DivergenceError naming the failing segment."""
    return segmented.run_segments(
        eng, state, num_iters, segment,
        on_segment=lambda s, done:
            check_finite(s, f"{where} @ iteration {done}"))


def converge_guarded(eng, max_iters: int | None = None,
                     segment: int = 64, stall_segments: int = 3):
    """Push-engine convergence with stall detection.

    Progress is the (monotone) label fingerprint — the float64 sum of
    the finite labels — not the frontier size, which legitimately
    stays constant on path-like graphs.  If the fingerprint AND the
    active count are unchanged for ``stall_segments`` consecutive
    segments while the frontier is non-empty, raises StallError.  NaN
    labels raise DivergenceError (+inf sentinels are fine).  Returns
    (labels [nv] host, total_iters)."""
    label0, active0 = eng.init_state()
    history: list[tuple] = []

    def on_segment(label, active, total, cnt):
        if cnt == 0:
            return
        check_finite(label, f"push converge @ iteration {total}",
                     allow_inf=True)
        arr = to_host(label).astype(np.float64)
        fp = float(arr[np.isfinite(arr)].sum())
        history.append((cnt, fp))
        if len(history) > stall_segments:
            history.pop(0)
        if len(history) == stall_segments and len(set(history)) == 1:
            raise StallError(
                f"frontier stuck at {cnt} active vertices with no "
                f"label progress for {stall_segments * segment} "
                f"iterations")

    label, _active, total = segmented.converge_segments(
        eng, label0, active0, segment, max_iters, on_segment=on_segment)
    return eng.unpad(label), total
