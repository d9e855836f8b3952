"""On-device correctness audits (counterpart of lux_tpu/device_check.py:
47 ``DeviceChecker``, :130 ``sssp``, :146 ``components`` and :203-210).

The host audits in check.py rebuild the whole edge list in numpy; these
run per part on the engine's device over the ShardedGraph's part-major
edge arrays — one gather of the audited state by ``src_slot``, one of
each part's own state by ``dst_local``, a compare and a count — and
read back one int32 count per part.  They count exactly what check.py
counts (for float distances: where the float32 sum rounds the same as
float64, e.g. integer weights).  The pagerank and colfilter audits are
not ported yet (ROADMAP A4 leftovers).
"""

from __future__ import annotations

import numpy as np
import torch

from lux_tpu_torch.check import CheckResult
from lux_tpu_torch.device import resolve_device
from lux_tpu_torch.graph import ShardedGraph


class DeviceChecker:
    """Per-part audits over one ShardedGraph on ``device`` (None = the
    card).  The flat part-major edge arrays go to the device once and
    serve every audit."""

    def __init__(self, sg: ShardedGraph, device=None):
        self.sg = sg
        self.device = resolve_device(device)
        self.src_slot = torch.tensor(sg.src_slot, device=self.device)
        self.dst_local = torch.tensor(sg.dst_local, device=self.device)
        self.weight = (torch.tensor(sg.edge_weight, device=self.device)
                       if sg.weighted else None)

    def _padded(self, state) -> torch.Tensor:
        """The engine's padded [P, vpad] state (tensor or array), or a
        host user-order [nv] array, as a tensor on the device."""
        sg = self.sg
        if tuple(state.shape) != (sg.num_parts, sg.vpad):
            state = sg.to_padded(np.asarray(state))
        return torch.as_tensor(state, device=self.device)

    def _edge_pred_counts(self, state, pred) -> list:
        """Edges violating ``pred(src_val, dst_val, weight)`` per part."""
        vpad = self.sg.vpad
        state = self._padded(state)
        src_v = torch.index_select(state.reshape(-1), 0,
                                   self.src_slot.reshape(-1).to(torch.int64))
        src_v = src_v.view(self.src_slot.shape)
        dst_v = torch.gather(state, 1,
                             self.dst_local.clamp(max=vpad - 1)
                             .to(torch.int64))
        bad = pred(src_v, dst_v, self.weight) & (self.dst_local < vpad)
        return bad.sum(dim=1, dtype=torch.int32).cpu().tolist()

    def sssp(self, state, weighted: bool = False) -> CheckResult:
        """Fixed point: dist[dst] <= dist[src] + w for every edge
        (reference sssp_gpu.cu:792-796, w = 1 in hops mode)."""
        if weighted and not self.sg.weighted:
            raise ValueError("weighted check needs a weighted graph")

        def pred(src_v, dst_v, w):
            return dst_v > src_v + (w if weighted else 1)

        counts = self._edge_pred_counts(state, pred)
        return CheckResult("sssp triangle inequality (device)",
                           sum(counts), self.sg.ne,
                           per_part=tuple(counts), unit="edges")

    def components(self, state) -> CheckResult:
        """Fixed point: labels[dst] >= labels[src]
        (reference components_gpu.cu:788)."""
        counts = self._edge_pred_counts(state, lambda s, d, w: d < s)
        return CheckResult("components monotonicity (device)",
                           sum(counts), self.sg.ne,
                           per_part=tuple(counts), unit="edges")


def check_sssp_device(sg, state, weighted=False, device=None):
    return DeviceChecker(sg, device).sssp(state, weighted)


def check_components_device(sg, state, device=None):
    return DeviceChecker(sg, device).components(state)
