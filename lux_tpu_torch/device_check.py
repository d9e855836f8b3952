"""On-device correctness audits (counterpart of lux_tpu/device_check.py:
47 ``DeviceChecker``, :130 ``sssp``, :146 ``components``, :155
``pagerank``, :177 ``colfilter`` and :203-218).

The host audits in check.py rebuild the whole edge list in numpy; these
run per part on the engine's device over the ShardedGraph's part-major
edge arrays — one gather of the audited state by ``src_slot``, one of
each part's own state by ``dst_local``, a compare and a count — and
read back one int32 count per part.  They count exactly what check.py
counts (for float distances: where the float32 sum rounds the same as
float64, e.g. integer weights).  The pagerank audit re-derives one
iteration with the flat segment reduce, the colfilter audit sums the
squared rating errors of the learned and the initial factors per part,
both in float32 on the device.
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
        """The engine's padded [P, vpad, ...] state (tensor or array),
        or a host user-order [nv, ...] array, as a tensor on the
        device."""
        sg = self.sg
        if tuple(state.shape[:2]) != (sg.num_parts, sg.vpad):
            state = sg.to_padded(np.asarray(state))
        return torch.as_tensor(state, device=self.device)

    def _edge_rows(self, state):
        """(padded state, each edge's source and destination state
        [P, epad, ...], real-edge mask [P, epad]); pads read slot
        vpad - 1 of their part and are masked."""
        vpad = self.sg.vpad
        state = self._padded(state)
        trail = tuple(state.shape[2:])
        shape = tuple(self.src_slot.shape) + trail
        flat = state.reshape((-1,) + trail)
        src_v = torch.index_select(
            flat, 0, self.src_slot.reshape(-1).to(torch.int64)).view(shape)
        base = torch.arange(self.sg.num_parts,
                            device=self.device)[:, None] * vpad
        dst_i = self.dst_local.to(torch.int64).clamp(max=vpad - 1) + base
        dst_v = torch.index_select(flat, 0, dst_i.reshape(-1)).view(shape)
        return state, src_v, dst_v, self.dst_local < vpad

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

    def pagerank(self, state, tol: float = 1e-6) -> CheckResult:
        """Residual audit: one more (degree-normalized) iteration moves
        every rank by less than ``tol`` (see check.check_pagerank)."""
        from lux_tpu_torch.apps.pagerank import ALPHA
        from lux_tpu_torch.ops.segment import segment_reduce
        sg = self.sg
        P, vpad = sg.num_parts, sg.vpad
        state, src_v, _dst_v, valid = self._edge_rows(state)
        msgs = torch.where(valid, src_v, torch.zeros_like(src_v))
        base = torch.arange(P, device=self.device)[:, None] * (vpad + 1)
        seg = (self.dst_local.to(torch.int64) + base).reshape(-1)
        red = segment_reduce(msgs.reshape(-1), seg, P * (vpad + 1),
                             "sum").view(P, vpad + 1)[:, :vpad]
        pr = (1.0 - ALPHA) / sg.nv + ALPHA * red
        deg = torch.as_tensor(sg.deg_padded, device=self.device)
        nxt = torch.where(deg > 0, pr / deg.clamp(min=1).to(pr.dtype), pr)
        vm = torch.as_tensor(sg.vmask, device=self.device)
        bad = ((nxt - state).abs() > tol) & vm
        counts = bad.sum(dim=1, dtype=torch.int32).cpu().tolist()
        return CheckResult(f"pagerank residual(tol={tol}) (device)",
                           sum(counts), sg.nv, per_part=tuple(counts))

    def colfilter(self, state) -> CheckResult:
        """The learned factors must predict the ratings no worse than
        the uniform sqrt(1/K) init (see check.check_colfilter), whose
        prediction is K * (1/K) = 1 on every edge."""
        if self.weight is None:
            raise ValueError("the colfilter audit needs a weighted graph")
        _state, src_v, dst_v, valid = self._edge_rows(state)
        pred = (src_v * dst_v).sum(dim=-1)
        zero = torch.zeros((), dtype=pred.dtype, device=self.device)
        err = torch.where(valid, self.weight - pred, zero)
        err0 = torch.where(valid, self.weight - 1.0, zero)
        sse = torch.stack([(err * err).sum(dim=1),
                           (err0 * err0).sum(dim=1)], dim=1).cpu().numpy()
        ne = max(1, self.sg.ne)
        learned = float(np.sqrt(sse[:, 0].astype(np.float64).sum() / ne))
        init = float(np.sqrt(sse[:, 1].astype(np.float64).sum() / ne))
        bad = int(learned > init + 1e-9)
        return CheckResult("colfilter rmse non-increase (device)", bad,
                           self.sg.ne, unit="edges")


def check_sssp_device(sg, state, weighted=False, device=None):
    return DeviceChecker(sg, device).sssp(state, weighted)


def check_components_device(sg, state, device=None):
    return DeviceChecker(sg, device).components(state)


def check_pagerank_device(sg, state, tol=1e-6, device=None):
    return DeviceChecker(sg, device).pagerank(state, tol)


def check_colfilter_device(sg, state, device=None):
    return DeviceChecker(sg, device).colfilter(state)
