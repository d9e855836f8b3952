"""Profiler ranges and traces on the port (lux_tpu_torch/profiling.py and
the engines' named ranges).

- ``profiling.trace`` writes one Chrome trace (``trace.json``) holding
  the engines' ranges with the reference's names (pull: lux_exchange,
  lux_gather, lux_reduce, lux_apply, lux_gather_reduce, lux_dot_reduce
  and lux_<program>; push: lux_dense / lux_sparse with lux_exchange,
  lux_relax, lux_reduce, lux_update inside), one of each an iteration,
  and the run paths' lux_timed_run / lux_segment / lux_checkpoint_save.
- Outside a trace no range is entered (``record_function`` is a
  dispatcher op, and the streamed pair step is host bound).
- The phase timer prints the reference's table.

On the CPU at R-MAT 7-8; counts compare exactly.
"""

import json
import os

import numpy as np
import pytest
import torch

from lux_tpu_torch import checkpoint, profiling, segmented, timing
from lux_tpu_torch.apps import colfilter, pagerank, sssp
from lux_tpu_torch.convert import rmat_graph
from lux_tpu_torch.graph import Graph

CPU = "cpu"


@pytest.fixture(scope="module")
def graph():
    return rmat_graph(scale=8, edge_factor=8, seed=2)


def _names(path) -> list:
    doc = json.load(open(path))
    evs = doc["traceEvents"] if isinstance(doc, dict) else doc
    return [e.get("name") for e in evs if e.get("ph") == "X"]


def _count(names, name) -> int:
    return sum(1 for n in names if n == name)


def test_trace_holds_the_pull_ranges(graph, tmp_path):
    eng = pagerank.build_engine(graph, 2, device=CPU)
    state = eng.init_state()
    with profiling.trace(str(tmp_path), device=CPU) as prof:
        assert prof is not None and profiling.active()
        eng.run(state, 4)
    names = _names(tmp_path / profiling.TRACE_FILE)
    for r in ("lux_exchange", "lux_gather", "lux_reduce", "lux_apply",
              "lux_pagerank"):
        assert _count(names, r) == 4, r
    assert _count(names, "lux_gather_reduce") == 0
    assert not profiling.active()


def test_paged_and_dot_ranges(graph, tmp_path):
    eng = pagerank.build_engine(graph, 1, device=CPU, gather="paged")
    src, dst = graph.edge_arrays()
    w = np.random.default_rng(3).integers(1, 6, src.size).astype(np.int32)
    cf = colfilter.build_engine(Graph.from_edges(src, dst, graph.nv,
                                                 weights=w), 1, device=CPU)
    with profiling.trace(str(tmp_path), device=CPU):
        eng.run(eng.init_state(), 2)
        cf.run(cf.init_state(), 3)
    names = _names(tmp_path / profiling.TRACE_FILE)
    assert _count(names, "lux_gather_reduce") == 2
    assert _count(names, "lux_dot_reduce") == 3
    assert _count(names, "lux_apply") == 5
    assert _count(names, "lux_gather") == 0


def test_push_ranges(graph, tmp_path):
    start = int(np.bincount(graph.edge_arrays()[0],
                            minlength=graph.nv).argmax())
    eng = sssp.build_engine(graph, start, device=CPU)
    with profiling.trace(str(tmp_path), device=CPU):
        _l, _a, it = eng.converge(*eng.init_state())
    names = _names(tmp_path / profiling.TRACE_FILE)
    dense = eng.schedule.count("dense")
    sparse = eng.schedule.count("sparse")
    assert dense >= 1 and sparse >= 1 and dense + sparse == it
    assert _count(names, "lux_dense") == dense
    assert _count(names, "lux_sparse") == sparse
    for r in ("lux_exchange", "lux_relax", "lux_reduce", "lux_update"):
        assert _count(names, r) == dense, r
    assert _count(names, "lux_sssp") == it


def test_run_path_ranges(graph, tmp_path):
    """lux_timed_run from timing's trace_dir, lux_segment# from the
    drivers, lux_checkpoint_save around a save."""
    eng = pagerank.build_engine(graph, 1, device=CPU)
    _s, secs = timing.timed_fused_run(eng, 2, trace_dir=str(tmp_path / "a"))
    names = _names(tmp_path / "a" / profiling.TRACE_FILE)
    assert _count(names, "lux_timed_run#0") == 1
    assert _count(names, "lux_apply") == 2       # the timed run alone
    with profiling.trace(str(tmp_path / "b"), device=CPU):
        segmented.run_segments(eng, eng.init_state(), 5, 2)
        checkpoint.run_checkpointed(eng, eng.init_state(), 2,
                                    str(tmp_path / "c.npz"), segment=1)
    names = _names(tmp_path / "b" / profiling.TRACE_FILE)
    assert [n for n in names if n.startswith("lux_segment")] == \
        ["lux_segment#0", "lux_segment#1", "lux_segment#2",
         "lux_segment#0", "lux_segment#1"]
    assert _count(names, "lux_checkpoint_save") == 2


def test_no_range_is_entered_without_a_profiler(graph, monkeypatch):
    """Outside a trace the engines enter no record_function at all."""
    entered = []
    real = torch.profiler.record_function

    def spy(name, *a, **k):
        entered.append(name)
        return real(name, *a, **k)
    monkeypatch.setattr(torch.profiler, "record_function", spy)
    eng = pagerank.build_engine(graph, 1, device=CPU)
    eng.run(eng.init_state(), 3)
    start = int(np.bincount(graph.edge_arrays()[0],
                            minlength=graph.nv).argmax())
    p = sssp.build_engine(graph, start, device=CPU)
    p.converge(*p.init_state())
    assert entered == []
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        eng.run(eng.init_state(), 1)
    assert "lux_apply" in entered


def test_trace_without_dir_is_a_no_op(graph, tmp_path, capsys):
    with profiling.trace(None) as prof:
        assert prof is None and not profiling.active()
    assert capsys.readouterr().out == ""
    with profiling.trace(str(tmp_path / "t"), device=CPU):
        pass
    assert "profiler trace written to" in capsys.readouterr().out
    assert os.path.exists(tmp_path / "t" / profiling.TRACE_FILE)


def test_phase_timer_report(capsys):
    pt = profiling.PhaseTimer()
    with pt.phase("load"):
        pass
    with pt.phase("iterate") as ph:
        ph.fence = torch.ones(3)
    rows = pt.report()
    assert [n for n, _t in rows] == ["load", "iterate"]
    out = capsys.readouterr().out.splitlines()
    assert out[0].lstrip().startswith("load") and "total" in out[-1]


def test_device_fence_on_the_cpu_is_a_no_op():
    assert profiling.device_fence(CPU)() is None
