"""Several processes on one host, each loading only its own parts (the
reference's tests/test_multiprocess.py and tests/mp_worker.py, as gloo
ranks on the CPU).

A .lux file is written once here; two ranks spawned by
``parallel.launch.spawn_ranks`` each build ``ShardedGraph.
build_from_file(parts=process_parts(P))`` through the native loader and
run PageRank and SSSP on the gather and owner exchanges and on a
local-parts pair build, held here against the NumPy oracles (PageRank
rtol 2e-5, labels bit for bit).  A local-parts build of another rank's
parts raises as the reference's ``_check_local_parts`` does.  Then the
CLI under torchrun (``-mesh 2``, two gloo ranks, only rank 0 printing)
and the dryrun's own entry point at world 2."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from lux_tpu_torch.apps import pagerank, sssp
from lux_tpu_torch.format import write_lux
from lux_tpu_torch.graph import Graph
from lux_tpu_torch.parallel import suites
from lux_tpu_torch.parallel.launch import RankError, spawn_ranks

REPO = Path(__file__).resolve().parent.parent
P = 4
NPROC = 2
DEADLINE = 120


@pytest.fixture(scope="module")
def lux_path(tmp_path_factory):
    g = suites.rmat(10, 8, 3)
    path = str(tmp_path_factory.mktemp("mp") / "mp.lux")
    write_lux(path, g.row_ptrs, g.col_idx, degrees=g.out_degrees)
    return path


@pytest.fixture(scope="module")
def weighted_lux_path(tmp_path_factory):
    g = suites.rmat(10, 8, 3, weighted=True)
    path = str(tmp_path_factory.mktemp("mpw") / "w.lux")
    write_lux(path, g.row_ptrs, g.col_idx,
              weights=g.weights.astype(np.int32), degrees=g.out_degrees)
    return path


@pytest.fixture(scope="module")
def ranks(lux_path):
    from lux_tpu_torch import native
    native.build()              # built once here, not by every rank
    return spawn_ranks(suites.from_file, NPROC, "cpu", DEADLINE,
                       args=(dict(parts=P, path=lux_path),))


@pytest.fixture(scope="module")
def graph(lux_path):
    return Graph.from_file(lux_path)


def test_each_rank_loads_only_its_parts(ranks):
    for r, res in enumerate(ranks):
        rows, n = res["rows"]
        assert rows == [2 * r, 2 * r + 1] and n == 2


@pytest.mark.parametrize("exchange", ["gather", "owner"])
def test_pagerank_and_sssp_from_local_parts(ranks, graph, exchange):
    want_pr = pagerank.reference_pagerank(graph, 5)
    want_ds = sssp.reference_sssp(graph, 0)
    for res in ranks:
        np.testing.assert_allclose(res[f"pr_{exchange}"], want_pr,
                                   rtol=2e-5, atol=1e-12)
        np.testing.assert_array_equal(
            res[f"sssp_{exchange}"].astype(np.int64), want_ds)


def test_local_parts_pair_build(ranks, graph):
    """Pair rows planned on each rank's own rows against the depth
    profile agreed across ranks (ops/pairs.plan_sharded_pairs)."""
    from lux_tpu_torch.graph import pair_relabel
    g5, perm5, _starts = pair_relabel(graph, P, pair_threshold=8)
    rank5 = np.empty(graph.nv, np.int64)
    rank5[perm5] = np.arange(graph.nv)
    for res in ranks:
        assert res["pairs_engaged"]
        np.testing.assert_array_equal(res["perm5"], perm5)
        np.testing.assert_allclose(res["pr_pairs"],
                                   pagerank.reference_pagerank(g5, 5),
                                   rtol=2e-5, atol=1e-12)
        np.testing.assert_array_equal(
            res["sssp_pairs"].astype(np.int64),
            sssp.reference_sssp(g5, int(rank5[0])))


def test_local_parts_not_the_ranks_raise(ranks):
    for r, res in enumerate(ranks):
        mine = [2 * r, 2 * r + 1]
        assert res["mismatch"] is not None
        assert f"this process's sharding rows {mine}" in res["mismatch"]
        assert "process_parts" in res["mismatch"]


def test_a_failing_rank_fails_the_launch():
    """A rank that raises (here: a suite given no spec keys) fails the
    launch with its traceback, every rank killed."""
    with pytest.raises(RankError, match="KeyError"):
        spawn_ranks(suites.subset, 2, "cpu", 60, args=({},))


def _run(cmd):
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    return subprocess.Popen(cmd, cwd=REPO, env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)


def test_cli_mesh_under_torchrun_and_dryrun(lux_path, weighted_lux_path):
    """``torchrun --nproc-per-node 2 -m lux_tpu_torch.cli <app> -mesh 2``
    with gloo ranks: -check passes and only rank 0 prints; and
    ``python -m lux_tpu_torch.parallel.dryrun -world 2 -device cpu``."""
    run = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "2", "-m", "lux_tpu_torch.cli"]
    files = {"pagerank": lux_path, "sssp": lux_path,
             "colfilter": weighted_lux_path}
    procs = {app: _run(run + [app, "-file", f, "-np", "4", "-mesh", "2",
                              "-device", "cpu", "-check"])
             for app, f in files.items()}
    procs["dryrun"] = _run([sys.executable, "-m",
                            "lux_tpu_torch.parallel.dryrun", "-world", "2",
                            "-device", "cpu"])
    try:
        outs = {k: p.communicate(timeout=DEADLINE) for k, p in
                procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
    for app in files:
        out, err = outs[app]
        assert procs[app].returncode == 0, err + out
        assert out.count("[PASS]") == 1 and "[FAIL]" not in out, out
        assert out.count("ELAPSED TIME") == 1, out
    out, err = outs["dryrun"]
    assert procs["dryrun"].returncode == 0, err + out
    assert "all six configurations oracle-checked" in out
