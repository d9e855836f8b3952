"""What a rank of a spawned mesh runs for the port's CPU tests and
chip_smoke.py's mesh phase (counterpart of tests/mp_worker.py and
tests/test_multidevice.py:23-66): each suite builds engines on the
rank's mesh, runs them and returns host results (every rank the whole
of each), which the caller holds against the engines without a mesh,
the reference and the oracles.  A suite is a module-level function of
this package, so a spawned rank imports nothing else.
"""

from __future__ import annotations

import numpy as np
import torch


def rmat(scale: int, ef: int, seed: int, weighted: bool = False):
    """An R-MAT graph; integer weights 1..5 from ``seed + 1``."""
    from lux_tpu_torch.convert import rmat_edges
    from lux_tpu_torch.graph import Graph

    src, dst, nv = rmat_edges(scale, ef, seed=seed)
    w = None
    if weighted:
        w = np.random.default_rng(seed + 1).integers(
            1, 6, src.size).astype(np.float32)
    return Graph.from_edges(src, dst, nv, weights=w)


def symmetric(g):
    """``g`` with every edge also reversed (components' input)."""
    from lux_tpu_torch.apps.components import symmetrize
    from lux_tpu_torch.graph import Graph

    src, dst = g.edge_arrays()[:2]
    s, d = symmetrize(src, dst)
    return Graph.from_edges(s, d, g.nv)


def engine_cases(parts: int, graphs: dict):
    """name -> (builder(mesh, device) -> engine, how to run it): the
    engine variants a mesh runs, the same with and without a mesh."""
    from lux_tpu_torch.apps import colfilter, components, pagerank, sssp
    from lux_tpu_torch.graph import pair_relabel

    g, gw, gs = graphs["plain"], graphs["weighted"], graphs["sym"]
    g8, perm, starts = pair_relabel(g, parts, pair_threshold=8)
    gw8, _pw, starts_w = pair_relabel(gw, parts, pair_threshold=4)
    P = parts
    # the hub: a start whose frontier spans many iterations
    s0 = int(np.argmax(g.out_degrees))
    s8 = int(np.nonzero(perm == s0)[0][0])

    def pr(graph=g, **kw):
        return lambda mesh, dev: pagerank.build_engine(
            graph, P, mesh=mesh, device=dev, **kw)

    cases = {
        "pr_tiled": (pr(), ("run", 4)),
        "pr_flat": (pr(layout="flat"), ("run", 3)),
        "pr_stream": (lambda mesh, dev: _pull(
            g, P, mesh, dev, stream_msgs=True), ("run", 3)),
        "pr_until": (pr(), ("until", 1e-7, 40)),
        "pr_owner": (pr(exchange="owner"), ("run", 4)),
        "pr_pairs": (pr(graph=g8, starts=starts, pair_threshold=8),
                     ("run", 3)),
        "pr_pairs_owner": (pr(graph=g8, starts=starts, pair_threshold=8,
                              exchange="owner"), ("run", 3)),
        "cf": (lambda mesh, dev: colfilter.build_engine(
            gw, P, mesh=mesh, device=dev), ("run", 2)),
        "cf_pairs": (lambda mesh, dev: colfilter.build_engine(
            gw8, P, mesh=mesh, device=dev, starts=starts_w,
            pair_threshold=4), ("run", 2)),
        "sssp": (lambda mesh, dev: sssp.build_engine(
            g, s0, P, mesh=mesh, device=dev), ("converge",)),
        "sssp_dense": (lambda mesh, dev: sssp.build_engine(
            g, s0, P, mesh=mesh, device=dev, enable_sparse=False),
            ("converge",)),
        "sssp_delta": (lambda mesh, dev: sssp.build_engine(
            gw, s0, P, mesh=mesh, device=dev, weighted=True, delta=2.0),
            ("converge",)),
        "sssp_owner": (lambda mesh, dev: sssp.build_engine(
            g, s0, P, mesh=mesh, device=dev, exchange="owner"),
            ("converge",)),
        "sssp_owner_ring": (lambda mesh, dev: sssp.build_engine(
            gw, s0, P, mesh=mesh, device=dev, weighted=True,
            exchange="owner", owner_minmax_fused=True), ("converge",)),
        "sssp_pairs": (lambda mesh, dev: sssp.build_engine(
            g8, s8, P, mesh=mesh, device=dev, starts=starts,
            pair_threshold=8), ("converge",)),
        "cc": (lambda mesh, dev: components.build_engine(
            gs, P, mesh=mesh, device=dev), ("converge",)),
        "cc_owner_ring": (lambda mesh, dev: components.build_engine(
            gs, P, mesh=mesh, device=dev, exchange="owner",
            owner_minmax_fused=True), ("converge",)),
    }
    return cases


def _pull(g, P, mesh, dev, **kw):
    from lux_tpu_torch.apps import pagerank
    from lux_tpu_torch.engine.pull import PullEngine
    from lux_tpu_torch.graph import ShardedGraph

    return PullEngine(ShardedGraph.build(g, P), pagerank.make_program(),
                      mesh=mesh, device=dev, **kw)


def run_case(eng, how):
    """Run an engine as ``how`` says -> (unpadded result, iterations)."""
    if how[0] == "run":
        return eng.unpad(eng.run(eng.init_state(), how[1])), how[1]
    if how[0] == "until":
        st, it, _res = eng.run_until(eng.init_state(), how[1], how[2])
        return eng.unpad(st), it
    lab, act, it = eng.converge(*eng.init_state())
    return eng.unpad(lab), it


def graphs_of(spec: dict) -> dict:
    g = rmat(spec["scale"], spec["ef"], spec["seed"])
    return {"plain": g,
            "weighted": rmat(spec["scale"], spec["ef"], spec["seed"],
                             weighted=True),
            "sym": symmetric(g)}


def engines(mesh, spec: dict) -> dict:
    """Every ``engine_cases`` variant on this rank's mesh with
    ``spec["parts"]`` parts -> name -> (result, iterations)."""
    cases = engine_cases(spec["parts"], graphs_of(spec))
    names = spec.get("names") or list(cases)
    out = {}
    for name in names:
        build, how = cases[name]
        out[name] = run_case(build(mesh, None), how)
    return out


def subset(mesh, spec: dict):
    """A mesh over the first ``spec["world"]`` ranks of the group:
    PageRank on it (None on the ranks outside it)."""
    from lux_tpu_torch.apps import pagerank
    from lux_tpu_torch.parallel.mesh import make_mesh

    sub = make_mesh(spec["world"], mesh.device)
    if sub is None:
        return None
    g = rmat(spec["scale"], spec["ef"], spec["seed"])
    return pagerank.run(g, spec["iters"], spec["parts"], mesh=sub), \
        sub.world, sub.rank


def exchange(mesh, spec: dict) -> dict:
    """``owner_exchange`` across the mesh for each kind and form, on
    this rank's contribution [P, ntw] (integers from ``seed + rank``,
    as float32 for the sum: exact in any order) -> (kind, fused) ->
    this rank's rows."""
    from lux_tpu_torch.ops.owner import owner_exchange

    P, ntw = spec["parts"], spec["ntw"]
    out = {}
    for kind in ("sum", "min", "max"):
        acc = contribution(spec, mesh.rank, kind, P, ntw)
        for fused in (False, True):
            out[(kind, fused)] = owner_exchange(
                torch.from_numpy(acc), kind, axis=mesh, ndev=mesh.world,
                minmax_fused=fused).numpy()
    return out


def contribution(spec: dict, rank: int, kind: str, P: int, ntw: int):
    """Rank ``rank``'s owner contribution of ``exchange``."""
    rng = np.random.default_rng(spec["seed"] + rank)
    x = rng.integers(-1000, 1000, (P, ntw))
    return x.astype(np.float32 if kind == "sum" else np.int32)


def checkpoint_save(mesh, spec: dict):
    """PageRank ``spec["iters"]`` iterations on this mesh, saved to
    ``spec["path"]`` (rank 0 writes) -> the unpadded state."""
    from lux_tpu_torch import checkpoint
    from lux_tpu_torch.apps import pagerank

    g = rmat(spec["scale"], spec["ef"], spec["seed"])
    eng = pagerank.build_engine(g, spec["parts"], mesh=mesh)
    st = eng.run(eng.init_state(), spec["iters"])
    checkpoint.save(spec["path"], (st,),
                    {"iter": spec["iters"], "kind": "pull",
                     "placement": eng.placement_meta()}, mesh=mesh)
    return eng.unpad(st)


def checkpoint_restore(mesh, spec: dict):
    """The checkpoint at ``spec["path"]`` placed on this mesh's engine
    (another world) -> (the restored state unpadded, the state after
    ``spec["more"]`` further iterations, the saved placement)."""
    from lux_tpu_torch import checkpoint
    from lux_tpu_torch.apps import pagerank

    g = rmat(spec["scale"], spec["ef"], spec["seed"])
    eng = pagerank.build_engine(g, spec["parts"], mesh=mesh)
    leaves, meta = checkpoint.load(spec["path"])
    st = eng.place(leaves[0])
    return (eng.unpad(st), eng.unpad(eng.run(st, spec["more"])),
            meta["placement"])


def from_file(mesh, spec: dict) -> dict:
    """Each rank loads only its own parts of ``spec["path"]`` (the
    native loader) and runs PageRank and SSSP on the gather and owner
    exchanges, then pair rows on a local-parts build of the pair
    relabelled graph (tests/mp_worker.py) -> name -> result."""
    from lux_tpu_torch.apps import pagerank, sssp
    from lux_tpu_torch.engine.pull import PullEngine
    from lux_tpu_torch.engine.push import PushEngine
    from lux_tpu_torch.graph import Graph, ShardedGraph, pair_relabel
    from lux_tpu_torch.parallel.multihost import process_parts

    P, path = spec["parts"], spec["path"]
    local = process_parts(P, mesh)
    sg = ShardedGraph.build_from_file(path, P, parts=local)
    out = {"rows": ([int(p) for p in sg.part_ids()],
                    int(sg.src_slot.shape[0]))}
    for ex in ("gather", "owner"):
        eng = PullEngine(sg, pagerank.make_program(), mesh=mesh,
                         exchange=ex)
        out[f"pr_{ex}"] = eng.unpad(eng.run(eng.init_state(), 5))
        peng = PushEngine(sg, sssp.make_program(0), mesh=mesh, exchange=ex)
        lab, _act, _it = peng.converge(*peng.init_state())
        out[f"sssp_{ex}"] = peng.unpad(lab)
    g = Graph.from_file(path)
    g5, perm5, starts5 = pair_relabel(g, P, pair_threshold=8)
    sg5 = ShardedGraph.build(g5, P, starts=starts5, pair_threshold=8,
                             parts=local)
    eng = PullEngine(sg5, pagerank.make_program(), mesh=mesh,
                     pair_threshold=8)
    out["pairs_engaged"] = eng.pairs is not None
    out["pr_pairs"] = eng.unpad(eng.run(eng.init_state(), 5))
    rank5 = np.empty(g.nv, np.int64)
    rank5[perm5] = np.arange(g.nv)
    peng = PushEngine(sg5, sssp.make_program(int(rank5[0])), mesh=mesh,
                      pair_threshold=8)
    lab, _act, _it = peng.converge(*peng.init_state())
    out["sssp_pairs"] = peng.unpad(lab)
    out["perm5"] = perm5
    # a local-parts build of another rank's parts is refused
    other = list(process_parts(P, mesh))
    other = [(p + len(other)) % P for p in other]
    try:
        PullEngine(ShardedGraph.build_from_file(path, P, parts=other),
                   pagerank.make_program(), mesh=mesh)
        out["mismatch"] = None
    except ValueError as e:
        out["mismatch"] = str(e)
    return out


def combined(mesh, spec: dict) -> dict:
    """One spawn's worth for the CPU tests: the dryrun's six
    configurations, then each suite ``spec`` names (``engines``,
    ``exchange``, ``subset``, ``save``, ``restore``) with its own spec ->
    suite -> its result."""
    from lux_tpu_torch.parallel import dryrun

    out = {"dryrun": dryrun.configs(mesh)}
    for name, fn in (("engines", engines), ("exchange", exchange),
                     ("subset", subset), ("save", checkpoint_save),
                     ("restore", checkpoint_restore)):
        if name in spec:
            out[name] = fn(mesh, spec[name])
    return out


def _events_ms(fn, reps: int) -> float:
    """Mean device ms of ``fn`` over ``reps`` calls, by CUDA events
    after one warm-up call."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _counted():
    from lux_tpu_torch.ops.chunk_reduce import (chunk_partials,
                                                chunk_partials_batched)
    from lux_tpu_torch.ops.lane_shuffle import lane_shuffle
    return chunk_partials, chunk_partials_batched, lane_shuffle


def _zero_launches() -> None:
    """Every launch count of the kernels these configs can reach at 0."""
    b1, b1b, b2 = _counted()
    b1.launches = b1b.launches = b2.launches = 0
    b1.launches_by_e = {}


def _launches() -> dict:
    """The launch counts since ``_zero_launches`` (B1's also by chunk
    width)."""
    b1, b1b, b2 = _counted()
    return {"chunk_partials": b1.launches,
            "chunk_partials_batched": b1b.launches,
            "lane_shuffle": b2.launches,
            "chunk_partials_by_e": dict(b1.launches_by_e)}


def mp_configs(mesh, spec: dict) -> dict:
    """bench.py's pagerank-mp and sssp-mp (pair relabel, ``parts``
    parts, ``exchange="owner"``, pairs ``threshold`` / ``min_fill``) on
    this rank's mesh of cards, for chip_smoke.py's mesh phase.  ``spec``
    carries the relabelled graph ``g3``, its ShardedGraph ``sg`` and the
    SSSP ``start`` (a rank in the smoke's process), or ``scale``, ``ef``
    and ``seed`` to build them.  Each config: the unpadded result, the
    kernels' launches a run (``iters`` iterations) or a converge, every
    count at 0 just before and read just after (B1's also by chunk
    width), the run's or converge's device ms; then each
    collective of an iteration timed alone by CUDA events (``reps``
    calls), and pagerank-mp's owner chunks at its init state (B1's
    input on this path).  ``spec["keep"]``: the two engines too
    (``engines``), for the caller to time beside others."""
    from lux_tpu_torch.apps import pagerank, sssp
    from lux_tpu_torch.convert import rmat_graph
    from lux_tpu_torch.graph import ShardedGraph, pair_relabel
    from lux_tpu_torch.ops import collectives as C
    from lux_tpu_torch.ops import owner as om

    P, T, F = spec["parts"], spec["threshold"], spec["min_fill"]
    iters, reps = spec["iters"], spec["reps"]
    g3, sg, start = spec.get("g3"), spec.get("sg"), spec.get("start")
    if g3 is None:
        g = rmat_graph(spec["scale"], spec["ef"], seed=spec["seed"])
        g3, perm, starts = pair_relabel(g, P, pair_threshold=T)
        sg = ShardedGraph.build(g3, P, starts=starts, pair_threshold=T)
        v0 = 0 if g.out_degrees[0] > 0 else int(np.argmax(
            g.out_degrees > 0))
        start = int(np.nonzero(perm == v0)[0][0])
    kw = dict(sg=sg, pair_threshold=T, pair_min_fill=F, exchange="owner",
              mesh=mesh)
    out = {}
    eng = pagerank.build_engine(g3, P, **kw)
    eng.step(eng.init_state())                       # warm-up
    state = eng.init_state()
    torch.cuda.synchronize()
    _zero_launches()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    state = eng.run(state, iters)
    t1.record()
    t1.synchronize()
    launches = _launches()
    out["pagerank-mp"] = dict(
        result=eng.unpad(state), launches=launches,
        run_ms=t0.elapsed_time(t1), owner_E=eng.owner.E)
    init = eng.init_state()
    acc = eng._owner_contribs(init)
    src, rel = om.decoded_slots(eng.arrays)
    lp, Cn, E = src.shape
    rows = (om.gather_messages(init, src).reshape(lp * Cn, E),
            rel.reshape(lp * Cn, E))
    # a spawned rank's tensors travel to the caller through the host
    out["b1_rows"] = rows if mesh.world == 1 else tuple(
        x.cpu() for x in rows)
    coll = {"all_gather_state": _events_ms(
                lambda: C.all_gather_parts(mesh, init), reps),
            "reduce_scatter_owner": _events_ms(
                lambda: C.reduce_scatter_parts(mesh, acc, "sum"), reps)}
    coll_bytes = {"all_gather_state": init.numel() * init.element_size(),
                  "reduce_scatter_owner": acc.numel() * acc.element_size()}
    pr_eng = eng if spec.get("keep") else None
    del eng, state, init, acc, src, rel
    eng = sssp.build_engine(g3, start, P, **kw)
    lab, act = eng.init_state()
    torch.cuda.synchronize()
    _zero_launches()
    t0.record()
    lab, act, it = eng.converge(lab, act)
    t1.record()
    t1.synchronize()
    launches = _launches()
    out["sssp-mp"] = dict(result=eng.unpad(lab), iterations=it,
                          schedule=list(eng.schedule), launches=launches,
                          converge_ms=t0.elapsed_time(t1),
                          owner_E=eng.owner.E)
    lab0, act0 = eng.init_state()
    masked = torch.where(act0, lab0, eng._ident)
    sacc = om.owner_contribs(eng.owner, masked, eng.arrays, "min",
                             eng._msg, eng.num_parts, plan=eng._plan,
                             max_run=eng._plan.max_len)
    cnt = act0.sum(dtype=torch.int32)
    coll["all_to_all_owner_min"] = _events_ms(
        lambda: C.all_to_all_parts(mesh, sacc), reps)
    coll["all_reduce_count"] = _events_ms(
        lambda: C.all_reduce_scalar(mesh, cnt, "sum"), reps)
    coll_bytes["all_to_all_owner_min"] = sacc.numel() * sacc.element_size()
    coll_bytes["all_reduce_count"] = 4
    out["collectives_ms"], out["collective_bytes"] = coll, coll_bytes
    out["start"] = start
    if spec.get("keep"):
        out["engines"] = (pr_eng, eng)
    return out
