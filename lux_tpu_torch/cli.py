"""Command-line apps with the reference's flag names (counterpart of
lux_tpu/cli.py:69, :116, :165, :557 and :596-689, :864).

    python -m lux_tpu_torch.cli pagerank -file g.lux -ni 10 [-np N]
                                         [-gather flat|paged|pagemajor]
                                         [-pair T [-min-fill F]]
                                         [-sources A,B,C | -batch B]
                                         [-check] [-device cuda|cpu]
    python -m lux_tpu_torch.cli sssp -file g.lux [-start S] [-weighted]
                                     [-delta D|auto] [-np N]
                                     [-gather flat|paged|pagemajor]
                                     [-pair T [-min-fill F]]
                                     [-sources A,B,C | -batch B]
                                     [-check] [-device cuda|cpu]
    python -m lux_tpu_torch.cli components -file g.lux [-np N] [...]
    python -m lux_tpu_torch.cli colfilter -file w.lux -ni 10 [-np N]
                                          [-gather flat|paged]
                                          [-pair T [-min-fill F]]
                                          [-check] [-device cuda|cpu]
    python -m lux_tpu_torch.cli convert -input edges.txt -output g.lux
                                        -nv N [-weighted]

``pagerank`` prints ``ELAPSED TIME = ... s`` (the timed run only, after
one warm-up run) and ``GTEPS = ne * iterations / seconds / 1e9``, like
the reference.  The default device is the card; ``-device cpu`` runs
the plain PyTorch versions on the host.  ``-gather paged|pagemajor``
runs the page-binned delivery (ops/pagegather.py); ``-gather auto``
is refused (exit 2) until its cost model is measured on the card.
``-pair T`` relabels the graph (graph.pair_relabel) and serves dense
tile pairs by pair-lane rows (ops/pairs.py); the ranks go back to the
input's vertex order before ``-check``.  ``-min-fill auto`` is refused
(exit 2) like ``-gather auto``.

``sssp`` and ``components`` run the push engine to convergence and
print ``ELAPSED TIME = ... s (N iterations)`` (one timed converge after
a warm-up) and GTEPS over the iterations run; ``-start`` is an input
vertex id, mapped through the relabelling under ``-pair``; ``-check``
runs the on-device fixed-point audit (device_check.py) on the engine's
device.  ``components`` expects an undirected (symmetrized) graph.

``-sources A,B,C`` runs the query-batched engine of ``pagerank``
(personalized, one-hot resets), ``sssp`` (k-source) or ``components``
(seeded), one state column a query and one gather serving them all;
``-batch B`` without ``-sources`` takes B evenly spaced vertices, and
with it must match the list's length.  These runs also print ``BATCH =
B queries; QUERY-GTEPS = ...`` (ne x iterations x B / seconds); ``-pair``
and ``-delta`` are single-query machinery and refused with them, and
``-check`` is skipped for them with a note, as in the reference.

``colfilter`` trains the K = 20 factorization on a weighted graph for
``-ni`` iterations and prints ``ELAPSED TIME``, ``GTEPS`` and ``RMSE``
(over the edges of the graph it ran, relabelled under ``-pair``) as
the reference does; ``-check`` runs the on-device RMSE audit.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from lux_tpu_torch.device import DeviceUnavailableError
from lux_tpu_torch.engine.pull import NotPortedError


def _min_fill_arg(v: str):
    """-min-fill value: an int, or 'auto' (not ported)."""
    return "auto" if v == "auto" else int(v)


def _relabel_for_pairs(args, g, num_parts):
    """-pair T: relabel so pair-lane delivery finds dense tile pairs.
    Returns (graph to run on, perm | None, starts | None) with
    perm[new] = old."""
    if args.pair is None:
        return g, None, None
    from lux_tpu_torch.graph import pair_relabel
    return pair_relabel(g, num_parts, pair_threshold=args.pair)


def _add_batch_flags(ap) -> None:
    ap.add_argument("-sources", default=None, metavar="A,B,C",
                    help="comma list of query sources: runs the "
                         "query-batched engine, one state column a "
                         "query and one gather serving them all; -pair "
                         "(and sssp's -delta) must be off")
    ap.add_argument("-batch", type=int, default=0, metavar="B",
                    help="without -sources: a B-query batch of evenly "
                         "spaced source vertices; with -sources: must "
                         "match the list's length")


def _batched_sources(args, nv: int):
    """None, or the query sources of -sources / -batch (the reference's
    rules and errors, lux_tpu/cli.py:326-362; exit 2 on a bad list)."""
    srcs = args.sources
    B = int(args.batch or 0)
    if srcs is None and not B:
        return None
    if args.pair is not None:
        print("error: -pair is single-query machinery (pair delivery "
              "reads scalar state); drop it for -sources/-batch runs",
              file=sys.stderr)
        raise SystemExit(2)
    if srcs is not None:
        try:
            out = [int(s) for s in srcs.split(",") if s.strip()]
        except ValueError:
            print(f"error: -sources must be a comma list of vertex ids, "
                  f"got {srcs!r}", file=sys.stderr)
            raise SystemExit(2)
        if not out:
            print("error: -sources named no vertices", file=sys.stderr)
            raise SystemExit(2)
        if B and B != len(out):
            print(f"error: -batch {B} != len(-sources) = {len(out)}",
                  file=sys.stderr)
            raise SystemExit(2)
    else:
        out = [int(x) for x in
               np.linspace(0, nv - 1, B).round().astype(np.int64)]
    for s in out:
        if not 0 <= s < nv:
            print(f"error: source vertex {s} out of range [0, {nv})",
                  file=sys.stderr)
            raise SystemExit(2)
    return out


def _print_batch(sources, ne, iters, elapsed) -> None:
    """The batched runs' per-query delivered-rate line."""
    B = len(sources)
    if iters > 0 and elapsed > 0:
        qg = ne * iters * B / elapsed / 1e9
        print(f"BATCH = {B} queries; QUERY-GTEPS = {qg:.4f} "
              f"({1.0 / qg:.1f} ns/edge/query delivered)")
    else:
        print(f"BATCH = {B} queries")


def _batch_check_note() -> int:
    print("note: -check does not support batched runs yet; skipped "
          "(oracle proofs: tests/test_torch_batched.py)")
    return 0


def cmd_pagerank(argv) -> int:
    ap = argparse.ArgumentParser(prog="lux_tpu_torch pagerank")
    ap.add_argument("-file", required=True, help=".lux graph file")
    ap.add_argument("-ni", type=int, default=10, help="iterations")
    ap.add_argument("-np", type=int, default=1, help="partitions")
    ap.add_argument("-check", action="store_true",
                    help="residual audit of the result (exit 1 on FAIL)")
    ap.add_argument("-gather", default="flat",
                    choices=["flat", "paged", "pagemajor", "auto"],
                    help="state-table delivery: the per-edge gather "
                         "('flat'), page rows + lane shuffle ('paged'), "
                         "or full gather rows bound to pages first "
                         "('pagemajor'); 'auto' is not ported")
    ap.add_argument("-pair", type=int, default=None, metavar="T",
                    help="pair-lane delivery with threshold T (relabels "
                         "the graph internally; ranks are mapped back "
                         "to input ids); exclusive with -gather "
                         "paged|pagemajor")
    ap.add_argument("-min-fill", type=_min_fill_arg, default=None,
                    dest="min_fill", metavar="F",
                    help="with -pair: drop pair rows that would deliver "
                         "< F live lanes (their edges ride the residual "
                         "path); 'auto' is not ported")
    _add_batch_flags(ap)
    ap.add_argument("-device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    from lux_tpu_torch.apps import pagerank
    from lux_tpu_torch.format import GraphFormatError
    from lux_tpu_torch.graph import Graph
    from lux_tpu_torch.ops.pairs import resolve_min_fill
    from lux_tpu_torch.timing import timed_fused_run

    resolve_min_fill(args.min_fill)     # refuse 'auto' before any work
    if not os.path.exists(args.file):
        print(f"error: graph file not found: {args.file}", file=sys.stderr)
        return 2
    try:
        g = Graph.from_file(args.file)
    except GraphFormatError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    num_parts = max(1, args.np)
    sources = _batched_sources(args, g.nv)
    g_run, perm, starts = _relabel_for_pairs(args, g, num_parts)
    eng = pagerank.build_engine(g_run, num_parts, device=args.device,
                                gather=args.gather, starts=starts,
                                pair_threshold=args.pair,
                                pair_min_fill=args.min_fill,
                                sources=sources)
    state, elapsed = timed_fused_run(eng, args.ni)
    print(f"ELAPSED TIME = {elapsed:.7f} s")
    print(f"GTEPS = {g.ne * args.ni / elapsed / 1e9:.4f}")
    if sources is not None:
        _print_batch(sources, g.ne, args.ni, elapsed)
        if args.check:
            return _batch_check_note()
    if args.check:
        from lux_tpu_torch.check import check_pagerank
        ranks = eng.unpad(state)
        if perm is not None:        # relabelled order -> input order
            user = np.empty_like(ranks)
            user[perm] = ranks
            ranks = user
        res = check_pagerank(g, ranks, tol=1e-3)
        print(res)
        return 0 if res.ok else 1
    return 0


def _push_app(argv, prog_name) -> int:
    ap = argparse.ArgumentParser(prog=f"lux_tpu_torch {prog_name}")
    ap.add_argument("-file", required=True, help=".lux graph file")
    ap.add_argument("-np", type=int, default=1, help="partitions")
    ap.add_argument("-check", action="store_true",
                    help="on-device fixed-point audit (exit 1 on FAIL)")
    ap.add_argument("-gather", default="flat",
                    choices=["flat", "paged", "pagemajor", "auto"],
                    help="dense iterations' delivery (as for pagerank)")
    ap.add_argument("-pair", type=int, default=None, metavar="T",
                    help="pair-lane delivery with threshold T on dense "
                         "iterations (relabels the graph internally)")
    ap.add_argument("-min-fill", type=_min_fill_arg, default=None,
                    dest="min_fill", metavar="F",
                    help="with -pair: drop pair rows with < F live lanes; "
                         "'auto' is not ported")
    _add_batch_flags(ap)
    ap.add_argument("-device", default="cuda", choices=["cuda", "cpu"])
    if prog_name == "sssp":
        ap.add_argument("-start", type=int, default=0,
                        help="start vertex (input id)")
        ap.add_argument("-weighted", action="store_true",
                        help="weighted distances (else hop counts)")
        ap.add_argument("-delta", default=None,
                        help="delta-stepping bucket width (a number or "
                             "'auto'; default: off)")
    args = ap.parse_args(argv)

    from lux_tpu_torch import device_check
    from lux_tpu_torch.apps import components, sssp
    from lux_tpu_torch.format import GraphFormatError
    from lux_tpu_torch.graph import Graph
    from lux_tpu_torch.ops.pairs import resolve_min_fill
    from lux_tpu_torch.timing import timed_converge

    resolve_min_fill(args.min_fill)     # refuse 'auto' before any work
    weighted = prog_name == "sssp" and args.weighted
    if not os.path.exists(args.file):
        print(f"error: graph file not found: {args.file}", file=sys.stderr)
        return 2
    try:
        g = Graph.from_file(args.file, weighted=weighted or None)
    except GraphFormatError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    num_parts = max(1, args.np)
    sources = _batched_sources(args, g.nv)
    g_run, perm, starts = _relabel_for_pairs(args, g, num_parts)
    opts = dict(num_parts=num_parts, starts=starts, gather=args.gather,
                pair_threshold=args.pair, pair_min_fill=args.min_fill,
                sources=sources, device=args.device)
    if prog_name == "sssp":
        start = args.start
        if perm is not None and 0 <= start < g.nv:
            rank = np.empty(g.nv, np.int64)
            rank[perm] = np.arange(g.nv)
            start = int(rank[start])
        delta = args.delta
        if delta is not None and delta != "auto":
            delta = float(delta)
        if sources is not None and delta is not None:
            print("error: -delta is single-query machinery; drop it for "
                  "-sources/-batch runs", file=sys.stderr)
            return 2
        eng = sssp.build_engine(g_run, start, weighted=weighted,
                                delta=delta, **opts)
    else:
        eng = components.build_engine(g_run, **opts)
    labels, iters, [elapsed] = timed_converge(eng)
    print(f"ELAPSED TIME = {elapsed:.7f} s ({iters} iterations)")
    if iters > 0:
        print(f"GTEPS = {g.ne * iters / elapsed / 1e9:.4f}")
    if sources is not None:
        _print_batch(sources, g.ne, iters, elapsed)
        if args.check:
            return _batch_check_note()
    if args.check:
        # labels are in g_run's order, which is the engine's; the
        # fixed-point properties do not depend on the numbering
        if prog_name == "sssp":
            res = device_check.check_sssp_device(
                eng.sg, labels, weighted=weighted, device=args.device)
        else:
            res = device_check.check_components_device(
                eng.sg, labels, device=args.device)
        print(res)
        return 0 if res.ok else 1
    return 0


def cmd_sssp(argv) -> int:
    return _push_app(argv, "sssp")


def cmd_components(argv) -> int:
    return _push_app(argv, "components")


def cmd_colfilter(argv) -> int:
    ap = argparse.ArgumentParser(prog="lux_tpu_torch colfilter")
    ap.add_argument("-file", required=True, help="weighted .lux file")
    ap.add_argument("-ni", type=int, default=10, help="iterations")
    ap.add_argument("-np", type=int, default=1, help="partitions")
    ap.add_argument("-check", action="store_true",
                    help="on-device RMSE audit (exit 1 on FAIL)")
    ap.add_argument("-gather", default="flat",
                    choices=["flat", "paged", "pagemajor", "auto"],
                    help="delivery (as for pagerank; 'pagemajor' is "
                         "refused for the dot path, 'auto' not ported)")
    ap.add_argument("-pair", type=int, default=None, metavar="T",
                    help="pair-lane SDDMM delivery with threshold T "
                         "(relabels the graph internally)")
    ap.add_argument("-min-fill", type=_min_fill_arg, default=None,
                    dest="min_fill", metavar="F",
                    help="with -pair: drop pair rows with < F live lanes "
                         "(bench.py's colfilter config uses 22); 'auto' "
                         "is not ported")
    ap.add_argument("-device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    from lux_tpu_torch import device_check
    from lux_tpu_torch.apps import colfilter
    from lux_tpu_torch.format import GraphFormatError
    from lux_tpu_torch.graph import VPAD_ALIGN, Graph, ShardedGraph
    from lux_tpu_torch.ops.pairs import resolve_min_fill
    from lux_tpu_torch.timing import timed_fused_run

    resolve_min_fill(args.min_fill)     # refuse 'auto' before any work
    if not os.path.exists(args.file):
        print(f"error: graph file not found: {args.file}", file=sys.stderr)
        return 2
    try:
        g = Graph.from_file(args.file, weighted=True)
    except GraphFormatError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    num_parts = max(1, args.np)
    g_run, _perm, starts = _relabel_for_pairs(args, g, num_parts)
    # the whole graph's layout: the audit reads every edge, while a
    # pair engine keeps only the residual's
    sg = ShardedGraph.build(g_run, num_parts, starts=starts,
                            pair_threshold=args.pair,
                            vpad_align=128 if args.gather != "flat"
                            else VPAD_ALIGN)
    try:
        eng = colfilter.build_engine(g_run, num_parts, device=args.device,
                                     sg=sg, gather=args.gather,
                                     pair_threshold=args.pair,
                                     pair_min_fill=args.min_fill)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    state, elapsed = timed_fused_run(eng, args.ni)
    print(f"ELAPSED TIME = {elapsed:.7f} s")
    if args.ni > 0:
        print(f"GTEPS = {g.ne * args.ni / elapsed / 1e9:.4f}")
    out = eng.unpad(state)
    # out is in g_run's order; the RMSE runs over its edges, so the
    # relabelled graph is the matching choice
    print(f"RMSE = {colfilter.rmse(g_run, out):.6f}")
    if args.check:
        res = device_check.check_colfilter_device(sg, state,
                                                  device=args.device)
        print(res)
        return 0 if res.ok else 1
    return 0


def cmd_convert(argv) -> int:
    ap = argparse.ArgumentParser(prog="lux_tpu_torch convert")
    ap.add_argument("-input", required=True, help="text edge list")
    ap.add_argument("-output", required=True, help=".lux output")
    ap.add_argument("-nv", type=int, required=True)
    ap.add_argument("-weighted", action="store_true")
    args = ap.parse_args(argv)

    from lux_tpu_torch.convert import convert_edge_list
    convert_edge_list(args.input, args.output, args.nv,
                      weighted=args.weighted)
    return 0


_APPS = {"pagerank": cmd_pagerank, "sssp": cmd_sssp,
         "components": cmd_components, "colfilter": cmd_colfilter,
         "convert": cmd_convert}


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: python -m lux_tpu_torch.cli "
              f"{{{','.join(_APPS)}}} [flags]")
        return 0 if argv else 2
    if argv[0] not in _APPS:
        print(f"unknown app {argv[0]!r}; choose from {list(_APPS)}",
              file=sys.stderr)
        return 2
    try:
        return _APPS[argv[0]](argv[1:])
    except (DeviceUnavailableError, NotPortedError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
