"""Command-line apps with the reference's flag names (counterpart of
lux_tpu/cli.py:596-689 and :864).

    python -m lux_tpu_torch.cli pagerank -file g.lux -ni 10 [-np N]
                                         [-gather flat|paged|pagemajor]
                                         [-check] [-device cuda|cpu]
    python -m lux_tpu_torch.cli convert -input edges.txt -output g.lux
                                        -nv N [-weighted]

``pagerank`` prints ``ELAPSED TIME = ... s`` (the timed run only, after
one warm-up run) and ``GTEPS = ne * iterations / seconds / 1e9``, like
the reference.  The default device is the card; ``-device cpu`` runs
the plain PyTorch versions on the host.  ``-gather paged|pagemajor``
runs the page-binned delivery (ops/pagegather.py); ``-gather auto``
is refused (exit 2) until its cost model is measured on the card.
"""

from __future__ import annotations

import argparse
import os
import sys

from lux_tpu_torch.device import DeviceUnavailableError
from lux_tpu_torch.engine.pull import NotPortedError


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
    ap.add_argument("-device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    from lux_tpu_torch.apps import pagerank
    from lux_tpu_torch.format import GraphFormatError
    from lux_tpu_torch.graph import Graph
    from lux_tpu_torch.timing import timed_fused_run

    if not os.path.exists(args.file):
        print(f"error: graph file not found: {args.file}", file=sys.stderr)
        return 2
    try:
        g = Graph.from_file(args.file)
    except GraphFormatError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    eng = pagerank.build_engine(g, max(1, args.np), device=args.device,
                                gather=args.gather)
    state, elapsed = timed_fused_run(eng, args.ni)
    print(f"ELAPSED TIME = {elapsed:.7f} s")
    print(f"GTEPS = {g.ne * args.ni / elapsed / 1e9:.4f}")
    if args.check:
        from lux_tpu_torch.check import check_pagerank
        res = check_pagerank(g, eng.unpad(state), tol=1e-3)
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


_APPS = {"pagerank": cmd_pagerank, "convert": cmd_convert}


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
