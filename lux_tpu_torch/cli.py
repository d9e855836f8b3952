"""Command-line apps with the reference's flag names (counterpart of
lux_tpu/cli.py:69, :116, :165, :557 and :596-689, :864).

    python -m lux_tpu_torch.cli pagerank -file g.lux -ni 10 [-np N]
                                         [-exchange auto|gather|owner]
                                         [-gather flat|paged|pagemajor|auto]
                                         [-pair T [-min-fill F|auto]]
                                         [-mxu auto|mxu|vpu] [-calibrate]
                                         [-sources A,B,C | -batch B]
                                         [-tol T [-max-iters N]]
                                         [-check] [-device cuda|cpu]
    python -m lux_tpu_torch.cli sssp -file g.lux [-start S] [-weighted]
                                     [-delta D|auto] [-np N]
                                     [-exchange auto|gather|owner]
                                     [-gather flat|paged|pagemajor|auto]
                                     [-pair T [-min-fill F|auto]]
                                     [-mxu auto|mxu|vpu] [-calibrate]
                                     [-sources A,B,C | -batch B]
                                     [-sparse 0|1]
                                     [-check] [-device cuda|cpu]
    python -m lux_tpu_torch.cli components -file g.lux [-np N] [...]
    python -m lux_tpu_torch.cli colfilter -file w.lux -ni 10 [-np N]
                                          [-gather flat|paged|auto]
                                          [-pair T [-min-fill F|auto]]
                                          [-mxu auto|mxu|vpu] [-calibrate]
                                          [-check] [-device cuda|cpu]
    python -m lux_tpu_torch.cli convert -input edges.txt -output g.lux
                                        -nv N [-weighted]

``pagerank`` prints ``ELAPSED TIME = ... s`` (the timed run only, after
one warm-up run) and ``GTEPS = ne * iterations / seconds / 1e9``, like
the reference.  The default device is the card; ``-device cpu`` runs
the plain PyTorch versions on the host.  ``-gather paged|pagemajor``
runs the page-binned delivery (ops/pagegather.py); ``-gather auto``
picks flat, paged or page-major by scalemodel's break-even on the
plan's counted stats (the card's measured constants).  ``-pair T``
relabels the graph (graph.pair_relabel) and serves dense tile pairs by
pair-lane rows (ops/pairs.py); the ranks go back to the input's vertex
order before ``-check``.  ``-min-fill auto`` resolves to scalemodel's
break-even fill for the program's K.  ``-mxu auto|mxu|vpu`` picks the
tiled reduce: 'mxu' the one-hot (matrix-unit) forms (kernel S9 for a
scalar float32 sum, the tournament for min/max, the segmented sum as
matmuls), 'vpu' kernel B1, 'auto' (default) by scalemodel's break-even
width.  ``-exchange owner`` (pagerank, sssp, components) runs the owner
exchange (ops/owner.py: each source part gathers from its own shard);
with ``-gather paged|pagemajor|auto`` it runs the owner paged plans
(ops/pagegather.py: each source part's page rows against its own shard;
page-major rows routed whole to their destination parts);
'auto' (default) keeps the gather exchange on the card and takes the
owner exchange elsewhere past OWNER_AUTO_BYTES of state table;
colfilter notes that it does not apply and ignores it.

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

``-tol T`` runs pagerank to convergence (the max-abs change of the
degree-scaled rank state <= T, at most ``-max-iters`` iterations,
default 10000) instead of ``-ni`` iterations, and prints ``ELAPSED TIME
= ... s (N iterations, residual R)``.  ``-sparse 0`` (sssp, components)
builds the push engine without the src-sorted sparse view: every
iteration runs dense.

Every app but ``convert`` takes ``-validate`` (format.validate_graph at
load: a malformed file exits 2 with its typed GraphFormatError) and
``-audit warn|error`` (lux_tpu_torch/audit.py over one iteration of
every program variant at engine build; under ``error`` a violation
exits 2 with its typed AuditError).  ``-mesh N`` runs the app over a
parts mesh of N ranks (lux_tpu/cli.py:14-15), one process a card:
``torchrun --nproc-per-node N -m lux_tpu_torch.cli pagerank -file g.lux
-np P -mesh N`` (P a multiple of N; ``-device cpu`` takes gloo ranks on
the CPU).  A process group whose world is not N exits 2 saying so, and
only rank 0 prints.

``colfilter`` trains the K = 20 factorization on a weighted graph for
``-ni`` iterations and prints ``ELAPSED TIME``, ``GTEPS`` and ``RMSE``
(over the edges of the graph it ran, relabelled under ``-pair``) as
the reference does; ``-check`` runs the on-device RMSE audit.

Every app but ``convert`` takes the guarded-execution flags
(lux_tpu/cli.py:93-99, :180-209, :461-560): ``-health`` runs the
device health watchdog (a trip exits with a typed HealthError);
``-retries N``, ``-seg-budget S`` and ``-resume CKPT`` run under the
supervisor (lux_tpu_torch/resilience.py): segmented, checkpointed
after every segment, transient failures retried from the last
checkpoint, ``-resume`` continuing a run a previous invocation (of
either package) checkpointed.  The supervised path prints ``#
supervisor: attempts=... segments=... resumed_from=[...]`` and, for a
run the checkpoint already completed, ``GTEPS = n/a (run already
complete in checkpoint)``.  ``-elastic`` (ROADMAP A6b-2) is refused
(exit 2).

Every app but ``convert`` takes the observability flags
(lux_tpu/cli.py:84, :113, :210-244, :288-330, :395-445):
``-verbose`` prints the load line, the memory advisor's estimate
(ShardedGraph.memory_report: the reference's pricing, the same line),
the port's own ledger of the step (``ledger:``, memwatch.MemoryLedger:
the pair rows', dot blocks' and one-hot forms' temporaries as the port
allocates them) and, for ``sssp`` / ``components``, the
converge's per-iteration ``iter i: frontier=F edges=E`` lines replayed
from its device-side counters; ``-phases N`` runs N more iterations
phase by phase after the timed run and prints ``iter i: ...
gather=...ms`` (push: ``frontier=F`` and the dense phases, or
``sparse``); ``-profile DIR`` writes the timed run's profiler trace to
``DIR/trace.json``; ``-events FILE`` writes the run's telemetry events
as JSONL (``python -m lux_tpu_torch.tracing FILE`` exports them);
``-iter-stats`` records the timed run's per-iteration counters and
prints them after it; ``-flight FILE`` installs the crash flight
recorder, which the supervisor dumps to FILE on a fatal failure.
``-calibrate`` runs the session-calibration probes (observe.py) before
the run, prints the fingerprint header and emits the ``calibration``
event.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time

import numpy as np

from lux_tpu_torch.audit import AuditError
from lux_tpu_torch.device import DeviceUnavailableError
from lux_tpu_torch.engine.pull import NotPortedError


def _min_fill_arg(v: str):
    """-min-fill value: an int, or 'auto'."""
    return "auto" if v == "auto" else int(v)


def _mxu_arg(args):
    """-mxu auto|mxu|vpu -> the engines' use_mxu value."""
    return {"auto": "auto", "mxu": True, "vpu": False}[args.mxu]


def _add_mxu_flag(ap) -> None:
    ap.add_argument("-mxu", default="auto", choices=["auto", "mxu", "vpu"],
                    help="tiled reduce: 'mxu' the one-hot (matrix-unit) "
                         "forms, 'vpu' kernel B1, 'auto' (default) by "
                         "scalemodel's break-even on the K x B width")


def _add_exchange_flag(ap) -> None:
    ap.add_argument("-exchange", default="auto",
                    choices=["auto", "gather", "owner"],
                    help="state exchange for pagerank/sssp/components: "
                         "'gather' (every part gathers from the whole "
                         "state table), 'owner' (each source part "
                         "gathers from its own shard; ops/owner.py) or "
                         "'auto' (the default: gather on the card, "
                         "elsewhere owner past OWNER_AUTO_BYTES of state "
                         "table).  colfilter's dot path has "
                         "its own delivery and ignores it")


def _warn_exchange_ignored(args) -> None:
    """colfilter's dot path has its own delivery; -exchange does not
    apply there (lux_tpu/cli.py:452)."""
    if args.exchange not in ("gather", "auto"):
        print(f"note: -exchange {args.exchange} does not apply to "
              f"colfilter's dot path; ignored")


def _maybe_calibrate(args) -> None:
    """-calibrate: run (or reuse) the session probes on the run's
    device and print the fingerprint header; the ``calibration`` event
    lands in the run's telemetry (observe.calibrate emits it)."""
    if not getattr(args, "calibrate", False):
        return
    from lux_tpu_torch import observe
    fp = observe.calibrate(device=args.device)
    print(f"# calibration: session {fp.session} {fp.platform}/"
          f"{fp.backend} {fp.device_name} ndev={fp.ndev} grade={fp.grade}"
          f" -- gather {fp.probe['gather_small_ns']:.4f} ns/elem "
          f"({fp.deviation:.2f}x the card's figure)")
    if fp.grade == "degraded":
        print("# WARNING: DEGRADED session -- numbers from this process "
              "are labeled, not trusted")


def _relabel_for_pairs(args, g, num_parts):
    """-pair T: relabel so pair-lane delivery finds dense tile pairs.
    Returns (graph to run on, perm | None, starts | None) with
    perm[new] = old."""
    if args.pair is None:
        return g, None, None
    from lux_tpu_torch.graph import pair_relabel
    if getattr(args, "verbose", False):
        print(f"pair-lane: degree relabel + threshold {args.pair}")
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


def _add_guard_flags(ap) -> None:
    """The guarded-execution and durability flags (lux_tpu/cli.py:93-99,
    :180-209)."""
    ap.add_argument("-health", action="store_true",
                    help="run under the device health watchdog "
                         "(lux_tpu_torch/health.py): NaN/Inf state, "
                         "divergent or oscillating residuals and "
                         "frontier stalls fold into a health word on "
                         "the device, decoded at run/segment "
                         "boundaries; a trip raises a typed HealthError "
                         "naming the check, part and iteration")
    ap.add_argument("-retries", type=int, default=0, metavar="N",
                    help="supervise the run (lux_tpu_torch.resilience): "
                         "classify failures, retry transient ones up to "
                         "N times with backoff, and resume from the "
                         "last segment checkpoint")
    ap.add_argument("-seg-budget", type=float, default=0.0,
                    dest="seg_budget", metavar="S",
                    help="run in duration-budgeted segments of about S "
                         "seconds each (segmented.DurationBudget: on "
                         "the card it bounds the work lost between two "
                         "checkpoints); implies the supervised path")
    ap.add_argument("-resume", default=None, metavar="CKPT",
                    help="checkpoint file: save after every segment and "
                         "resume from it if it exists; implies the "
                         "supervised path (without it, -retries / "
                         "-seg-budget checkpoint to a temporary file "
                         "for in-run recovery only).  Supervised timing "
                         "includes the checkpoint saves")
    ap.add_argument("-elastic", action="store_true",
                    help="not ported (ROADMAP A6b-2: degraded-mesh "
                         "recovery needs several devices)")
    ap.add_argument("-flight", default=None, metavar="FILE",
                    help="install the crash flight recorder "
                         "(lux_tpu_torch/tracing.py): a bounded ring of "
                         "recent telemetry events, the last health word "
                         "and placement metadata, dumped atomically to "
                         "FILE by the supervisor on a fatal failure")


def _add_observe_flags(ap) -> None:
    """The observability flags (lux_tpu/cli.py:84, :113, :210-244)."""
    ap.add_argument("-verbose", action="store_true",
                    help="print the load line, the memory advisor's "
                         "estimate and (push apps) the per-iteration "
                         "frontier series replayed from the converge's "
                         "device-side counters")
    ap.add_argument("-phases", type=int, default=0, metavar="N",
                    help="after the timed run, run N iterations phase by "
                         "phase (each fenced) and print the split; read "
                         "relative weights, not GTEPS")
    ap.add_argument("-profile", default=None, metavar="DIR",
                    help="write a profiler trace of the timed run to "
                         "DIR/trace.json (chrome://tracing, Perfetto)")
    ap.add_argument("-events", default=None, metavar="FILE",
                    help="append the run's telemetry events to FILE as "
                         "JSONL (export: python -m lux_tpu_torch.tracing "
                         "FILE)")
    ap.add_argument("-iter-stats", action="store_true", dest="iter_stats",
                    help="record the timed run's per-iteration counters "
                         "on the device (push: frontier and edges "
                         "relaxed; pull: residual and changed vertices) "
                         "and print them after it")
    ap.add_argument("-calibrate", action="store_true",
                    help="run the session-calibration probes "
                         "(lux_tpu_torch/observe.py) before the run and "
                         "print / emit the fingerprint")


def _add_build_flags(ap) -> None:
    """-validate, -audit and -mesh (lux_tpu/cli.py:75-112)."""
    ap.add_argument("-validate", action="store_true",
                    help="validate the .lux file's structural invariants "
                         "at load (monotone row_ptrs, col_idx in range, "
                         "section sizes, degree consistency -- "
                         "format.validate_graph); a malformed file exits "
                         "2 with a typed error instead of running to a "
                         "wrong answer")
    ap.add_argument("-audit", default=None, choices=["warn", "error"],
                    help="audit one iteration of every program variant "
                         "at engine build (lux_tpu_torch/audit.py: gather "
                         "budget, host data, dtype discipline, owner "
                         "schedule, identity inits, host reads an "
                         "iteration).  'warn' prints AuditWarnings; "
                         "'error' refuses a violating build (exit 2, "
                         "typed AuditError)")
    ap.add_argument("-mesh", type=int, default=1,
                    help="ranks in the parts mesh, one a card: N > 1 runs "
                         "under torchrun --nproc-per-node N (the process "
                         "group's world must be N)")


def _load_graph(args, weighted):
    """Graph.from_file with -validate -> the graph, or exit code 2 on a
    missing or malformed file (a typed GraphFormatError)."""
    from lux_tpu_torch.format import GraphFormatError
    from lux_tpu_torch.graph import Graph

    if not os.path.exists(args.file):
        print(f"error: graph file not found: {args.file}", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    try:
        g = Graph.from_file(args.file, weighted=weighted,
                            validate=args.validate)
    except GraphFormatError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    _print_loaded(args, g, time.perf_counter() - t0)
    return g


class MeshWorldError(RuntimeError):
    """``-mesh N`` in a process group whose world is not N."""


def _refuse_unported_flags(args) -> None:
    """-elastic stays refused; -mesh joins the parts mesh (``args.
    mesh_obj``: None for -mesh 1 outside a launcher)."""
    if args.elastic:
        raise NotPortedError("-elastic (re-placement over the surviving "
                             "devices after a topology fault) is not "
                             "ported yet (ROADMAP A6b-2)")
    args.mesh_obj = _join_mesh(args)


def _join_mesh(args):
    """-mesh N (lux_tpu/cli.py:14-15): the process group's mesh, which
    must have N ranks.  A process that no launcher started is a world
    of 1, so -mesh 1 there runs without a mesh."""
    import torch.distributed as dist

    from lux_tpu_torch.parallel import multihost
    if args.mesh < 1:
        raise MeshWorldError(f"-mesh {args.mesh}: a mesh has >= 1 rank")
    launched = multihost.launched() or dist.is_initialized()
    if dist.is_initialized():
        world = dist.get_world_size()
    else:
        world = int(os.environ["WORLD_SIZE"]) if launched else 1
    if world != args.mesh:
        raise MeshWorldError(
            f"-mesh {args.mesh} needs a process group of world "
            f"{args.mesh}, this one has world {world}: start it as "
            f"torchrun --nproc-per-node {args.mesh} -m lux_tpu_torch.cli "
            f"... -mesh {args.mesh}")
    if not launched:
        return None
    multihost.initialize(device=args.device)
    mesh = multihost.global_mesh(device=args.device)
    if mesh.rank != 0:
        # every rank runs the app; rank 0 alone prints its lines
        sys.stdout = open(os.devnull, "w")
    return mesh


@contextlib.contextmanager
def _telemetry(args, app):
    """The run's telemetry sinks from -events / -iter-stats, and the
    flight recorder from -flight (lux_tpu/cli.py:395-420).  Without
    them the handle is the null one."""
    from lux_tpu_torch import telemetry, tracing

    if args.flight:
        tracing.install_flight_recorder(args.flight)
    ev = telemetry.EventLog(args.events) if args.events else None
    st = telemetry.IterStats() if args.iter_stats else None
    try:
        with telemetry.use(events=ev, iter_stats=st) as tel:
            tel.emit("run_start", schema=telemetry.SCHEMA, app=app,
                     file=args.file, np=args.np)
            yield tel
    finally:
        if ev is not None:
            ev.close()
        if args.flight:
            tracing.uninstall_flight_recorder()


def _finish_run(tel, elapsed, iters) -> None:
    """``run_done``, and the -iter-stats replay with its per-part table
    (lux_tpu/cli.py:424-445)."""
    tel.emit("run_done", seconds=round(elapsed, 6), iters=iters)
    st = tel.iter_stats
    if st is None or st.kind is None:
        return
    print("# iter-stats (device-side counters, fused run):")
    for line in st.replay_lines():
        print(line)
    for line in st.parts_lines():
        print(f"# {line}")
    tel.emit("iter_stats", **{("engine" if k == "kind" else k): v
                              for k, v in st.summary().items()})


def _print_phases(report, tel=None) -> None:
    """The per-iteration phase table (lux_tpu/cli.py:307-323), also
    emitted as one ``phases`` event."""
    META = ("frontier", "bucket", "advances")
    for i, t in enumerate(report):
        extra = "".join(f" {k}={t[k]:g}" for k in META if k in t)
        split = "  ".join(f"{k}={v * 1e3:7.2f}ms" for k, v in t.items()
                          if k not in META)
        print(f"iter {i}:{extra}  {split}")
    if tel is not None:
        tel.emit("phases", iters=len(report),
                 report=[{k: (v if k in META else round(v, 6))
                          for k, v in t.items()} for t in report])


def _print_loaded(args, g, seconds: float) -> None:
    if args.verbose:
        print(f"loaded nv={g.nv} ne={g.ne} weighted={g.weights is not None}"
              f" ({seconds:.2f}s)")


def _print_memory(args, eng, num_parts: int) -> None:
    """-verbose: the memory advisor's estimate of the engine's layout
    (reference cli.py:586-592), the reference's pricing, and below it
    the port's ledger of one step (memwatch.MemoryLedger), which prices
    the temporaries the port allocates its own way."""
    from lux_tpu_torch import memwatch, telemetry
    telemetry.current().emit("header", schema=telemetry.SCHEMA,
                             **eng.sg.telemetry_header())
    if args.verbose:
        rep = eng.sg.memory_report()
        print(f"memory: {rep['total_bytes'] / 1e6:.1f} MB total over "
              f"{num_parts} part(s) "
              f"({rep['edge_bytes_per_part'] / 1e6:.1f} MB edges + "
              f"{rep['vertex_bytes_per_part'] / 1e6:.1f} MB vertices "
              f"per part)")
        led = memwatch.MemoryLedger.for_engine(eng)
        print(f"ledger: {led.total_bytes / 1e6:.1f} MB a step (the port's "
              f"arrays and eager temporaries, memwatch.MemoryLedger; the "
              f"memory: line above is the reference's pricing)")


def _supervisor_opts(args, app):
    """None, or (checkpoint path, supervised-run kwargs) when any of
    -retries / -seg-budget / -resume asks for the supervisor
    (lux_tpu/cli.py:461-495).  Without -resume the checkpoint is a
    pid-qualified temporary file, removed after the run."""
    if not (args.retries > 0 or args.seg_budget > 0 or args.resume):
        return None
    import tempfile

    from lux_tpu_torch import resilience

    if getattr(args, "profile", None):
        print("note: -profile is ignored on the supervised path "
              "(segments are separate runs)")
    if getattr(args, "verbose", False):
        print("note: -verbose is ignored on the supervised path; "
              "-iter-stats records per-iteration counters across "
              "segments instead")

    path = args.resume or os.path.join(
        tempfile.gettempdir(),
        f"lux_torch_{app}_supervised.{os.getpid()}.ckpt.npz")
    kw = dict(policy=resilience.RetryPolicy(retries=max(0, args.retries)),
              seg_budget=args.seg_budget or None,
              resume=args.resume is not None)
    return path, kw


def _run_supervised(eng, sup, args, ni=None):
    """One supervised execution (pull fixed-``ni``, or push converge
    when ni is None), printing the supervisor's report and removing the
    temporary checkpoint (not a -resume one) on success and failure.
    Returns (result, total_iters, elapsed, billed, mark): ``billed``
    leaves out the iterations a previous invocation's -resume
    checkpoint already did."""
    import time

    from lux_tpu_torch import checkpoint, resilience

    path, kw = sup
    t0 = time.perf_counter()
    try:
        if ni is not None:
            result, report = resilience.supervised_run(eng, ni, path, **kw)
            total = ni
        else:
            label, _active, total, report = \
                resilience.supervised_converge(eng, path, **kw)
            result = eng.unpad(label)
        elapsed = time.perf_counter() - t0
    finally:
        if not args.resume:
            checkpoint.remove(path)
    print(f"# supervisor: attempts={report.attempts} "
          f"segments={report.segments} "
          f"resumed_from={report.resumed_from}")
    billed = total - (report.initial_resume or 0)
    return (result, total, elapsed, billed,
            " (supervised; incl. checkpoint saves)")


def _print_gteps(ne, iters, elapsed, mark="") -> None:
    if iters > 0:
        print(f"GTEPS = {ne * iters / elapsed / 1e9:.4f}{mark}")
    else:
        print("GTEPS = n/a (run already complete in checkpoint)")


def _batch_check_note() -> int:
    print("note: -check does not support batched runs yet; skipped "
          "(oracle proofs: tests/test_torch_batched.py)")
    return 0


def cmd_pagerank(argv) -> int:
    ap = argparse.ArgumentParser(prog="lux_tpu_torch pagerank")
    ap.add_argument("-file", required=True, help=".lux graph file")
    ap.add_argument("-ni", type=int, default=10, help="iterations")
    ap.add_argument("-tol", type=float, default=None,
                    help="run to convergence (max-abs change of the "
                         "degree-scaled rank state <= tol) instead of "
                         "a fixed -ni count")
    ap.add_argument("-max-iters", type=int, default=10000,
                    dest="max_iters",
                    help="iteration cap for -tol runs (default 10000)")
    ap.add_argument("-np", type=int, default=1, help="partitions")
    ap.add_argument("-check", action="store_true",
                    help="residual audit of the result (exit 1 on FAIL)")
    ap.add_argument("-gather", default="flat",
                    choices=["flat", "paged", "pagemajor", "auto"],
                    help="state-table delivery: the per-edge gather "
                         "('flat'), page rows + lane shuffle ('paged'), "
                         "or full gather rows bound to pages first "
                         "('pagemajor'); 'auto' picks by scalemodel")
    ap.add_argument("-pair", type=int, default=None, metavar="T",
                    help="pair-lane delivery with threshold T (relabels "
                         "the graph internally; ranks are mapped back "
                         "to input ids); exclusive with -gather "
                         "paged|pagemajor")
    ap.add_argument("-min-fill", type=_min_fill_arg, default=None,
                    dest="min_fill", metavar="F",
                    help="with -pair: drop pair rows that would deliver "
                         "< F live lanes (their edges ride the residual "
                         "path); 'auto' is scalemodel's break-even")
    _add_exchange_flag(ap)
    _add_mxu_flag(ap)
    _add_batch_flags(ap)
    _add_guard_flags(ap)
    _add_observe_flags(ap)
    _add_build_flags(ap)
    ap.add_argument("-device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    _refuse_unported_flags(args)
    with _telemetry(args, "pagerank") as tel:
        return _pagerank(args, tel)


def _pagerank(args, tel) -> int:
    from lux_tpu_torch.apps import pagerank
    from lux_tpu_torch.ops.pairs import resolve_min_fill
    from lux_tpu_torch.timing import timed_fused_run, timed_run_until

    resolve_min_fill(args.min_fill)     # a bad value fails before any work
    if not os.path.exists(args.file):
        print(f"error: graph file not found: {args.file}", file=sys.stderr)
        return 2
    _maybe_calibrate(args)
    g = _load_graph(args, None)
    if isinstance(g, int):
        return g
    num_parts = max(1, args.np)
    sources = _batched_sources(args, g.nv)
    g_run, perm, starts = _relabel_for_pairs(args, g, num_parts)
    eng = pagerank.build_engine(g_run, num_parts, device=args.device,
                                mesh=args.mesh_obj,
                                gather=args.gather, starts=starts,
                                pair_threshold=args.pair,
                                pair_min_fill=args.min_fill,
                                sources=sources, health=args.health,
                                use_mxu=_mxu_arg(args),
                                exchange=args.exchange, audit=args.audit)
    _print_memory(args, eng, num_parts)
    sup = _supervisor_opts(args, "pagerank")
    if args.tol is not None:
        if sup is not None:
            print("note: -tol runs one convergence; -retries/-seg-budget/"
                  "-resume apply to fixed -ni runs only and are ignored "
                  "here")
        state, total, res, elapsed = timed_run_until(
            eng, args.tol, args.max_iters, trace_dir=args.profile)
        ni, mark = total, ""
        print(f"ELAPSED TIME = {elapsed:.7f} s ({total} iterations, "
              f"residual {res:.3e})")
    elif sup is not None:
        state, total, elapsed, ni, mark = _run_supervised(
            eng, sup, args, ni=args.ni)
        print(f"ELAPSED TIME = {elapsed:.7f} s")
    else:
        state, elapsed = timed_fused_run(eng, args.ni,
                                         trace_dir=args.profile)
        total = ni = args.ni
        mark = ""
        print(f"ELAPSED TIME = {elapsed:.7f} s")
    _print_gteps(g.ne, ni, elapsed, mark)
    _finish_run(tel, elapsed, total)
    if args.phases:
        _state, rep = eng.timed_phases(eng.init_state(), args.phases)
        _print_phases(rep, tel)
    if sources is not None:
        _print_batch(sources, g.ne, ni, elapsed)
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
                         "'auto' is scalemodel's break-even")
    _add_exchange_flag(ap)
    _add_mxu_flag(ap)
    _add_batch_flags(ap)
    _add_guard_flags(ap)
    ap.add_argument("-device", default="cuda", choices=["cuda", "cpu"])
    _add_observe_flags(ap)
    _add_build_flags(ap)
    ap.add_argument("-sparse", type=int, default=1, choices=[0, 1],
                    metavar="0|1",
                    help="keep the src-sorted sparse-frontier view (1, "
                         "the default); 0 leaves it out (less edge "
                         "memory) and every iteration runs dense")
    if prog_name == "sssp":
        ap.add_argument("-start", type=int, default=0,
                        help="start vertex (input id)")
        ap.add_argument("-weighted", action="store_true",
                        help="weighted distances (else hop counts)")
        ap.add_argument("-delta", default=None,
                        help="delta-stepping bucket width (a number or "
                             "'auto'; default: off)")
    args = ap.parse_args(argv)
    _refuse_unported_flags(args)
    with _telemetry(args, prog_name) as tel:
        return _push_run(args, tel, prog_name)


def _push_run(args, tel, prog_name) -> int:

    from lux_tpu_torch import device_check
    from lux_tpu_torch.apps import components, sssp
    from lux_tpu_torch.ops.pairs import resolve_min_fill
    from lux_tpu_torch.timing import timed_converge

    resolve_min_fill(args.min_fill)     # a bad value fails before any work
    weighted = prog_name == "sssp" and args.weighted
    if not os.path.exists(args.file):
        print(f"error: graph file not found: {args.file}", file=sys.stderr)
        return 2
    _maybe_calibrate(args)
    g = _load_graph(args, weighted or None)
    if isinstance(g, int):
        return g
    num_parts = max(1, args.np)
    sources = _batched_sources(args, g.nv)
    g_run, perm, starts = _relabel_for_pairs(args, g, num_parts)
    opts = dict(num_parts=num_parts, starts=starts, gather=args.gather,
                pair_threshold=args.pair, pair_min_fill=args.min_fill,
                sources=sources, device=args.device, health=args.health,
                use_mxu=_mxu_arg(args), exchange=args.exchange,
                enable_sparse=bool(args.sparse), audit=args.audit,
                mesh=args.mesh_obj)
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
    _print_memory(args, eng, num_parts)
    sup = _supervisor_opts(args, prog_name)
    if sup is not None:
        labels, iters, elapsed, it_exec, mark = _run_supervised(eng, sup,
                                                                args)
    else:
        labels, iters, [elapsed] = timed_converge(
            eng, verbose=args.verbose, trace_dir=args.profile)
        it_exec, mark = iters, ""
    print(f"ELAPSED TIME = {elapsed:.7f} s ({iters} iterations)")
    _print_gteps(g.ne, it_exec, elapsed, mark)
    _finish_run(tel, elapsed, iters)
    if args.phases:
        lab0, act0 = eng.init_state()
        _l, _a, rep = eng.timed_phases(lab0, act0, args.phases)
        _print_phases(rep, tel)
    if sources is not None:
        _print_batch(sources, g.ne, it_exec, elapsed)
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
                         "refused for the dot path)")
    ap.add_argument("-pair", type=int, default=None, metavar="T",
                    help="pair-lane SDDMM delivery with threshold T "
                         "(relabels the graph internally)")
    ap.add_argument("-min-fill", type=_min_fill_arg, default=None,
                    dest="min_fill", metavar="F",
                    help="with -pair: drop pair rows with < F live lanes "
                         "(bench.py's colfilter config uses 22); 'auto' "
                         "is scalemodel's break-even at K = 20")
    _add_exchange_flag(ap)
    _add_mxu_flag(ap)
    _add_guard_flags(ap)
    _add_observe_flags(ap)
    _add_build_flags(ap)
    ap.add_argument("-device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    _refuse_unported_flags(args)
    _warn_exchange_ignored(args)
    with _telemetry(args, "colfilter") as tel:
        return _colfilter(args, tel)


def _colfilter(args, tel) -> int:
    from lux_tpu_torch import device_check
    from lux_tpu_torch.apps import colfilter
    from lux_tpu_torch.graph import VPAD_ALIGN, ShardedGraph
    from lux_tpu_torch.ops.pairs import resolve_min_fill
    from lux_tpu_torch.timing import timed_fused_run

    resolve_min_fill(args.min_fill)     # a bad value fails before any work
    if not os.path.exists(args.file):
        print(f"error: graph file not found: {args.file}", file=sys.stderr)
        return 2
    _maybe_calibrate(args)
    g = _load_graph(args, True)
    if isinstance(g, int):
        return g
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
                                     mesh=args.mesh_obj,
                                     sg=sg, gather=args.gather,
                                     pair_threshold=args.pair,
                                     pair_min_fill=args.min_fill,
                                     health=args.health,
                                     use_mxu=_mxu_arg(args),
                                     audit=args.audit)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    _print_memory(args, eng, num_parts)
    sup = _supervisor_opts(args, "colfilter")
    if sup is not None:
        state, total, elapsed, ni, mark = _run_supervised(
            eng, sup, args, ni=args.ni)
    else:
        state, elapsed = timed_fused_run(eng, args.ni,
                                         trace_dir=args.profile)
        total = ni = args.ni
        mark = ""
    print(f"ELAPSED TIME = {elapsed:.7f} s")
    _print_gteps(g.ne, ni, elapsed, mark)
    _finish_run(tel, elapsed, total)
    if args.phases:
        _state, rep = eng.timed_phases(eng.init_state(), args.phases)
        _print_phases(rep, tel)
    out = eng.unpad(state)
    # out is in g_run's order; the RMSE runs over its edges, so the
    # relabelled graph is the matching choice
    print(f"RMSE = {colfilter.rmse(g_run, out):.6f}")
    if args.check:
        if args.mesh_obj is not None:
            # the audit reads the whole state: every rank's rows
            state = np.asarray(sg.to_padded(out))
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
    except (DeviceUnavailableError, NotPortedError, AuditError,
            MeshWorldError) as e:
        # -audit error: a violating build is a typed, named refusal
        # (like GraphFormatError), never a run whose numbers silently
        # embed the violation
        print(f"error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
