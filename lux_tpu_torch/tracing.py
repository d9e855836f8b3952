"""Run tracing: span timeline with Perfetto export, plus the crash
flight recorder (counterpart of lux_tpu/tracing.py).

1. **Span model + Perfetto export** (``trace_export``): reconstruct the
   run -> attempt -> segment / timed-run -> phase hierarchy from a
   telemetry event stream (telemetry.py: every event carries ``tm``,
   ``pid`` and ``session``) and emit Chrome-trace / Perfetto JSON.  One
   trace process per (session, pid) stream, aligned by the median
   ``t - tm`` offset; events carrying fenced ``seconds`` (segment,
   timed_run, checkpoint_save) become duration spans ending at their
   emit time; ``phases`` reports unroll into per-iteration phase spans;
   ``mem_sample`` events draw a counter track; serving events
   (``query_enqueue`` / ``query_start`` / ``query_done`` / ``failover``)
   become per-query lanes; everything else is an instant marker.
   ``validate_trace`` machine-checks the output: spans nest per track,
   no span lies outside a run, query phases lie inside their query, a
   qid retires once unless a failover moved it to another track.  The
   trace is the reference's for the same event list (the generator
   field names this package).
2. **Crash flight recorder** (``FlightRecorder``): a bounded ring of
   recent events plus the last health word, calibration and placement
   metadata, fed as a telemetry observer and dumped ATOMICALLY (a
   temporary file, then ``os.replace``) to ``FLIGHT.json`` by the
   resilience supervisor on fatal failures and topology faults.

CLI (``python -m lux_tpu_torch.tracing``):

- no arguments: run the four apps on small graphs (``-device cpu`` on a
  machine without a card) with telemetry and per-part counters, and
  export ``trace.json``;
- ``FILE...``: export existing event JSONL file(s), rotated generations
  included.

The reference's mesh drills (``-drill``: the elastic device-loss and
the two-process worker-kill drills) need a mesh or several processes
and are refused, naming ROADMAP A6b-2.  Pure host code over event dicts,
apart from the smoke's engine runs; it imports nothing of the
reference.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import os
import sys
import tempfile
import time
from statistics import median

from lux_tpu_torch import telemetry

SCHEMA = 1

# event kinds whose fenced ``seconds`` is a real duration ending at
# the emit time -> duration spans on the execution track
SPAN_KINDS = {"segment", "timed_run", "checkpoint_save"}
# run boundaries (one CLI invocation / bench config each)
RUN_BOUNDARIES = ("run_start", "config_start")
# instant markers promoted to PROCESS scope (big visual arrows)
PROCESS_INSTANTS = {"mesh_shrink", "topology_fault", "replace",
                    "failure", "health_trip", "flight_dump"}
# timed_phases report keys that are counters, not phase seconds
META_KEYS = ("frontier", "bucket", "advances")
# round 19 (lux_tpu/comms.py): phases whose span subdivides into
# per-collective child spans when the run carries a comm_ledger event
# with a priced wire time (the engines' COMM_PHASES anchor)
COMM_PHASE_NAMES = ("exchange", "gen_exchange")

# per-query serving spans (round 17): query tracks start here, one
# LANE per set of non-overlapping queries (greedy interval packing —
# an oversubscribed load renders as stacked lanes whose depth IS the
# concurrency), leaving tid 1..99 to the execution epochs.  Round 18
# (serving fleet, lux_tpu/fleet.py): lanes group PER REPLICA — each
# replica group gets a contiguous tid range starting at
# QUERY_TID_BASE, sized max(QUERY_REPLICA_STRIDE, its lane count)
# (so small traces keep stable base+group*stride tids and a deep
# group can never collide into the next group's range), and a
# failover renders as the qid's span SPLITTING onto the new
# replica's track group (the round-13 mesh-shrink epoch pattern
# applied to query lanes; ``validate_trace`` machine-checks the
# transition).
QUERY_TID_BASE = 100
QUERY_REPLICA_STRIDE = 40


def _num(x) -> bool:
    return isinstance(x, (int, float)) and not isinstance(x, bool) \
        and x == x and abs(x) != float("inf")


# ---------------------------------------------------------------------
# event loading / stream splitting (wire format of telemetry.EventLog)

def load_events(path: str):
    """Tolerant JSONL load -> (events, errors)."""
    events, errs = [], []
    with open(path) as f:
        for i, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                ev = json.loads(line)
            except json.JSONDecodeError as e:
                errs.append(f"{path}:{i}: unparseable JSON ({e})")
                continue
            if not isinstance(ev, dict) or "kind" not in ev:
                errs.append(f"{path}:{i}: event without a 'kind'")
                continue
            events.append(ev)
    if not events and not errs:
        errs.append(f"{path}: no events found")
    return events, errs


def split_streams(events):
    """[(key, events)] per (session, pid) stream in first-appearance
    order — the round-12 merge key; legacy events (no session/pid)
    share the ``None`` stream."""
    streams, order = {}, []
    for ev in events:
        key = None
        if "session" in ev or "pid" in ev:
            key = (ev.get("session"), ev.get("pid"))
        if key not in streams:
            streams[key] = []
            order.append(key)
        streams[key].append(ev)
    return [(k, streams[k]) for k in order]


def split_runs(events):
    """Group one stream into runs at run_start/config_start
    boundaries; a log without boundary events is one anonymous run."""
    runs, cur = [], []
    for ev in events:
        if ev["kind"] in RUN_BOUNDARIES and cur:
            runs.append(cur)
            cur = []
        cur.append(ev)
    if cur:
        runs.append(cur)
    return runs


# ---------------------------------------------------------------------
# pillar 1: span reconstruction + Chrome-trace/Perfetto export

@dataclasses.dataclass
class _Track:
    """Mutable per-stream export state (epoch = mesh-shrink count:
    execution spans after a shrink move to a new tid — the track
    transition that makes an elastic drill readable)."""
    pid: int
    epoch: int = 0
    shrink_labels: dict = dataclasses.field(default_factory=dict)


def _stream_offset(evs) -> float:
    """Median wall-minus-monotonic offset: aligns this process's
    monotonic timestamps onto the (roughly) shared wall clock."""
    ds = [ev["t"] - ev["tm"] for ev in evs
          if _num(ev.get("t")) and _num(ev.get("tm"))]
    return median(ds) if ds else 0.0


def _ats(ev, off) -> float | None:
    """Aligned absolute seconds of one event (monotonic + offset;
    wall-clock fallback for legacy events)."""
    if _num(ev.get("tm")):
        return ev["tm"] + off
    if _num(ev.get("t")):
        return ev["t"]
    return None


def _span(name, cat, ts, dur, pid, tid, args=None) -> dict:
    out = {"name": str(name), "cat": cat, "ph": "X",
           "ts": round(ts, 1), "dur": round(max(dur, 0.0), 1),
           "pid": pid, "tid": tid}
    if args:
        out["args"] = args
    return out


def _instant(name, ts, pid, tid, scope="t", args=None) -> dict:
    out = {"name": str(name), "cat": "marker", "ph": "i",
           "ts": round(ts, 1), "pid": pid, "tid": tid, "s": scope}
    if args:
        out["args"] = args
    return out


def _meta(name, pid, value, tid=None) -> dict:
    out = {"name": name, "ph": "M", "pid": pid,
           "args": {"name" if name.endswith("_name")
                    else "sort_index": value}}
    if tid is not None:
        out["tid"] = tid
    return out


def _clamp(ts, dur, lo, hi):
    ts = min(max(ts, lo), hi)
    return ts, max(0.0, min(dur, hi - ts))


def _span_name(ev) -> str:
    k = ev["kind"]
    if k == "segment":
        n = ev.get("n", ev.get("iters"))
        return f"segment[{ev.get('engine', '?')} n={n}]"
    if k == "timed_run":
        return f"timed_run[{ev.get('repeat', 0)}]"
    return k


def _run_spans(run, us, trk: _Track, te: list):
    """Emit one run's spans into ``te``: the run span + attempt spans
    on tid 0, execution/phase spans on tid 1+epoch, everything else
    as instant markers.  Child spans are clamped into the run extent
    so the nesting invariant holds by construction."""
    times = [us(ev) for ev in run]
    rstart, rend = min(times), max(times)
    head = run[0] if run[0]["kind"] in RUN_BOUNDARIES else {}
    name = head.get("app") or head.get("config") or "run"
    args = {k: head[k] for k in ("app", "config", "file", "mesh",
                                 "drill", "worker") if k in head}
    # the counters digest (imbalance + per-part totals) rides the run
    # span so Perfetto's selection panel shows the attribution
    for ev in run:
        if ev["kind"] == "iter_stats":
            args["iter_stats"] = {
                k: v for k, v in ev.items()
                if k in ("engine", "iters", "imbalance", "parts",
                         "parts_edges", "parts_changed", "edges_sum",
                         "changed_sum")}
    te.append(_span(name, "run", rstart, rend - rstart, trk.pid, 0,
                    args=args or None))
    # round 19: the run's comm ledgers, keyed by app (a decompose run
    # holds several apps in one stream) — each phases event below
    # subdivides with ITS app's ledger; a lone ledger also serves
    # phases events that carry no app tag (the CLI -phases shape)
    comm_by_app = {}
    for ev in run:
        if ev["kind"] == "comm_ledger":
            comm_by_app[ev.get("app", ev.get("config"))] = ev

    # attempt spans: boundaries at retry / handled-topology events
    # (supervise() retries immediately after a handled topology fault
    # and after the retry backoff otherwise)
    bounds = [rstart]
    for ev, ts in zip(run, times):
        if ev["kind"] == "retry" or (ev["kind"] == "topology_fault"
                                     and ev.get("handled")):
            bounds.append(ts)
    bounds.append(rend)
    for i in range(len(bounds) - 1):
        a, b = bounds[i], bounds[i + 1]
        te.append(_span(f"attempt {i}", "attempt", a, b - a,
                        trk.pid, 0))

    for ev, ts in zip(run, times):
        kind = ev["kind"]
        tid = 1 + trk.epoch
        if kind in SPAN_KINDS and _num(ev.get("seconds")):
            dur = ev["seconds"] * 1e6
            s, d = _clamp(ts - dur, dur, rstart, rend)
            te.append(_span(_span_name(ev), "exec", s, d, trk.pid,
                            tid, args={k: v for k, v in ev.items()
                                       if k in ("n", "done", "iters",
                                                "total", "active",
                                                "repeat", "iter",
                                                "path", "engine")}))
        elif kind == "phases":
            report = [r for r in ev.get("report", [])
                      if isinstance(r, dict)]
            total = sum(v for r in report for k, v in r.items()
                        if k not in META_KEYS and _num(v)) * 1e6
            cur = max(rstart, ts - total)
            comm = comm_by_app.get(ev.get("app"))
            if comm is None and "app" not in ev \
                    and len(comm_by_app) == 1:
                comm = next(iter(comm_by_app.values()))
            for i, r in enumerate(report):
                for ph, v in r.items():
                    if ph in META_KEYS or not _num(v):
                        continue
                    d = v * 1e6
                    s, d = _clamp(cur, d, rstart, rend)
                    te.append(_span(f"i{i}:{ph}", "phase", s, d,
                                    trk.pid, tid))
                    if ph in COMM_PHASE_NAMES:
                        te.extend(_collective_spans(
                            comm, i, ph, s, d, trk.pid, tid))
                    cur += d
        elif kind == "mem_sample":
            # round-22 memory observatory: the occupancy trail draws
            # as a Chrome COUNTER track ("C" phase) — live bytes +
            # the peak watermark as stacked series, one counter row
            # per replica when the sample is labeled
            cname = "memory"
            if ev.get("replica"):
                cname = f"memory:{ev['replica']}"
            te.append({"name": cname, "ph": "C", "ts": ts,
                       "pid": trk.pid,
                       "args": {"live_bytes":
                                int(ev.get("live_bytes", 0)),
                                "peak_bytes":
                                int(ev.get("peak_bytes", 0))}})
        elif kind in RUN_BOUNDARIES:
            pass                       # represented by the run span
        else:
            scope = "p" if kind in PROCESS_INSTANTS else "t"
            iargs = {k: v for k, v in ev.items()
                     if k not in ("t", "tm", "pid", "session", "kind")
                     and isinstance(v, (int, float, str, bool))}
            te.append(_instant(kind, ts, trk.pid, tid, scope=scope,
                               args=iargs or None))
        if kind == "mesh_shrink":
            trk.epoch += 1
            to = ev.get("to_ndev", ev.get("to_nproc"))
            trk.shrink_labels[trk.epoch] = (
                f"exec (after shrink #{trk.epoch}"
                + (f", ndev={to}" if _num(to) else "") + ")")
    _query_spans(run, times, trk, te, rstart, rend)


def _collective_spans(comm, i, ph, s, d, pid, tid) -> list:
    """Per-collective child spans inside one exchange-phase span
    (round 19, lux_tpu/comms.py): the ledger's priced wire window —
    min(predicted wire seconds, the measured phase) — sits at the
    START of the phase (the collective launches before the epilogue
    consumes it), subdivided proportionally to each collective's
    shipped bytes.  Emitted only when the ledger carries a priced
    wire time (a measured link rate existed): an unpriced guess must
    not render as measurement.  Children lie strictly inside the
    phase span, so the nesting validator holds by construction."""
    if not isinstance(comm, dict) or d <= 0:
        return []
    pred = comm.get("predicted_s")
    groups = comm.get("per_collective")
    if not _num(pred) or pred <= 0 or not isinstance(groups, list):
        return []
    ents = [g for g in groups if isinstance(g, dict)
            and _num(g.get("shipped_bytes")) and g["shipped_bytes"] > 0]
    # cond branches are ALTERNATIVES: predicted_s prices the steady
    # path (unconditional + heaviest branch, the ledger convention),
    # so the subdivision keeps exactly that path — rendering a branch
    # that did not run would show collectives the iteration never
    # launched
    by_branch: dict = {}
    for g in ents:
        by_branch.setdefault(g.get("branch") or "", []).append(g)
    keep = by_branch.pop("", [])
    if by_branch:
        keep += max(by_branch.values(),
                    key=lambda gs: sum(g["shipped_bytes"]
                                       for g in gs))
    ents = keep
    total = sum(g["shipped_bytes"] for g in ents)
    if total <= 0:
        return []
    win = min(pred * 1e6, d)
    out, cur = [], s
    for g in ents:
        cd = win * g["shipped_bytes"] / total
        cur2, cd = _clamp(cur, cd, s, s + d)
        out.append(_span(f"i{i}:{ph}:{g.get('prim')}", "collective",
                         cur2, cd, pid, tid,
                         args={"shipped_bytes": g["shipped_bytes"],
                               "count": g.get("count"),
                               "tier": g.get("tier")}))
        cur = cur2 + cd
    return out


def _merge_windows(windows):
    """Sorted, overlap-merged [(s, e)] — sibling spans on one track
    must be disjoint for the nesting validator."""
    out = []
    for s, e in sorted(windows):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def _query_spans(run, times, trk: _Track, te: list, rstart, rend):
    """Per-query serving spans (round 17, lux_tpu/serve.py events):
    each retired query becomes a ``query`` span from its enqueue to
    its retirement, with ``query_phase`` children splitting the life
    into the queue WAIT (enqueue -> column assignment) and the
    engine segments that carried it — so a query's wait-vs-compute
    renders visibly in Perfetto.  Queries pack greedily onto
    ``queries.N`` lanes (one lane per set of non-overlapping
    queries); everything is clamped into the run extent so the
    run-nesting invariant holds by construction, and
    ``validate_trace`` machine-checks the query/query_phase nesting
    rule.

    Round 18 (serving fleet): lanes group PER REPLICA (thread name
    ``queries[replica].N``), and a ``failover`` event SPLITS the
    qid's span at the failover instant — the pre-failover segment
    stays on the dead replica's track group, the post-failover
    segment (named ``... (failover)``, args carrying
    ``failover_from``/``failover_to``) moves onto the survivor's —
    the same track-transition idiom the mesh-shrink epochs use, now
    on the query lanes."""
    enq, starts, done, fo = {}, {}, {}, {}
    segs = []
    for ev, ts in zip(run, times):
        kind = ev["kind"]
        qid = ev.get("qid")
        if kind == "query_enqueue":
            enq.setdefault(qid, ts)
        elif kind == "query_start":
            starts.setdefault(qid, []).append((ts, ev))
        elif kind == "failover":
            fo.setdefault(qid, []).append((ts, ev))
        elif kind == "query_done":
            done[qid] = (ts, ev)
        elif kind == "segment" and _num(ev.get("seconds")):
            d = ev["seconds"] * 1e6
            segs.append((ts - d, ts))
    if not done:
        return
    segs = _merge_windows(segs)
    qs = []
    for qid, (tend, ev) in done.items():
        t0 = enq.get(qid)
        if t0 is None and _num(ev.get("latency_s")):
            t0 = tend - ev["latency_s"] * 1e6
        sl = starts.get(qid) or []
        t1 = sl[0][0] if sl else None
        if t1 is None and t0 is not None and _num(ev.get("wait_s")):
            t1 = t0 + ev["wait_s"] * 1e6
        t0 = tend if t0 is None else t0
        t1 = t0 if t1 is None else t1
        t0 = min(max(t0, rstart), rend)          # clamp + order
        t1 = min(max(t1, t0), rend)
        tend = min(max(tend, t1), rend)
        qs.append((t0, t1, tend, qid, ev))
    qs.sort(key=lambda x: (x[0], x[2]))
    groups: dict = {}           # replica -> lane-group index
    lane_ends: dict = {}        # group -> per-lane end times
    lane_labels: dict = {}      # (group, lane) -> thread label
    placed: list = []           # (group, lane, span dict) pending tid

    def lane_of(replica, s, e):
        group = groups.setdefault(replica, len(groups))
        ends = lane_ends.setdefault(group, [])
        lane = next((i for i, x in enumerate(ends) if x <= s), None)
        if lane is None:
            lane = len(ends)
            ends.append(e)
            lane_labels[(group, lane)] = (
                f"queries.{lane}" if replica is None
                else f"queries[{replica}].{lane}")
        else:
            ends[lane] = max(ends[lane], e)
        return group, lane

    for t0, t1, tend, qid, ev in qs:
        sl = starts.get(qid) or []
        fos = sorted(fo.get(qid) or [], key=lambda x: x[0])
        cuts = [t0]
        for ts_f, _fev in fos:
            cuts.append(min(max(ts_f, cuts[-1]), tend))
        cuts.append(tend)

        def replica_of(i):
            if i == 0:
                # the failover record is authoritative for the
                # pre-failover replica: a query killed while still
                # QUEUED on the dead replica has its first
                # query_start on the survivor, but its first life
                # segment belongs to the replica it was assigned to
                if fos:
                    return fos[0][1].get("from_replica")
                if sl:
                    return sl[0][1].get("replica")
                return ev.get("replica")
            return fos[i - 1][1].get("to_replica")

        base = {k: v for k, v in ev.items()
                if k in ("qid", "query_kind", "col", "iters",
                         "segments", "latency_s", "wait_s",
                         "converged", "slo_ms", "slo_ok")}
        for i in range(len(cuts) - 1):
            s, e = cuts[i], cuts[i + 1]
            replica = replica_of(i)
            gl = lane_of(replica, s, e)
            args = dict(base)
            if replica is not None:
                args["replica"] = replica
            name = f"q{qid} [{ev.get('query_kind', '?')}]"
            if i > 0:
                fev = fos[i - 1][1]
                args["failover_from"] = fev.get("from_replica")
                args["failover_to"] = fev.get("to_replica")
                name += " (failover)"
            placed.append((*gl, _span(name, "query", s, e - s,
                                      trk.pid, 0, args=args)))
            lo = min(max(t1, s), e) if i == 0 else s
            if i == 0 and lo > s:
                placed.append((*gl, _span("wait", "query_phase", s,
                                          lo - s, trk.pid, 0)))
            resident = False
            for s0, s1 in segs:
                a, b = max(s0, lo), min(s1, e)
                if b > a:
                    placed.append((*gl, _span("seg", "query_phase",
                                              a, b - a, trk.pid, 0)))
                    resident = True
            if not resident and e > lo:
                # no overlapping segment events (sparse log): one
                # undifferentiated residency child keeps
                # wait-vs-compute readable
                placed.append((*gl, _span("resident", "query_phase",
                                          lo, e - lo, trk.pid, 0)))

    # tid assignment is a SECOND pass: each replica group gets a
    # contiguous lane range sized by its ACTUAL lane count (at least
    # QUERY_REPLICA_STRIDE, so small traces keep the stable
    # base+group*stride tids) — a group needing more lanes than the
    # stride can never collide into the next group's track range
    offsets, off = {}, 0
    for group in sorted(lane_ends):
        offsets[group] = off
        off += max(QUERY_REPLICA_STRIDE, len(lane_ends[group]))
    for (group, lane), label in sorted(lane_labels.items()):
        te.append(_meta("thread_name", trk.pid, label,
                        tid=QUERY_TID_BASE + offsets[group] + lane))
    for group, lane, span in placed:
        span["tid"] = QUERY_TID_BASE + offsets[group] + lane
        te.append(span)


def trace_export(events, out: str | None = None) -> dict:
    """Chrome-trace/Perfetto JSON for a (possibly multi-process)
    telemetry event list.  One trace process per (session, pid)
    stream; ``out`` additionally writes the JSON atomically.  Returns
    the trace dict ({"traceEvents": [...], ...})."""
    streams = split_streams(events)
    offs = {key: _stream_offset(evs) for key, evs in streams}
    t0s = [t for key, evs in streams
           for t in (_ats(ev, offs[key]) for ev in evs)
           if t is not None]
    t0 = min(t0s) if t0s else 0.0
    te: list = []
    for si, (key, evs) in enumerate(streams):
        trk = _Track(pid=si)
        off = offs[key]

        def us(ev, _off=off):
            a = _ats(ev, _off)
            return 0.0 if a is None else (a - t0) * 1e6

        session, ospid = key if key is not None else (None, None)
        pname = (f"session {session} pid {ospid}"
                 if key is not None else "events")
        te.append(_meta("process_name", si, pname))
        te.append(_meta("process_sort_index", si, si))
        te.append(_meta("thread_name", si, "run/attempt", tid=0))
        for run in split_runs(evs):
            _run_spans(run, us, trk, te)
        te.append(_meta("thread_name", si, "exec", tid=1))
        for epoch, label in trk.shrink_labels.items():
            te.append(_meta("thread_name", si, label, tid=1 + epoch))
    trace = {"traceEvents": te, "displayTimeUnit": "ms",
             "otherData": {"schema": SCHEMA,
                           "generator": "lux_tpu_torch.tracing",
                           "streams": len(streams)}}
    if out:
        _atomic_write_json(out, trace)
    return trace


def _atomic_write_json(path: str, doc) -> None:
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


# span endpoints inherit the 1e-6 s rounding of ``tm``/``seconds``:
# tolerate up to 2 us of slack before calling two spans overlapping
_EPS_US = 2.0


def validate_trace(trace, eps_us: float = _EPS_US) -> list[str]:
    """Machine-check a trace: known phases only, numeric
    ts/dur, PROPER NESTING per (pid, tid) track (two spans either
    disjoint or one contains the other), no orphan spans (every
    non-run span lies inside some run span of its process), and —
    round 17 — the per-query nesting rule: every ``query`` span
    carries its qid, and every ``query_phase`` span (wait / seg /
    resident) lies inside some ``query`` span of its own track.
    Returns error strings; empty = valid."""
    errs: list[str] = []
    evs = trace.get("traceEvents") if isinstance(trace, dict) else None
    if not isinstance(evs, list) or not evs:
        return ["traceEvents missing or empty"]
    spans: dict = {}
    runs: dict = {}
    qspans: dict = {}
    qphases: dict = {}
    qrecords: list = []
    for i, e in enumerate(evs):
        if not isinstance(e, dict):
            errs.append(f"traceEvents[{i}]: not an object")
            continue
        ph = e.get("ph")
        if ph not in ("X", "i", "I", "M"):
            errs.append(f"traceEvents[{i}]: unknown ph {ph!r}")
            continue
        if ph == "M":
            continue
        if not isinstance(e.get("name"), str):
            errs.append(f"traceEvents[{i}]: non-string name")
        if not _num(e.get("ts")):
            errs.append(f"traceEvents[{i}]: non-numeric ts")
            continue
        if ph == "X":
            if not _num(e.get("dur")) or e["dur"] < 0:
                errs.append(f"traceEvents[{i}] {e.get('name')!r}: "
                            f"bad dur {e.get('dur')!r}")
                continue
            spans.setdefault((e.get("pid"), e.get("tid")),
                             []).append(e)
            if e.get("cat") == "run":
                runs.setdefault(e.get("pid"), []).append(
                    (e["ts"], e["ts"] + e["dur"]))
            elif e.get("cat") == "query":
                if not isinstance((e.get("args") or {}).get("qid"),
                                  int):
                    errs.append(f"traceEvents[{i}] {e.get('name')!r}:"
                                f" query span without an integer "
                                f"args.qid")
                qspans.setdefault((e.get("pid"), e.get("tid")),
                                  []).append(
                    (e["ts"], e["ts"] + e["dur"]))
                qrecords.append(e)
            elif e.get("cat") == "query_phase":
                qphases.setdefault((e.get("pid"), e.get("tid")),
                                   []).append(e)
    for (pid, tid), sp in spans.items():
        sp.sort(key=lambda e: (e["ts"], -e["dur"]))
        stack: list[float] = []
        for e in sp:
            s, end = e["ts"], e["ts"] + e["dur"]
            while stack and stack[-1] <= s + eps_us:
                stack.pop()
            if stack and end > stack[-1] + eps_us:
                errs.append(
                    f"track (pid {pid}, tid {tid}): span "
                    f"{e['name']!r} [{s}, {end}] overlaps the "
                    f"enclosing span ending at {stack[-1]} — spans "
                    f"must nest")
            stack.append(end)
    for (pid, _tid), sp in spans.items():
        rl = runs.get(pid)
        if not rl:
            continue            # hand-made trace without run spans
        for e in sp:
            if e.get("cat") == "run":
                continue
            s, end = e["ts"], e["ts"] + e["dur"]
            if not any(rs - eps_us <= s and end <= re + eps_us
                       for rs, re in rl):
                errs.append(f"orphan span {e['name']!r} (pid {pid}): "
                            f"[{s}, {end}] lies in no run span")
    # round 17: a query phase (wait/seg/resident) outside every query
    # span of its track is an orphan — the wait-vs-compute split
    # would be attributed to no query
    for key, phases in qphases.items():
        ql = qspans.get(key, [])
        for e in phases:
            s, end = e["ts"], e["ts"] + e["dur"]
            if not any(qs - eps_us <= s and end <= qe + eps_us
                       for qs, qe in ql):
                errs.append(
                    f"track (pid {key[0]}, tid {key[1]}): "
                    f"query_phase span {e['name']!r} [{s}, {end}] "
                    f"lies in no query span — per-query phases must "
                    f"nest inside their query")
    # round 18 (serving fleet): a qid appearing as MULTIPLE query
    # spans is a failover split — every span after the first must
    # carry its failover record and sit on a DIFFERENT track (the
    # new replica's lane group); anything else is either a duplicate
    # retirement or a failover that did not transition tracks.
    # Scoped to the containing run window so qids legitimately reused
    # across runs in one stream don't conflate.
    by_qid: dict = {}
    for e in qrecords:
        qid = (e.get("args") or {}).get("qid")
        if not isinstance(qid, int):
            continue            # reported above
        pid = e.get("pid")
        rl = runs.get(pid) or []
        w = next((i for i, (rs, re) in enumerate(rl)
                  if rs - eps_us <= e["ts"]
                  and e["ts"] + e["dur"] <= re + eps_us), None)
        by_qid.setdefault((pid, w, qid), []).append(e)
    for (pid, _w, qid), lst in by_qid.items():
        if len(lst) < 2:
            continue
        lst.sort(key=lambda e: e["ts"])
        for prev, cur in zip(lst, lst[1:]):
            args = cur.get("args") or {}
            if "failover_from" not in args:
                errs.append(
                    f"qid {qid} (pid {pid}): {len(lst)} query spans "
                    f"but the span at ts {cur['ts']} carries no "
                    f"failover record — a qid must retire exactly "
                    f"once")
                continue
            if cur.get("tid") == prev.get("tid"):
                errs.append(
                    f"qid {qid} (pid {pid}): post-failover segment "
                    f"at ts {cur['ts']} sits on the SAME track (tid "
                    f"{cur.get('tid')}) as the segment it continues "
                    f"— a failover must transition onto the new "
                    f"replica's track")
            rep = args.get("replica")
            if rep is not None and args.get("failover_to") is not None \
                    and rep != args["failover_to"]:
                errs.append(
                    f"qid {qid} (pid {pid}): post-failover segment "
                    f"claims replica {rep!r} but its failover record "
                    f"names {args['failover_to']!r} — the span "
                    f"contradicts its own transition")
    return errs


# ---------------------------------------------------------------------
# pillar 3: crash flight recorder

FLIGHT_DEFAULT = "FLIGHT.json"
FLIGHT_CAPACITY = 256


class FlightRecorder:
    """Bounded postmortem ring: the last ``capacity`` telemetry
    events plus the most recent health word, calibration fingerprint
    and placement metadata, dumped atomically on demand.  Installed
    as a telemetry observer (``install_flight_recorder``); the
    resilience supervisor dumps it on FATAL failures and topology
    faults, so a run that dies leaves ``FLIGHT.json`` behind."""

    def __init__(self, path: str = FLIGHT_DEFAULT,
                 capacity: int = FLIGHT_CAPACITY):
        self.path = path
        self.ring: collections.deque = collections.deque(
            maxlen=max(1, int(capacity)))
        self.last_health: dict | None = None
        self.last_calibration: dict | None = None
        self.placement: dict = {}
        self.dumps = 0
        # round-22 memory observatory: the occupancy trail survives
        # the main ring's churn — a fatal's postmortem always shows
        # the memory history even when chatty per-query events have
        # already rotated the samples out of the ring
        self.mem_trail: collections.deque = collections.deque(
            maxlen=64)

    def record(self, ev: dict) -> None:
        self.ring.append(ev)
        k = ev.get("kind")
        if k in ("health", "health_trip"):
            self.last_health = ev
        elif k == "calibration":
            self.last_calibration = ev
            if _num(ev.get("ndev")):
                self.placement["ndev"] = ev["ndev"]
        elif k == "header":
            for f in ("nv", "ne", "num_parts"):
                if f in ev:
                    self.placement[f] = ev[f]
        elif k == "mesh_shrink":
            to = ev.get("to_ndev", ev.get("to_nproc"))
            if _num(to):
                self.placement["ndev"] = to
            self.placement["shrinks"] = \
                self.placement.get("shrinks", 0) + 1
        elif k == "replace":
            if _num(ev.get("to_ndev")):
                self.placement["ndev"] = ev["to_ndev"]
        elif k in ("mem_sample", "mem_watermark", "mem_pressure"):
            self.mem_trail.append(ev)

    def snapshot(self, reason=None, classification=None) -> dict:
        counts: dict = {}
        for ev in self.ring:
            counts[ev.get("kind")] = counts.get(ev.get("kind"), 0) + 1
        return {"schema": SCHEMA, "t": round(time.time(), 6),
                "session": telemetry.session_id(), "pid": os.getpid(),
                "reason": reason, "classification": classification,
                "placement": self.placement or None,
                "health": self.last_health,
                "calibration": self.last_calibration,
                "counts": counts,
                "mem_trail": list(self.mem_trail) or None,
                "events": list(self.ring)}

    def dump(self, reason=None, classification=None) -> str:
        """Atomic write (tmp + rename: a crash mid-dump can never
        leave a torn FLIGHT.json) -> the dump path."""
        doc = self.snapshot(reason, classification)
        _atomic_write_json(self.path, doc)
        self.dumps += 1
        telemetry.current().emit(
            "flight_dump", path=self.path,
            reason=None if reason is None else str(reason)[:300],
            classification=classification, events=len(doc["events"]))
        return self.path


_RECORDER: FlightRecorder | None = None


def install_flight_recorder(path: str = FLIGHT_DEFAULT,
                            capacity: int = FLIGHT_CAPACITY
                            ) -> FlightRecorder:
    """Install (or replace) the process flight recorder as a
    telemetry observer.  Idempotent per path; the CLI's ``-flight``
    calls this."""
    global _RECORDER
    uninstall_flight_recorder()
    _RECORDER = FlightRecorder(path, capacity)
    telemetry.add_observer(_RECORDER.record)
    return _RECORDER


def uninstall_flight_recorder() -> None:
    global _RECORDER
    if _RECORDER is not None:
        telemetry.remove_observer(_RECORDER.record)
        _RECORDER = None


def flight_recorder() -> FlightRecorder | None:
    return _RECORDER


def flight_dump(reason=None, classification=None) -> str | None:
    """Dump the installed recorder (no-op None when none is
    installed) — the resilience supervisor's crash hook."""
    if _RECORDER is None:
        return None
    return _RECORDER.dump(reason, classification)


def load_flight(path: str) -> dict:
    with open(path) as f:
        doc = json.load(f)
    if not isinstance(doc, dict) or "events" not in doc:
        raise ValueError(f"{path}: not a flight-recorder dump "
                         f"(no 'events')")
    return doc


# ---------------------------------------------------------------------
# drills + CLI

SMOKE_APPS = ("pagerank", "cc", "sssp", "colfilter")


def _emit_iter_stats(tel, st) -> None:
    if st.kind is None:
        return
    tel.emit("iter_stats", **{("engine" if k == "kind" else k): v
                              for k, v in st.summary().items()})


def _smoke_engine(app: str, scale: int, ef: int, num_parts: int,
                  device):
    """One app's engine on a small R-MAT graph (the reference's
    observe._build_app_engine shapes: cc symmetrized, colfilter weighted
    1..5 from seed 1, sssp from vertex 0)."""
    import numpy as np

    from lux_tpu_torch.convert import rmat_graph
    from lux_tpu_torch.graph import Graph

    g = rmat_graph(scale=scale, edge_factor=ef, seed=0)
    kw = dict(num_parts=num_parts, device=device)
    if app == "pagerank":
        from lux_tpu_torch.apps import pagerank
        return pagerank.build_engine(g, **kw)
    if app == "cc":
        from lux_tpu_torch.apps import components
        s, d = components.symmetrize(*g.edge_arrays())
        return components.build_engine(Graph.from_edges(s, d, g.nv), **kw)
    if app == "sssp":
        from lux_tpu_torch.apps import sssp
        return sssp.build_engine(g, 0, **kw)
    if app == "colfilter":
        from lux_tpu_torch.apps import colfilter
        rng = np.random.default_rng(1)
        src, dst = g.edge_arrays()
        gw = Graph.from_edges(src, dst, g.nv, weights=rng.integers(
            1, 6, size=g.ne).astype(np.int32))
        return colfilter.build_engine(gw, **kw)
    raise ValueError(f"unknown app {app!r}")


def run_smoke(events_path: str, apps=SMOKE_APPS, scale: int = 8,
              ef: int = 8, np_parts: int = 2, device=None) -> None:
    """Run each app once on a small graph with telemetry and per-part
    counters, leaving an events JSONL that the exporter and
    scripts/events_summary.py read.  ``device=None`` is the card."""
    from lux_tpu_torch.timing import timed_converge, timed_fused_run

    ev = telemetry.EventLog(events_path)
    st = telemetry.IterStats()
    with telemetry.use(events=ev, iter_stats=st) as tel:
        for app in apps:
            eng = _smoke_engine(app, scale, ef, np_parts, device)
            tel.emit("run_start", schema=telemetry.SCHEMA, app=app)
            tel.emit("header", schema=telemetry.SCHEMA,
                     **eng.sg.telemetry_header())
            if hasattr(eng, "converge"):           # push engines
                _labels, iters, elapsed = timed_converge(eng, repeats=1)
                seconds = elapsed[0]
            else:
                _state, seconds = timed_fused_run(eng, 5)
                iters = 5
            tel.emit("run_done", seconds=round(seconds, 6), iters=iters)
            _emit_iter_stats(tel, st)
    ev.close()


def _refuse_drill(what: str):
    from lux_tpu_torch.engine.pull import NotPortedError
    raise NotPortedError(f"{what} is not ported yet (ROADMAP A6b-2: it "
                         f"needs a device mesh or several processes; "
                         f"the port runs one device)")


def run_loss_drill(workdir: str, events_path: str, ni: int = 12,
                   segment: int = 3) -> None:
    """The reference's in-process DEVICE_LOSS elastic drill
    (lux_tpu/tracing.py:939): refused until the mesh lands."""
    _refuse_drill("the elastic device-loss drill (run_loss_drill)")


def run_kill_drill(workdir: str) -> str | None:
    """The reference's two-process worker-kill drill
    (lux_tpu/tracing.py:1106): refused until the mesh lands."""
    _refuse_drill("the worker-kill drill (run_kill_drill)")


def _summarize(trace, out_path, errs, to=sys.stdout) -> None:
    te = trace["traceEvents"]
    n_span = sum(1 for e in te if e.get("ph") == "X")
    n_inst = sum(1 for e in te if e.get("ph") == "i")
    marks = sorted({e["name"] for e in te if e.get("ph") == "i"})
    print(f"trace: {out_path}  "
          f"({trace['otherData']['streams']} stream(s), {n_span} "
          f"spans, {n_inst} instant markers)", file=to)
    if marks:
        print(f"  markers: {', '.join(marks)}", file=to)
    shrinks = [e for e in te
               if e.get("ph") == "i" and e["name"] == "mesh_shrink"]
    if shrinks:
        print(f"  mesh-shrink marker present "
              f"(x{len(shrinks)}) — load in chrome://tracing / "
              f"ui.perfetto.dev", file=to)
    print(("trace VALID (spans nest, no orphans)" if not errs
           else f"trace INVALID: {len(errs)} error(s)"), file=to)


def main(argv=None) -> int:
    import argparse

    argv = list(sys.argv[1:] if argv is None else argv)
    ap = argparse.ArgumentParser(
        prog="python -m lux_tpu_torch.tracing",
        description="span timeline export (Chrome trace / Perfetto JSON) "
                    "from telemetry event logs; with no FILE, runs the "
                    "4-app smoke first")
    ap.add_argument("files", nargs="*", metavar="EVENTS_JSONL",
                    help="existing event files to export (merged onto "
                         "one timeline)")
    ap.add_argument("-o", default="trace.json", dest="out",
                    metavar="TRACE_JSON")
    ap.add_argument("-drill", action="store_true",
                    help="the reference's mesh drills: not ported "
                         "(ROADMAP A6b-2)")
    ap.add_argument("-workdir", default=None,
                    help="working directory for smoke artifacts "
                         "(default: a fresh temp dir)")
    ap.add_argument("-scale", type=int, default=8,
                    help="smoke RMAT scale (default 8)")
    ap.add_argument("-ef", type=int, default=8)
    ap.add_argument("-np", type=int, default=2, dest="np_parts")
    ap.add_argument("-apps", nargs="+", default=list(SMOKE_APPS),
                    choices=SMOKE_APPS, metavar="APP")
    ap.add_argument("-device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    from lux_tpu_torch.device import DeviceUnavailableError
    from lux_tpu_torch.engine.pull import NotPortedError
    try:
        if args.drill:
            run_kill_drill(args.workdir or ".")
        if args.files:
            # a rotated EventLog leaves .1/.2 generations beside the
            # live file: read the whole set, oldest first, as one stream
            paths = [g for p in args.files
                     for g in telemetry.rotated_paths(p)]
        else:
            workdir = args.workdir or tempfile.mkdtemp(prefix="lux_trace_")
            os.makedirs(workdir, exist_ok=True)
            path = os.path.join(workdir, "events.jsonl")
            run_smoke(path, apps=args.apps, scale=args.scale, ef=args.ef,
                      np_parts=args.np_parts, device=args.device)
            paths = [path]
    except (DeviceUnavailableError, NotPortedError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    events, errs = [], []
    for p in paths:
        evs, es = load_events(p)
        events += evs
        errs += es
    trace = trace_export(events, out=args.out)
    verrs = validate_trace(trace)
    _summarize(trace, args.out, verrs)
    for e in errs + verrs:
        print(f"ERROR: {e}", file=sys.stderr)
    return 1 if (errs or verrs) else 0


if __name__ == "__main__":
    sys.exit(main())
