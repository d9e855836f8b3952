"""Calibrated measurement: session calibration, phase-cost attribution
and a persistent perf ledger (counterpart of lux_tpu/observe.py:76-370,
:489-843, :845-1195, :1275-1418).

1. **Session calibration** (``calibrate``): three probes at the
   reference's pinned shapes -- a small-table gather, a pair-dot
   product and a paged delivery row (page fetch, kernel B2, kernel B1)
   -- timed by ``timing.loop_bench`` once a process, give a
   ``Fingerprint``: the measured figures beside the card's own
   (scalemodel's ``probe_*`` constants), the device, a session id and a
   grade.  A session is ``canonical`` on a CUDA device named as the
   constants' card with its gather probe within ``DEVIATION_BOUND`` of
   the constant, ``degraded`` outside that bound on the same card, and
   ``uncalibrated`` on the CPU or any other card.
2. **Phase-cost attribution** (``decompose``): an engine's
   ``timed_phases`` split, median and MAD a phase, against
   ``scalemodel.phase_model`` rescaled to this session
   (``session_scale``); a verdict a phase (``ok``, ``drift_slow``,
   ``drift_fast``, or ``unmodeled`` where no figure prices it).
3. **Perf ledger** (``PerfLedger``): append-only JSONL of calibrated
   records (probe, phase, bench, debt), each stamped with the session's
   digest.  The default file is the port's own, ``LEDGER_DEFAULT``;
   the ledger refuses ``PERF_LEDGER.jsonl`` and the reference's
   ``PERFLEDGER.jsonl``, which other programs own.  ``DEBTS`` lists the card's
   figures this port leaves modeled rather than measured.

Waits for ROADMAP A6b-2: the link calibration (``calibrate_links``) and
the communication attribution.  The digest's ``audit`` field is the
auditor's verdict on one step of each probe (``_audit_probe_programs``,
lux_tpu_torch/audit.py): a probe that recomputed state-independent work
or synced with the host would measure nothing.

CLI: ``python -m lux_tpu_torch.observe [-device cpu]`` prints the
calibrated phase report of the four apps.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time

import numpy as np
import torch

from lux_tpu_torch import scalemodel, telemetry
from lux_tpu_torch.device import resolve_device
from lux_tpu_torch.timing import loop_bench, median_mad

SCHEMA = 1
# the port's own ledger file (listed in .gitignore)
LEDGER_DEFAULT = "lux_tpu_torch_perf.jsonl"
# ledgers other programs own: never appended here
FOREIGN_LEDGERS = frozenset({"PERF_LEDGER.jsonl", "PERFLEDGER.jsonl"})
LEDGER_KINDS = ("probe", "phase", "bench", "debt")

# the probes' shapes are pinned (the reference's): a figure compares
# across sessions only if every session measures the same program
PROBE_GATHER_LOGV = 18        # 1 MB float32 table
PROBE_GATHER_N = 1 << 20      # 1M indices a step
PROBE_DOT_ROWS = 256          # pair-dot rows a step
PROBE_DOT_K = 20              # colfilter's K
PROBE_PAGE_ROWS = 2048        # paged delivery rows a step
PROBE_PAGE_TABLE = 256        # pages in the probe's page buffer
PROBE_LOOP_K = 8              # steps a timed sample
DEVIATION_BOUND = 3.0         # outside [1/3, 3] x the card's = degraded


def canonical_figures(constants=None) -> dict:
    """The probe figures of record: the card's measured ones."""
    c = constants or scalemodel.DEFAULT
    return {"gather_small_ns": c.probe_gather_ns,
            "pair_dot_row_ns": c.probe_pair_dot_row_ns,
            "page_gather_row_ns": c.probe_page_row_ns}


CANONICAL = canonical_figures()


# ---------------------------------------------------------------------
# robust statistics (median_mad: timing.py's, the same function)

def drift_verdict(samples, predicted_s, bound: float = DEVIATION_BOUND):
    """Measured seconds against a prediction, with a variance-aware
    bound: ``bound`` widens by the samples' relative MAD (1.4826 MAD
    estimates sigma for normal noise).  -> "ok" | "drift_slow" |
    "drift_fast" | "unmodeled"."""
    if predicted_s is None or predicted_s <= 0:
        return "unmodeled"
    m, mad = median_mad(samples)
    if m <= 0:
        return "unmodeled"
    eff = bound * (1.0 + 3.0 * 1.4826 * mad / m)
    ratio = m / predicted_s
    if ratio > eff:
        return "drift_slow"
    if ratio < 1.0 / eff:
        return "drift_fast"
    return "ok"


# ---------------------------------------------------------------------
# pillar 1: session calibration

@dataclasses.dataclass(frozen=True)
class Fingerprint:
    """One process's calibration: measured probe figures beside the
    card's."""

    schema: int
    session: str              # telemetry.session_id()
    pid: int
    backend: str              # the torch device type: "cuda" | "cpu"
    platform: str             # "gpu" | "cpu"
    device_name: str          # torch.cuda.get_device_name, or "cpu"
    ndev: int
    probe: dict               # measured {name_ns, name_mad_ns}
    canonical: dict           # the figures of record (canonical_figures)
    deviation: float          # gather probe / the card's gather figure
    grade: str
    audit: dict               # audit.digest of the probe programs

    def digest(self) -> dict:
        """The compact field ledger records carry."""
        return {
            "schema": self.schema, "session": self.session,
            "platform": self.platform, "backend": self.backend,
            "device": self.device_name, "ndev": self.ndev,
            "grade": self.grade, "deviation": round(self.deviation, 4),
            "probe": {k: round(v, 4) for k, v in self.probe.items()},
            "audit": dict(self.audit),
        }


def _gather_probe(dev):
    rng = np.random.default_rng(0)            # pinned seed: one program
    v = 1 << PROBE_GATHER_LOGV
    carry = [torch.tensor(rng.random(v, np.float32), device=dev)]
    idx = torch.tensor(rng.integers(0, v, PROBE_GATHER_N).astype(np.int32),
                       device=dev)

    def step():
        sv = torch.index_select(carry[0], 0, idx).sum()
        carry[0] = carry[0] + sv * 1e-30
        return sv
    step.carry = carry
    return step


def _dot_probe(dev, kdim: int = PROBE_DOT_K):
    from lux_tpu_torch.ops.tiled import full_fp32
    rng = np.random.default_rng(1)
    shape = (PROBE_DOT_ROWS, 128, kdim)
    carry = [torch.tensor(rng.random(shape, np.float32), device=dev)]
    t = torch.tensor(rng.random(shape, np.float32), device=dev)

    def step():
        # the pair-dot delivery's product: D = S @ T^T a row
        with full_fp32():
            sv = torch.bmm(carry[0], t.transpose(1, 2)).sum()
        carry[0] = carry[0] + sv * 1e-30
        return sv
    step.carry = carry
    return step


def _page_probe(dev):
    """One paged delivery row a row: page-row fetch, the lane shuffle
    (kernel B2), the per-row reduce (kernel B1), as the engines run
    it (ops/pagegather.paged_partial)."""
    from lux_tpu_torch.ops.chunk_reduce import chunk_partials
    from lux_tpu_torch.ops.lane_shuffle import lane_shuffle
    rng = np.random.default_rng(2)           # pinned seed: one program
    carry = [torch.tensor(rng.random((PROBE_PAGE_TABLE, 128), np.float32),
                          device=dev)]
    slot = rng.integers(0, PROBE_PAGE_TABLE, PROBE_PAGE_ROWS)
    lane = rng.integers(0, 128, (PROBE_PAGE_ROWS, 128))
    sl = ((slot[:, None].astype(np.uint32) << np.uint32(7))
          | lane.astype(np.uint32)).view(np.int32)
    rel = rng.integers(0, 128, (PROBE_PAGE_ROWS, 128)).astype(np.int8)
    slot_t = torch.tensor(slot, device=dev)
    sl_t = torch.tensor(sl, device=dev)
    rel_t = torch.tensor(rel, device=dev)

    def step():
        rows = torch.index_select(carry[0], 0, slot_t)
        vals = lane_shuffle(rows, sl_t)
        sv = chunk_partials(vals, rel_t, 128, "sum").sum()
        carry[0] = carry[0] + sv * 1e-30
        return sv
    step.carry = carry
    return step


def _audit_probe_programs(dev):
    """The auditor over one step of each probe (the reference's
    lux_tpu/observe.py:268): the calibration must satisfy the invariants
    it referees.  Each step runs once under the recorder, its carry the
    state -> (audit.digest, findings)."""
    from lux_tpu_torch import audit
    findings = []
    for name, make in (("gather", _gather_probe), ("pair_dot", _dot_probe),
                       ("page_gather", _page_probe)):
        step = make(dev)
        trace = audit.record(step, (), state=step.carry)
        findings += audit.audit_trace(trace, where=f"observe.probe_{name}")
    return audit.digest(findings, mode="error"), findings


def _device_name(dev) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def _grade(device_name: str, deviation: float,
           bound: float = DEVIATION_BOUND, constants=None) -> str:
    """canonical / degraded on the constants' own card (within / outside
    ``bound``), uncalibrated on the CPU or any other card."""
    c = constants or scalemodel.DEFAULT
    if device_name != c.card:
        return "uncalibrated"
    if deviation > bound or deviation < 1.0 / bound:
        return "degraded"
    return "canonical"


_FP: Fingerprint | None = None


def calibrate(force: bool = False, clock=None, repeats: int = 3,
              device=None, constants=None) -> Fingerprint:
    """Run the probes once a process (cached; ``force`` re-runs) on
    ``device`` (None: the card) and return the session's Fingerprint.
    ``clock`` (a host clock, injectable for deterministic tests) times
    the samples instead of CUDA events.  Emits a ``calibration``
    event."""
    global _FP
    if _FP is not None and not force:
        return _FP
    dev = resolve_device(device)
    c = constants or scalemodel.DEFAULT
    kw = dict(repeats=repeats, device=dev, clock=clock)
    g_m, g_mad = median_mad(loop_bench(_gather_probe(dev), PROBE_LOOP_K,
                                       **kw))
    d_m, d_mad = median_mad(loop_bench(_dot_probe(dev), PROBE_LOOP_K, **kw))
    p_m, p_mad = median_mad(loop_bench(_page_probe(dev), PROBE_LOOP_K,
                                       **kw))
    probe = {
        "gather_small_ns": g_m / PROBE_GATHER_N * 1e9,
        "gather_small_mad_ns": g_mad / PROBE_GATHER_N * 1e9,
        "pair_dot_row_ns": d_m / PROBE_DOT_ROWS * 1e9,
        "pair_dot_row_mad_ns": d_mad / PROBE_DOT_ROWS * 1e9,
        "page_gather_row_ns": p_m / PROBE_PAGE_ROWS * 1e9,
        "page_gather_row_mad_ns": p_mad / PROBE_PAGE_ROWS * 1e9,
    }
    canon = canonical_figures(c)
    audit_digest, _findings = _audit_probe_programs(dev)
    deviation = probe["gather_small_ns"] / canon["gather_small_ns"]
    name = _device_name(dev)
    fp = Fingerprint(
        schema=SCHEMA, session=telemetry.session_id(), pid=os.getpid(),
        backend=dev.type, platform="gpu" if dev.type == "cuda" else "cpu",
        device_name=name,
        ndev=torch.cuda.device_count() if dev.type == "cuda" else 1,
        probe=probe, canonical=canon, deviation=deviation,
        grade=_grade(name, deviation, constants=c), audit=audit_digest)
    telemetry.current().emit("calibration", **fp.digest())
    _FP = fp
    return fp


def fingerprint_digest(fp: Fingerprint | None = None) -> dict:
    """The ``calibration`` field of a record: ``fp``'s digest, or this
    process's calibration's."""
    return (fp or calibrate()).digest()


def session_scale(fp: Fingerprint) -> float:
    """Rescales the card's constants into THIS session's ns: the
    measured gather probe over the card's figure (~1 on a healthy card;
    whatever the host costs on the CPU)."""
    return fp.probe["gather_small_ns"] / fp.canonical["gather_small_ns"]


# ---------------------------------------------------------------------
# pillar 2: phase-cost attribution

# timed_phases report keys that are counters, not phase seconds
META_KEYS = ("frontier", "bucket", "advances")


@dataclasses.dataclass(frozen=True)
class PhaseCost:
    phase: str
    samples: tuple            # seconds, one per measured iteration
    median_s: float
    mad_s: float
    predicted_s: float | None  # session-scaled model; None = unmodeled
    ratio: float | None        # median / predicted
    verdict: str               # ok | drift_slow | drift_fast | unmodeled


@dataclasses.dataclass(frozen=True)
class AppDecomposition:
    app: str
    engine: str               # "pull" | "push"
    exchange: str
    ne: int
    nv: int
    iters: int
    session: str
    scale: float              # session_scale applied to the model
    phases: tuple             # PhaseCost, report order
    comm: dict | None = None  # the communication attribution (ROADMAP A6b-2)

    def as_dict(self) -> dict:
        return {
            "app": self.app, "engine": self.engine,
            "exchange": self.exchange, "ne": self.ne, "nv": self.nv,
            "iters": self.iters, "session": self.session,
            "scale": round(self.scale, 4), "comm": self.comm,
            "phases": [{
                "phase": p.phase,
                "median_s": round(p.median_s, 6),
                "mad_s": round(p.mad_s, 6),
                "predicted_s": (None if p.predicted_s is None
                                else round(p.predicted_s, 6)),
                "ratio": None if p.ratio is None else round(p.ratio, 3),
                "verdict": p.verdict,
            } for p in self.phases],
        }


def _engine_kind(eng) -> str:
    return "push" if hasattr(eng, "converge") else "pull"


def _engine_ne(eng) -> int:
    """Every edge the engine delivers: with pair rows ``eng.sg`` is the
    residual layout, and the pair plan counts the whole graph."""
    if eng.pairs is not None and "ne" in getattr(eng.pairs, "stats", {}):
        return int(eng.pairs.stats["ne"])
    return int(eng.sg.ne)


def _engine_model(eng, scale: float, page_scale: float | None = None,
                  constants=None) -> dict:
    """scalemodel.phase_model priced from the engine's own layout stats
    (pair coverage and inflation, K, the paged plan's page ratio and
    fills, the resolved ``use_mxu``)."""
    from lux_tpu_torch.engine.pull import mxu_wide_of
    cov, row_infl = 0.0, 1.0
    if eng.pairs is not None:
        cov = float(eng.pairs.stats["coverage"])
        row_infl = max(1.0, float(eng.pairs.stats["inflation"]))
    state_bytes = getattr(eng.program, "state_bytes", None) or 4
    kdim = max(1, int(state_bytes) // 4)
    dot = getattr(eng.program, "edge_value_from_dot", None) is not None
    pp = getattr(eng, "page_plan", None)
    paged = pp is not None
    return scalemodel.phase_model(
        engine=_engine_kind(eng), exchange=eng.exchange,
        ne=_engine_ne(eng), nv=int(eng.sg.nv), kdim=kdim,
        pair_coverage=cov, pair_row_inflation=row_infl,
        state_bytes_per_vertex=int(state_bytes), dot=dot, scale=scale,
        use_mxu=bool(getattr(eng, "use_mxu", False)),
        mxu_wide=mxu_wide_of(eng.program),
        reduce_kind=getattr(eng.program, "reduce", "sum"),
        scalar_f32=bool(getattr(eng, "scalar_f32_sum", False)),
        paged=paged,
        page_ratio=float(pp.stats["page_ratio"]) if paged else 0.0,
        page_fill=float(pp.stats.get("padded_fill", pp.stats["fill"]))
        if paged else 128.0,
        page_scale=page_scale,
        page_mode=pp.mode if paged else "paged",
        page_g_fill=float(pp.stats.get("padded_g_fill", 128.0))
        if paged else 128.0,
        constants=constants)


def decompose(eng, app: str, iters: int = 3,
              fingerprint: Fingerprint | None = None,
              bound: float = DEVIATION_BOUND,
              constants=None) -> AppDecomposition:
    """One engine's per-iteration phase split (median of ``iters`` and
    MAD a phase), each phase against the session-scaled model.  A pure
    observer: the phases run from the engine's own ``init_state`` on
    their own tensors, so a run after it is bit-identical to one
    without.  Emits a ``phases`` event, a ``phase_cost`` event a phase
    and a ``drift`` event a verdict that is not ok."""
    fp = fingerprint or calibrate(device=eng.device)
    scale = session_scale(fp)
    page_scale = None
    if "page_gather_row_ns" in fp.probe:
        page_scale = (fp.probe["page_gather_row_ns"]
                      / fp.canonical["page_gather_row_ns"])
    model = _engine_model(eng, scale, page_scale, constants)
    kind = _engine_kind(eng)
    tel = telemetry.current()

    def run_phases(n):
        if kind == "push":
            label, active = eng.init_state()
            return eng.timed_phases(label, active, n)[2]
        return eng.timed_phases(eng.init_state(), n)[1]

    # warm over the same trajectory that is measured: push iterations
    # switch between the dense and sparse phases as the frontier moves
    run_phases(iters)
    report = run_phases(iters)
    tel.emit("phases", app=app, iters=len(report),
             report=[{k: (v if k in META_KEYS else round(float(v), 6))
                      for k, v in entry.items()} for entry in report])
    by_phase: dict[str, list] = {}
    for entry in report:
        for k, v in entry.items():
            if k not in META_KEYS:
                by_phase.setdefault(k, []).append(float(v))
    phases = []
    for name, samples in by_phase.items():
        m, mad = median_mad(samples)
        pred_ns = model.get(name)
        pred = None if pred_ns is None else pred_ns * 1e-9
        verdict = drift_verdict(samples, pred, bound=bound)
        ratio = None if not pred else m / pred
        phases.append(PhaseCost(phase=name, samples=tuple(samples),
                                median_s=m, mad_s=mad, predicted_s=pred,
                                ratio=ratio, verdict=verdict))
        tel.emit("phase_cost", app=app, phase=name, median_s=round(m, 6),
                 mad_s=round(mad, 6),
                 predicted_s=None if pred is None else round(pred, 6),
                 verdict=verdict)
        if verdict.startswith("drift"):
            tel.emit("drift", app=app, phase=name, verdict=verdict,
                     measured_s=round(m, 6), predicted_s=round(pred, 6),
                     ratio=round(m / pred, 3), session=fp.session)
    return AppDecomposition(
        app=app, engine=kind, exchange=eng.exchange, ne=_engine_ne(eng),
        nv=int(eng.sg.nv), iters=iters, session=fp.session, scale=scale,
        phases=tuple(phases))


def render_report(decomps, fp: Fingerprint) -> str:
    """Fingerprint header and a measured-against-model table an app."""
    lines = [
        f"session {fp.session}  platform={fp.platform} "
        f"backend={fp.backend} device={fp.device_name} ndev={fp.ndev}  "
        f"grade={fp.grade}",
        f"probe: gather {fp.probe['gather_small_ns']:.4f} ns/elem "
        f"(card {fp.canonical['gather_small_ns']:.4f}, deviation "
        f"{fp.deviation:.2f}x)  pair-dot "
        f"{fp.probe['pair_dot_row_ns']:.2f} ns/row (card "
        f"{fp.canonical['pair_dot_row_ns']:.2f})  paged row "
        f"{fp.probe['page_gather_row_ns']:.2f} ns/row (card "
        f"{fp.canonical['page_gather_row_ns']:.2f})",
    ]
    for d in decomps:
        lines.append("")
        lines.append(f"== {d.app} ({d.engine}, exchange={d.exchange}, "
                     f"ne={d.ne}, nv={d.nv}, {d.iters} iters, model "
                     f"x{d.scale:.2f}) ==")
        lines.append(f"{'phase':14s} {'median':>10s} {'mad':>9s} "
                     f"{'model':>10s} {'ratio':>7s}  verdict")
        for p in d.phases:
            pred = ("-" if p.predicted_s is None
                    else f"{p.predicted_s * 1e3:8.3f}ms")
            ratio = "-" if p.ratio is None else f"{p.ratio:6.2f}x"
            lines.append(f"{p.phase:14s} {p.median_s * 1e3:8.3f}ms "
                         f"{p.mad_s * 1e3:7.3f}ms {pred:>10s} {ratio:>7s}  "
                         f"{p.verdict}")
    return "\n".join(lines)


# ---------------------------------------------------------------------
# pillar 3: the perf ledger and the debts

class PerfLedger:
    """Append-only JSONL of calibrated records: {"schema", "t", "kind",
    "session", "calibration", ...payload}.  Records are never rewritten;
    a degraded session's stay, labeled by their digest."""

    def __init__(self, path: str = LEDGER_DEFAULT):
        if os.path.basename(path) in FOREIGN_LEDGERS:
            raise ValueError(f"{path}: the port's perf ledger never "
                             f"appends to {sorted(FOREIGN_LEDGERS)} (other "
                             f"programs own them); the default is "
                             f"{LEDGER_DEFAULT}")
        self.path = path

    def append(self, kind: str, payload: dict,
               fingerprint: Fingerprint | None = None) -> dict:
        if kind not in LEDGER_KINDS:
            raise ValueError(f"unknown ledger kind {kind!r} "
                             f"(one of {LEDGER_KINDS})")
        fp = fingerprint or calibrate()
        rec = {"schema": SCHEMA, "t": round(time.time(), 6), "kind": kind,
               "session": fp.session, "calibration": fp.digest(),
               **payload}
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        return rec


def iter_ledger(path: str):
    """(lineno, record | None, error | None) a ledger line."""
    with open(path) as f:
        for i, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError as e:
                yield i, None, f"unparseable JSON ({e})"
                continue
            if not isinstance(rec, dict):
                yield i, None, "record is not a JSON object"
                continue
            yield i, rec, None


def validate_ledger(path: str) -> list[str]:
    """Schema audit of a ledger -> error strings (empty: clean).  Every
    record carries schema, kind, session and a calibration digest with
    a known grade and a finite positive deviation."""
    errs = []
    n = 0
    for i, rec, err in iter_ledger(path):
        if err:
            errs.append(f"line {i}: {err}")
            continue
        n += 1
        if rec.get("schema") != SCHEMA:
            errs.append(f"line {i}: schema={rec.get('schema')!r} "
                        f"(expected {SCHEMA})")
        kind = rec.get("kind")
        if kind not in LEDGER_KINDS:
            errs.append(f"line {i}: unknown kind {kind!r}")
        if not isinstance(rec.get("session"), str) or not rec.get("session"):
            errs.append(f"line {i}: missing session id")
        cal = rec.get("calibration")
        if not isinstance(cal, dict):
            errs.append(f"line {i}: missing calibration digest")
        else:
            if cal.get("grade") not in ("canonical", "degraded",
                                        "uncalibrated"):
                errs.append(f"line {i}: calibration.grade="
                            f"{cal.get('grade')!r} unknown")
            dev = cal.get("deviation")
            if not isinstance(dev, (int, float)) or isinstance(dev, bool) \
                    or not dev == dev or dev <= 0:
                errs.append(f"line {i}: calibration.deviation={dev!r} "
                            f"must be a finite positive number")
        if kind == "phase" and not isinstance(rec.get("phases"), list):
            errs.append(f"line {i}: phase record without a phases list")
        if kind == "bench" and not isinstance(rec.get("metric"), str):
            errs.append(f"line {i}: bench record without a metric name")
        if kind == "debt" and not isinstance(rec.get("debt"), str):
            errs.append(f"line {i}: debt record without a debt id")
    if n == 0 and not errs:
        errs.append("empty ledger")
    return errs


@dataclasses.dataclass(frozen=True)
class Debt:
    """One of the card's figures left modeled rather than measured.
    ``platform``: "card" (a session on the constants' card) or "any";
    ``auto`` names a probe ``collect_debts`` can run, else the debt is
    manual and ``pointer`` says where it is documented."""
    id: str
    title: str
    pointer: str
    platform: str = "card"
    min_ndev: int = 1
    auto: str | None = None


DEBTS = (
    Debt("dot-row-k-sweep",
         "sweep the dot path's per-K row terms over K: pair_dot_row_k_ns "
         "and residual_dot_k_ns are measured at K = 20 alone and priced "
         "linear in K",
         "PERF.md §6, the H100 constants table",
         auto="_debt_pair_dot_sweep"),
    Debt("mxu-tile-split",
         "split of the one-hot form's cost into the fixed onehot_tile_ns "
         "and the per-slice mxu_tile_ns: a two-point fit of the float32 "
         "torch.bmm at one and eight columns, not a sweep over widths; "
         "the min/max tournament's rounds are priced by it, not timed",
         "PERF.md §6, the H100 constants table"),
    Debt("combine-scan-fit",
         "the use_mxu combine figures: segscan_lane_ns and "
         "segscan_slice_ns a two-point fit (main at K = 1, colfilter's "
         "pair residual at K = 20), combine_pass_ns one average over both "
         "cells' doubling passes, s9_row_ns at the main shape alone",
         "PERF.md §6, the H100 constants table"),
    Debt("paged-dot-row-k",
         "the paged dot row's per-K term, measured at K = 20 on the "
         "colfilter cell's degree-relabelled R-MAT 16 alone",
         "PERF.md §6, the H100 constants table"),
)


def _on_card(fp: Fingerprint, constants=None) -> bool:
    c = constants or scalemodel.DEFAULT
    return fp.device_name == c.card


def match_debts(fp: Fingerprint, constants=None):
    """The debts this session could collect."""
    return [d for d in DEBTS
            if (d.platform == "any" or _on_card(fp, constants))
            and fp.ndev >= d.min_ndev]


def _debt_pair_dot_sweep(fp: Fingerprint, clock=None, device=None):
    """The pair-dot probe across K, ns a row each."""
    dev = resolve_device(device if device is not None else (
        "cuda" if fp.backend == "cuda" else "cpu"))
    sweep = {}
    for k in (1, 4, 8, 16, 20, 32):
        m, mad = median_mad(loop_bench(_dot_probe(dev, k), PROBE_LOOP_K,
                                       repeats=3, device=dev, clock=clock))
        sweep[str(k)] = {"row_ns": round(m / PROBE_DOT_ROWS * 1e9, 4),
                         "mad_ns": round(mad / PROBE_DOT_ROWS * 1e9, 4)}
    return {"debt": "dot-row-k-sweep", "rows": PROBE_DOT_ROWS,
            "sweep": sweep}


def collect_debts(fp: Fingerprint, ledger: PerfLedger | None, only=None,
                  clock=None, device=None):
    """Run every matched debt that has a probe, appending a "debt"
    record each; manual debts are skipped with their pointer.  ->
    (collected records, [(debt id, reason)] skipped)."""
    collected, skipped = [], []
    for d in match_debts(fp):
        if only is not None and d.id not in only:
            continue
        if d.auto is None:
            skipped.append((d.id, f"manual: {d.pointer}"))
            continue
        payload = globals()[d.auto](fp, clock=clock, device=device)
        if isinstance(payload, str):
            skipped.append((d.id, payload))
            continue
        collected.append(ledger.append("debt", payload, fp)
                         if ledger is not None else payload)
        telemetry.current().emit("debt_collected", debt=d.id)
    return collected, skipped


# ---------------------------------------------------------------------
# CLI: python -m lux_tpu_torch.observe

APPS = ("pagerank", "cc", "sssp", "colfilter")


def calibrate_links(*args, **kwargs):
    """The reference's link calibration (lux_tpu/observe.py:416): the
    collectives' rates between cards, ROADMAP A6b-2."""
    from lux_tpu_torch.engine.pull import NotPortedError
    raise NotPortedError("calibrate_links (the collectives' rates between "
                         "cards) is not ported yet (ROADMAP A6b-2)")


def _build_app_engine(app: str, scale: int, ef: int, num_parts: int,
                      pair_threshold: int | None, gather: str = "flat",
                      device=None):
    from lux_tpu_torch.convert import rmat_graph
    from lux_tpu_torch.graph import Graph
    g = rmat_graph(scale=scale, edge_factor=ef, seed=0)
    # per-app preparation first (cc symmetrizes, colfilter weights),
    # then one relabel of the graph that runs
    if app == "cc":
        from lux_tpu_torch.apps import components
        s, dst = components.symmetrize(*g.edge_arrays())
        g = Graph.from_edges(s, dst, g.nv)
    elif app == "colfilter":
        rng = np.random.default_rng(1)
        g.weights = rng.integers(1, 6, size=g.ne).astype(np.int32)
    elif app not in ("pagerank", "sssp"):
        raise ValueError(f"unknown app {app!r}")
    starts = None
    if pair_threshold is not None:
        from lux_tpu_torch.graph import pair_relabel
        g, _perm, starts = pair_relabel(g, num_parts,
                                        pair_threshold=pair_threshold)
    kw = dict(pair_threshold=pair_threshold, starts=starts, gather=gather,
              device=device)
    if app == "pagerank":
        from lux_tpu_torch.apps import pagerank
        return pagerank.build_engine(g, num_parts, **kw)
    if app == "cc":
        from lux_tpu_torch.apps import components
        return components.build_engine(g, num_parts, **kw)
    if app == "sssp":
        from lux_tpu_torch.apps import sssp
        return sssp.build_engine(g, 0, num_parts=num_parts, **kw)
    from lux_tpu_torch.apps import colfilter
    return colfilter.build_engine(g, num_parts, **kw)


def main(argv=None) -> int:
    import argparse
    import sys

    ap = argparse.ArgumentParser(
        prog="python -m lux_tpu_torch.observe",
        description="calibrated phase-decomposition report: the session "
                    "probes, each app's measured phases against "
                    "scalemodel with drift verdicts, a ledger append")
    ap.add_argument("-scale", type=int, default=12,
                    help="R-MAT scale of the graphs (default 12)")
    ap.add_argument("-ef", type=int, default=8, help="edges/vertex")
    ap.add_argument("-np", type=int, default=1, help="partitions")
    ap.add_argument("-pair", type=int, default=None, metavar="T",
                    help="pair-lane threshold (with the pair relabel)")
    ap.add_argument("-gather", default="flat",
                    choices=["flat", "paged", "pagemajor", "auto"],
                    help="state delivery; 'auto' resolves through "
                         "scalemodel's break-even on the plan's stats")
    ap.add_argument("-iters", type=int, default=3,
                    help="measured iterations a phase (median + MAD)")
    ap.add_argument("-apps", nargs="+", default=list(APPS), choices=APPS,
                    metavar="APP", help=f"subset of {', '.join(APPS)}")
    ap.add_argument("-events", default=None, metavar="FILE",
                    help="append telemetry events as JSONL")
    ap.add_argument("-ledger", default=LEDGER_DEFAULT, metavar="FILE",
                    help=f"perf ledger path (default {LEDGER_DEFAULT})")
    ap.add_argument("-no-ledger", action="store_true", dest="no_ledger",
                    help="do not append the ledger")
    ap.add_argument("-debts", action="store_true",
                    help="list the debts this session matches and exit")
    ap.add_argument("-collect-debts", action="store_true",
                    dest="collect_debts",
                    help="run the matched debts' probes, append records")
    ap.add_argument("-device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    events = telemetry.EventLog(args.events) if args.events else None
    ledger = None if args.no_ledger else PerfLedger(args.ledger)
    with telemetry.use(events=events):
        fp = calibrate(device=args.device)
        if fp.grade == "degraded":
            print(f"# WARNING: degraded session: gather probe "
                  f"{fp.deviation:.2f}x off the card's figure; samples "
                  f"are labeled, not trusted", file=sys.stderr)
        # a pure -debts listing is read-only
        if ledger is not None and not (args.debts
                                       and not args.collect_debts):
            ledger.append("probe", {"probe": fp.probe}, fp)
        if args.debts or args.collect_debts:
            matched = match_debts(fp)
            if not matched:
                print(f"no debts match this session (device="
                      f"{fp.device_name}, ndev={fp.ndev})")
            for d in matched:
                auto = f"auto ({d.auto})" if d.auto else "manual"
                print(f"debt {d.id}: {d.title} [{auto}; {d.pointer}]")
            if args.collect_debts:
                collected, skipped = collect_debts(fp, ledger,
                                                   device=args.device)
                for rec in collected:
                    print(f"collected {rec['debt']}: "
                          f"{json.dumps(rec.get('sweep', rec))}")
                for did, reason in skipped:
                    print(f"skipped {did}: {reason}")
        else:
            decomps = []
            for app in args.apps:
                if args.gather == "pagemajor" and app == "colfilter":
                    print(f"# skipping {app}: gather='pagemajor' does not "
                          f"serve K-dim (SDDMM) programs")
                    continue
                eng = _build_app_engine(app, args.scale, args.ef, args.np,
                                        args.pair, gather=args.gather,
                                        device=args.device)
                d = decompose(eng, app, iters=args.iters, fingerprint=fp)
                decomps.append(d)
                if ledger is not None:
                    ledger.append("phase", d.as_dict(), fp)
            print(render_report(decomps, fp))
    if events is not None:
        events.close()
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
