"""The port's program auditor (lux_tpu_torch/audit.py); its verdicts on
the reference's engine matrix are tests/test_torch_audit_matrix.py's.

- Every check has a violating fixture (a second table gather, a float64
  op, an ``.item()`` in a step, host data made into a tensor, a
  ``scatter_reduce`` amin onto ``zeros``, a state-independent gather, a
  global gather on the owner exchange, a ledger off its engine) that
  raises its typed subclass under ``"error"`` and warns under
  ``"warn"``; the pragma is check-specific.
- The hooks: ``audit=`` on the engines and apps, a hand kernel's launch
  seen with its tensors, resilience's FATAL class, the digest."""

import warnings

import numpy as np
import pytest
import torch

from lux_tpu_torch import _kernels, audit, resilience
from lux_tpu_torch.apps import components, pagerank, sssp
from lux_tpu_torch.engine.pull import gather_rows
from lux_tpu_torch.graph import Graph

CPU = "cpu"


def test_repo_audit_cli_clean(capsys):
    """``python -m lux_tpu_torch.audit`` over the matrix: clean."""
    assert audit.main(["-no-ledger", "-device", "cpu"]) == 0
    assert "audit: clean" in capsys.readouterr().out


# ---------------------------------------------------------------------
# one violating fixture a check


def _graph(nv=256, ne=2048, seed=0):
    r = np.random.default_rng(seed)
    return Graph.from_edges(r.integers(0, nv, ne), r.integers(0, nv, ne), nv)


@pytest.fixture(scope="module")
def pull_eng():
    return pagerank.build_engine(_graph(), num_parts=2, device=CPU)


def _two_gathers(st):
    flat = st.reshape(-1)
    idx = torch.arange(flat.shape[0] - 1, -1, -1)
    a = gather_rows(flat, idx)
    b = gather_rows(flat, idx)
    return a + b


def _two_gathers_allowed(st):
    flat = st.reshape(-1)
    idx = torch.arange(flat.shape[0] - 1, -1, -1)
    a = gather_rows(flat, idx)
    # audit: allow(gather-budget) the fixture's justified second fetch
    b = gather_rows(flat, idx)
    return a + b


def _two_gathers_other_pragma(st):
    flat = st.reshape(-1)
    idx = torch.arange(flat.shape[0] - 1, -1, -1)
    a = gather_rows(flat, idx)
    # audit: allow(dtype-discipline) names another check
    b = gather_rows(flat, idx)
    return a + b


def _float64(st):
    return (st.double() * 2).float()


def _int64_promotion(st):
    lab = st.to(torch.int32)
    return lab + torch.arange(lab.shape[-1])


def _item(st):
    return st * float(st.max().item())


def _host_data(st):
    big = torch.tensor(np.zeros((1 << 18) + 1, np.float32))  # > 1 MiB
    return st + big[:1]


def _amin_onto_zeros(st):
    flat = st.reshape(-1)
    out = torch.zeros(16, dtype=flat.dtype)
    idx = torch.arange(flat.shape[0]) % 16
    return out.scatter_reduce(0, idx, flat, "amin")


def _invariant_gather(st):
    table = torch.arange(8192, dtype=torch.float32)
    idx = torch.arange(8192) % 4096
    return st + torch.index_select(table, 0, idx).sum()


FIXTURES = {
    "gather-budget": (_two_gathers, audit.GatherBudgetError),
    "dtype-discipline": (_float64, audit.DtypeDisciplineError),
    "callback-in-loop": (_item, audit.CallbackInLoopError),
    "const-bytes": (_host_data, audit.ConstBytesError),
    "identity-init": (_amin_onto_zeros, audit.IdentityInitError),
    "loop-invariant": (_invariant_gather, audit.LoopInvariantError),
}


def _audit_fixture(eng, fn, mode, **kw):
    eng._register_variant("fixture", fn, lambda: (eng.init_state(),))
    try:
        traces = audit.run_variants(eng, ["fixture"])
        return audit.audit_engine(eng, mode=mode, traces=traces, **kw)
    finally:
        eng._variants().pop("fixture")


@pytest.mark.parametrize("check", sorted(FIXTURES))
def test_violation_raises_typed_and_warns(pull_eng, check):
    fn, err = FIXTURES[check]
    if check == "loop-invariant":
        # warning severity: raised only as a warning
        got = _audit_fixture(pull_eng, fn, None)
        assert {f.check for f in got} == {check}
        assert all(f.severity == "warn" for f in got)
        with pytest.raises(err):
            audit.raise_findings(got, warnings_as_errors=True)
    else:
        with pytest.raises(err) as ei:
            _audit_fixture(pull_eng, fn, "error")
        assert ei.value.check == check
        assert {f.check for f in ei.value.findings} == {check}
    with pytest.warns(audit.AuditWarning, match=check):
        _audit_fixture(pull_eng, fn, "warn")


def test_int64_by_promotion_fails(pull_eng):
    """An int32 plus an int64 arange promotes silently: caught; the
    explicit casts and index ops torch requires pass (the matrix)."""
    with pytest.raises(audit.DtypeDisciplineError, match="add"):
        _audit_fixture(pull_eng, _int64_promotion, "error")


def test_pragma_is_check_specific(pull_eng):
    assert _audit_fixture(pull_eng, _two_gathers_allowed, "error") == []
    with pytest.raises(audit.GatherBudgetError):
        _audit_fixture(pull_eng, _two_gathers_other_pragma, "error")


def test_owner_global_gather_breaks_schedule():
    """On the owner exchange a gather over the global table (not one a
    source part from its shard) breaks the one-card schedule."""
    eng = pagerank.build_engine(_graph(), num_parts=4, exchange="owner",
                                device=CPU)

    def global_gather(st):
        flat = st.reshape(-1)
        return st + gather_rows(flat, torch.zeros(4, dtype=torch.int64)
                                ).sum()

    with pytest.raises(audit.CollectiveScheduleError, match="A6b"):
        _audit_fixture(eng, global_gather, "error",
                       allow={"gather-budget"})
    assert audit.audit_engine(eng, mode="error") == []


def test_ledger_drift_raises_typed(monkeypatch):
    """A ledger that lost a term drifts from the measured step."""
    from lux_tpu_torch import memwatch
    g = _graph(2048, 32768)
    eng = pagerank.build_engine(g, num_parts=2, device=CPU)
    assert audit.check_ledger(eng) == []
    orig = memwatch.eager_terms
    monkeypatch.setattr(memwatch, "eager_terms", lambda e: {
        k: v * 8 for k, v in orig(e).items()})
    with pytest.raises(audit.LedgerDriftError):
        audit.audit_engine(eng, mode="error", ledger=True, traces={})
    with pytest.warns(audit.AuditWarning, match="ledger-drift"):
        audit.audit_engine(eng, mode="warn", ledger=True, traces={})


def test_unknown_mode_is_typed_error(pull_eng):
    with pytest.raises(ValueError, match="unknown mode"):
        audit.audit_engine(pull_eng, mode="strict")
    with pytest.raises(ValueError, match="unknown mode"):
        pagerank.build_engine(_graph(), num_parts=2, device=CPU,
                              audit="strict")


def test_audit_errors_classify_fatal():
    assert resilience.classify(audit.AuditError("x")) == resilience.FATAL
    assert resilience.classify(
        audit.CallbackInLoopError("tunnel 413")) == resilience.FATAL


def test_digest_shape():
    f = [audit.Finding("gather-budget", "error", "w", "d"),
         audit.Finding("loop-invariant", "warn", "w", "d")]
    assert audit.digest(f, mode="error") == {
        "mode": "error", "errors": 1, "warnings": 1,
        "failed_checks": ["gather-budget"]}


# ---------------------------------------------------------------------
# the hooks


@pytest.mark.parametrize("app", ["pagerank", "sssp", "components"])
def test_build_time_audit_leaves_results_alone(app):
    """audit="error" builds, audits clean (no warning either) and runs as
    the unaudited engine does, bit for bit."""
    g = _graph(seed=3)
    build = {"pagerank": lambda **kw: pagerank.build_engine(
                 g, num_parts=2, device=CPU, **kw),
             "sssp": lambda **kw: sssp.build_engine(
                 g, 0, num_parts=2, device=CPU, **kw),
             "components": lambda **kw: components.build_engine(
                 g, num_parts=2, device=CPU, **kw)}[app]
    with warnings.catch_warnings():
        warnings.simplefilter("error", audit.AuditWarning)
        eng = build(audit="error")
        build(audit="warn")
    plain = build()
    if app == "pagerank":
        assert torch.equal(eng.run(eng.init_state(), 3),
                           plain.run(plain.init_state(), 3))
    else:
        got = eng.converge(*eng.init_state())
        want = plain.converge(*plain.init_state())
        assert torch.equal(got[0], want[0]) and got[2] == want[2]


def test_push_variants_cover_both_paths():
    """An engine that also iterates sparse registers each path forced;
    the converge from the init takes the sparse path."""
    eng = sssp.build_engine(_graph(), 0, num_parts=2, device=CPU)
    traces = audit.run_variants(eng)
    assert set(traces) == {"step", "step_dense", "step_sparse", "converge",
                           "converge_stats", "converge_health"}
    assert traces["step_dense"].schedule == ["dense"]
    assert traces["step_sparse"].schedule == ["sparse"]
    assert traces["converge"].schedule == ["sparse"]
    # the converge's one read an iteration, the step's none
    assert len(traces["converge"].host_reads) == 1
    assert traces["step"].host_reads == []


def test_kernel_launch_is_recorded_with_its_tensors():
    """A wrapper's launch count shows the launch to a recording, the
    state's taint flowing through it."""

    def fake_kernel(x):
        out = torch.empty_like(x)
        out.copy_(x)
        _kernels.counted(fake_kernel, "fake", (x,), (out,))
        return out

    fake_kernel.launches = 0
    st = torch.ones(8)
    tr = audit.record(lambda s: fake_kernel(s) * 2, (st,))
    ops = [o for o in tr.ops if o.name == "kernel:fake"]
    assert len(ops) == 1 and ops[0].ins[0].tainted
    assert ops[0].outs[0].tainted and fake_kernel.launches == 1
    assert tr.kernel_launches == 1
    assert _kernels.observer() is None


def test_launches_on_other_threads_stay_out_of_the_trace():
    """The launch observer is the recording thread's, as the recorder's
    torch modes are: a counted kernel another thread launches while a
    recording runs is counted, and is not in the trace."""
    import threading

    def fake_kernel(x, name):
        out = x.clone()
        _kernels.counted(fake_kernel, name, (x,), (out,))
        return out

    fake_kernel.launches = 0
    recording, launched = threading.Event(), threading.Event()

    def other():
        recording.wait(10)
        fake_kernel(torch.ones(4), "other")
        launched.set()

    def step(s):
        recording.set()
        assert launched.wait(10)
        return fake_kernel(s, "mine") + 1

    t = threading.Thread(target=other)
    t.start()
    tr = audit.record(step, (torch.ones(8),))
    t.join()
    names = [o.name for o in tr.ops if o.name.startswith("kernel:")]
    assert names == ["kernel:mine"] and fake_kernel.launches == 2
    assert _kernels.observer() is None


def test_sync_debug_needs_a_single_thread():
    """torch's sync debug mode is process-wide: asking for it while
    another thread runs is refused, not taken."""
    import threading
    done = threading.Event()
    t = threading.Thread(target=done.wait, args=(10,))
    t.start()
    try:
        with pytest.raises(RuntimeError, match="process-wide"):
            audit.record(lambda s: s + 1, (torch.ones(4),),
                         sync_debug=True)
    finally:
        done.set()
        t.join()
    assert audit.record(lambda s: s + 1, (torch.ones(4),),
                        sync_debug=True).host_reads == []


@pytest.mark.parametrize("fn,reads", [
    (lambda s: s.sum().item(), 1),          # one read, not two
    (lambda s: float(s[0]), 1),
    (lambda s: torch.equal(s, s * 1), 1),
    (lambda s: torch.bincount(s.long()), 1),
    (lambda s: torch.repeat_interleave(s, s.long()), 1),
    (lambda s: torch.repeat_interleave(s, s.long(), output_size=4), 0),
    (lambda s: s.index_put_((s > 0,), torch.zeros(())), 1),
    (lambda s: torch.cumsum(s, 0), 0)])
def test_host_reads_inside_ops_count(fn, reads):
    """The recorder sees a read inside torch's own ops (a scalar, a bool
    comparison, a size from the data) once, on its own thread: the
    reads the card's sync debug mode would catch."""
    tr = audit.record(fn, (torch.ones(4, dtype=torch.int32),))
    assert len(tr.host_reads) == reads, [o.name for o in tr.host_reads]


def test_ledger_below_the_check_floor_warns(monkeypatch, pull_eng):
    """memwatch.drift_verdict judges the ledger; on a padding-dominated
    shape (priced arguments under MEM_CHECK_FLOOR_BYTES) a failing ratio
    is a warning, as in memwatch.bench_digest."""
    from lux_tpu_torch import memwatch
    rep = audit.ledger_report(pull_eng)
    assert rep["argument_bytes"] < memwatch.MEM_CHECK_FLOOR_BYTES
    orig = memwatch.eager_terms
    monkeypatch.setattr(memwatch, "eager_terms", lambda e: {
        k: v * 64 for k, v in orig(e).items()})
    got = audit.check_ledger(pull_eng)
    assert [(f.check, f.severity) for f in got] == [("ledger-drift", "warn")]
    assert "check floor" in got[0].detail
    assert audit.audit_engine(pull_eng, mode="error", ledger=True,
                              traces={}) == got
    with pytest.warns(audit.AuditWarning, match="ledger-drift"):
        audit.audit_engine(pull_eng, mode="warn", ledger=True, traces={})
