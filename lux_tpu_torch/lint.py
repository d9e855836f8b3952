"""lint — AST-level convention linter for the port's Python tree (a copy
of scripts/lint_lux.py, which the port may not import; the findings'
text, the pragma and the exit codes are the script's).

The companion of lux_tpu_torch/audit.py: where the auditor checks the
ops one iteration RUNS, this checks SOURCE against the conventions that
no recorded op shows.  The checks, in the order they run:

  oracle        Every app module (lux_tpu_torch/apps/*.py) defines a
                top-level NumPy oracle named ``reference_*``
                (scripts/lint_lux.py:388); a module shipping a
                query-batched variant also ships a ``reference_*
                batched*`` oracle, an incremental revalidator a
                ``reference_*incremental`` one (defined or cited).
                Deletion-capable functions (``*decremental*``,
                ``delete_edges``, ``reweight_edges``) anywhere in the
                tree define or cite a ``reference_*decremental`` oracle
                (:462); those findings carry the check name ``oracle``
                too, as the script's do.
  budget-gauge  Tree-wide: a class whose ``__init__`` assigns
                ``self.max_bytes`` registers a metrics gauge somewhere
                in the class (:505).
  citation      Every module of lux_tpu_torch/engine/ and
                lux_tpu_torch/ops/ cites a reference ``file:line`` in
                its module docstring (:554, the pattern at :109).
  part-stats-oracle
                Every engine ``*_stats`` / ``*_health`` variant whose
                docstring cites per-part counters is covered by a test
                that names it beside a ``per_part*`` oracle (:593).
                Coverage is read from tests/test_torch_*.py only: the
                port's tests must hold the port.
  chaos-coverage
                Every fault action constant of lux_tpu_torch/faults.py
                (a module-level ALL-CAPS name bound to a string) is
                named, by constant or value, in tests/test_torch_*.py
                (:629).
  hot-path-metrics
                No metrics call anywhere in lux_tpu_torch/engine/ or
                lux_tpu_torch/ops/ (:712, its whole-file mode).  The
                script's other mode, fused-loop bodies (functions
                handed to ``fori_loop`` / ``while_loop`` / ``scan``),
                has nothing to read here: an eager port has no fused
                loops.
  collective-scope
                No collective call (the script's names, :743, plus
                torch.distributed's ``all_reduce``,
                ``all_gather_into_tensor``, ``reduce_scatter_tensor``,
                ``all_to_all_single``) outside lux_tpu_torch/ops/ and
                lux_tpu_torch/engine/ (:749).  None exists yet; it
                guards the mesh (ROADMAP A6b).
  event-name    Every string literal passed to ``emit`` / ``_emit`` /
                ``emit_sampled`` is in scripts/events_summary.py's
                ``KNOWN``, parsed statically as the script does (:816,
                :838); that script reads the port's event logs too.
  command-drift Every ``python -m lux_tpu_torch.<mod>`` (or ``python3
                -m``) in README.md, .claude/skills/verify/SKILL.md,
                PERF.md and ROADMAP.md resolves to a module with a
                ``__main__`` entry (:879).

Two of the script's checks do not apply.  ``jit-closure`` (:353) guards
arrays closed over by ``jax.jit`` programs, which bake into the XLA
program as constants; the port compiles no program (the auditor's
const-bytes check covers host data made into tensors in an iteration).
``bench-fence`` (:780) guards ``block_until_ready`` in scripts/, a JAX
fence; the port's timings use CUDA events (profiling.py, chip_smoke.py).

Suppression: ``# audit: allow(<check>)`` on the flagged line, or in the
contiguous comment block directly above it, with a one-line
justification — the syntax audit.py honors too.

Usage:  python -m lux_tpu_torch.lint [PATHS...]
        (default: lux_tpu_torch/; the doc commands are checked always)
Exit status: 0 clean, 1 any unsuppressed finding.
"""

from __future__ import annotations

import argparse
import ast
import os
import re
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "lux_tpu_torch"

PRAGMA_RE = re.compile(r"#\s*audit:\s*allow\(([a-z-]+)\)")

CITATION_RE = re.compile(r"[\w/]+\.(?:h|cc|cu|cuh|inl|py|md):\d+")

# the documents whose cited commands command-drift checks
DOCS = ("README.md", os.path.join(".claude", "skills", "verify",
                                  "SKILL.md"), "PERF.md", "ROADMAP.md")


class Finding:
    def __init__(self, path, line, check, message):
        self.path, self.line, self.check, self.message = \
            path, line, check, message

    def __str__(self):
        rel = os.path.relpath(self.path, REPO)
        return f"{rel}:{self.line}: [{self.check}] {self.message}"


def _suppressed(lines, line_no: int, check: str) -> bool:
    """Pragma on the flagged line or the contiguous comment block
    directly above it (blank lines and decorators do not break it)."""

    def hit(text):
        return any(m.group(1) == check for m in PRAGMA_RE.finditer(text))

    if 0 < line_no <= len(lines) and hit(lines[line_no - 1]):
        return True
    ln = line_no - 2
    while ln >= 0:
        stripped = lines[ln].strip()
        if stripped.startswith("#"):
            if hit(stripped):
                return True
            ln -= 1
        elif not stripped or stripped.startswith("@"):
            ln -= 1
        else:
            break
    return False


# ---------------------------------------------------------------------
# check: oracle presence


def check_oracle(path, tree, lines):
    if os.path.basename(path) == "__init__.py":
        return []
    has = any(isinstance(n, ast.FunctionDef)
              and n.name.startswith("reference_") for n in tree.body)
    findings = []
    if not has and not _suppressed(lines, 1, "oracle"):
        findings.append(Finding(
            path, 1, "oracle",
            "app module has no top-level reference_* NumPy oracle — "
            "every algorithm needs one (CLAUDE.md: new device code "
            "gets an oracle test first)"))
    batched_defs = [n for n in tree.body
                    if isinstance(n, ast.FunctionDef)
                    and "batched" in n.name
                    and not n.name.startswith("reference_")]
    has_batched_oracle = any(
        isinstance(n, ast.FunctionDef)
        and n.name.startswith("reference_") and "batched" in n.name
        for n in tree.body)
    for n in batched_defs:
        if has_batched_oracle or _suppressed(lines, n.lineno, "oracle"):
            continue
        findings.append(Finding(
            path, n.lineno, "oracle",
            f"{n.name} builds a query-batched variant but the module "
            f"has no reference_*batched* NumPy oracle — batched "
            f"device code needs its columns-vs-independent-runs "
            f"oracle first (CLAUDE.md convention; ROADMAP item 2)"))
        break
    # an incremental revalidator may be a method: walk the whole tree
    incr_defs = [n for n in ast.walk(tree)
                 if isinstance(n, ast.FunctionDef)
                 and ("incremental" in n.name or "revalidate" in n.name)
                 and not n.name.startswith("reference_")]
    has_incr_oracle = any(
        isinstance(n, ast.FunctionDef)
        and n.name.startswith("reference_") and "incremental" in n.name
        for n in tree.body) or bool(
            re.search(r"reference_\w*incremental", "\n".join(lines)))
    for n in incr_defs:
        if has_incr_oracle or _suppressed(lines, n.lineno, "oracle"):
            continue
        findings.append(Finding(
            path, n.lineno, "oracle",
            f"{n.name} builds an incremental-revalidation variant "
            f"but the module has no reference_*_incremental NumPy "
            f"oracle — incremental device code must be proved equal "
            f"to full recompute at the same epoch (CLAUDE.md "
            f"convention; lux_tpu/livegraph.py round 20)"))
        break
    return findings


def check_decremental_oracle(path, tree, lines):
    """A deletion-capable function (a def with ``decremental`` in its
    name, or ``delete_edges`` / ``reweight_edges``) needs a
    ``reference_*decremental`` oracle defined or cited in its module
    (the port's: apps/sssp.reference_sssp_decremental,
    apps/components.reference_components_decremental).  Tree-wide; such
    functions are methods, so the whole tree is walked."""
    decr_defs = [n for n in ast.walk(tree)
                 if isinstance(n, ast.FunctionDef)
                 and ("decremental" in n.name
                      or n.name in ("delete_edges", "reweight_edges"))
                 and not n.name.startswith("reference_")]
    if not decr_defs:
        return []
    has_decr_oracle = any(
        isinstance(n, ast.FunctionDef)
        and n.name.startswith("reference_") and "decremental" in n.name
        for n in ast.walk(tree)) or bool(
            re.search(r"reference_\w*decremental", "\n".join(lines)))
    findings = []
    for n in decr_defs:
        if has_decr_oracle or _suppressed(lines, n.lineno, "oracle"):
            continue
        findings.append(Finding(
            path, n.lineno, "oracle",
            f"{n.name} is a deletion-capable builder but the module "
            f"neither defines nor cites a reference_*decremental "
            f"NumPy oracle — anti-monotone mutations must be proved "
            f"equal to full recompute at the same epoch (CLAUDE.md "
            f"convention; lux_tpu/livegraph.py round 21)"))
        break
    return findings


# ---------------------------------------------------------------------
# check: byte-budgeted consumers register a gauge


def check_budget_gauge(path, tree, lines):
    """A class whose ``__init__`` assigns ``self.max_bytes`` references
    a ``.gauge(`` call somewhere in the class.  Tree-wide."""
    findings = []
    for cls in ast.walk(tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        init = next((n for n in cls.body
                     if isinstance(n, ast.FunctionDef)
                     and n.name == "__init__"), None)
        if init is None:
            continue
        budgeted = any(
            isinstance(t, ast.Attribute) and t.attr == "max_bytes"
            and isinstance(t.value, ast.Name) and t.value.id == "self"
            for n in ast.walk(init) if isinstance(n, ast.Assign)
            for t in n.targets)
        if not budgeted or _suppressed(lines, cls.lineno, "budget-gauge"):
            continue
        has_gauge = any(
            isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
            and n.func.attr == "gauge" for n in ast.walk(cls))
        if not has_gauge:
            findings.append(Finding(
                path, cls.lineno, "budget-gauge",
                f"{cls.name} budgets bytes (self.max_bytes) but "
                f"registers no metrics gauge — a byte ceiling the "
                f"memory observatory cannot watch fill "
                f"(lux_tpu/memwatch.py round 22; see "
                f"AnswerCache.set_metrics for the convention)"))
    return findings


# ---------------------------------------------------------------------
# check: citation presence


def check_citation(path, tree, lines):
    if os.path.basename(path) == "__init__.py":
        return []
    doc = ast.get_docstring(tree) or ""
    if CITATION_RE.search(doc) or _suppressed(lines, 1, "citation"):
        return []
    return [Finding(
        path, 1, "citation",
        "module docstring cites no reference file:line — engine/ops "
        "modules must anchor their design to the reference "
        "implementation for parity auditing (CLAUDE.md conventions)")]


# ---------------------------------------------------------------------
# the tests' texts (part-stats-oracle, chaos-coverage)

PART_STATS_DOC = "per-part"
PART_ORACLE_TOKEN = re.compile(r"\bper_part\w*")
_TESTS_CACHE: list[str] | None = None


def _test_texts() -> list[str]:
    """Cached source texts of every tests/test_torch_*.py: the port's
    own tests, which are what hold the port."""
    global _TESTS_CACHE
    if _TESTS_CACHE is None:
        texts = []
        tdir = os.path.join(REPO, "tests")
        if os.path.isdir(tdir):
            for f in sorted(os.listdir(tdir)):
                if f.startswith("test_torch_") and f.endswith(".py"):
                    try:
                        with open(os.path.join(tdir, f)) as fh:
                            texts.append(fh.read())
                    except OSError:
                        continue
        _TESTS_CACHE = texts
    return _TESTS_CACHE


def check_part_stats_oracle(path, tree, lines):
    """Engine variants citing per-part counters carry a per-part oracle
    test."""
    findings = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.FunctionDef):
            continue
        if not (node.name.endswith("_stats")
                or node.name.endswith("_health")):
            continue
        doc = ast.get_docstring(node) or ""
        if PART_STATS_DOC not in doc.lower():
            continue
        if _suppressed(lines, node.lineno, "part-stats-oracle"):
            continue
        covered = any(node.name in txt and PART_ORACLE_TOKEN.search(txt)
                      for txt in _test_texts())
        if not covered:
            findings.append(Finding(
                path, node.lineno, "part-stats-oracle",
                f"{node.name} cites per-part counters but no test "
                f"under tests/ references it together with a "
                f"per_part* NumPy oracle — per-part counter "
                f"variants need their sum-over-parts-bitwise proof "
                f"(CLAUDE.md: new device code gets an oracle test "
                f"first)"))
    return findings


ACTION_NAME_RE = re.compile(r"^[A-Z][A-Z0-9_]*$")


def check_chaos_coverage(path, tree, lines):
    """Every fault-plan action constant is named, by constant or value,
    in some test."""
    findings = []
    for node in tree.body:
        if not (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and ACTION_NAME_RE.match(node.targets[0].id)
                and isinstance(node.value, ast.Constant)
                and isinstance(node.value.value, str)):
            continue
        name, value = node.targets[0].id, node.value.value
        if _suppressed(lines, node.lineno, "chaos-coverage"):
            continue
        if not any(name in txt or value in txt for txt in _test_texts()):
            findings.append(Finding(
                path, node.lineno, "chaos-coverage",
                f"fault action {name} = {value!r} is drilled by no "
                f"file under tests/ — a fault action nobody injects "
                f"is a recovery path that ships untested (faults.py's "
                f"whole purpose); add a drill or suppress with a "
                f"justification"))
    return findings


# ---------------------------------------------------------------------
# check: no metrics calls in engine / ops code


def _references_metrics(expr) -> bool:
    """Does this call target reach through a ``metrics`` name or
    attribute?"""
    for n in ast.walk(expr):
        if isinstance(n, ast.Name) and n.id == "metrics":
            return True
        if isinstance(n, ast.Attribute) and n.attr == "metrics":
            return True
    return False


def check_hot_path_metrics(path, tree, lines):
    """Flag metrics calls anywhere in an engine/ops module."""
    findings = []
    seen = set()
    for n in ast.walk(tree):
        if not (isinstance(n, ast.Call) and _references_metrics(n.func)):
            continue
        line = getattr(n, "lineno", 1)
        if line in seen or _suppressed(lines, line, "hot-path-metrics"):
            continue
        seen.add(line)
        findings.append(Finding(
            path, line, "hot-path-metrics",
            "metrics call inside engine device code — metrics are "
            "host-side, segment-boundary only "
            "(lux_tpu/metrics.py contract; the audited "
            "callback-in-loop ban's source-level twin)"))
    return findings


# ---------------------------------------------------------------------
# check: collectives stay inside ops/ + engine/

COLLECTIVE_CALLS = {
    "ppermute", "all_to_all", "psum_scatter", "reduce_scatter",
    "all_gather", "psum", "pmin", "pmax",
    # torch.distributed's own names for the same collectives
    "all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor",
    "all_to_all_single",
}


def check_collective_scope(path, tree, lines):
    """Flag collective calls outside lux_tpu_torch/ops/ and engine/."""
    findings = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        name = f.attr if isinstance(f, ast.Attribute) \
            else getattr(f, "id", None)
        if name not in COLLECTIVE_CALLS:
            continue
        line = getattr(node, "lineno", 1)
        if _suppressed(lines, line, "collective-scope"):
            continue
        findings.append(Finding(
            path, line, "collective-scope",
            f"{name} call outside lux_tpu/ops/ + lux_tpu/engine/ — "
            f"the collective-schedule audit and the comm byte ledger "
            f"(lux_tpu/comms.py) only account collectives in those "
            f"trees; move it behind an op interface or carry an "
            f"explicit pragma with the justification"))
    return findings


# ---------------------------------------------------------------------
# check: event names against events_summary.py's catalogue

EVENT_EMIT_NAMES = {"emit", "_emit", "emit_sampled"}

_KNOWN_EVENTS_CACHE = None


def _known_events() -> set:
    """scripts/events_summary.py's KNOWN set, parsed statically."""
    global _KNOWN_EVENTS_CACHE
    if _KNOWN_EVENTS_CACHE is None:
        path = os.path.join(REPO, "scripts", "events_summary.py")
        known = set()
        try:
            with open(path) as f:
                tree = ast.parse(f.read(), filename=path)
            for node in tree.body:
                if (isinstance(node, ast.Assign) and len(node.targets) == 1
                        and isinstance(node.targets[0], ast.Name)
                        and node.targets[0].id == "KNOWN"):
                    known = set(ast.literal_eval(node.value))
        except (OSError, SyntaxError, ValueError):
            pass
        _KNOWN_EVENTS_CACHE = known
    return _KNOWN_EVENTS_CACHE


def check_event_names(path, tree, lines):
    """Every string literal passed to an emit is in KNOWN."""
    known = _known_events()
    if not known:
        return []
    findings = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call) or not node.args:
            continue
        f = node.func
        name = f.id if isinstance(f, ast.Name) else (
            f.attr if isinstance(f, ast.Attribute) else None)
        if name not in EVENT_EMIT_NAMES:
            continue
        arg = node.args[0]
        if not (isinstance(arg, ast.Constant) and isinstance(arg.value, str)):
            continue
        if arg.value in known or _suppressed(lines, node.lineno,
                                             "event-name"):
            continue
        findings.append(Finding(
            path, node.lineno, "event-name",
            f"emit({arg.value!r}) is not in events_summary.KNOWN "
            f"— add the event name to the KNOWN catalogue so the "
            f"runtime audit recognizes it before it first fires"))
    return findings


# ---------------------------------------------------------------------
# check: the documents' commands resolve

DOC_COMMAND_RE = re.compile(
    r"python3?\s+-m\s+(" + PKG + r"(?:\.[A-Za-z_][A-Za-z0-9_]*)+)")


def check_doc_commands(repo: str = REPO, docs=DOCS):
    """command-drift: every ``python -m lux_tpu_torch.<mod>`` cited in
    the documents resolves to a module with a ``__main__`` entry (or a
    package ``__main__.py``)."""
    findings = []
    for doc in docs:
        p = os.path.join(repo, doc)
        if not os.path.isfile(p):
            continue
        with open(p) as f:
            doc_lines = f.read().splitlines()
        for i, line in enumerate(doc_lines, 1):
            for m in DOC_COMMAND_RE.finditer(line):
                dotted = m.group(1)
                base = os.path.join(repo, *dotted.split("."))
                mod_py = base + ".py"
                if os.path.isfile(os.path.join(base, "__main__.py")):
                    continue
                if not os.path.isfile(mod_py):
                    msg = (f"cites `python -m {dotted}` but no such "
                           f"module exists")
                else:
                    with open(mod_py) as f:
                        if "__main__" in f.read():
                            continue
                    msg = (f"cites `python -m {dotted}` but "
                           f"{os.path.relpath(mod_py, repo)} has no "
                           f"`if __name__ == \"__main__\"` entry")
                if _suppressed(doc_lines, i, "command-drift"):
                    continue
                findings.append(Finding(p, i, "command-drift", msg))
    return findings


# ---------------------------------------------------------------------
# driver


def _under(norm: str, sub: str) -> bool:
    return f"/{PKG}/{sub}" in norm


def lint_file(path: str):
    """Every check that applies to ``path``, in the module docstring's
    order."""
    with open(path) as f:
        src = f.read()
    lines = src.splitlines()
    try:
        tree = ast.parse(src, filename=path)
    except SyntaxError as e:
        return [Finding(path, e.lineno or 1, "parse",
                        f"syntax error: {e.msg}")]
    norm = path.replace(os.sep, "/")
    device_code = _under(norm, "engine/") or _under(norm, "ops/")
    findings = []
    if _under(norm, "apps/"):
        findings += check_oracle(path, tree, lines)
    findings += check_decremental_oracle(path, tree, lines)
    findings += check_budget_gauge(path, tree, lines)
    if device_code:
        findings += check_citation(path, tree, lines)
    if _under(norm, "engine/"):
        findings += check_part_stats_oracle(path, tree, lines)
    if norm.endswith(f"/{PKG}/faults.py"):
        findings += check_chaos_coverage(path, tree, lines)
    if device_code:
        findings += check_hot_path_metrics(path, tree, lines)
    else:
        findings += check_collective_scope(path, tree, lines)
    findings += check_event_names(path, tree, lines)
    return findings


def iter_py_files(paths):
    for p in paths:
        if os.path.isfile(p) and p.endswith(".py"):
            yield p
        elif os.path.isdir(p):
            for root, _dirs, files in os.walk(p):
                if "__pycache__" in root:
                    continue
                for f in sorted(files):
                    if f.endswith(".py"):
                        yield os.path.join(root, f)


def lint_paths(paths):
    findings = []
    for f in iter_py_files(paths):
        findings += lint_file(os.path.abspath(f))
    return findings


def run_lint(paths=None, repo: str = REPO):
    """The findings over ``paths`` (default: the package) plus the
    documents' commands."""
    if not paths:
        paths = [os.path.join(repo, PKG)]
    return lint_paths(paths) + check_doc_commands(repo)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="AST convention linter for the port (app oracles, "
                    "reference citations, budget gauges, test coverage "
                    "of per-part stats and fault actions, metrics and "
                    "collectives in their trees, event names, the "
                    "documents' commands)")
    ap.add_argument("paths", nargs="*")
    ap.add_argument("-q", action="store_true", dest="quiet")
    args = ap.parse_args(argv)
    findings = run_lint(args.paths)
    for f in findings:
        print(str(f), file=sys.stderr)
    if findings:
        print(f"lint: {len(findings)} finding(s) — FAILED", file=sys.stderr)
        return 1
    if not args.quiet:
        print("lint: clean")
    return 0


if __name__ == "__main__":
    sys.exit(main())
