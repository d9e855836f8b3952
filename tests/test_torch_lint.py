"""lux_tpu_torch/lint.py against scripts/lint_lux.py.

For every check the port keeps: a planted violation in a ``tmp_path``
tree is flagged, its ``# audit: allow(<check>)`` pragma suppresses it,
and the script's own function (loaded from its source with ``ast``: the
script is not imported) gives the same check names and lines on the
same snippet, the port's tree under ``lux_tpu_torch/`` and the
script's under ``lux_tpu/``.  The coverage checks read the same test
texts on both sides.  Then the linter is clean over the port and its
documents, run as ``python -m lux_tpu_torch.lint``.
"""

import ast
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from lux_tpu_torch import lint

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def ref_lint():
    """scripts/lint_lux.py's imports, constants, classes and functions,
    defined from its source (its ``main`` never runs)."""
    path = REPO / "scripts" / "lint_lux.py"
    tree = ast.parse(path.read_text(), filename=str(path))
    keep = [n for n in tree.body if isinstance(
        n, (ast.FunctionDef, ast.ClassDef, ast.Assign, ast.AnnAssign,
            ast.Import, ast.ImportFrom))]
    ns = {"__name__": "lint_lux", "__file__": str(path)}
    exec(compile(ast.Module(body=keep, type_ignores=[]), str(path),
                 "exec"), ns)
    return ns


@pytest.fixture
def same_tests(ref_lint, monkeypatch):
    """Give both linters the same test texts for the coverage checks."""
    def use(texts):
        monkeypatch.setattr(lint, "_TESTS_CACHE", list(texts))
        monkeypatch.setitem(ref_lint, "_TESTS_CACHE", list(texts))
    return use


def _plant(root: Path, pkg: str, rel: str, src: str) -> str:
    p = root / pkg / rel
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(textwrap.dedent(src))
    return str(p)


def _got(findings) -> list:
    return sorted((f.check, f.line) for f in findings)


def _both(ref_lint, tmp_path, rel, src):
    """(port findings, script findings) of one snippet, each linted as a
    file of its own package tree."""
    port = lint.lint_file(_plant(tmp_path / "port", "lux_tpu_torch", rel,
                                 src))
    ref = ref_lint["lint_file"](_plant(tmp_path / "ref", "lux_tpu", rel,
                                       src))
    return _got(port), _got(ref)


CITED = '"""An ops module (cf. lux_tpu/ops/tiled.py:12)."""\n'

# check -> (relative path, violating snippet, the same with its pragma,
# the (check, line) findings the violation gives)
CASES = {
    "oracle": ("apps/foo.py",
               "def run(g):\n    return g\n",
               "# audit: allow(oracle) a driver, not an algorithm\n"
               "def run(g):\n    return g\n",
               [("oracle", 1)]),
    "oracle_batched": ("apps/bar.py",
                       "def reference_bar(g):\n    return g\n\n\n"
                       "def build_batched(g):\n    return g\n",
                       "def reference_bar(g):\n    return g\n\n\n"
                       "# audit: allow(oracle) the columns' oracle is "
                       "reference_bar\n"
                       "def build_batched(g):\n    return g\n",
                       [("oracle", 5)]),
    "oracle_incremental": ("apps/baz.py",
                           "def reference_baz(g):\n    return g\n\n\n"
                           "class L:\n    def revalidate(self):\n"
                           "        pass\n",
                           "def reference_baz(g):\n    return g\n\n\n"
                           "class L:\n    # audit: allow(oracle) held "
                           "by a test's recompute\n"
                           "    def revalidate(self):\n        pass\n",
                           [("oracle", 6)]),
    "oracle_decremental": ("live.py",
                           "class Live:\n    def delete_edges(self, s, d):"
                           "\n        return 0\n",
                           "class Live:\n    # audit: allow(oracle) a "
                           "test recomputes from scratch\n"
                           "    def delete_edges(self, s, d):\n"
                           "        return 0\n",
                           [("oracle", 2)]),
    "budget-gauge": ("cache.py",
                     "class Cache:\n    def __init__(self):\n"
                     "        self.max_bytes = 1 << 20\n",
                     "# audit: allow(budget-gauge) a test double\n"
                     "class Cache:\n    def __init__(self):\n"
                     "        self.max_bytes = 1 << 20\n",
                     [("budget-gauge", 1)]),
    "citation": ("engine/step.py",
                 '"""An engine module without its anchor."""\nX = 1\n',
                 "# audit: allow(citation) no reference counterpart\n"
                 '"""An engine module without its anchor."""\n'
                 "X = 1\n",
                 [("citation", 1)]),
    "part-stats-oracle": ("engine/eng.py",
                          '"""Engine (lux_tpu/engine/pull.py:1)."""\n\n\n'
                          "def run_stats(s):\n"
                          '    """Counters and their per-part rows."""\n'
                          "    return s\n",
                          '"""Engine (lux_tpu/engine/pull.py:1)."""\n\n\n'
                          "# audit: allow(part-stats-oracle) no parts\n"
                          "def run_stats(s):\n"
                          '    """Counters and their per-part rows."""\n'
                          "    return s\n",
                          [("part-stats-oracle", 4)]),
    "chaos-coverage": ("faults.py",
                       'CRASH = "crash"\nSTALL = "stall_forever"\n',
                       'CRASH = "crash"\n'
                       "# audit: allow(chaos-coverage) library-internal\n"
                       'STALL = "stall_forever"\n',
                       [("chaos-coverage", 2)]),
    "hot-path-metrics": ("ops/red.py",
                         CITED + "def red(x, metrics):\n"
                         "    metrics.counter('n').inc()\n    return x\n",
                         CITED + "def red(x, metrics):\n"
                         "    # audit: allow(hot-path-metrics) host side\n"
                         "    metrics.counter('n').inc()\n    return x\n",
                         [("hot-path-metrics", 3)]),
    "collective-scope": ("serve2.py",
                         "def f(dist, x):\n    dist.all_gather(x)\n",
                         "def f(dist, x):\n"
                         "    dist.all_gather(x)  # audit: allow("
                         "collective-scope) a probe\n",
                         [("collective-scope", 2)]),
    "event-name": ("tel.py",
                   "def f(log):\n    log.emit('segment')\n"
                   "    log.emit('no_such_event')\n",
                   "def f(log):\n    log.emit('segment')\n"
                   "    # audit: allow(event-name) a test event\n"
                   "    log.emit('no_such_event')\n",
                   [("event-name", 3)]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_planted_violation_flagged_suppressed_and_as_the_script(
        ref_lint, same_tests, tmp_path, case):
    rel, bad, allowed, want = CASES[case]
    same_tests(["def test_x():\n    CRASH = 1\n"])
    got, ref = _both(ref_lint, tmp_path / "bad", rel, bad)
    assert got == want
    assert ref == got
    got, ref = _both(ref_lint, tmp_path / "ok", rel, allowed)
    assert got == [] and ref == []


def test_coverage_checks_read_the_tests(ref_lint, same_tests, tmp_path):
    """A test naming the variant beside a per_part* oracle, or the fault
    action's value, clears the finding on both sides."""
    rel, bad, _a, _w = CASES["part-stats-oracle"]
    same_tests(["def per_part_oracle(): pass\n\n"
                "def test_run_stats(eng):\n    eng.run_stats(1)\n"])
    assert _both(ref_lint, tmp_path / "a", rel, bad) == ([], [])
    rel, bad, _a, _w = CASES["chaos-coverage"]
    same_tests(["PLAN = ('crash', 'stall_forever')\n"])
    assert _both(ref_lint, tmp_path / "b", rel, bad) == ([], [])


def test_tests_read_are_the_ports(monkeypatch, tmp_path):
    """The port's coverage comes from tests/test_torch_*.py alone."""
    monkeypatch.setattr(lint, "_TESTS_CACHE", None)
    monkeypatch.setattr(lint, "REPO", str(tmp_path))
    (tmp_path / "tests").mkdir()
    (tmp_path / "tests" / "test_other.py").write_text("CRASH = 1\n")
    (tmp_path / "tests" / "test_torch_x.py").write_text("STALL = 1\n")
    assert lint._test_texts() == ["STALL = 1\n"]


def test_torch_collectives_and_scope(tmp_path):
    """torch.distributed's names are collectives too, and ops/ and
    engine/ may call them."""
    src = "def f(dist, x):\n    dist.all_reduce(x)\n" \
          "    dist.reduce_scatter_tensor(x, x)\n"
    got = _got(lint.lint_file(_plant(tmp_path, "lux_tpu_torch",
                                     "fleet2.py", src)))
    assert got == [("collective-scope", 2), ("collective-scope", 3)]
    ok = _plant(tmp_path, "lux_tpu_torch", "ops/coll.py", CITED + src)
    assert lint.lint_file(ok) == []


def test_scope_rules_follow_the_ports_directories(tmp_path):
    """citation and hot-path-metrics bind engine/ and ops/, the oracle
    rule apps/: the same snippets elsewhere pass."""
    for rel in ("apps/foo.py", "engine/step.py", "ops/red.py"):
        src = CASES[{"apps/foo.py": "oracle", "engine/step.py": "citation",
                     "ops/red.py": "hot-path-metrics"}[rel]][1]
        flagged = lint.lint_file(_plant(tmp_path / "in", "lux_tpu_torch",
                                        rel, src))
        elsewhere = lint.lint_file(_plant(tmp_path / "out", "lux_tpu_torch",
                                          os.path.basename(rel), src))
        assert flagged and elsewhere == []


def test_command_drift_as_the_script(ref_lint, tmp_path):
    """The documents' ``python -m`` / ``python3 -m`` commands resolve to
    a module with a ``__main__`` entry or a package ``__main__.py``."""
    lines = ("run `python -m {p}.good -v`\n"
             "and `python -m {p}.quiet`\n"
             "and `python -m {p}.gone`\n"
             "and `python -m {p}.pkg`\n"
             "<!-- audit: allow(command-drift) retired -->\n"
             "# audit: allow(command-drift) retired\n"
             "`python -m {p}.gone`\n")
    for root, pkg, doc in ((tmp_path / "port", "lux_tpu_torch",
                            "README.md"),
                           (tmp_path / "ref", "lux_tpu", "CLAUDE.md")):
        _plant(root, pkg, "good.py", "if __name__ == '__main__':\n    pass\n")
        _plant(root, pkg, "quiet.py", "X = 1\n")
        _plant(root, pkg, "pkg/__main__.py", "X = 1\n")
        (root / doc).write_text(lines.format(p=pkg))
    got = _got(lint.check_doc_commands(str(tmp_path / "port")))
    ref = _got(ref_lint["check_doc_commands"](str(tmp_path / "ref")))
    assert got == [("command-drift", 2), ("command-drift", 3)] == ref
    # python3 is a command too, and every document the port lists counts
    skill = tmp_path / "port" / ".claude" / "skills" / "verify"
    skill.mkdir(parents=True)
    (skill / "SKILL.md").write_text("`python3 -m lux_tpu_torch.gone`\n")
    (tmp_path / "port" / "PERF.md").write_text(
        "`python3 -m lux_tpu_torch.good`\n")
    got = lint.check_doc_commands(str(tmp_path / "port"))
    assert sorted((os.path.basename(f.path), f.line) for f in got) == [
        ("README.md", 2), ("README.md", 3), ("SKILL.md", 1)]


def test_finding_text_is_the_scripts(ref_lint, tmp_path):
    rel, bad, _a, _w = CASES["budget-gauge"]
    f = lint.lint_file(_plant(tmp_path / "p", "lux_tpu_torch", rel, bad))
    r = ref_lint["lint_file"](_plant(tmp_path / "r", "lux_tpu", rel, bad))
    assert [x.message for x in f] == [x.message for x in r]


def test_port_and_docs_are_clean():
    """``python -m lux_tpu_torch.lint`` over the port and its documents:
    exit 0, "lint: clean"; a planted violation makes it exit 1."""
    out = subprocess.run([sys.executable, "-m", "lux_tpu_torch.lint"],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "lint: clean"
    assert lint.run_lint() == []


def test_main_exit_codes(tmp_path, capsys):
    bad = _plant(tmp_path, "lux_tpu_torch", "apps/foo.py",
                 CASES["oracle"][1])
    assert lint.main([bad]) == 1
    assert "[oracle]" in capsys.readouterr().err
    ok = _plant(tmp_path, "lux_tpu_torch", "apps/ok.py",
                "def reference_ok(g):\n    return g\n")
    assert lint.main([ok, "-q"]) == 0
