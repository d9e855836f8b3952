"""lockcheck — host-concurrency and durability static analyzer for the
port's threaded host code (a copy of lux_tpu/lockcheck.py, which the
port may not import; the checks, the pragma and the exit codes are the
reference's).

The port's engines are single-stream eager PyTorch; the substrate above
them (serve.py, fleet.py, livegraph.py, journal.py, heartbeat.py,
metrics.py, telemetry.py, checkpoint.py, plus _kernels.py and
native/__init__.py, whose build caches hold locks in the port) is
threaded, durability-critical Python.  lux_tpu_torch/audit.py checks
the programs the engines run; THIS module checks lock discipline and
durability ordering in the threaded host code.  AST/CFG only: no
imports of the checked modules, no tracing, seconds on CPU.

Five check classes, each raising ``LockCheckError(check=...)`` in
error mode:

  guarded-field
      Lockset inference.  A class that owns a lock (an attribute
      assigned ``threading.Lock()`` / ``RLock()`` / ``Condition()``)
      defines a GUARDED field the moment any method mutates that
      field under the lock; every other mutation site of the same
      field must then hold the lock too (``__init__`` and
      locally-constructed instances are construction-phase and
      exempt; private helpers whose every intra-class call site
      holds the lock inherit it — the documented
      "caller holds the lock" idiom).  The motivating bug is the
      PR-15/20 compact() lock WINDOW: a fold that released the lock
      mid-operation lost a concurrent append twice over
      (livegraph.LiveGraph.compact docstring).

  lock-order
      Cross-module lock-acquisition graph.  An edge A -> B is
      recorded when code acquires B while holding A — directly
      (nested ``with``) or transitively through method calls
      (receiver types resolved from ``self.attr = ClassName(...)``
      assignments, falling back to a unique-method-name match).
      Any cycle among DISTINCT locks is a potential deadlock; the
      PR-15 fifth-review refresh_live/run/compact three-way
      deadlock is the motivating fixture
      (tests/test_lockcheck.py).

  durable-before-visible
      Record-stream durability ordering (journal.py / livegraph.py
      WAL / checkpoint.py contract, stated until now only in
      comments).  Within a function, every path from a RECORD write
      (``.write()`` on a binary-mode handle, ``np.save``/
      ``np.savez``/``pickle.dump`` into one) to a VISIBLE action —
      a ``return`` (explicit or fall-through), a telemetry
      ``emit``, a queue ``put``/``notify``, an ``os.rename``/
      ``os.replace`` publish — must cross an ``os.fsync``.
      Checkpoints must follow write-tmp -> fsync -> rename; the
      subprocess spool's json must be written LAST (its presence
      marks a complete pair — a json published before its sidecars
      advertises a torn answer).  Text-mode writes (heartbeats,
      spool manifests) are liveness signals, lossy by design, and
      exempt by mode.

  snapshot-iteration
      Iterating a guarded container outside its lock without a
      ``list()``/``tuple()``/``sorted()``/``set()`` snapshot — the
      PR-15 fifth-review collector race (refresh_live iterating
      ``self.collectors`` while submit threads append; dicts raise
      RuntimeError mid-resize, lists silently skip).

  toctou-gate
      A guarded field read OUTSIDE the lock feeding a condition
      that gates a mutation INSIDE it, with no re-check under the
      lock — the stamp-then-admit window class (PR-16: a separate
      epoch read + admit let a concurrent mutate+compact fold the
      stamped view away before the admission ledger protected it;
      livegraph.LiveGraph.admit is the one-acquisition fix).

Suppression: ``# lockcheck: allow(<check>)`` on the flagged line or
in the contiguous comment block directly above it, with a one-line
justification — the same syntax audit.py and lint_lux.py honor.

Usage:  python -m lux_tpu_torch.lockcheck [PATHS...]
        (default: the port's threaded host modules, HOST_MODULES)
Exit status: 0 clean, 1 any unsuppressed finding.
tests/test_torch_lockcheck.py holds the port's tree to clean and this
copy to the reference's verdicts on its violating fixtures.
"""

from __future__ import annotations

import argparse
import ast
import dataclasses
import os
import re
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the port's threaded host modules (paths under lux_tpu_torch/): the
# reference's eight, plus the two build caches that hold locks in the
# port; main() checks these by default, analyze_paths takes any .py
HOST_MODULES = ("serve.py", "fleet.py", "livegraph.py", "journal.py",
                "heartbeat.py", "metrics.py", "telemetry.py",
                "checkpoint.py", "_kernels.py",
                os.path.join("native", "__init__.py"))

CHECKS = ("guarded-field", "lock-order", "durable-before-visible",
          "snapshot-iteration", "toctou-gate")

PRAGMA_RE = re.compile(r"#\s*lockcheck:\s*allow\(([a-z-]+)\)")

LOCK_FACTORIES = {"Lock", "RLock", "Condition"}

# container-mutating method names (called on a field -> mutation)
MUTATOR_METHODS = {"append", "extend", "insert", "add", "update",
                   "pop", "popitem", "popleft", "appendleft",
                   "remove", "discard", "clear", "setdefault",
                   "move_to_end", "sort", "reverse"}

# sanctioned snapshot wrappers for iterating a guarded container
SNAPSHOT_FUNCS = {"list", "tuple", "sorted", "set", "frozenset",
                  "dict"}

# container constructors (self.f = ...) marking a field container-ish
CONTAINER_FACTORIES = {"list", "dict", "set", "OrderedDict", "deque",
                       "Counter", "defaultdict"}

# visible-action call names for durable-before-visible
EMIT_NAMES = {"emit", "_emit", "emit_sampled"}
ENQUEUE_NAMES = {"put", "notify", "notify_all"}
PUBLISH_NAMES = {"rename", "replace"}       # os.rename / os.replace


class LockCheckError(Exception):
    """Typed lock-discipline violation: ``check`` names the violated
    check class (one of CHECKS), ``findings`` carries every site."""

    def __init__(self, check: str, message: str, findings=()):
        super().__init__(message)
        self.check = check
        self.findings = list(findings)


@dataclasses.dataclass
class Finding:
    path: str
    line: int
    check: str
    message: str

    def __str__(self):
        rel = os.path.relpath(self.path, REPO)
        return f"{rel}:{self.line}: [{self.check}] {self.message}"


def _suppressed(lines, line_no: int, check: str) -> bool:
    """Pragma on the flagged line or the contiguous comment block
    directly above it (mirrors scripts/lint_lux.py)."""

    def hit(text):
        return any(m.group(1) == check
                   for m in PRAGMA_RE.finditer(text))

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
# model


def _is_lock_factory(expr) -> bool:
    if not isinstance(expr, ast.Call):
        return False
    f = expr.func
    if isinstance(f, ast.Attribute) and f.attr in LOCK_FACTORIES \
            and isinstance(f.value, ast.Name) \
            and f.value.id == "threading":
        return True
    return isinstance(f, ast.Name) and f.id in LOCK_FACTORIES


def _call_name(expr):
    """'ClassName' for ``ClassName(...)`` / ``cls(...)``, else None."""
    if isinstance(expr, ast.Call):
        if isinstance(expr.func, ast.Name):
            return expr.func.id
        if isinstance(expr.func, ast.Attribute):
            return expr.func.attr
    return None


def _self_field(expr):
    """'f' for ``self.f`` (one level), else None."""
    if isinstance(expr, ast.Attribute) \
            and isinstance(expr.value, ast.Name) \
            and expr.value.id == "self":
        return expr.attr
    return None


def _is_binary_open(expr) -> bool:
    """``open(path, 'ab')`` / ``os.fdopen(fd, 'wb')`` with a binary
    WRITE mode — the record-stream handle discriminator (text-mode
    writes are liveness/manifest signals, exempt by contract)."""
    if not isinstance(expr, ast.Call):
        return False
    f = expr.func
    name = None
    if isinstance(f, ast.Name):
        name = f.id
    elif isinstance(f, ast.Attribute):
        name = f.attr
    if name not in ("open", "fdopen"):
        return False
    mode = None
    if len(expr.args) >= 2 and isinstance(expr.args[1], ast.Constant):
        mode = expr.args[1].value
    for kw in expr.keywords:
        if kw.arg == "mode" and isinstance(kw.value, ast.Constant):
            mode = kw.value.value
    return (isinstance(mode, str) and "b" in mode
            and any(c in mode for c in "wax+"))


@dataclasses.dataclass
class _Fact:
    """One collected site; ``held`` is a frozenset of lock keys."""
    line: int
    held: frozenset
    field: str = ""
    in_init: bool = False
    extra: tuple = ()


class _FuncModel:
    def __init__(self, node, cls, mod):
        self.node = node
        self.cls = cls                     # _ClassModel or None
        self.mod = mod
        self.name = node.name
        self.is_init = node.name in ("__init__", "__post_init__")
        self.mutations: list[_Fact] = []   # field mutations (self.*)
        self.iterations: list[_Fact] = []  # unwrapped field iteration
        self.acquisitions: list[_Fact] = []  # field=lock key acquired
        self.calls: list[_Fact] = []       # extra=(kind, a, b)
        self.if_nodes: list[tuple] = []    # (If/While node, heldset)
        self.outside_reads: dict[str, set] = {}  # local -> fields
        self.self_call_sites: dict[str, list] = {}  # name -> [held]
        self.inherited: frozenset = frozenset()  # inferred held locks


class _ClassModel:
    def __init__(self, node, mod):
        self.node = node
        self.mod = mod
        self.name = node.name
        self.lock_attrs: set[str] = set()
        self.attr_types: dict[str, str] = {}
        self.container_attrs: set[str] = set()
        self.binary_handle_attrs: set[str] = set()
        self.methods: dict[str, _FuncModel] = {}

    def lock_key(self, attr: str) -> str:
        return f"{self.mod}:{self.name}.{attr}"

    @property
    def lock_keys(self) -> set[str]:
        return {self.lock_key(a) for a in self.lock_attrs}


class _FileModel:
    def __init__(self, path, src):
        self.path = path
        self.lines = src.splitlines()
        self.mod = os.path.basename(path)[:-3]
        self.tree = ast.parse(src, filename=path)
        self.classes: dict[str, _ClassModel] = {}
        self.functions: dict[str, _FuncModel] = {}
        self.module_locks: set[str] = set()

    def lock_key(self, name: str) -> str:
        return f"{self.mod}:{name}"


def _prescan(fm: _FileModel) -> None:
    """Phase 1: class skeletons — lock attrs, attr types, container
    and binary-handle attrs — plus module-level locks.  Runs before
    fact collection so ``with <local>._lock`` and receiver types can
    resolve across classes and files."""
    for node in fm.tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and _is_lock_factory(node.value):
            fm.module_locks.add(node.targets[0].id)
        if not isinstance(node, ast.ClassDef):
            continue
        cm = _ClassModel(node, fm.mod)
        fm.classes[node.name] = cm
        for n in ast.walk(node):
            if not isinstance(n, ast.Assign) or len(n.targets) != 1:
                continue
            field = _self_field(n.targets[0])
            if field is None:
                continue
            if _is_lock_factory(n.value):
                cm.lock_attrs.add(field)
            elif _is_binary_open(n.value):
                cm.binary_handle_attrs.add(field)
            else:
                cname = _call_name(n.value)
                if cname in CONTAINER_FACTORIES or isinstance(
                        n.value, (ast.List, ast.Dict, ast.Set)):
                    cm.container_attrs.add(field)
                elif cname and cname[:1].isupper():
                    # self.attr = ClassName(...) — receiver typing
                    # for cross-class lock-order resolution
                    cm.attr_types[field] = cname


# ---------------------------------------------------------------------
# phase 2: fact collection (lock contexts, mutations, iterations,
# calls) — one structured recursive walk per function


class _Collector:
    """Walks one function body tracking the held-lock context."""

    def __init__(self, fmodel: _FuncModel, file_model: _FileModel,
                 registry: "dict[str, list[_ClassModel]]"):
        self.f = fmodel
        self.file = file_model
        self.registry = registry
        self.ctor_locals: dict[str, str] = {}   # name -> class name

    # -- lock expression resolution -----------------------------------

    def _lock_key_of(self, expr) -> str | None:
        """Lock key for a with-item / acquire() receiver, or None."""
        if isinstance(expr, ast.Name):
            if expr.id in self.file.module_locks:
                return self.file.lock_key(expr.id)
            return None
        if isinstance(expr, ast.Attribute) \
                and isinstance(expr.value, ast.Name):
            base, attr = expr.value.id, expr.attr
            if base == "self" and self.f.cls is not None \
                    and attr in self.f.cls.lock_attrs:
                return self.f.cls.lock_key(attr)
            cname = self.ctor_locals.get(base)
            if cname:
                for cm in self.registry.get(cname, ()):
                    if attr in cm.lock_attrs:
                        return cm.lock_key(attr)
        return None

    # -- entry ---------------------------------------------------------

    def run(self):
        self.block(self.f.node.body, frozenset())

    def block(self, stmts, held):
        for st in stmts:
            self.stmt(st, held)

    # -- statements ----------------------------------------------------

    def stmt(self, st, held):
        if isinstance(st, ast.With):
            add = set()
            for item in st.items:
                key = self._lock_key_of(item.context_expr)
                if key is not None:
                    self.f.acquisitions.append(_Fact(
                        line=st.lineno, held=held, field=key))
                    add.add(key)
                else:
                    self.expr(item.context_expr, held)
            self.block(st.body, held | add)
        elif isinstance(st, (ast.If, ast.While)):
            self.f.if_nodes.append((st, held))
            self.expr(st.test, held)
            self.block(st.body, held)
            self.block(st.orelse, held)
        elif isinstance(st, ast.For):
            self._iteration(st.iter, held, st.lineno)
            self.expr(st.iter, held, top_iter=True)
            self.block(st.body, held)
            self.block(st.orelse, held)
        elif isinstance(st, ast.Try):
            self.block(st.body, held)
            for h in st.handlers:
                self.block(h.body, held)
            self.block(st.orelse, held)
            self.block(st.finalbody, held)
        elif isinstance(st, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            self._assignment(st, held)
        elif isinstance(st, ast.Delete):
            for t in st.targets:
                self._mutation_target(t, held, st.lineno)
        elif isinstance(st, ast.Expr):
            self.expr(st.value, held)
        elif isinstance(st, ast.Return):
            if st.value is not None:
                self.expr(st.value, held)
        elif isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
            pass          # nested defs analyzed at their call sites
        elif isinstance(st, ast.ClassDef):
            pass
        else:
            for child in ast.iter_child_nodes(st):
                if isinstance(child, ast.expr):
                    self.expr(child, held)
                elif isinstance(child, ast.stmt):
                    self.stmt(child, held)

    def _assignment(self, st, held):
        targets = st.targets if isinstance(st, ast.Assign) \
            else [st.target]
        value = st.value
        if value is not None:
            self.expr(value, held)
        for t in targets:
            self._mutation_target(t, held, st.lineno)
        # locally-constructed instances (construction phase — their
        # field writes are thread-confined until published)
        if isinstance(st, ast.Assign) and len(targets) == 1 \
                and isinstance(targets[0], ast.Name):
            cname = _call_name(value)
            if cname == "cls" and self.f.cls is not None:
                self.ctor_locals[targets[0].id] = self.f.cls.name
            elif cname and cname in self.registry:
                self.ctor_locals[targets[0].id] = cname
            # local snapshot of a guarded read OUTSIDE the lock:
            # feeds the toctou variable-mediated pattern
            fields = {_self_field(n) for n in ast.walk(value)
                      if _self_field(n)}
            fields.discard(None)
            if fields and isinstance(targets[0], ast.Name):
                own = (self.f.cls.lock_keys if self.f.cls else set())
                if not (held & own):
                    self.f.outside_reads.setdefault(
                        targets[0].id, set()).update(fields)

    def _mutation_target(self, t, held, line):
        """self.f = / self.f[k] = / del self.f[k] style mutations."""
        field = _self_field(t)
        if field is None and isinstance(t, ast.Subscript):
            field = _self_field(t.value)
        if field is None and isinstance(t, (ast.Tuple, ast.List)):
            for el in t.elts:
                self._mutation_target(el, held, line)
            return
        if field is not None:
            self.f.mutations.append(_Fact(
                line=line, held=held, field=field,
                in_init=self.f.is_init))

    # -- iteration facts ----------------------------------------------

    def _iter_field(self, expr):
        """'f' when expr iterates ``self.f`` (or its .items()/
        .values()/.keys()) directly, else None."""
        field = _self_field(expr)
        if field is not None:
            return field
        if isinstance(expr, ast.Call) and not expr.args \
                and isinstance(expr.func, ast.Attribute) \
                and expr.func.attr in ("items", "values", "keys"):
            return _self_field(expr.func.value)
        return None

    def _iteration(self, expr, held, line):
        field = self._iter_field(expr)
        if field is not None:
            self.f.iterations.append(_Fact(
                line=line, held=held, field=field,
                in_init=self.f.is_init))

    # -- expressions ---------------------------------------------------

    def expr(self, e, held, top_iter=False):
        if e is None:
            return
        for node in ast.walk(e):
            if isinstance(node, ast.Call):
                self._call(node, held)
            elif isinstance(node, (ast.GeneratorExp, ast.ListComp,
                                   ast.SetComp, ast.DictComp)):
                for comp in node.generators:
                    self._iteration(comp.iter, held,
                                    getattr(comp.iter, "lineno",
                                            node.lineno))

    def _call(self, node, held):
        f = node.func
        # snapshot wrappers sanction a direct field iteration
        if isinstance(f, ast.Name) and f.id in SNAPSHOT_FUNCS \
                and node.args:
            field = self._iter_field(node.args[0])
            if field is not None:
                # drop the matching iteration fact if a comprehension
                # walk already recorded it (list(self.f) is the
                # sanctioned snapshot, not a violation)
                self.f.iterations = [
                    it for it in self.f.iterations
                    if not (it.field == field
                            and it.line == getattr(node.args[0],
                                                   "lineno",
                                                   node.lineno))]
                return
        # min()/max()/sum()/any()/all() over a raw guarded field are
        # iterations too
        if isinstance(f, ast.Name) \
                and f.id in ("min", "max", "sum", "any", "all"):
            for a in node.args:
                self._iteration(a, held, node.lineno)
        if isinstance(f, ast.Attribute):
            # container-mutator on a self field
            field = _self_field(f.value)
            if field is not None and f.attr in MUTATOR_METHODS:
                self.f.mutations.append(_Fact(
                    line=node.lineno, held=held, field=field,
                    in_init=self.f.is_init))
            # explicit lock.acquire()
            if f.attr == "acquire":
                key = self._lock_key_of(f.value)
                if key is not None:
                    self.f.acquisitions.append(_Fact(
                        line=node.lineno, held=held, field=key))
            # call-graph facts for lock-order
            if isinstance(f.value, ast.Name):
                base = f.value.id
                if base == "self":
                    self.f.calls.append(_Fact(
                        line=node.lineno, held=held,
                        extra=("self", f.attr, None)))
                    self.f.self_call_sites.setdefault(
                        f.attr, []).append((held, self.f.name))
                else:
                    cname = self.ctor_locals.get(base)
                    self.f.calls.append(_Fact(
                        line=node.lineno, held=held,
                        extra=("name", f.attr, cname)))
            elif _self_field(f.value) is not None:
                self.f.calls.append(_Fact(
                    line=node.lineno, held=held,
                    extra=("attr", f.attr, _self_field(f.value))))
        elif isinstance(f, ast.Name):
            self.f.calls.append(_Fact(
                line=node.lineno, held=held,
                extra=("func", f.id, None)))


def _collect(fm: _FileModel, registry) -> None:
    for node in fm.tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            fmodel = _FuncModel(node, None, fm.mod)
            fm.functions[node.name] = fmodel
            _Collector(fmodel, fm, registry).run()
        elif isinstance(node, ast.ClassDef):
            cm = fm.classes[node.name]
            for sub in node.body:
                if isinstance(sub, (ast.FunctionDef,
                                    ast.AsyncFunctionDef)):
                    fmodel = _FuncModel(sub, cm, fm.mod)
                    cm.methods[sub.name] = fmodel
                    _Collector(fmodel, fm, registry).run()


def _infer_lock_held_helpers(cm: _ClassModel) -> None:
    """Private helpers whose EVERY non-__init__ intra-class call site
    holds a lock inherit that lock — the documented 'caller holds
    the lock' idiom (AnswerCache._pop, LiveGraph._fresh_delta).
    Fixpoint over the intra-class call graph."""
    for _ in range(8):
        changed = False
        # name -> list of effective held sets at each call site
        sites: dict[str, list] = {}
        for m in cm.methods.values():
            if m.is_init:
                continue
            eff = m.inherited
            for name, calls in m.self_call_sites.items():
                for held, _src in calls:
                    sites.setdefault(name, []).append(held | eff)
        for name, heldsets in sites.items():
            m = cm.methods.get(name)
            if m is None or m.is_init \
                    or not name.startswith("_") \
                    or name.startswith("__"):
                continue
            common = frozenset.intersection(
                *[frozenset(h) for h in heldsets]) if heldsets \
                else frozenset()
            common = frozenset(common) & frozenset(cm.lock_keys)
            if common and common != m.inherited:
                m.inherited = frozenset(common)
                changed = True
        if not changed:
            break


def _effective(fact_held: frozenset, m: _FuncModel) -> frozenset:
    return frozenset(fact_held) | m.inherited


# ---------------------------------------------------------------------
# check: guarded-field


def _guard_map(cm: _ClassModel) -> dict[str, set]:
    """field -> set of lock keys under which it is mutated (the
    inferred lockset).  Fields touched only in __init__ don't
    count — construction is single-threaded by convention."""
    guards: dict[str, set] = {}
    for m in cm.methods.values():
        for mu in m.mutations:
            if mu.in_init:
                continue
            eff = _effective(mu.held, m)
            hit = eff & cm.lock_keys
            if hit:
                guards.setdefault(mu.field, set()).update(hit)
    # a lock attribute is never its own guarded field
    for a in cm.lock_attrs:
        guards.pop(a, None)
    return guards


def check_guarded_field(fm: _FileModel) -> list[Finding]:
    findings = []
    for cm in fm.classes.values():
        if not cm.lock_attrs:
            continue
        guards = _guard_map(cm)
        for m in cm.methods.values():
            for mu in m.mutations:
                g = guards.get(mu.field)
                if not g or mu.in_init:
                    continue
                if _effective(mu.held, m) & g:
                    continue
                if _suppressed(fm.lines, mu.line, "guarded-field"):
                    continue
                locks = ", ".join(sorted(k.split(":", 1)[1]
                                         for k in g))
                findings.append(Finding(
                    fm.path, mu.line, "guarded-field",
                    f"{cm.name}.{mu.field} is mutated under "
                    f"{locks} elsewhere but {m.name} mutates it "
                    f"with no lock held — the compact()-window bug "
                    f"class (every mutation site of a guarded "
                    f"field must hold the lock, or carry a "
                    f"justified pragma)"))
    return findings


# ---------------------------------------------------------------------
# check: snapshot-iteration


def check_snapshot_iteration(fm: _FileModel) -> list[Finding]:
    findings = []
    for cm in fm.classes.values():
        if not cm.lock_attrs:
            continue
        guards = _guard_map(cm)
        for m in cm.methods.values():
            for it in m.iterations:
                g = guards.get(it.field)
                if not g or it.in_init:
                    continue
                if not (cm.container_attrs & {it.field}
                        or it.field in guards):
                    continue
                if _effective(it.held, m) & g:
                    continue
                if _suppressed(fm.lines, it.line,
                               "snapshot-iteration"):
                    continue
                findings.append(Finding(
                    fm.path, it.line, "snapshot-iteration",
                    f"{m.name} iterates guarded container "
                    f"{cm.name}.{it.field} outside its lock with "
                    f"no list()/tuple() snapshot — the refresh_live "
                    f"collector-race class (a concurrent mutation "
                    f"mid-iteration raises or silently skips)"))
    return findings


# ---------------------------------------------------------------------
# check: toctou-gate


def _test_reads(test, guards, outside_reads) -> set:
    """Guarded fields the condition reads — directly or through a
    local previously snapshotted outside the lock."""
    fields = set()
    for n in ast.walk(test):
        f = _self_field(n)
        if f in guards:
            fields.add(f)
        if isinstance(n, ast.Name) and n.id in outside_reads:
            fields.update(outside_reads[n.id] & set(guards))
    return fields


def check_toctou_gate(fm: _FileModel) -> list[Finding]:
    findings = []
    for cm in fm.classes.values():
        if not cm.lock_attrs:
            continue
        guards = _guard_map(cm)
        if not guards:
            continue
        for m in cm.methods.values():
            if m.is_init:
                continue
            for node, held in m.if_nodes:
                eff = _effective(held, m)
                if eff & cm.lock_keys:
                    continue          # gate already under the lock
                gated = _test_reads(node.test, guards,
                                    m.outside_reads)
                if not gated:
                    continue
                hit = self_mutating_with(node, cm, guards)
                if hit is None:
                    continue
                if _suppressed(fm.lines, node.lineno, "toctou-gate"):
                    continue
                findings.append(Finding(
                    fm.path, node.lineno, "toctou-gate",
                    f"{m.name} reads guarded "
                    f"{cm.name}.{'/'.join(sorted(gated))} outside "
                    f"the lock to gate a mutation inside it (line "
                    f"{hit}) with no re-check under the lock — the "
                    f"stamp-then-admit window class (take the lock "
                    f"around read+mutate, or re-validate inside)"))
    return findings


def self_mutating_with(gate_node, cm: _ClassModel,
                       guards) -> int | None:
    """Line of a with-own-lock block inside the gate body that
    mutates a guarded field WITHOUT re-checking any guarded field
    under the lock; None when the gated mutation is safe."""
    for w in ast.walk(gate_node):
        if not isinstance(w, ast.With):
            continue
        acquires = False
        for item in w.items:
            f = _self_field(item.context_expr)
            if f in cm.lock_attrs:
                acquires = True
        if not acquires:
            continue
        mutates = rechecks = False
        for n in ast.walk(w):
            if isinstance(n, (ast.If, ast.While)) and n is not w:
                if any(_self_field(x) in guards
                       for x in ast.walk(n.test)):
                    rechecks = True
            t = None
            if isinstance(n, (ast.Assign, ast.AugAssign)):
                targets = n.targets if isinstance(n, ast.Assign) \
                    else [n.target]
                for t in targets:
                    f = _self_field(t)
                    if f is None and isinstance(t, ast.Subscript):
                        f = _self_field(t.value)
                    if f in guards:
                        mutates = True
            if isinstance(n, ast.Call) \
                    and isinstance(n.func, ast.Attribute) \
                    and n.func.attr in MUTATOR_METHODS \
                    and _self_field(n.func.value) in guards:
                mutates = True
        if mutates and not rechecks:
            return w.lineno
    return None


# ---------------------------------------------------------------------
# check: lock-order


def _build_registry(models) -> dict[str, list[_ClassModel]]:
    reg: dict[str, list[_ClassModel]] = {}
    for fm in models:
        for cm in fm.classes.values():
            reg.setdefault(cm.name, []).append(cm)
    return reg


def _method_owners(models) -> dict[str, list]:
    """method name -> [(class model, func model)] over every class
    (lock-order call-resolution fallback: unique names only)."""
    owners: dict[str, list] = {}
    for fm in models:
        for cm in fm.classes.values():
            for name, m in cm.methods.items():
                owners.setdefault(name, []).append((cm, m))
    return owners


def _resolve_call(fact, m: _FuncModel, registry, owners):
    """-> _FuncModel of the callee, or None."""
    kind, name, hint = fact.extra
    if kind == "self" and m.cls is not None:
        return m.cls.methods.get(name)
    if kind == "attr" and m.cls is not None:
        tname = m.cls.attr_types.get(hint)
        if tname:
            for cm in registry.get(tname, ()):
                if name in cm.methods:
                    return cm.methods[name]
    if kind == "name" and hint:
        for cm in registry.get(hint, ()):
            if name in cm.methods:
                return cm.methods[name]
    if kind == "func":
        return None       # module functions resolved by the caller
    # fallback: unique method name among lock-relevant classes
    if kind in ("attr", "name"):
        cands = [(cm, fn) for cm, fn in owners.get(name, ())
                 if cm.lock_attrs]
        if len(cands) == 1:
            return cands[0][1]
    return None


def check_lock_order(models) -> list[Finding]:
    registry = _build_registry(models)
    owners = _method_owners(models)
    funcs: list[tuple[_FileModel, _FuncModel]] = []
    for fm in models:
        funcs += [(fm, f) for f in fm.functions.values()]
        for cm in fm.classes.values():
            funcs += [(fm, f) for f in cm.methods.values()]
    by_model = {id(f): fm for fm, f in funcs}

    def callee_of(fact, m):
        kind, name, _hint = fact.extra
        if kind == "func":
            fm = by_model.get(id(m))
            return fm.functions.get(name) if fm else None
        return _resolve_call(fact, m, registry, owners)

    # may_acquire fixpoint over the resolved call graph
    may: dict[int, frozenset] = {
        id(f): frozenset(a.field for a in f.acquisitions)
        for _fm, f in funcs}
    for _ in range(12):
        changed = False
        for _fm, f in funcs:
            acc = set(may[id(f)])
            for c in f.calls:
                callee = callee_of(c, f)
                if callee is not None and id(callee) in may:
                    acc |= may[id(callee)]
            froz = frozenset(acc)
            if froz != may[id(f)]:
                may[id(f)] = froz
                changed = True
        if not changed:
            break

    # edges a -> b (b acquired or reachable while a held)
    edges: dict[tuple, tuple] = {}
    for fm, f in funcs:
        for a in f.acquisitions:
            for h in _effective(a.held, f):
                if h != a.field:
                    edges.setdefault((h, a.field),
                                     (fm.path, a.line, f.name))
        for c in f.calls:
            callee = callee_of(c, f)
            if callee is None:
                continue
            for h in _effective(c.held, f):
                for b in may.get(id(callee), ()):
                    if h != b:
                        edges.setdefault((h, b),
                                         (fm.path, c.line, f.name))

    # cycle detection (DFS over the lock graph)
    graph: dict[str, set] = {}
    for (a, b) in edges:
        graph.setdefault(a, set()).add(b)
        graph.setdefault(b, set())
    seen_cycles = set()
    findings = []
    line_index = {fm.path: fm.lines for fm in models}

    def dfs(start):
        stack = [(start, [start])]
        while stack:
            node, path = stack.pop()
            for nxt in graph.get(node, ()):
                if nxt == start and len(path) > 1:
                    canon = frozenset(path)
                    if canon in seen_cycles:
                        continue
                    seen_cycles.add(canon)
                    cyc = path + [start]
                    ex_path, ex_line, ex_fn = edges[(path[0],
                                                     path[1])]
                    if _suppressed(line_index.get(ex_path, []),
                                   ex_line, "lock-order"):
                        continue
                    findings.append(Finding(
                        ex_path, ex_line, "lock-order",
                        f"lock-acquisition cycle "
                        f"{' -> '.join(cyc)} (first edge in "
                        f"{ex_fn}) — a potential deadlock: two "
                        f"threads entering the cycle at different "
                        f"points wait on each other forever (the "
                        f"refresh_live/run/compact three-way class)"
                    ))
                elif nxt not in path:
                    stack.append((nxt, path + [nxt]))

    for start in sorted(graph):
        dfs(start)
    return findings


# ---------------------------------------------------------------------
# check: durable-before-visible


class _DurableState:
    __slots__ = ("dirty", "json_published")

    def __init__(self, dirty=frozenset(), json_published=False):
        self.dirty = frozenset(dirty)
        self.json_published = json_published

    def merge(self, other):
        return _DurableState(self.dirty | other.dirty,
                             self.json_published
                             or other.json_published)


def _contains_json_literal(expr) -> bool:
    return any(isinstance(n, ast.Constant)
               and isinstance(n.value, str) and ".json" in n.value
               for n in ast.walk(expr))


class _DurableWalker:
    """Statement-level abstract interpretation: track binary handles
    dirty (written, not yet fsynced) and flag visible actions
    crossed while dirty (see module docstring)."""

    def __init__(self, fm: _FileModel, fname: str, cls, findings):
        self.fm = fm
        self.fname = fname
        self.cls = cls
        self.findings = findings
        self.handles: set[str] = set()        # binary handle names
        if cls is not None:
            self.handles |= {f"self.{a}"
                             for a in cls.binary_handle_attrs}

    def flag(self, line, what):
        if _suppressed(self.fm.lines, line, "durable-before-visible"):
            return
        self.findings.append(Finding(
            self.fm.path, line, "durable-before-visible",
            f"{self.fname}: {what} with unsynced record bytes "
            f"pending — every path from a record write to a "
            f"visible action must cross os.fsync (journal/WAL/"
            f"checkpoint durable-before-visible contract)"))

    def flag_json(self, line):
        if _suppressed(self.fm.lines, line, "durable-before-visible"):
            return
        self.findings.append(Finding(
            self.fm.path, line, "durable-before-visible",
            f"{self.fname}: file write AFTER the spool json "
            f"publish — the json's presence marks a complete "
            f"pair, so it must be written LAST"))

    # -- handle tracking ----------------------------------------------

    def _handle_of(self, expr) -> str | None:
        if isinstance(expr, ast.Name) and expr.id in self.handles:
            return expr.id
        f = _self_field(expr)
        if f is not None and f"self.{f}" in self.handles:
            return f"self.{f}"
        return None

    # -- walk ----------------------------------------------------------

    def block(self, stmts, state):
        for st in stmts:
            state = self.stmt(st, state)
        return state

    def stmt(self, st, state):
        if isinstance(st, ast.With):
            for item in st.items:
                if item.optional_vars is not None \
                        and isinstance(item.optional_vars, ast.Name):
                    if _is_binary_open(item.context_expr):
                        self.handles.add(item.optional_vars.id)
                        continue
                    # rebinding a tracked name to a non-binary
                    # stream (text-mode json/manifest) drops it
                    self.handles.discard(item.optional_vars.id)
                state = self.scan_expr(item.context_expr, state)
            return self.block(st.body, state)
        if isinstance(st, ast.If):
            state = self.scan_expr(st.test, state)
            s1 = self.block(st.body, state)
            s2 = self.block(st.orelse, state)
            return s1.merge(s2)
        if isinstance(st, (ast.For, ast.While)):
            if isinstance(st, ast.For):
                state = self.scan_expr(st.iter, state)
            else:
                state = self.scan_expr(st.test, state)
            # dirty bytes carry across iterations; the json-last
            # contract is PER ITERATION (each loop pass writes a
            # fresh answer pair), so json_published resets at the
            # body entry and never leaks out of the loop
            once = self.block(st.body,
                              _DurableState(state.dirty, False))
            merged = _DurableState(state.dirty | once.dirty, False)
            twice = self.block(st.body, merged)
            dirty = merged.dirty | twice.dirty
            tail = self.block(st.orelse,
                              _DurableState(dirty,
                                            state.json_published))
            return _DurableState(dirty | tail.dirty,
                                 state.json_published
                                 or tail.json_published)
        if isinstance(st, ast.Try):
            after = self.block(st.body, state)
            worst = state.merge(after)
            for h in st.handlers:
                worst = worst.merge(self.block(h.body, worst))
            worst = worst.merge(self.block(st.orelse, after))
            return self.block(st.finalbody, worst)
        if isinstance(st, ast.Return):
            if st.value is not None:
                state = self.scan_expr(st.value, state)
            if state.dirty:
                self.flag(st.lineno, "return (visible to callers)")
            return _DurableState()
        if isinstance(st, ast.Raise):
            return _DurableState()    # error path: nothing published
        if isinstance(st, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            if st.value is not None:
                state = self.scan_expr(st.value, state)
            # f = open(path, 'ab') binds a persistent binary handle;
            # rebinding a tracked name to anything else drops it
            if isinstance(st, ast.Assign) and len(st.targets) == 1:
                t = st.targets[0]
                name = t.id if isinstance(t, ast.Name) else (
                    f"self.{_self_field(t)}"
                    if _self_field(t) is not None else None)
                if name is not None:
                    if _is_binary_open(st.value):
                        self.handles.add(name)
                    else:
                        self.handles.discard(name)
            return state
        if isinstance(st, ast.Expr):
            return self.scan_expr(st.value, state)
        # default: scan expressions, recurse into child statements
        for child in ast.iter_child_nodes(st):
            if isinstance(child, ast.expr):
                state = self.scan_expr(child, state)
        return state

    def scan_expr(self, e, state):
        if e is None:
            return state
        for node in ast.walk(e):
            if not isinstance(node, ast.Call):
                continue
            state = self._call(node, state)
        return state

    def _call(self, node, state):
        f = node.func
        attr = f.attr if isinstance(f, ast.Attribute) else None
        name = f.id if isinstance(f, ast.Name) else None
        dirty, json_pub = set(state.dirty), state.json_published

        def record_write(h):
            # a pragma AT THE WRITE SITE exempts this record stream
            # from the durability contract entirely (the spool-file
            # escape hatch: same-host IPC, journal-reconstructible)
            if json_pub:
                self.flag_json(node.lineno)
            if not _suppressed(self.fm.lines, node.lineno,
                               "durable-before-visible"):
                dirty.add(h)

        # record writes
        if attr == "write" and isinstance(f, ast.Attribute):
            h = self._handle_of(f.value)
            if h is not None:
                record_write(h)
        if attr in ("save", "savez", "savez_compressed") \
                and node.args:
            h = self._handle_of(node.args[0])
            if h is not None:
                record_write(h)
        if attr == "dump" and len(node.args) >= 2:
            h = self._handle_of(node.args[1])
            if h is not None:
                record_write(h)

        # fsync clears (the one relevant handle in this codebase;
        # matching fd expressions would be false precision)
        if attr == "fsync":
            dirty = set()

        # visible actions
        if dirty:
            if attr in ENQUEUE_NAMES:
                self.flag(node.lineno, f".{attr}() enqueue")
            elif attr in EMIT_NAMES or name in EMIT_NAMES:
                self.flag(node.lineno, "telemetry emit")
            elif attr in PUBLISH_NAMES and isinstance(f, ast.Attribute) \
                    and isinstance(f.value, ast.Name) \
                    and f.value.id == "os":
                self.flag(node.lineno, f"os.{attr} publish")
        if attr in PUBLISH_NAMES and isinstance(f, ast.Attribute) \
                and isinstance(f.value, ast.Name) \
                and f.value.id == "os" and len(node.args) >= 2:
            if json_pub:
                self.flag_json(node.lineno)
            elif _contains_json_literal(node.args[1]):
                json_pub = True
        return _DurableState(dirty, json_pub)


def check_durable_before_visible(fm: _FileModel) -> list[Finding]:
    findings = []

    def run(fmodel, cls):
        w = _DurableWalker(fm, fmodel.name, cls, findings)
        end = w.block(fmodel.node.body, _DurableState())
        if end.dirty:
            # fall-through end == implicit return
            last = fmodel.node.body[-1]
            if not _suppressed(fm.lines, last.lineno,
                               "durable-before-visible"):
                w.flag(last.lineno,
                       "function end (implicit return)")

    for f in fm.functions.values():
        run(f, None)
    for cm in fm.classes.values():
        for m in cm.methods.values():
            run(m, cm)
    return findings


# ---------------------------------------------------------------------
# driver


def _load(path: str) -> _FileModel | None:
    with open(path) as f:
        src = f.read()
    return _FileModel(path, src)


def analyze_paths(paths) -> list[Finding]:
    """Run all five checks over ``paths`` (.py files); lock-order is
    computed over the whole set at once (the cross-module graph)."""
    models = []
    findings: list[Finding] = []
    for p in paths:
        p = os.path.abspath(p)
        try:
            models.append(_load(p))
        except SyntaxError as e:
            findings.append(Finding(p, e.lineno or 1, "parse",
                                    f"syntax error: {e.msg}"))
    for fm in models:
        _prescan(fm)
    registry = _build_registry(models)
    for fm in models:
        _collect(fm, registry)
        for cm in fm.classes.values():
            _infer_lock_held_helpers(cm)
    for fm in models:
        findings += check_guarded_field(fm)
        findings += check_snapshot_iteration(fm)
        findings += check_toctou_gate(fm)
        findings += check_durable_before_visible(fm)
    findings += check_lock_order(models)
    findings.sort(key=lambda f: (f.path, f.line, f.check))
    seen, uniq = set(), []
    for f in findings:
        key = (f.path, f.line, f.check, f.message)
        if key not in seen:
            seen.add(key)
            uniq.append(f)
    return uniq


def default_paths() -> list[str]:
    base = os.path.join(REPO, "lux_tpu_torch")
    return [os.path.join(base, m) for m in HOST_MODULES
            if os.path.isfile(os.path.join(base, m))]


def run_lockcheck(paths=None, mode: str = "error") -> list[Finding]:
    """Library entry: analyze and either return the findings
    (``mode='findings'``), print them as warnings (``'warn'``), or
    raise the typed ``LockCheckError`` of the first finding's check
    class (``'error'`` — the tier-1 gate's form)."""
    if mode not in ("error", "warn", "findings"):
        raise ValueError(f"unknown lockcheck mode {mode!r}; choose "
                         f"error|warn|findings")
    findings = analyze_paths(paths if paths is not None
                             else default_paths())
    if not findings:
        return []
    if mode == "warn":
        for f in findings:
            print(f"lockcheck warning: {f}", file=sys.stderr)
        return findings
    if mode == "error":
        first = findings[0]
        raise LockCheckError(
            first.check,
            "\n".join(str(f) for f in findings),
            findings)
    return findings


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="host-concurrency & durability static analyzer "
                    "(guarded-field, lock-order, "
                    "durable-before-visible, snapshot-iteration, "
                    "toctou-gate)")
    ap.add_argument("paths", nargs="*", default=None,
                    help="files to check (default: the threaded "
                         "host modules)")
    ap.add_argument("-q", action="store_true", dest="quiet")
    args = ap.parse_args(argv)
    paths = args.paths or default_paths()
    findings = analyze_paths(paths)
    for f in findings:
        print(str(f), file=sys.stderr)
    if findings:
        print(f"lockcheck: {len(findings)} finding(s) — FAILED",
              file=sys.stderr)
        return 1
    if not args.quiet:
        print(f"lockcheck: clean ({len(paths)} module(s), "
              f"checks: {', '.join(CHECKS)})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
