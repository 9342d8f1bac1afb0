"""lock-discipline: protected state is only touched under its lock.

The engine's concurrency contract is conventional, not typed: a class owns
a lock attribute, every mutation of the state that lock protects happens
inside ``with self.<lock>:``, helpers that require the caller to hold the
lock carry a ``_locked`` suffix, and nothing slow runs while holding a
lock.  This rule machine-checks the convention per class:

* **lock attributes** — anything assigned ``threading.Lock()`` /
  ``RLock()`` / ``make_lock(...)``, or used as ``with self.<attr>:`` where
  the name looks like a lock (``*lock*`` / ``*_mu``);
* **protected attributes** — inferred as every ``self`` attribute mutated
  inside a ``with self.<lock>:`` block anywhere in the class, plus any
  attribute whose ``__init__`` assignment carries a ``# guarded by <lock>``
  comment (the explicit spelling for state whose *only* mutation site is
  the suspect one — inference alone cannot see those);
* **findings** — mutations of protected attributes outside a lock scope
  (``__init__``, ``__del__`` and ``*_locked`` methods are exempt),
  blocking calls (``open``, ``sleep``, ``wait``, subprocess/filesystem)
  while holding a lock, and statically inverted acquisition orders between
  nested ``with`` scopes.

Messages carry class.method + attribute, not line numbers, so baseline
identities survive unrelated edits.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, Iterable, List, Optional, Set, Tuple

from ..astutil import mutation_targets
from ..framework import Finding, Project, rule

RULE = "lock-discipline"

LOCK_FACTORIES = (
    "threading.Lock", "threading.RLock", "make_lock", "lockdep.make_lock",
)
_LOCKISH = re.compile(r"(^|_)(lock|mu|mutex)($|_)|lock", re.IGNORECASE)
_GUARDED = re.compile(r"self\.(\w+)[^#\n]*#\s*guarded by (\w+)")

#: calls that block or do I/O — forbidden while holding an engine lock
BLOCKING_NAMES = {"open", "input"}
BLOCKING_ATTRS = {"sleep", "wait"}
BLOCKING_DOTTED = {
    "os.makedirs", "os.remove", "os.replace", "os.rename", "os.fsync",
    "np.save", "np.load", "numpy.save", "numpy.load",
    "json.dump", "json.load",
    "time.sleep",
}
BLOCKING_PREFIXES = ("subprocess.", "shutil.", "requests.", "urllib.")

EXEMPT_METHODS = ("__init__", "__del__")


def _dotted(node: ast.AST) -> Optional[str]:
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _with_lock_attr(expr: ast.AST, lock_attrs: Set[str]) -> Optional[str]:
    """``with self.<attr>:`` → attr, when attr is a known/lockish lock."""
    if (
        isinstance(expr, ast.Attribute)
        and isinstance(expr.value, ast.Name)
        and expr.value.id == "self"
    ):
        if expr.attr in lock_attrs or _LOCKISH.search(expr.attr):
            return expr.attr
    return None


def _lock_attrs(cls: ast.ClassDef) -> Set[str]:
    attrs: Set[str] = set()
    for node in ast.walk(cls):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
            fname = _dotted(node.value.func)
            if fname in LOCK_FACTORIES:
                for t in node.targets:
                    if (
                        isinstance(t, ast.Attribute)
                        and isinstance(t.value, ast.Name)
                        and t.value.id == "self"
                    ):
                        attrs.add(t.attr)
        elif isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                got = _with_lock_attr(item.context_expr, attrs)
                if got:
                    attrs.add(got)
    return attrs


def _annotated_guards(cls: ast.ClassDef, source_lines: List[str]) -> Set[str]:
    """Attributes annotated ``# guarded by <lock>`` inside the class."""
    end = getattr(cls, "end_lineno", None) or cls.lineno
    out: Set[str] = set()
    for line in source_lines[cls.lineno - 1:end]:
        m = _GUARDED.search(line)
        if m:
            out.add(m.group(1))
    return out


_SIMPLE = (ast.Assign, ast.AnnAssign, ast.AugAssign, ast.Delete, ast.Expr,
           ast.Return, ast.Raise, ast.Assert)


class _ClassScan:
    def __init__(self, cls_name: str, lock_attrs: Set[str]):
        self.cls_name = cls_name
        self.lock_attrs = lock_attrs
        #: (attr, method, line, held) for every self-attr mutation
        self.mutations: List[Tuple[str, str, int, frozenset]] = []
        #: (outer, inner, method, line) nested lock acquisitions
        self.nestings: List[Tuple[str, str, str, int]] = []
        #: (dotted_call, method, line, lock) blocking calls under a lock
        self.blocking: List[Tuple[str, str, int, str]] = []

    def scan_method(self, method: ast.FunctionDef) -> None:
        self._scan(method.body, frozenset(), method.name)

    def _scan(self, stmts: Iterable[ast.stmt], held: frozenset, m: str) -> None:
        for s in stmts:
            if isinstance(s, (ast.With, ast.AsyncWith)):
                got = set()
                for item in s.items:
                    attr = _with_lock_attr(item.context_expr, self.lock_attrs)
                    if attr:
                        got.add(attr)
                        for h in held:
                            if h != attr:
                                self.nestings.append((h, attr, m, s.lineno))
                    elif held:
                        # `with open(...)` while holding a lock is itself I/O
                        self._scan_blocking(item.context_expr, held, m)
                self._scan(s.body, held | frozenset(got), m)
            elif isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.ClassDef)):
                continue  # closures: conservative, out of scope
            elif isinstance(s, _SIMPLE):
                for attr, node in mutation_targets(s):
                    self.mutations.append((attr, m, node.lineno, held))
                if held:
                    self._scan_blocking(s, held, m)
            elif isinstance(s, ast.If):
                self._scan(s.body, held, m)
                self._scan(s.orelse, held, m)
            elif isinstance(s, (ast.For, ast.AsyncFor, ast.While)):
                self._scan(s.body, held, m)
                self._scan(s.orelse, held, m)
            elif isinstance(s, ast.Try):
                self._scan(s.body, held, m)
                for h in s.handlers:
                    self._scan(h.body, held, m)
                self._scan(s.orelse, held, m)
                self._scan(s.finalbody, held, m)
            elif hasattr(s, "body") and isinstance(getattr(s, "body"), list):
                self._scan(s.body, held, m)  # match statements etc.

    def _scan_blocking(self, stmt: ast.stmt, held: frozenset, m: str) -> None:
        for node in ast.walk(stmt):
            if not isinstance(node, ast.Call):
                continue
            dotted = _dotted(node.func)
            bad = False
            if isinstance(node.func, ast.Name) and node.func.id in BLOCKING_NAMES:
                bad = True
            elif isinstance(node.func, ast.Attribute):
                if node.func.attr in BLOCKING_ATTRS:
                    bad = True
                elif dotted is not None and (
                    dotted in BLOCKING_DOTTED
                    or dotted.startswith(BLOCKING_PREFIXES)
                ):
                    bad = True
            if bad:
                self.blocking.append(
                    (dotted or "open", m, node.lineno, sorted(held)[0])
                )


@rule(
    RULE,
    "lock-protected state is only mutated under its lock; no blocking "
    "calls or inverted acquisition orders while holding one",
)
def check_lock_discipline(project: Project):
    #: (cls, outer) → (inner, path, method) for the global inversion check
    order_edges: Dict[Tuple[str, str], List[Tuple[str, str, str]]] = {}
    findings: List[Finding] = []
    emitted: Set[str] = set()

    def emit(path, line, message):
        f = Finding(RULE, project.rel(path), line, message)
        if f.identity() not in emitted:
            emitted.add(f.identity())
            findings.append(f)

    for path in project.iter_pkg("**/*.py"):
        try:
            tree = project.tree(path)
        except SyntaxError:
            continue
        source_lines = project.source(path).splitlines()
        for cls in [n for n in tree.body if isinstance(n, ast.ClassDef)]:
            lock_attrs = _lock_attrs(cls)
            if not lock_attrs:
                continue
            scan = _ClassScan(cls.name, lock_attrs)
            methods = [
                n for n in cls.body
                if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
            ]
            for method in methods:
                scan.scan_method(method)

            # protected = inferred (mutated under some lock) + annotated
            protected: Set[str] = set()
            for attr, _m, _line, held in scan.mutations:
                if held and attr not in lock_attrs:
                    protected.add(attr)
            protected |= _annotated_guards(cls, source_lines) - lock_attrs

            for attr, m, line, held in scan.mutations:
                if attr not in protected or held:
                    continue
                if m in EXEMPT_METHODS or m.endswith("_locked"):
                    continue
                emit(
                    path, line,
                    f"{cls.name}.{m}: mutation of lock-protected attribute "
                    f"'{attr}' outside a 'with self.<lock>' scope",
                )
            for dotted, m, line, lock in scan.blocking:
                emit(
                    path, line,
                    f"{cls.name}.{m}: blocking call {dotted}() while "
                    f"holding 'self.{lock}'",
                )
            for outer, inner, m, line in scan.nestings:
                order_edges.setdefault((cls.name, outer), []).append(
                    (inner, project.rel(path), m)
                )

    for (cls_name, outer), inners in sorted(order_edges.items()):
        for inner, rel_path, m in inners:
            rev = order_edges.get((cls_name, inner), [])
            if any(i == outer for i, _p, _m in rev):
                emit(
                    project.root / rel_path, 1,
                    f"{cls_name}: inconsistent lock order — both "
                    f"'{outer}' → '{inner}' and '{inner}' → '{outer}' "
                    "nestings exist (potential deadlock)",
                )
    return findings
