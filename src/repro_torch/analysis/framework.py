"""AST-lint framework for the engine's invariants.

The reproduction's correctness story — count-preserving rewrites, complete
cache keys, backend bit-identity, lock discipline — lives in frozen plan
dataclasses and a handful of conventions (``with self._lock`` scopes,
``_locked``-suffix helpers, ``# guarded by <lock>`` annotations).  This
module is the machinery that checks those conventions on every commit:

* :class:`Finding` — one structured violation with a **stable identity**
  (rule + file + message, *not* the line number, so baselines survive
  unrelated edits);
* a rule registry (:func:`rule`) — each rule is a function
  ``fn(project) -> Iterable[Finding]`` over a parsed :class:`Project`;
* a committed JSON **baseline** of grandfathered findings with one-line
  justifications — the CI gate fails only on findings *not* in it;
* the ``python -m repro_torch.analysis`` CLI (see ``__main__``).

Rules themselves live in :mod:`repro_torch.analysis.rules`; the runtime
lock sanitizer in :mod:`repro_torch.analysis.lockdep`; the Hopper launch
checker in :mod:`repro_torch.analysis.kernels_check`.
"""

from __future__ import annotations

import ast
import dataclasses
import hashlib
import json
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Optional, Sequence

__all__ = [
    "Finding",
    "Rule",
    "rule",
    "registered_rules",
    "Project",
    "run_rules",
    "load_baseline",
    "save_baseline",
    "split_findings",
]


# ---------------------------------------------------------------------------
# Findings
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Finding:
    """One structured violation.

    ``identity()`` deliberately excludes the line number: a baseline entry
    must keep matching its finding while unrelated edits shift the file."""

    rule: str
    path: str  # posix path relative to the project root
    line: int
    message: str

    def identity(self) -> str:
        blob = f"{self.rule}|{self.path}|{self.message}"
        return hashlib.sha256(blob.encode()).hexdigest()[:16]

    def format(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"

    def to_dict(self) -> Dict[str, object]:
        return {
            "id": self.identity(),
            "rule": self.rule,
            "path": self.path,
            "line": self.line,
            "message": self.message,
        }


# ---------------------------------------------------------------------------
# Rule registry
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Rule:
    name: str
    doc: str
    fn: Callable[["Project"], Iterable[Finding]]


_RULES: Dict[str, Rule] = {}


def rule(name: str, doc: str = ""):
    """Register a rule function under ``name`` (decorator)."""

    def deco(fn):
        _RULES[name] = Rule(name, doc or (fn.__doc__ or "").strip(), fn)
        return fn

    return deco


def registered_rules() -> Dict[str, Rule]:
    """Name → rule, loading the built-in rule modules on first use."""
    from . import rules  # noqa: F401  (imports register via @rule)

    return dict(_RULES)


# ---------------------------------------------------------------------------
# Project context
# ---------------------------------------------------------------------------


class Project:
    """Lazily-parsed view of one source tree.

    ``root`` is the repo root; the *package root* (the directory holding
    ``query/``, ``kernels/``, ...) is ``root/src/repro_torch`` when that
    exists, else ``root`` itself — which is what lets the test fixtures
    under ``tests/analysis_fixtures/`` mimic the real layout with three
    files."""

    def __init__(self, root):
        self.root = Path(root).resolve()
        pkg = self.root / "src" / "repro_torch"
        self.pkg_root = pkg if pkg.is_dir() else self.root
        self._sources: Dict[Path, str] = {}
        self._trees: Dict[Path, ast.Module] = {}

    # -- files ---------------------------------------------------------------
    def pkg_path(self, rel: str) -> Path:
        return self.pkg_root / rel

    def has(self, rel: str) -> bool:
        return self.pkg_path(rel).is_file()

    def iter_pkg(self, pattern: str) -> List[Path]:
        return sorted(p for p in self.pkg_root.glob(pattern) if p.is_file())

    def rel(self, path: Path) -> str:
        path = Path(path).resolve()
        try:
            return path.relative_to(self.root).as_posix()
        except ValueError:
            return path.as_posix()

    # -- parsing -------------------------------------------------------------
    def source(self, path: Path) -> str:
        path = Path(path)
        if path not in self._sources:
            self._sources[path] = path.read_text()
        return self._sources[path]

    def tree(self, path: Path) -> ast.Module:
        path = Path(path)
        if path not in self._trees:
            self._trees[path] = ast.parse(
                self.source(path), filename=str(path)
            )
        return self._trees[path]

    # -- findings ------------------------------------------------------------
    def finding(self, rule_name: str, path: Path, node, message: str) -> Finding:
        line = getattr(node, "lineno", node if isinstance(node, int) else 0)
        return Finding(rule_name, self.rel(path), int(line), message)


def run_rules(
    project: Project, names: Optional[Sequence[str]] = None
) -> List[Finding]:
    """Run the named rules (default: all registered) over ``project``."""
    rules = registered_rules()
    if names is None:
        selected = list(rules.values())
    else:
        unknown = sorted(set(names) - set(rules))
        if unknown:
            raise KeyError(f"unknown rules: {unknown}")
        selected = [rules[n] for n in names]
    findings: List[Finding] = []
    for r in selected:
        findings.extend(r.fn(project))
    return sorted(findings, key=lambda f: (f.path, f.line, f.rule, f.message))


# ---------------------------------------------------------------------------
# Baseline
# ---------------------------------------------------------------------------


def load_baseline(path) -> Dict[str, Dict[str, object]]:
    """Identity → entry.  A missing file is an empty baseline."""
    path = Path(path)
    if not path.is_file():
        return {}
    data = json.loads(path.read_text())
    return dict(data.get("findings", {}))


def save_baseline(
    path,
    findings: Sequence[Finding],
    justification: str = "grandfathered",
) -> None:
    entries = {
        f.identity(): {
            "rule": f.rule,
            "path": f.path,
            "message": f.message,
            "justification": justification,
        }
        for f in findings
    }
    payload = {"version": 1, "findings": dict(sorted(entries.items()))}
    Path(path).write_text(json.dumps(payload, indent=2) + "\n")


def split_findings(
    findings: Sequence[Finding], baseline: Dict[str, Dict[str, object]]
):
    """``(new, known, stale_ids)``: findings not in the baseline, findings
    covered by it, and baseline entries that no longer fire (candidates for
    deletion — the gate reports them so baselines only shrink)."""
    new: List[Finding] = []
    known: List[Finding] = []
    seen = set()
    for f in findings:
        fid = f.identity()
        if fid in baseline:
            known.append(f)
            seen.add(fid)
        else:
            new.append(f)
    stale = sorted(set(baseline) - seen)
    return new, known, stale
