"""cache-key-completeness: every plan field flows into the plan key.

The plan/result cache is keyed on ``LogicalPlan.key()`` — a hash of the
canonical payload.  A plan node carrying state that does *not* reach the
payload makes two semantically different plans collide on one cache entry:
the single worst class of bug this engine can have, and invisible to tests
that never construct the colliding pair.  Three checks on ``query/ast.py``:

1. every plan dataclass (op / sink / the plan itself) is ``frozen=True`` —
   mutable plan nodes can change after their key was computed;
2. no method grows a **non-field attribute** on a plan dataclass (via
   ``self.x = …``, ``object.__setattr__``, or ``setattr``) — such state is
   invisible to ``dataclasses.asdict`` and therefore unkeyed.  Private
   underscore attributes on the *source algebra* classes (resolution
   memos) are exempt because sources are keyed by data fingerprint, not by
   the plan payload;
3. the canonical payload covers every field: if ``_payload`` (or ``key``)
   is written in terms of ``dataclasses.asdict``/``astuple`` all fields
   flow by construction; if it reads attributes explicitly, the read set
   must cover every field of every plan dataclass.
"""

from __future__ import annotations

import ast
from typing import List, Set

from ..astutil import (
    annotated_fields,
    dataclass_decoration,
    dataclass_is_frozen,
    dotted_name,
)
from ..framework import Finding, Project, rule

AST_FILE = "query/ast.py"
RULE = "cache-key-completeness"


def plan_dataclasses(tree: ast.Module) -> List[ast.ClassDef]:
    return [
        n
        for n in tree.body
        if isinstance(n, ast.ClassDef) and dataclass_decoration(n) is not None
    ]


def _setattr_names(cls: ast.ClassDef) -> List[tuple]:
    """(attr, line) for every attribute written on ``self`` anywhere in the
    class's methods, through any spelling."""
    out = []
    for method in cls.body:
        if not isinstance(method, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        for node in ast.walk(method):
            if isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
                targets = (
                    node.targets
                    if isinstance(node, ast.Assign)
                    else [node.target]
                )
                for t in targets:
                    if (
                        isinstance(t, ast.Attribute)
                        and isinstance(t.value, ast.Name)
                        and t.value.id == "self"
                    ):
                        out.append((t.attr, node.lineno))
            elif isinstance(node, ast.Call):
                fname = dotted_name(node.func)
                if fname in ("object.__setattr__", "setattr") and (
                    len(node.args) >= 2
                    and isinstance(node.args[0], ast.Name)
                    and node.args[0].id == "self"
                    and isinstance(node.args[1], ast.Constant)
                ):
                    out.append((str(node.args[1].value), node.lineno))
    return out


def _payload_reads(tree: ast.Module):
    """``(uses_asdict, attribute_read_set)`` for the canonicalization
    function — ``_payload`` if defined, else ``key``."""
    fn = None
    for cls in tree.body:
        if not isinstance(cls, ast.ClassDef):
            continue
        for method in cls.body:
            if isinstance(method, ast.FunctionDef) and method.name == "_payload":
                fn = method
                break
        if fn is None:
            for method in cls.body:
                if isinstance(method, ast.FunctionDef) and method.name == "key":
                    fn = method
    if fn is None:
        return None
    uses_asdict = False
    reads: Set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Call):
            fname = dotted_name(node.func)
            if fname in (
                "dataclasses.asdict", "asdict",
                "dataclasses.astuple", "astuple",
            ):
                uses_asdict = True
        if isinstance(node, ast.Attribute):
            reads.add(node.attr)
    return uses_asdict, reads


@rule(
    RULE,
    "plan/op dataclasses are frozen, grow no unkeyed attributes, and every "
    "field reaches the canonical payload",
)
def check_cache_keys(project: Project):
    if not project.has(AST_FILE):
        return
    path = project.pkg_path(AST_FILE)
    tree = project.tree(path)
    rel = project.rel(path)
    classes = plan_dataclasses(tree)
    if not classes:
        return

    payload = _payload_reads(tree)
    for cls in classes:
        dec = dataclass_decoration(cls)
        if not dataclass_is_frozen(dec):
            yield Finding(
                RULE, rel, cls.lineno,
                f"plan dataclass {cls.name} is not frozen=True; mutable "
                "plan nodes can change after their cache key is computed",
            )
        fields = set(annotated_fields(cls))
        for attr, line in _setattr_names(cls):
            if attr in fields or attr.startswith("_"):
                continue  # field normalization / private memo
            yield Finding(
                RULE, rel, line,
                f"unkeyed plan field: {cls.name}.{attr} is assigned in a "
                "method but is not a dataclass field, so it never reaches "
                "the canonical payload (cache-key collision)",
            )
        if payload is not None:
            uses_asdict, reads = payload
            if not uses_asdict:
                for f in sorted(fields - reads):
                    yield Finding(
                        RULE, rel, cls.lineno,
                        f"field {cls.name}.{f} does not flow into the "
                        "canonical payload (the payload function reads "
                        "attributes explicitly and never reads it)",
                    )
