"""backend-coverage: every sink is dispatched by every physical backend.

The planner and the executor both branch on the sink's class.  A new sink
added to ``query/ast.py`` that neither file mentions would fall through
``isinstance`` ladders silently — historically the exact spot correctness
regressions hide when backends multiply.  The rule:

* collects every ``*Sink`` class defined in ``query/ast.py``;
* resolves the module's sink *aliases* — tuple aliases like
  ``TOPOLOGY_SINKS = (DFGSink, ...)`` and the ``Sink = Union[...]`` type —
  so dispatch through an alias (or a ``+``-concatenation of aliases)
  covers all members;
* scans ``query/planner.py`` and ``query/execute.py`` for the names
  referenced by ``isinstance(..., X)`` second arguments;
* reports every sink missing from either file.

Handling and *explicit rejection* look identical to this rule — both are an
``isinstance`` mention — which is exactly the invariant: the backend must
*decide* about every sink, not ignore it.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Set

from ..astutil import flatten_name_refs
from ..framework import Finding, Project, rule

AST_FILE = "query/ast.py"
BACKEND_FILES = ("query/planner.py", "query/execute.py")


def sink_classes(tree: ast.Module) -> List[str]:
    return [
        n.name
        for n in tree.body
        if isinstance(n, ast.ClassDef) and n.name.endswith("Sink")
    ]


def sink_aliases(tree: ast.Module, sinks: Set[str]) -> Dict[str, Set[str]]:
    """Module-level names that stand for groups of sink classes: tuple/list
    aliases, ``Union[...]`` aliases, and ``+``-concatenations of either."""
    aliases: Dict[str, Set[str]] = {}

    def resolve(node: ast.AST) -> Set[str]:
        out: Set[str] = set()
        if isinstance(node, (ast.Tuple, ast.List)):
            for e in node.elts:
                out |= resolve(e)
        elif isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
            out |= resolve(node.left) | resolve(node.right)
        elif isinstance(node, ast.Subscript):
            # Union[A, B, ...]
            out |= resolve(node.slice)
        elif isinstance(node, ast.Name):
            if node.id in sinks:
                out.add(node.id)
            elif node.id in aliases:
                out |= aliases[node.id]
        return out

    for node in tree.body:
        if (
            isinstance(node, ast.Assign)
            and len(node.targets) == 1
            and isinstance(node.targets[0], ast.Name)
        ):
            members = resolve(node.value)
            if members:
                aliases[node.targets[0].id] = members
    return aliases


def covered_sinks(
    tree: ast.Module, sinks: Set[str], aliases: Dict[str, Set[str]]
) -> Set[str]:
    """Sink classes mentioned by any ``isinstance`` dispatch in ``tree``
    (directly, through an alias, or through a local re-aliasing of one)."""
    local = dict(aliases)
    local.update(sink_aliases(tree, sinks))  # file-local regroupings
    covered: Set[str] = set()
    for node in ast.walk(tree):
        if (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Name)
            and node.func.id in ("isinstance", "issubclass")
            and len(node.args) == 2
        ):
            for name in flatten_name_refs(node.args[1]):
                if name in sinks:
                    covered.add(name)
                elif name in local:
                    covered |= local[name] & sinks
    return covered


@rule(
    "backend-coverage",
    "every Sink class is handled or explicitly rejected by every physical "
    "backend dispatcher",
)
def check_backend_coverage(project: Project):
    if not project.has(AST_FILE):
        return
    ast_path = project.pkg_path(AST_FILE)
    ast_tree = project.tree(ast_path)
    sinks = set(sink_classes(ast_tree))
    if not sinks:
        return
    aliases = sink_aliases(ast_tree, sinks)
    for rel in BACKEND_FILES:
        if not project.has(rel):
            continue
        path = project.pkg_path(rel)
        covered = covered_sinks(project.tree(path), sinks, aliases)
        for sink in sorted(sinks - covered):
            yield Finding(
                "backend-coverage",
                project.rel(path),
                1,
                f"sink {sink} (declared in {AST_FILE}) is neither handled "
                f"nor explicitly rejected by any isinstance dispatch in "
                f"{rel}",
            )
