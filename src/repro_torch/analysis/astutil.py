"""Small AST helpers shared by the lint rules."""

from __future__ import annotations

import ast
from typing import Iterator, List, Optional, Set, Tuple

__all__ = [
    "dotted_name",
    "flatten_name_refs",
    "dataclass_decoration",
    "annotated_fields",
    "self_attr_root",
    "MUTATING_METHODS",
]

#: container methods that mutate their receiver in place — calling one on a
#: lock-protected attribute counts as a mutation for the lock rule
MUTATING_METHODS = frozenset({
    "append", "appendleft", "extend", "insert", "remove", "pop", "popleft",
    "popitem", "clear", "update", "setdefault", "add", "discard",
    "move_to_end", "rotate",
})


def dotted_name(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for Name/Attribute chains, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def flatten_name_refs(node: ast.AST) -> List[str]:
    """Class-name references in an ``isinstance`` second argument: a bare
    Name, an Attribute tail (``mod.DFGSink`` → ``DFGSink``), a Tuple/List of
    them, or a ``+`` concatenation of alias tuples."""
    if isinstance(node, ast.Name):
        return [node.id]
    if isinstance(node, ast.Attribute):
        return [node.attr]
    if isinstance(node, (ast.Tuple, ast.List)):
        out: List[str] = []
        for e in node.elts:
            out.extend(flatten_name_refs(e))
        return out
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
        return flatten_name_refs(node.left) + flatten_name_refs(node.right)
    return []


def dataclass_decoration(cls: ast.ClassDef) -> Optional[ast.AST]:
    """The ``dataclass`` / ``dataclasses.dataclass`` decorator node (bare or
    called), or None."""
    for dec in cls.decorator_list:
        target = dec.func if isinstance(dec, ast.Call) else dec
        name = dotted_name(target)
        if name in ("dataclass", "dataclasses.dataclass"):
            return dec
    return None


def dataclass_is_frozen(dec: ast.AST) -> bool:
    if not isinstance(dec, ast.Call):
        return False
    for kw in dec.keywords:
        if kw.arg == "frozen":
            return isinstance(kw.value, ast.Constant) and kw.value.value is True
    return False


def annotated_fields(cls: ast.ClassDef) -> List[str]:
    """Dataclass field names: class-body annotated assignments (skipping
    ClassVar annotations is unnecessary here — the plan nodes use none)."""
    out = []
    for node in cls.body:
        if isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            out.append(node.target.id)
    return out


def self_attr_root(node: ast.AST) -> Optional[str]:
    """The root attribute of a ``self.<attr>…`` access: ``self.x`` → x,
    ``self.x[k]`` → x, ``self.x.y`` → x.  None for non-self targets."""
    while isinstance(node, (ast.Subscript, ast.Attribute)):
        if (
            isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"
        ):
            return node.attr
        node = node.value
    return None


def mutation_targets(stmt: ast.AST) -> Iterator[Tuple[str, ast.AST]]:
    """Yield ``(self_attr, node)`` for every mutation of a ``self``
    attribute inside ``stmt`` (without descending into nested function or
    class definitions): assignments, augmented assignments, deletions, and
    in-place container-method calls."""
    for node in _walk_shallow(stmt):
        if isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            targets = (
                node.targets if isinstance(node, ast.Assign) else [node.target]
            )
            for t in targets:
                for leaf in _unpack(t):
                    root = self_attr_root(leaf)
                    if root is not None:
                        yield root, node
        elif isinstance(node, ast.Delete):
            for t in node.targets:
                root = self_attr_root(t)
                if root is not None:
                    yield root, node
        elif isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
            if node.func.attr in MUTATING_METHODS:
                root = self_attr_root(node.func.value)
                if root is not None:
                    yield root, node
        elif isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
            # object.__setattr__(self, "x", v) handled by the caller; here
            # cover setattr(self, "x", v)
            if (
                node.func.id == "setattr"
                and node.args
                and isinstance(node.args[0], ast.Name)
                and node.args[0].id == "self"
                and len(node.args) >= 2
                and isinstance(node.args[1], ast.Constant)
            ):
                yield str(node.args[1].value), node


def _unpack(target: ast.AST) -> Iterator[ast.AST]:
    if isinstance(target, (ast.Tuple, ast.List)):
        for e in target.elts:
            yield from _unpack(e)
    else:
        yield target


def _walk_shallow(stmt: ast.AST) -> Iterator[ast.AST]:
    """ast.walk that does not descend into nested def/class bodies."""
    stack = [stmt]
    while stack:
        node = stack.pop()
        yield node
        for child in ast.iter_child_nodes(node):
            if isinstance(
                child,
                (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef, ast.Lambda),
            ) and child is not stmt:
                continue
            stack.append(child)
