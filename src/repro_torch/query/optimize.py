"""Rule-based logical optimization.

All rewrites are **count-preserving**: every optimized plan produces counts
bit-identical to naive left-to-right evaluation of the original chain.

Rules (this slice has no materializing ops, so the chain is one segment):

* **window fusion** — ``Window(a,b) ∧ Window(c,d) → Window(max(a,c),
  min(b,d))`` (pair-endpoint masks AND together, so the intersection is
  exact); every empty window — fused or phrased directly — normalizes to
  the one canonical :data:`~repro_torch.query.ast.EMPTY_WINDOW`, so
  equivalent empty queries share a cache key and backends short-circuit to
  zeros;
* **activity-predicate intersection** — consecutive ``Activities`` filters
  intersect their keep-sets;
* **view composition** — ``ApplyView ∘ ApplyView`` collapses to one
  projection (group partitions compose; HIDDEN absorbs);
* **canonical ordering** — the chain is normalized to
  ``[Window?, Activities?, ApplyView?]``.  Pure predicates commute with each
  other and with the projection, so reordering is free — and it makes the
  plan key insensitive to the order the analyst happened to chain calls in
  (better cache hit rate);
* **no-op elimination** — infinite windows and keep-everything filters drop
  (needs the source schema, hence the ``activity_names`` argument).

Physical pushdowns (row-range dicing into :class:`MemmapLog`'s chunk time
index, fused kernel dicing, view-below-count relabeling, activity filters as
output masks) are decided by :mod:`repro_torch.query.planner` on top of the
canonical plan produced here.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

from repro_torch.core.views import HIDDEN

from .ast import (
    EMPTY_WINDOW,
    Activities,
    ApplyView,
    LogicalPlan,
    QueryPlanError,
    Window,
)

__all__ = ["canonicalize", "compose_views"]


def compose_views(first: ApplyView, second: ApplyView) -> ApplyView:
    """``second ∘ first`` as a single raw→group projection.

    A raw activity hidden at either stage is hidden in the composition;
    otherwise it lands on ``second``'s label for ``first``'s label.  Group
    *order* (first appearance over the raw vocabulary) is preserved, so the
    composed projection yields the same matrix as staged application.
    """
    m2 = dict(second.mapping)

    def lift(label: str) -> str:
        if label == HIDDEN:
            return HIDDEN
        return m2.get(label, second.default)

    mapping = {a: lift(l1) for a, l1 in first.mapping}
    return ApplyView(
        mapping=tuple(sorted(mapping.items())), default=lift(first.default)
    )


def canonicalize(
    plan: LogicalPlan, activity_names: Optional[Sequence[str]] = None
) -> Tuple[LogicalPlan, List[str]]:
    """Return (canonical plan, list of applied rewrites)."""
    notes: List[str] = []
    window: Optional[Window] = None
    acts: Optional[Tuple[str, ...]] = None
    view: Optional[ApplyView] = None
    for op in plan.ops:
        if isinstance(op, Window):
            if window is None:
                window = op
            else:
                window = window.intersect(op)
                notes.append("fuse_windows")
        elif isinstance(op, Activities):
            if view is not None:
                # after a projection "activities" would name group labels —
                # ambiguous and non-commutable.  Filter first, or hide
                # groups with a second view.
                raise QueryPlanError(
                    "activities() after view() is not supported: activity "
                    "filters name raw activities; apply them before the view"
                )
            keep = tuple(sorted(set(op.keep)))
            if acts is None:
                acts = keep
            else:
                acts = tuple(sorted(set(acts) & set(keep)))
                notes.append("intersect_activity_filters")
        elif isinstance(op, ApplyView):
            if view is None:
                view = op
            else:
                view = compose_views(view, op)
                notes.append("compose_views")
        else:
            raise QueryPlanError(f"unknown op {op!r}")

    ops: List = []
    if window is not None:
        if window.t0 == -math.inf and window.t1 == math.inf:
            notes.append("drop_infinite_window")
        else:
            if window.empty and window != EMPTY_WINDOW:
                notes.append("normalize_empty_window")
            ops.append(window.normalized())
    if acts is not None:
        # drop only an exact keep-everything filter; a superset contains
        # unknown names and must reach the executor's validation
        if activity_names is not None and set(acts) == set(activity_names):
            notes.append("drop_keep_all_filter")
        else:
            ops.append(Activities(acts))
    if view is not None:
        ops.append(view)
    out = LogicalPlan(plan.source, tuple(ops), plan.sink)
    if out.ops != plan.ops:
        notes.append("canonical_order")
    return out, notes
