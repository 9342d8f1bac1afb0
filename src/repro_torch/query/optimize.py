"""Rule-based logical optimization.

All rewrites are **count-preserving**: every optimized plan produces counts
bit-identical to naive left-to-right evaluation of the original chain.

Rules, applied per segment between materialization barriers
(:func:`repro_torch.query.ast.is_barrier` ops fix an intermediate
repository, so predicates must not cross them):

* **window fusion** — ``Window(a,b) ∧ Window(c,d) → Window(max(a,c),
  min(b,d))`` (pair-endpoint masks AND together, so the intersection is
  exact); every empty window — fused or phrased directly — normalizes to
  the one canonical :data:`~repro_torch.query.ast.EMPTY_WINDOW`, so
  equivalent empty queries share a cache key and backends short-circuit to
  zeros;
* **activity-predicate intersection** — consecutive paper-semantics
  ``Activities`` filters intersect their keep-sets;
* **view composition** — ``ApplyView ∘ ApplyView`` collapses to one
  projection (group partitions compose; HIDDEN absorbs);
* **canonical ordering** — each segment is normalized to
  ``[Window?, Activities?, ApplyView?]``.  Pure predicates commute with each
  other and with the projection, so reordering is free — and it makes the
  plan key insensitive to the order the analyst happened to chain calls in
  (better cache hit rate);
* **no-op elimination** — infinite windows and keep-everything filters drop
  (needs the source schema, hence the ``activity_names`` argument).

The same canonical form is count-preserving under the conformance sinks'
**sequence semantics** (fitness / alignments re-link survivors instead of
masking pairs): dicing events by two windows in either order keeps exactly
the events inside the intersection, keep-sets intersect identically, and
composed views project each event once.

Over a union source, :func:`distribute_over_union` splits the canonical
plan into the ops each branch runs and the ops the merge runs.

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
    Op,
    QueryPlanError,
    Window,
    is_barrier,
)

__all__ = ["canonicalize", "compose_views", "distribute_over_union"]


def distribute_over_union(plan: LogicalPlan) -> Tuple[Tuple[Op, ...], Tuple[Op, ...]]:
    """Split a canonical **barrier-free** plan into ``(branch_ops,
    merge_ops)`` for a union source.

    The rewrite is count-preserving because every op in scope is either

    * a :class:`Window` — a pair-endpoint predicate.  Pairs never span
      branches (traces belong to exactly one log), so filtering each branch
      and summing equals filtering the concatenation: the window is
      **pushed into every branch** (where it keeps the branch's own
      row-range / fused-kernel pushdowns);
    * an :class:`Activities` pair predicate or an :class:`ApplyView`
      projection — both are *linear* in Ψ (an output mask, resp.
      ``Gᵀ Ψ G``), so they commute with the union sum and run **once at the
      merge**, on the aligned union vocabulary.  Branch entries then stay
      reusable as plain single-log scans.

    Materializing ops (:func:`is_barrier`) do not distribute — top-k
    variants of a union is not the union of per-branch top-k — and are
    routed to the materialized-concatenation path by the planner.

    Topology sinks (process map / neighborhood) ride the same split: their
    branch sub-queries count plain Ψ (plus per-branch histograms for node
    significance), and the significance filter / BFS runs once at the
    merge on the aligned union matrix.
    """
    if plan.has_barrier():
        raise QueryPlanError(
            "materializing ops do not distribute over a union"
        )
    branch = tuple(op for op in plan.ops if isinstance(op, Window))
    merge = tuple(op for op in plan.ops if not isinstance(op, Window))
    return branch, merge


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


def _canonical_segment(
    seg: List[Op], activity_names: Optional[Sequence[str]], notes: List[str]
) -> List[Op]:
    window: Optional[Window] = None
    acts: Optional[Tuple[str, ...]] = None
    view: Optional[ApplyView] = None
    for op in seg:
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

    out: List[Op] = []
    if window is not None:
        if window.t0 == -math.inf and window.t1 == math.inf:
            notes.append("drop_infinite_window")
        else:
            if window.empty and window != EMPTY_WINDOW:
                notes.append("normalize_empty_window")
            out.append(window.normalized())
    if acts is not None:
        # drop only an exact keep-everything filter; a superset contains
        # unknown names and must reach the executor's validation
        if activity_names is not None and set(acts) == set(activity_names):
            notes.append("drop_keep_all_filter")
        else:
            out.append(Activities(acts, relink=False))
    if view is not None:
        out.append(view)
    return out


def canonicalize(
    plan: LogicalPlan, activity_names: Optional[Sequence[str]] = None
) -> Tuple[LogicalPlan, List[str]]:
    """Return (canonical plan, list of applied rewrites)."""
    notes: List[str] = []
    ops: List[Op] = []
    seg: List[Op] = []
    for op in plan.ops:
        if is_barrier(op):
            ops.extend(_canonical_segment(seg, activity_names, notes))
            seg = []
            ops.append(op)
            # after a barrier the vocabulary is unchanged (filters keep the
            # full activity_names list), so the schema stays valid
        else:
            seg.append(op)
    ops.extend(_canonical_segment(seg, activity_names, notes))
    out = LogicalPlan(plan.source, tuple(ops), plan.sink)
    if out.ops != plan.ops:
        notes.append("canonical_order")
    return out, notes
