"""Soundness (Definition 2 of the paper) for both repository forms.

A repository is sound iff:
  S1. every trace belongs to exactly one log          (|•t| = 1)
  S2. every event belongs to exactly one trace        (|•e ∩ T| = 1)
  S3. every event has at most one incoming E×E flow   (|•e ∩ E| ≤ 1)
  S4. every event has at most one outgoing E×E flow   (|e• ∩ E| ≤ 1)
  S5. every event has exactly one activity attribute  (|e• ∩ A| = 1)
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from .repository import EventRepository, GraphRepo

__all__ = ["SoundnessReport", "check_graph", "check_columnar", "is_sound"]


@dataclasses.dataclass
class SoundnessReport:
    ok: bool
    violations: List[str]

    def __bool__(self) -> bool:  # pragma: no cover - convenience
        return self.ok


def check_graph(g: GraphRepo) -> SoundnessReport:
    """Literal Definition 2 on the explicit graph form."""
    v: List[str] = []
    if not g.well_formed():
        v.append("not well-formed per Definition 1 (overlapping subsets or stray relations)")
    for t in sorted(g.traces):
        n = len(g.preset(t) & g.logs)
        if n != 1:
            v.append(f"S1: trace {t} belongs to {n} logs (must be 1)")
    for e in sorted(g.events):
        pre = g.preset(e)
        post = g.postset(e)
        nt = len(pre & g.traces)
        if nt != 1:
            v.append(f"S2: event {e} belongs to {nt} traces (must be 1)")
        ne_in = len(pre & g.events)
        if ne_in > 1:
            v.append(f"S3: event {e} has {ne_in} incoming E×E flows (max 1)")
        ne_out = len(post & g.events)
        if ne_out > 1:
            v.append(f"S4: event {e} has {ne_out} outgoing E×E flows (max 1)")
        na = len(post & g.attributes)
        if na != 1:
            v.append(f"S5: event {e} has {na} activity attributes (must be 1)")
    return SoundnessReport(ok=not v, violations=v)


def check_columnar(repo: EventRepository) -> SoundnessReport:
    """Soundness + canonical-form invariants on the columnar encoding.

    S2/S5 hold *by construction* in the columnar form (each event row carries
    exactly one trace id and one activity id); what must be validated is that
    the ids are in range and the canonical invariants (trace-contiguity,
    per-trace time order) that make the implicit E×E relation well defined —
    these imply S3/S4.
    """
    v: List[str] = []
    a, t, ts = repo.event_activity, repo.event_trace, repo.event_time
    E = repo.num_events
    if a.shape != (E,) or t.shape != (E,) or ts.shape != (E,):
        v.append("column length mismatch")
        return SoundnessReport(ok=False, violations=v)
    if E and (a.min() < 0 or a.max() >= repo.num_activities):
        v.append("S5: activity id out of range")
    if E and (t.min() < 0 or t.max() >= repo.num_traces):
        v.append("S2: trace id out of range")
    if repo.num_traces and (
        repo.trace_log.min() < 0 or repo.trace_log.max() >= repo.num_logs
    ):
        v.append("S1: log id out of range")
    if repo.trace_log.shape[0] != repo.num_traces:
        v.append("S1: trace_log column must assign exactly one log per trace")
    # trace-contiguity: each trace id forms one contiguous run (⇒ S3, S4)
    if E:
        change = np.nonzero(t[1:] != t[:-1])[0]
        starts = np.concatenate([[0], change + 1])
        run_ids = t[starts]
        if len(set(run_ids.tolist())) != len(run_ids):
            v.append("S3/S4: trace ids not contiguous — implicit E×E relation ambiguous")
        # within-trace time order
        same = t[1:] == t[:-1]
        if np.any(ts[1:][same] < ts[:-1][same]):
            v.append("canonical: event_time not non-decreasing within a trace")
    return SoundnessReport(ok=not v, violations=v)


def is_sound(obj) -> bool:
    if isinstance(obj, GraphRepo):
        return check_graph(obj).ok
    if isinstance(obj, EventRepository):
        return check_columnar(obj).ok
    raise TypeError(type(obj))
