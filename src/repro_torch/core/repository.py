"""Event repository (Definition 1 of Jalali 2020) in two isomorphic forms.

The paper stores logs in a graph database as nodes ``N = L ∪ T ∪ E ∪ A`` with
relations ``R = L×T ∪ T×E ∪ E×E ∪ E×A``.  We keep:

* :class:`GraphRepo` — the *literal* formalization: explicit node sets and a
  relation set.  Used for small inputs, the paper's worked example, soundness
  checking in the paper's exact terms, and property tests.

* :class:`EventRepository` — the scalable **columnar** form (struct of
  arrays): relations are aligned integer columns instead of pointers.  The
  columns live on the host as numpy arrays; the heavy computation
  (Algorithm 1 / DFG) copies the pair columns onto the card and counts
  there (:mod:`repro_torch.core.dfg`).

The two forms convert losslessly in both directions for sound repositories.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

__all__ = [
    "GraphRepo",
    "EventRepository",
    "paper_example_repo",
]


# ---------------------------------------------------------------------------
# Literal graph form (Definition 1)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class GraphRepo:
    """``G = (N = L ∪ T ∪ E ∪ A, R)`` with explicit node/relation sets.

    Node identity is a string; the four subsets must be disjoint.  Relations
    are ordered pairs of node ids.
    """

    logs: Set[str]
    traces: Set[str]
    events: Set[str]
    attributes: Set[str]
    relations: Set[Tuple[str, str]]

    # -- the paper's two neighborhood operators ---------------------------
    def preset(self, n: str) -> Set[str]:
        """``•n`` — nodes with a relation *into* ``n``."""
        return {a for (a, b) in self.relations if b == n}

    def postset(self, n: str) -> Set[str]:
        """``n•`` — nodes with a relation *from* ``n``."""
        return {b for (a, b) in self.relations if a == n}

    # -- structural helpers ------------------------------------------------
    @property
    def nodes(self) -> Set[str]:
        return self.logs | self.traces | self.events | self.attributes

    def relation_classes(self) -> Dict[str, Set[Tuple[str, str]]]:
        """Split R into the four classes of Definition 1."""
        out: Dict[str, Set[Tuple[str, str]]] = {
            "LT": set(),
            "TE": set(),
            "EE": set(),
            "EA": set(),
            "other": set(),
        }
        for a, b in self.relations:
            if a in self.logs and b in self.traces:
                out["LT"].add((a, b))
            elif a in self.traces and b in self.events:
                out["TE"].add((a, b))
            elif a in self.events and b in self.events:
                out["EE"].add((a, b))
            elif a in self.events and b in self.attributes:
                out["EA"].add((a, b))
            else:
                out["other"].add((a, b))
        return out

    def well_formed(self) -> bool:
        """Definition 1 structural constraints (disjoint subsets, R classes)."""
        subsets = [self.logs, self.traces, self.events, self.attributes]
        for i in range(len(subsets)):
            for j in range(i + 1, len(subsets)):
                if subsets[i] & subsets[j]:
                    return False
        return not self.relation_classes()["other"]

    # -- conversion ---------------------------------------------------------
    def to_columnar(self) -> "EventRepository":
        """Convert a *sound* GraphRepo to the columnar form.

        Event order within a trace follows the E×E successor chain (the
        repository has no timestamps in the formal model, so synthetic
        times 0,1,2,… are assigned along each chain).
        """
        classes = self.relation_classes()
        log_names = sorted(self.logs)
        trace_names = sorted(self.traces)
        act_names = sorted(self.attributes)
        log_idx = {n: i for i, n in enumerate(log_names)}
        trace_idx = {n: i for i, n in enumerate(trace_names)}
        act_idx = {n: i for i, n in enumerate(act_names)}

        trace_of_event: Dict[str, str] = {}
        for t, e in classes["TE"]:
            trace_of_event[e] = t
        act_of_event: Dict[str, str] = {}
        for e, a in classes["EA"]:
            act_of_event[e] = a
        succ: Dict[str, str] = {}
        has_pred: Set[str] = set()
        for e1, e2 in classes["EE"]:
            succ[e1] = e2
            has_pred.add(e2)

        trace_log = np.zeros(len(trace_names), dtype=np.int32)
        for l, t in classes["LT"]:
            trace_log[trace_idx[t]] = log_idx[l]

        ev_act: List[int] = []
        ev_trace: List[int] = []
        ev_time: List[float] = []
        ev_names: List[str] = []
        for t in trace_names:
            members = [e for e in self.events if trace_of_event.get(e) == t]
            heads = [e for e in members if e not in has_pred]
            # sound repo ⇒ exactly one chain per trace (or empty trace)
            heads.sort()
            order: List[str] = []
            for h in heads:
                cur: Optional[str] = h
                while cur is not None and cur in set(members) - set(order):
                    order.append(cur)
                    cur = succ.get(cur)
            for k, e in enumerate(order):
                ev_names.append(e)
                ev_act.append(act_idx[act_of_event[e]])
                ev_trace.append(trace_idx[t])
                ev_time.append(float(k))

        return EventRepository(
            event_activity=np.asarray(ev_act, dtype=np.int32),
            event_trace=np.asarray(ev_trace, dtype=np.int32),
            event_time=np.asarray(ev_time, dtype=np.float64),
            trace_log=trace_log,
            activity_names=act_names,
            trace_names=trace_names,
            log_names=log_names,
            event_names=ev_names,
        )


# ---------------------------------------------------------------------------
# Columnar form — the scalable representation
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class EventRepository:
    """Columnar event repository (canonical form).

    Canonical invariants (established by :meth:`from_event_table`):

    * events are **trace-contiguous**: all events of a trace are adjacent;
    * within a trace, events are sorted by ``event_time`` (stable);
    * ``event_trace`` is therefore non-decreasing.

    The E×E "directly follows" relation is *implicit*: event ``i`` directly
    precedes ``i+1`` iff ``event_trace[i] == event_trace[i+1]``.  This is the
    struct-of-arrays encoding of the paper's successor pointers.
    """

    event_activity: np.ndarray  # (E,) int32 — the E×A relation
    event_trace: np.ndarray  # (E,) int32 — the T×E relation (segment ids)
    event_time: np.ndarray  # (E,) float64 — Event property (paper §4)
    trace_log: np.ndarray  # (T,) int32 — the L×T relation
    activity_names: List[str]
    trace_names: List[str]
    log_names: List[str]
    event_names: Optional[List[str]] = None

    # -- sizes --------------------------------------------------------------
    @property
    def num_events(self) -> int:
        return int(self.event_activity.shape[0])

    @property
    def num_traces(self) -> int:
        return int(self.trace_log.shape[0])

    @property
    def num_activities(self) -> int:
        return len(self.activity_names)

    @property
    def num_logs(self) -> int:
        return len(self.log_names)

    # -- construction --------------------------------------------------------
    @staticmethod
    def from_event_table(
        case_ids: Sequence,
        activities: Sequence,
        timestamps: Optional[Sequence[float]] = None,
        log_ids: Optional[Sequence] = None,
        activity_vocab: Optional[List[str]] = None,
    ) -> "EventRepository":
        """Ingest a flat event table (one row per event) and canonicalize.

        Rows may arrive in any order; they are stably sorted by
        (case, timestamp).  When ``timestamps`` is None, arrival order within
        a case is used (the paper: "events should be stored according to the
        execution order, unless we have information about execution time").
        """
        n = len(case_ids)
        if len(activities) != n:
            raise ValueError("case_ids and activities must align")
        ts = (
            np.asarray(timestamps, dtype=np.float64)
            if timestamps is not None
            else np.arange(n, dtype=np.float64)
        )
        if ts.shape[0] != n:
            raise ValueError("timestamps must align with events")

        case_arr = np.asarray([str(c) for c in case_ids])
        trace_names = sorted(set(case_arr.tolist()))
        trace_idx = {c: i for i, c in enumerate(trace_names)}
        trace_col = np.asarray([trace_idx[c] for c in case_arr], dtype=np.int32)

        act_arr = [str(a) for a in activities]
        if activity_vocab is None:
            activity_vocab = sorted(set(act_arr))
        act_idx = {a: i for i, a in enumerate(activity_vocab)}
        try:
            act_col = np.asarray([act_idx[a] for a in act_arr], dtype=np.int32)
        except KeyError as e:
            raise ValueError(f"activity {e} not in provided vocabulary") from e

        if log_ids is None:
            log_names = ["l1"]
            trace_log = np.zeros(len(trace_names), dtype=np.int32)
        else:
            log_arr = np.asarray([str(x) for x in log_ids])
            log_names = sorted(set(log_arr.tolist()))
            log_idx = {x: i for i, x in enumerate(log_names)}
            trace_log = np.zeros(len(trace_names), dtype=np.int32)
            for c, l in zip(case_arr, log_arr):
                trace_log[trace_idx[c]] = log_idx[l]

        order = np.lexsort((np.arange(n), ts, trace_col))
        return EventRepository(
            event_activity=act_col[order],
            event_trace=trace_col[order],
            event_time=ts[order],
            trace_log=trace_log,
            activity_names=list(activity_vocab),
            trace_names=trace_names,
            log_names=log_names,
        )

    @staticmethod
    def from_traces(
        traces: Sequence[Sequence[str]],
        activity_vocab: Optional[List[str]] = None,
        log_name: str = "l1",
    ) -> "EventRepository":
        """Build from a list of activity-name sequences (one per trace)."""
        cases: List[str] = []
        acts: List[str] = []
        times: List[float] = []
        for i, tr in enumerate(traces):
            for k, a in enumerate(tr):
                cases.append(f"t{i + 1}")
                acts.append(a)
                times.append(float(k))
        repo = EventRepository.from_event_table(
            cases, acts, times, activity_vocab=activity_vocab
        )
        repo.log_names = [log_name]
        return repo

    # -- paper operators on the columnar form --------------------------------
    def events_of_activity(self, activity: str) -> np.ndarray:
        """``•a`` for an attribute node — indices of events executing it."""
        a = self.activity_names.index(activity)
        return np.nonzero(self.event_activity == a)[0]

    def trace_of(self, event_index: int) -> str:
        return self.trace_names[int(self.event_trace[event_index])]

    # -- directly-follows pairs (the E×E relation, vectorized) ---------------
    def df_pairs(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Return ``(src_act, dst_act, pair_valid)`` aligned arrays.

        ``src_act[i] = activity of event i``, ``dst_act[i] = activity of
        event i+1``, valid iff both belong to the same trace.  Shape (E-1,)
        (or (0,) for empty/singleton repositories).
        """
        a = self.event_activity
        t = self.event_trace
        if a.shape[0] < 2:
            z = np.zeros((0,), dtype=np.int32)
            return z, z, np.zeros((0,), dtype=bool)
        return a[:-1], a[1:], t[:-1] == t[1:]

    def padded_pairs(
        self, multiple: int
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """df_pairs padded to a length multiple (for sharding / kernels).

        Returns (src, dst, valid, src_time, dst_time), all length
        ``ceil((E-1)/multiple) * multiple`` (min. one multiple).
        """
        src, dst, valid = self.df_pairs()
        ts = self.event_time
        st = ts[:-1] if ts.shape[0] >= 2 else np.zeros((0,), np.float64)
        dt = ts[1:] if ts.shape[0] >= 2 else np.zeros((0,), np.float64)
        n = src.shape[0]
        padded = max(multiple, ((n + multiple - 1) // multiple) * multiple)
        pad = padded - n
        src = np.pad(src, (0, pad))
        dst = np.pad(dst, (0, pad))
        valid = np.pad(valid, (0, pad))
        st = np.pad(st, (0, pad))
        dt = np.pad(dt, (0, pad))
        return src, dst, valid, st, dt

    # -- trace boundaries -----------------------------------------------------
    def trace_boundaries(self) -> Tuple[np.ndarray, np.ndarray]:
        """(start_counts, end_counts) per activity — used for discovery's
        artificial START/END transitions."""
        starts = np.zeros(self.num_activities, dtype=np.int64)
        ends = np.zeros(self.num_activities, dtype=np.int64)
        t = self.event_trace
        a = self.event_activity
        if t.shape[0] == 0:
            return starts, ends
        is_start = np.ones(t.shape[0], dtype=bool)
        is_start[1:] = t[1:] != t[:-1]
        is_end = np.ones(t.shape[0], dtype=bool)
        is_end[:-1] = t[:-1] != t[1:]
        np.add.at(starts, a[is_start], 1)
        np.add.at(ends, a[is_end], 1)
        return starts, ends

    # -- conversion back to the literal graph --------------------------------
    def to_graph(self) -> GraphRepo:
        logs = {f"log:{n}" for n in self.log_names}
        traces = {f"trace:{n}" for n in self.trace_names}
        attrs = {f"act:{n}" for n in self.activity_names}
        ev_names = self.event_names or [f"e{i + 1}" for i in range(self.num_events)]
        events = set(ev_names)
        rel: Set[Tuple[str, str]] = set()
        for ti, li in enumerate(self.trace_log):
            rel.add((f"log:{self.log_names[int(li)]}", f"trace:{self.trace_names[ti]}"))
        for i in range(self.num_events):
            rel.add((f"trace:{self.trace_names[int(self.event_trace[i])]}", ev_names[i]))
            rel.add((ev_names[i], f"act:{self.activity_names[int(self.event_activity[i])]}"))
            if i + 1 < self.num_events and self.event_trace[i] == self.event_trace[i + 1]:
                rel.add((ev_names[i], ev_names[i + 1]))
        return GraphRepo(logs=logs, traces=traces, events=events, attributes=attrs, relations=rel)


    # -- persistence (two-tier store: see core/streaming.py for memmap tier) --
    def save(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        np.save(os.path.join(path, "event_activity.npy"), self.event_activity)
        np.save(os.path.join(path, "event_trace.npy"), self.event_trace)
        np.save(os.path.join(path, "event_time.npy"), self.event_time)
        np.save(os.path.join(path, "trace_log.npy"), self.trace_log)
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump(
                {
                    "activity_names": self.activity_names,
                    "trace_names": self.trace_names,
                    "log_names": self.log_names,
                },
                f,
            )

    @staticmethod
    def load(path: str) -> "EventRepository":
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        return EventRepository(
            event_activity=np.load(os.path.join(path, "event_activity.npy")),
            event_trace=np.load(os.path.join(path, "event_trace.npy")),
            event_time=np.load(os.path.join(path, "event_time.npy")),
            trace_log=np.load(os.path.join(path, "trace_log.npy")),
            activity_names=meta["activity_names"],
            trace_names=meta["trace_names"],
            log_names=meta["log_names"],
        )

def paper_example_repo() -> EventRepository:
    """The worked example of Fig. 3: l1 = {t1: a1,a2,a3 ; t2: a2,a3,a4}."""
    return EventRepository.from_traces(
        [["a1", "a2", "a3"], ["a2", "a3", "a4"]],
        activity_vocab=["a1", "a2", "a3", "a4"],
    )
