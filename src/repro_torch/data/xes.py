"""Minimal XES / CSV event-log import-export.

XES is the IEEE standard the paper's tooling (ProM, pm4py) consumes; the
subset handled here is the one the paper's data model needs:
``concept:name`` on traces (case id) and events (activity), and
``time:timestamp``.  CSV is the pragmatic interchange format
(case, activity, timestamp columns).
"""

from __future__ import annotations

import csv
import xml.etree.ElementTree as ET
from typing import Iterable, Optional, TextIO, Tuple

import numpy as np

from repro_torch.core.repository import EventRepository

__all__ = ["write_csv", "read_csv", "write_xes", "read_xes"]


# ---------------------------------------------------------------------------
# CSV
# ---------------------------------------------------------------------------


def write_csv(repo: EventRepository, f: TextIO) -> None:
    w = csv.writer(f)
    w.writerow(["case", "activity", "timestamp"])
    for i in range(repo.num_events):
        w.writerow([
            repo.trace_names[int(repo.event_trace[i])],
            repo.activity_names[int(repo.event_activity[i])],
            repr(float(repo.event_time[i])),
        ])


def read_csv(f: TextIO) -> EventRepository:
    r = csv.reader(f)
    header = next(r)
    idx = {name: i for i, name in enumerate(header)}
    cases, acts, times = [], [], []
    for row in r:
        if not row:
            continue
        cases.append(row[idx["case"]])
        acts.append(row[idx["activity"]])
        times.append(float(row[idx["timestamp"]]))
    return EventRepository.from_event_table(cases, acts, times)


# ---------------------------------------------------------------------------
# XES
# ---------------------------------------------------------------------------


def write_xes(repo: EventRepository, f: TextIO) -> None:
    root = ET.Element("log", {"xes.version": "1.0"})
    # each trace's events in row order, found by one stable sort of the rows
    # by trace (not one scan of every event per trace)
    order = np.argsort(repo.event_trace, kind="stable")
    bounds = np.zeros(repo.num_traces + 1, dtype=np.int64)
    np.cumsum(
        np.bincount(repo.event_trace, minlength=repo.num_traces),
        out=bounds[1:],
    )
    for t in range(repo.num_traces):
        tr = ET.SubElement(root, "trace")
        ET.SubElement(
            tr, "string",
            {"key": "concept:name", "value": repo.trace_names[t]},
        )
        for i in order[bounds[t]:bounds[t + 1]].tolist():
            ev = ET.SubElement(tr, "event")
            ET.SubElement(ev, "string", {
                "key": "concept:name",
                "value": repo.activity_names[int(repo.event_activity[i])],
            })
            ET.SubElement(ev, "float", {
                "key": "time:timestamp",
                "value": repr(float(repo.event_time[i])),
            })
    f.write(ET.tostring(root, encoding="unicode"))


def read_xes(f: TextIO) -> EventRepository:
    root = ET.parse(f).getroot()
    cases, acts, times = [], [], []
    seq = 0.0
    for tr in root.iter("trace"):
        case = "<unnamed>"
        for attr in tr:
            if attr.tag == "string" and attr.get("key") == "concept:name":
                case = attr.get("value")
        for ev in tr.iter("event"):
            act: Optional[str] = None
            ts: Optional[float] = None
            for attr in ev:
                if attr.get("key") == "concept:name":
                    act = attr.get("value")
                if attr.get("key") == "time:timestamp":
                    ts = float(attr.get("value"))
            if act is None:
                continue
            seq += 1.0
            cases.append(case)
            acts.append(act)
            times.append(ts if ts is not None else seq)
    return EventRepository.from_event_table(cases, acts, times)
