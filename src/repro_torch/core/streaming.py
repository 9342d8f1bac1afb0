"""Out-of-core / streaming DFG — reproduces the paper's Claim C1.

The graph-database property the paper exploits is that DFG computation runs
*where the data lives* with bounded working memory (Neo4j pages through its
store; the analyst's RAM never needs to hold the log).  Our two-tier store:

* **Device tier** — `EventRepository` pair columns copied onto the card
  for counting (see :mod:`repro_torch.core.dfg`).
* **Host tier** — :class:`MemmapLog`, a disk-resident columnar log
  (`np.memmap` per column + a per-chunk time index).  The streaming miner
  scans it chunk-by-chunk with **O(A² + chunk + open-cases)** peak memory —
  independent of log size, which is the paper's "data much bigger than
  computational memory" scenario.

The per-chunk time index gives the paper's Experiment-2 win: a time dice
reads only the touched byte range instead of loading the full log.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

__all__ = [
    "MemmapLog",
    "MemmapLogWriter",
    "MinerState",
    "StreamingDFGMiner",
    "memmap_log_name",
    "streaming_dfg",
]


def memmap_log_name(log: "MemmapLog") -> str:
    """The log name a memmap source contributes to provenance columns and
    auto-derived union branch names: the final path component (the name the
    log was created under).  One shared rule — the query layers must agree
    on it or branch names and materialized ``log_names`` drift apart."""
    base = os.path.basename(os.path.normpath(log.path))
    return base or "memmap"


# ---------------------------------------------------------------------------
# Disk-resident columnar log
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class MemmapLog:
    """Disk-backed event log: three aligned columns + metadata + time index.

    The stream is **time-ordered** (the natural order logs are recorded in);
    traces interleave.  ``chunk_time_index`` holds (start_row, min_t, max_t)
    per fixed-size chunk so time dices map to row ranges via binary search.
    """

    path: str
    num_events: int
    num_activities: int
    num_traces: int
    chunk_rows: int

    def __post_init__(self):
        self.activity = np.memmap(
            os.path.join(self.path, "activity.i32"),
            dtype=np.int32, mode="r", shape=(self.num_events,),
        )
        self.case = np.memmap(
            os.path.join(self.path, "case.i32"),
            dtype=np.int32, mode="r", shape=(self.num_events,),
        )
        self.time = np.memmap(
            os.path.join(self.path, "time.f64"),
            dtype=np.float64, mode="r", shape=(self.num_events,),
        )

    # -- writer -------------------------------------------------------------
    @staticmethod
    def create(
        path: str,
        num_events: int,
        num_activities: int,
        num_traces: int,
        chunk_rows: int = 1 << 20,
    ) -> "MemmapLogWriter":
        return MemmapLogWriter(path, num_events, num_activities, num_traces, chunk_rows)

    @staticmethod
    def open(path: str) -> "MemmapLog":
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        return MemmapLog(
            path=path,
            num_events=meta["num_events"],
            num_activities=meta["num_activities"],
            num_traces=meta["num_traces"],
            chunk_rows=meta["chunk_rows"],
        )

    # -- reading ------------------------------------------------------------
    def iter_chunks(
        self,
        chunk_rows: Optional[int] = None,
        row_range: Optional[Tuple[int, int]] = None,
    ) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        cr = chunk_rows or self.chunk_rows
        lo, hi = row_range if row_range else (0, self.num_events)
        for start in range(lo, hi, cr):
            end = min(start + cr, hi)
            yield (
                np.asarray(self.activity[start:end]),
                np.asarray(self.case[start:end]),
                np.asarray(self.time[start:end]),
            )

    def activity_labels(self) -> list:
        """Synthetic names for the integer activity ids — the same labels the
        mining CLI and the query engine use, so memmap branches align with
        in-memory repositories on a shared activity axis."""
        return [f"act_{i:03d}" for i in range(self.num_activities)]

    def rows_for_window(self, t0: float, t1: float) -> Tuple[int, int]:
        """Binary search the time column (stream is time-ordered) — this is
        the index-based dicing that beats load-everything below the
        crossover (paper Fig. 5)."""
        lo = int(np.searchsorted(self.time, t0, side="left"))
        hi = int(np.searchsorted(self.time, t1, side="left"))
        return lo, hi

    # -- growing ------------------------------------------------------------
    def append(
        self, activity: np.ndarray, case: np.ndarray, time: np.ndarray
    ) -> "MemmapLog":
        """Grow this log on disk by one time-ordered batch and return a
        freshly opened handle.  This instance keeps viewing the old row
        count — reopen (or use the returned log) to see the appended rows."""
        w = MemmapLogWriter.open_append(self.path)
        w.append(activity, case, time)
        return w.close()


class MemmapLogWriter:
    """Writes the disk tier.  Two modes:

    * **create** (constructor) — preallocates the three column files for a
      known ``num_events`` and fills them front to back;
    * **append** (:meth:`open_append`) — grows an *existing* log's column
      files and rewrites ``meta.json`` on close.  Appended rows must keep
      the stream time-ordered (nondecreasing, starting at or after the last
      stored timestamp): the chunk time index and the engine's append-only
      delta plans both rely on that invariant.
    """

    def __init__(self, path, num_events, num_activities, num_traces, chunk_rows):
        os.makedirs(path, exist_ok=True)
        self.path = path
        self.mode = "create"
        self.meta = dict(
            num_events=num_events,
            num_activities=num_activities,
            num_traces=num_traces,
            chunk_rows=chunk_rows,
        )
        self.activity = np.memmap(
            os.path.join(path, "activity.i32"), dtype=np.int32, mode="w+",
            shape=(num_events,),
        )
        self.case = np.memmap(
            os.path.join(path, "case.i32"), dtype=np.int32, mode="w+",
            shape=(num_events,),
        )
        self.time = np.memmap(
            os.path.join(path, "time.f64"), dtype=np.float64, mode="w+",
            shape=(num_events,),
        )
        self.cursor = 0

    @classmethod
    def open_append(cls, path: str) -> "MemmapLogWriter":
        """Open an existing log for append-only growth.

        New activity / case ids may exceed the stored vocabularies —
        ``num_activities`` / ``num_traces`` grow accordingly on close.
        """
        w = object.__new__(cls)
        w.path = path
        with open(os.path.join(path, "meta.json")) as f:
            w.meta = json.load(f)
        w.mode = "append"
        w.cursor = w.meta["num_events"]
        # an aborted earlier append (writer discarded before close, e.g. on
        # a time-order error) leaves orphan bytes past the committed row
        # count; truncate them or they would silently misalign this append
        for name, itemsize in (("activity.i32", 4), ("case.i32", 4),
                               ("time.f64", 8)):
            fpath = os.path.join(path, name)
            committed = w.cursor * itemsize
            if os.path.getsize(fpath) > committed:
                os.truncate(fpath, committed)
        w._files = {
            "activity": open(os.path.join(path, "activity.i32"), "ab"),
            "case": open(os.path.join(path, "case.i32"), "ab"),
            "time": open(os.path.join(path, "time.f64"), "ab"),
        }
        w._max_activity = w.meta["num_activities"] - 1
        w._max_case = w.meta["num_traces"] - 1
        n = w.meta["num_events"]
        if n:
            tail = np.memmap(
                os.path.join(path, "time.f64"), dtype=np.float64, mode="r",
                shape=(n,),
            )
            w._last_time = float(tail[-1])
            del tail
        else:
            w._last_time = -np.inf
        return w

    def append(self, activity: np.ndarray, case: np.ndarray, time: np.ndarray):
        activity = np.ascontiguousarray(activity, dtype=np.int32)
        case = np.ascontiguousarray(case, dtype=np.int32)
        time = np.ascontiguousarray(time, dtype=np.float64)
        n = activity.shape[0]
        if n == 0:
            return
        if self.mode == "append":
            if float(time[0]) < self._last_time or (np.diff(time) < 0).any():
                raise ValueError(
                    "appended rows must keep the stream time-ordered: "
                    f"batch starts at {float(time[0])} but the log ends at "
                    f"{self._last_time}"
                )
            self._files["activity"].write(activity.tobytes())
            self._files["case"].write(case.tobytes())
            self._files["time"].write(time.tobytes())
            self._last_time = float(time[-1])
            self._max_activity = max(self._max_activity, int(activity.max()))
            self._max_case = max(self._max_case, int(case.max()))
            self.cursor += n
            return
        s = self.cursor
        self.activity[s : s + n] = activity
        self.case[s : s + n] = case
        self.time[s : s + n] = time
        self.cursor += n

    def close(self) -> MemmapLog:
        if self.mode == "append":
            for f in self._files.values():
                f.flush()
                f.close()
            self.meta["num_events"] = self.cursor
            self.meta["num_activities"] = max(
                self.meta["num_activities"], self._max_activity + 1
            )
            self.meta["num_traces"] = max(
                self.meta["num_traces"], self._max_case + 1
            )
            with open(os.path.join(self.path, "meta.json"), "w") as f:
                json.dump(self.meta, f)
            return MemmapLog.open(self.path)
        assert self.cursor == self.meta["num_events"], (
            f"wrote {self.cursor} of {self.meta['num_events']} rows"
        )
        self.activity.flush()
        self.case.flush()
        self.time.flush()
        with open(os.path.join(self.path, "meta.json"), "w") as f:
            json.dump(self.meta, f)
        del self.activity, self.case, self.time
        return MemmapLog.open(self.path)


# ---------------------------------------------------------------------------
# Streaming miner
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class MinerState:
    """Resumable snapshot of a :class:`StreamingDFGMiner` — everything the
    incremental-maintenance path needs to continue a scan later: the Ψ
    counts, the last activity per open case (so pairs straddling the resume
    boundary are linked), and the consumed-row count."""

    psi: np.ndarray
    last_by_case: Dict[int, int]
    events_seen: int

    @property
    def num_activities(self) -> int:
        return int(self.psi.shape[0])

    def copy(self) -> "MinerState":
        return MinerState(self.psi.copy(), dict(self.last_by_case), self.events_seen)


class StreamingDFGMiner:
    """Incremental DFG over a time-ordered event stream with interleaved
    traces.  State: the (A, A) count matrix + one (activity, time) per *open*
    case.  Peak memory is O(A² + chunk + open cases) — never O(E).

    Also serves as the **incremental maintenance** path: feeding a live
    event stream keeps the DFG current (beyond-paper capability).
    """

    def __init__(self, num_activities: int):
        self.num_activities = num_activities
        self.psi = np.zeros((num_activities, num_activities), dtype=np.int64)
        self.last_by_case: Dict[int, int] = {}
        self.events_seen = 0

    def snapshot(self) -> MinerState:
        """Copy out the resumable state (safe to cache across appends)."""
        return MinerState(self.psi.copy(), dict(self.last_by_case), self.events_seen)

    @classmethod
    def restore(
        cls, state: MinerState, num_activities: Optional[int] = None
    ) -> "StreamingDFGMiner":
        """Resume from a snapshot.  A grown activity vocabulary pads Ψ with
        zero rows/columns; shrinking is not an append and is rejected."""
        a = state.num_activities if num_activities is None else int(num_activities)
        if a < state.num_activities:
            raise ValueError(
                f"cannot shrink the vocabulary on resume "
                f"({state.num_activities} -> {a})"
            )
        miner = cls(a)
        miner.psi[: state.num_activities, : state.num_activities] = state.psi
        miner.last_by_case = dict(state.last_by_case)
        miner.events_seen = int(state.events_seen)
        return miner

    def update(
        self, activity: np.ndarray, case: np.ndarray, time: np.ndarray
    ) -> None:
        """Consume one chunk (time-ordered rows; traces may interleave)."""
        n = activity.shape[0]
        if n == 0:
            return
        self.events_seen += int(n)
        # Within the chunk, group rows by case via a stable (case, time) sort.
        order = np.lexsort((np.arange(n), time, case))
        a = activity[order]
        c = case[order]
        same = np.zeros(n, dtype=bool)
        same[1:] = c[1:] == c[:-1]
        # in-chunk pairs
        src = a[:-1][same[1:]]
        dst = a[1:][same[1:]]
        if src.size:
            np.add.at(self.psi, (src, dst), 1)
        # cross-chunk pairs: first row of each case-run links to carried state
        run_start = ~same
        for i in np.nonzero(run_start)[0]:
            prev = self.last_by_case.get(int(c[i]))
            if prev is not None:
                self.psi[prev, a[i]] += 1
        # carry last event of each case-run
        run_end = np.ones(n, dtype=bool)
        run_end[:-1] = ~same[1:]
        for i in np.nonzero(run_end)[0]:
            self.last_by_case[int(c[i])] = int(a[i])

    def finalize(self) -> np.ndarray:
        return self.psi.copy()


def streaming_dfg(
    log: MemmapLog,
    chunk_rows: Optional[int] = None,
    time_window: Optional[Tuple[float, float]] = None,
) -> np.ndarray:
    """End-to-end out-of-core DFG over a memmap log.

    With a ``time_window`` the scan touches only the indexed row range
    (plus per-pair endpoint masking at the range edges for paper
    semantics — for a time-ordered stream the range *is* the window)."""
    miner = StreamingDFGMiner(log.num_activities)
    rng = log.rows_for_window(*time_window) if time_window else None
    for a, c, t in log.iter_chunks(chunk_rows=chunk_rows, row_range=rng):
        miner.update(a, c, t)
    return miner.finalize()
