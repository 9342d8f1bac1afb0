"""Case-partitioned sharded event logs — the horizontal-scaling graph tier.

The paper's scaling story (arXiv:2007.09352 §6, and the speed study it
leans on, arXiv:1701.00072) is that a *partitioned* graph database computes
the DFG where each partition lives and merges cheap per-partition counts.
We reproduce that shape host-side: a :class:`ShardedLog` is K independent
:class:`~repro_torch.core.streaming.MemmapLog` shards under one directory, with
cases assigned **whole** to shards by the stable ``case % K`` rule
(:func:`repro_torch.sharding.spec.shard_of_cases`).

Because a case never spans shards, every directly-follows pair is
shard-local: the global Ψ is a *pure sum* of the per-shard (A, A) count
matrices on the aligned union vocabulary — exactly the psum contract of
:func:`repro_torch.core.distributed.distributed_dfg`, and the reason the
``sharded-graph`` backend can merge per-shard ``EventGraph`` snapshots
without any cross-shard reconciliation.

Stability of ``case % K`` across appends is the delta-resume property: new
events for an existing case always land on the shard already holding it, so
an append touches only the owning shards — every other shard keeps its
prefix-preserving fingerprint and its cached CSR snapshot.

Empty residue classes own no events and would need zero-length memmaps
(which ``np.memmap`` rejects), so they simply have no shard directory; the
manifest records which residues are present and :meth:`ShardedLog.append`
creates missing shards on demand when a new case hashes into one.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core.streaming import MemmapLog
from repro_torch.sharding.spec import GraphShardSpec, shard_of_cases

__all__ = [
    "ShardedLog",
    "partition_memmap_log",
    "open_sharded_log",
    "sharded_log_name",
]

_MANIFEST = "manifest.json"
_FORMAT_VERSION = 1


def _shard_dirname(k: int) -> str:
    return f"shard{k:03d}"


def sharded_log_name(log: "ShardedLog") -> str:
    """Provenance name of a sharded source — same rule as
    :func:`repro_torch.core.streaming.memmap_log_name`: the final path component."""
    base = os.path.basename(os.path.normpath(log.path))
    return base or "sharded"


@dataclasses.dataclass
class ShardedLog:
    """K case-partitioned memmap shards + a manifest, presented as one log.

    ``shards[k]`` is the :class:`MemmapLog` owning residue class ``k``, or
    ``None`` when no case with ``case % K == k`` exists yet.  Each shard is
    a plain memmap log, so the whole single-log toolchain — ``build_graph``,
    prefix fingerprints, ``GraphStore`` extension — applies per shard
    unchanged.
    """

    path: str
    spec: GraphShardSpec
    shards: Tuple[Optional[MemmapLog], ...]

    # -- shape --------------------------------------------------------------
    @property
    def num_shards(self) -> int:
        return self.spec.num_shards

    @property
    def num_events(self) -> int:
        return sum(s.num_events for _, s in self.present_shards())

    @property
    def num_activities(self) -> int:
        """Union vocabulary size: appends may grow one shard's vocabulary
        ahead of the others, so the union is the max (shard vocabularies are
        always prefixes of the union under the shared ``act_%03d`` rule)."""
        return max(
            (s.num_activities for _, s in self.present_shards()), default=0
        )

    @property
    def num_traces(self) -> int:
        return max((s.num_traces for _, s in self.present_shards()), default=0)

    def activity_labels(self) -> list:
        return [f"act_{i:03d}" for i in range(self.num_activities)]

    def present_shards(self) -> List[Tuple[int, MemmapLog]]:
        return [(k, s) for k, s in enumerate(self.shards) if s is not None]

    def owning_shards(self, case_ids) -> np.ndarray:
        """Sorted unique shard indices owning the given case ids."""
        return np.unique(self.spec.shard_of(np.asarray(case_ids)))

    # -- io -----------------------------------------------------------------
    @staticmethod
    def open(path: str) -> "ShardedLog":
        with open(os.path.join(path, _MANIFEST)) as f:
            manifest = json.load(f)
        if manifest.get("format") != _FORMAT_VERSION:
            raise ValueError(
                f"unsupported sharded-log format {manifest.get('format')!r}"
            )
        spec = GraphShardSpec(
            num_shards=manifest["num_shards"],
            assignment=manifest.get("assignment", "case_mod"),
        )
        shards: List[Optional[MemmapLog]] = [None] * spec.num_shards
        for key, dirname in manifest["shards"].items():
            shards[int(key)] = MemmapLog.open(os.path.join(path, dirname))
        return ShardedLog(path=path, spec=spec, shards=tuple(shards))

    def _write_manifest(self) -> None:
        manifest = {
            "format": _FORMAT_VERSION,
            "num_shards": self.spec.num_shards,
            "assignment": self.spec.assignment,
            "shards": {
                str(k): _shard_dirname(k) for k, _ in self.present_shards()
            },
        }
        tmp = os.path.join(self.path, _MANIFEST + ".tmp")
        with open(tmp, "w") as f:
            json.dump(manifest, f)
        os.replace(tmp, os.path.join(self.path, _MANIFEST))

    # -- growing ------------------------------------------------------------
    def append(
        self, activity: np.ndarray, case: np.ndarray, time: np.ndarray
    ) -> "ShardedLog":
        """Route one time-ordered batch to its owning shards and return a
        fresh handle.  Only the owning shards' files (and fingerprints)
        change; a residue class seen for the first time gets a new shard
        directory.  Row order within each shard is the batch's own order, so
        per-shard streams stay time-ordered."""
        activity = np.ascontiguousarray(activity, dtype=np.int32)
        case = np.ascontiguousarray(case, dtype=np.int32)
        time = np.ascontiguousarray(time, dtype=np.float64)
        if activity.shape[0] == 0:
            return ShardedLog.open(self.path)
        owners = self.spec.shard_of(case)
        new_shards = list(self.shards)
        chunk_rows = max(
            (s.chunk_rows for _, s in self.present_shards()), default=1 << 20
        )
        grew_manifest = False
        for k in np.unique(owners):
            k = int(k)
            m = owners == k
            a, c, t = activity[m], case[m], time[m]
            shard = new_shards[k]
            if shard is None:
                w = MemmapLog.create(
                    os.path.join(self.path, _shard_dirname(k)),
                    num_events=int(a.shape[0]),
                    num_activities=max(
                        self.num_activities, int(a.max()) + 1
                    ),
                    num_traces=max(self.num_traces, int(c.max()) + 1),
                    chunk_rows=chunk_rows,
                )
                w.append(a, c, t)
                new_shards[k] = w.close()
                grew_manifest = True
            else:
                new_shards[k] = shard.append(a, c, t)
        grown = ShardedLog(
            path=self.path, spec=self.spec, shards=tuple(new_shards)
        )
        if grew_manifest:
            grown._write_manifest()
        return grown


def open_sharded_log(path: str) -> ShardedLog:
    return ShardedLog.open(path)


def partition_memmap_log(
    log: MemmapLog,
    num_shards: int,
    out_dir: str,
    *,
    chunk_rows: Optional[int] = None,
) -> ShardedLog:
    """Partition a memmap log case-wise into ``num_shards`` shards.

    Two streaming passes with O(chunk) working memory — the source log is
    never materialized, so a log larger than the single-host budget can be
    sharded on the host that holds it: pass 1 sizes each shard with
    ``bincount(case % K)``; pass 2 routes rows.  Relative event order is
    preserved within each shard (each shard is a subsequence of the
    time-ordered stream, hence itself time-ordered).
    """
    spec = GraphShardSpec(num_shards=num_shards)
    os.makedirs(out_dir, exist_ok=True)
    if os.path.exists(os.path.join(out_dir, _MANIFEST)):
        raise FileExistsError(
            f"{out_dir} already holds a sharded log; refusing to overwrite"
        )
    cr = chunk_rows or log.chunk_rows

    counts = np.zeros(num_shards, dtype=np.int64)
    for _, c, _ in log.iter_chunks():
        counts += np.bincount(
            shard_of_cases(c, num_shards), minlength=num_shards
        )

    writers = {
        k: MemmapLog.create(
            os.path.join(out_dir, _shard_dirname(k)),
            num_events=int(counts[k]),
            num_activities=log.num_activities,
            num_traces=log.num_traces,
            chunk_rows=cr,
        )
        for k in range(num_shards)
        if counts[k]
    }
    for a, c, t in log.iter_chunks():
        owners = shard_of_cases(c, num_shards)
        for k in np.unique(owners):
            k = int(k)
            if k in writers:
                m = owners == k
                writers[k].append(a[m], c[m], t[m])

    shards: List[Optional[MemmapLog]] = [None] * num_shards
    for k, w in writers.items():
        shards[k] = w.close()
    sharded = ShardedLog(path=out_dir, spec=spec, shards=tuple(shards))
    sharded._write_manifest()
    return sharded
