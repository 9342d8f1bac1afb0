"""Distributed DFG — the paper's horizontal scaling, over a mesh of cards.

Neo4j scales DFG computation by adding database nodes; here the "database"
is the mesh: event-pair columns are split over every position, each
position counts its resident shard with the ``dfg_count`` CUDA kernel (its
plain version on the CPU), and a sum of the (A, A) matrices over the mesh's
axes produces the global DFG.

Privacy property preserved *by construction*: the only tensor that crosses
positions (or ranks) is the aggregated int64 count matrix — raw events never
move (the paper's "remove the requirement to move data into analysts'
computer").

Two ways of running, chosen by whether ``torch.distributed`` has a process
group:

* **in one process** — each mesh position counts its padded shard on its
  own device, and the partial matrices are summed axis by axis;
* **across processes** — rank ``r`` owns position ``r`` of the flattened
  mesh, counts its shard, and the sum is ``torch.distributed.all_reduce``
  on int64: one all-reduce per mesh axis (``hierarchical=True``, each over
  the subgroup of ranks that differ only along that axis) or one over every
  rank.  NCCL reduces on the card; gloo (CPU hosts, or two ranks sharing
  one card, which NCCL refuses) reduces a host copy.

Works on any mesh rank — ``("data",)``, ``("data", "model")`` — with events
sharded over *all* axes flattened, because DFG counting is embarrassingly
data-parallel.  ``last_reductions`` records the collectives of the most
recent call.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .compat import Mesh
from .dfg import dfg_onehot, dfg_scatter

__all__ = [
    "Collective",
    "LoweredDFG",
    "distributed_dfg",
    "last_reductions",
    "local_dfg_fn",
    "lower_distributed_dfg",
    "merge_shard_counts",
    "merge_shard_psis",
    "shard_pairs",
]


@dataclasses.dataclass(frozen=True)
class Collective:
    """One reduction of a distributed count: ``op`` over the mesh ``axes``
    (``group_size`` positions), of one ``shape`` / ``dtype`` tensor."""

    op: str
    axes: Tuple[str, ...]
    group_size: int
    shape: Tuple[int, ...]
    dtype: str

    @property
    def bytes(self) -> int:
        return math.prod(self.shape) * torch.empty(
            (), dtype=getattr(torch, self.dtype)
        ).element_size()


#: the reductions of the most recent :func:`distributed_dfg` /
#: :func:`merge_shard_psis` call in this process, in order
last_reductions: List[Collective] = []


def local_dfg_fn(num_activities: int, backend: str = "kernel"):
    """Per-shard DFG count: ``(src, dst, valid)`` tensors on one device →
    the (A, A) int64 Ψ on that device.  ``"kernel"`` is the ``dfg_count``
    CUDA kernel on a card (its plain version on CPU tensors); ``"onehot"``
    and ``"scatter"`` are the torch formulations of
    :mod:`repro_torch.core.dfg`."""
    a = int(num_activities)
    if backend == "kernel":
        from repro_torch.kernels.dfg_count import ops as _ops

        def fn(src, dst, valid):
            return _ops.dfg_count(src, dst, valid, num_activities=a)

        return fn
    if backend == "onehot":
        return lambda s, d, v: dfg_onehot(s, d, v, num_activities=a)
    if backend == "scatter":
        return lambda s, d, v: dfg_scatter(s, d, v, num_activities=a)
    raise ValueError(
        f"unknown per-shard backend {backend!r}; use 'kernel', 'onehot' or "
        "'scatter'"
    )


def shard_pairs(
    src: np.ndarray,
    dst: np.ndarray,
    valid: np.ndarray,
    n_shards: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pad pair columns to a multiple of ``n_shards`` (padding marked
    invalid) so they shard evenly across devices."""
    n = src.shape[0]
    padded = max(n_shards, math.ceil(n / n_shards) * n_shards)
    pad = padded - n
    return (
        np.pad(src, (0, pad)).astype(np.int32),
        np.pad(dst, (0, pad)).astype(np.int32),
        np.pad(valid, (0, pad)).astype(bool),
    )


# ---------------------------------------------------------------------------
# Reduction over the mesh
# ---------------------------------------------------------------------------


def _process_group_active() -> bool:
    dist = torch.distributed
    return dist.is_available() and dist.is_initialized()


def _rank_position(mesh: Mesh) -> int:
    dist = torch.distributed
    world = dist.get_world_size()
    if world != mesh.size:
        raise RuntimeError(
            f"the process group has {world} ranks but the mesh "
            f"{mesh.shape} has {mesh.size} positions; each rank owns one "
            "position"
        )
    return dist.get_rank()


def _reduction_axes(mesh: Mesh, hierarchical: bool):
    """The reduction steps, in order: each a tuple of mesh axis indices —
    one step per axis, fastest (last) axis first, or one step over all."""
    nd = len(mesh.axis_names)
    if hierarchical:
        return [(i,) for i in reversed(range(nd))]
    return [tuple(range(nd))]


#: subgroups per (process group, mesh shape, axis names, step): every rank
#: must create every group in the same order, so they are made once
_GROUPS: Dict[Tuple, object] = {}


def _step_group(mesh: Mesh, axes: Tuple[int, ...], rank: int):
    """The process subgroup of this rank for a reduction over ``axes``:
    the ranks that differ from it only along those axes (the world group
    when that is every rank)."""
    dist = torch.distributed
    if len(axes) == len(mesh.axis_names) or all(
        mesh.devices.shape[i] == mesh.size for i in axes
    ):
        return None  # every rank: the default group
    key = (id(dist.group.WORLD), mesh.devices.shape, mesh.axis_names, axes)
    if key not in _GROUPS:
        ranks = np.arange(mesh.size).reshape(mesh.devices.shape)
        rest = [i for i in range(ranks.ndim) if i not in axes]
        rows = np.transpose(ranks, rest + list(axes)).reshape(
            -1, math.prod(mesh.devices.shape[i] for i in axes)
        )
        mine = None
        for row in rows:  # every rank creates every group, in one order
            g = dist.new_group([int(r) for r in row])
            if rank in row:
                mine = g
        _GROUPS[key] = mine
    return _GROUPS[key]


def _step_record(mesh: Mesh, axes, shape, dtype) -> Collective:
    return Collective(
        op="all_reduce",
        axes=tuple(mesh.axis_names[i] for i in axes),
        group_size=math.prod(mesh.devices.shape[i] for i in axes),
        shape=tuple(int(s) for s in shape),
        dtype=str(dtype).replace("torch.", ""),
    )


def _reduce_ranks(psi: torch.Tensor, mesh: Mesh, hierarchical: bool, rank: int):
    """This rank's partial Ψ summed over every rank, one all-reduce per
    step; the only tensor that leaves the rank."""
    dist = torch.distributed
    records = []
    for axes in _reduction_axes(mesh, hierarchical):
        group = _step_group(mesh, axes, rank)
        if dist.get_backend(group) != "nccl":
            psi = psi.cpu()  # gloo reduces host tensors
        dist.all_reduce(psi, op=dist.ReduceOp.SUM, group=group)
        records.append(_step_record(mesh, axes, psi.shape, psi.dtype))
    last_reductions[:] = records
    return psi


def _reduce_positions(partials: Sequence[torch.Tensor], mesh: Mesh,
                      hierarchical: bool) -> torch.Tensor:
    """The per-position partials (row-major order) summed step by step on
    the first position's device, in the same order as across ranks."""
    home = partials[0].device
    tail = tuple(partials[0].shape)
    stack = torch.stack([p.to(home) for p in partials]).reshape(
        mesh.devices.shape + tail
    )
    records = []
    for axes in _reduction_axes(mesh, hierarchical):
        stack = stack.sum(dim=axes, keepdim=True)
        records.append(_step_record(mesh, axes, tail, stack.dtype))
    last_reductions[:] = records
    return stack.reshape(tail)


def _mesh_sum(blocks: np.ndarray, mesh: Mesh, count, hierarchical: bool):
    """Split ``blocks`` (first axis a multiple of ``mesh.size``) evenly over
    the positions, ``count(block, device)`` each position's part on its
    device, and sum over the mesh — this rank's part only when a process
    group is active.  Returns a host int64 array."""
    per = blocks[0].shape[0] // mesh.size
    devices = mesh.flat_devices()

    def part(pos):
        sl = slice(pos * per, (pos + 1) * per)
        return count([b[sl] for b in blocks], devices[pos])

    if _process_group_active():
        rank = _rank_position(mesh)
        out = _reduce_ranks(part(rank), mesh, hierarchical, rank)
    else:
        out = _reduce_positions(
            [part(p) for p in range(mesh.size)], mesh, hierarchical
        )
    return out.cpu().numpy().astype(np.int64, copy=False)


def distributed_dfg(
    mesh: Mesh,
    src: np.ndarray,
    dst: np.ndarray,
    valid: np.ndarray,
    num_activities: int,
    *,
    backend: str = "kernel",
    hierarchical: bool = True,
) -> np.ndarray:
    """Compute the global DFG with pairs sharded over every mesh axis.

    ``hierarchical=True`` reduces over the fastest (last) axis first and
    the first axis last — on a multi-host mesh the last hop crosses the
    slow link, so the matrix is reduced inside a host before it touches
    it; ``hierarchical=False`` reduces once over every axis.  Across
    processes every rank passes the same (global) columns and counts its
    own shard of them."""
    src_s, dst_s, valid_s = shard_pairs(
        np.asarray(src), np.asarray(dst), np.asarray(valid), mesh.size
    )
    local = local_dfg_fn(num_activities, backend=backend)

    def count(cols, dev):
        return local(*(torch.from_numpy(c).to(dev) for c in cols))

    return _mesh_sum((src_s, dst_s, valid_s), mesh, count, hierarchical)


# ---------------------------------------------------------------------------
# Sharded-graph merge (case-partitioned shards → global sinks)
# ---------------------------------------------------------------------------


def _align_dense(mat: np.ndarray, ids, num_activities: int) -> np.ndarray:
    """Embed a shard-local (a, a) matrix into the (A, A) union frame.
    ``ids[i]`` is the union id of shard-local activity ``i`` (unique), so
    plain assignment places every cell — no accumulation inside one shard."""
    out = np.zeros((num_activities, num_activities), dtype=np.int64)
    idx = np.asarray(ids, dtype=np.int64)
    out[np.ix_(idx, idx)] = mat
    return out


def merge_shard_psis(
    psis,
    id_maps,
    num_activities: int,
    *,
    mesh: Optional[Mesh] = None,
) -> np.ndarray:
    """Merge per-shard (a_k, a_k) Ψ matrices into the global (A, A) Ψ.

    Cases never span shards under the ``case % K`` partition, so every
    directly-follows pair is counted by exactly one shard and the merge is a
    *pure sum* on the aligned union vocabulary — no reconciliation, the same
    contract as :func:`distributed_dfg`.  With a mesh of several positions
    the aligned stack is split over them and reduced over the mesh's axes
    (int64 — exact); otherwise the sum is a K·A² host reduction."""
    aligned = [
        _align_dense(psi, ids, num_activities)
        for psi, ids in zip(psis, id_maps)
    ]
    if not aligned:
        return np.zeros((num_activities, num_activities), dtype=np.int64)
    if mesh is None or mesh.size <= 1:
        return np.sum(aligned, axis=0, dtype=np.int64)
    stack = np.stack(aligned)
    pad = (-stack.shape[0]) % mesh.size
    if pad:
        stack = np.concatenate(
            [stack, np.zeros((pad, *stack.shape[1:]), dtype=np.int64)]
        )

    def count(blocks, dev):
        return torch.from_numpy(blocks[0]).to(dev).sum(dim=0)

    return _mesh_sum((stack,), mesh, count, hierarchical=True)


def merge_shard_counts(counts, id_maps, num_activities: int) -> np.ndarray:
    """Merge per-shard activity-count vectors (histogram / process-map node
    weights) onto the union vocabulary.  Each event lives on exactly one
    shard, so this too is a pure aligned sum."""
    out = np.zeros(num_activities, dtype=np.int64)
    for vec, ids in zip(counts, id_maps):
        idx = np.asarray(ids, dtype=np.int64)
        out[idx] += np.asarray(vec, dtype=np.int64)
    return out


# ---------------------------------------------------------------------------
# Dry run
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LoweredDFG:
    """What :func:`distributed_dfg` would run on ``mesh``, without running
    it: the per-position input shards and the output as meta tensors, and
    the collectives in order."""

    mesh_shape: Dict[str, int]
    padded_pairs: int
    shard_inputs: Tuple[torch.Tensor, ...]
    output: torch.Tensor
    collectives: Tuple[Collective, ...]

    def as_text(self) -> str:
        lines = [
            f"mesh {self.mesh_shape}: {self.padded_pairs} pairs, "
            + ", ".join(
                f"{tuple(t.shape)} {str(t.dtype).replace('torch.', '')}"
                for t in self.shard_inputs
            )
            + " per position",
            f"local count → {tuple(self.output.shape)} "
            f"{str(self.output.dtype).replace('torch.', '')}",
        ]
        lines += [
            f"{c.op} over {c.axes} ({c.group_size} positions) of "
            f"{c.shape} {c.dtype}, {c.bytes} B"
            for c in self.collectives
        ]
        return "\n".join(lines)


def lower_distributed_dfg(
    mesh: Mesh,
    num_pairs: int,
    num_activities: int,
    *,
    backend: str = "kernel",
) -> LoweredDFG:
    """Dry run (no execution, no device memory) of the distributed DFG, for
    planning and roofline use: meta tensors of each position's padded
    shard and of the (A, A) int64 output, and one all-reduce of that output
    per mesh axis — the only traffic between positions."""
    local_dfg_fn(num_activities, backend=backend)  # validates the backend
    n_dev = mesh.size
    padded = max(n_dev, math.ceil(num_pairs / n_dev) * n_dev)
    per = padded // n_dev
    meta = torch.device("meta")
    inputs = (
        torch.empty(per, dtype=torch.int32, device=meta),
        torch.empty(per, dtype=torch.int32, device=meta),
        torch.empty(per, dtype=torch.bool, device=meta),
    )
    a = int(num_activities)
    out = torch.empty((a, a), dtype=torch.int64, device=meta)
    return LoweredDFG(
        mesh_shape=mesh.shape,
        padded_pairs=padded,
        shard_inputs=inputs,
        output=out,
        collectives=tuple(
            _step_record(mesh, axes, out.shape, out.dtype)
            for axes in _reduction_axes(mesh, hierarchical=True)
        ),
    )
