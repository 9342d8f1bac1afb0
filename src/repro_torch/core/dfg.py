"""Algorithm 1 — Directly Follows Graph computation, in-store.

Formulations (all return an ``(A, A)`` int64 count matrix
``Ψ[a, b] = |a >_L b|``):

* :func:`dfg_algorithm1` — literal transcription of the paper's pseudocode on
  the explicit graph form (O(A²·E); oracle for tests only).
* :func:`dfg_numpy` — ``np.add.at`` on the pair columns (the host oracle,
  also used by the streaming tier).
* :func:`dfg_scatter` — ``index_put_(accumulate=True)`` on the device.
* :func:`dfg_onehot` — ``Ψ = Σ OneHot(src)ᵀ·OneHot(dst)`` as chunked
  ``torch.matmul`` (the one-hots never materialize at full E×A).
* ``backend="kernel"`` routes to :mod:`repro_torch.kernels.dfg_count`, the
  hand-written CUDA histogram.

The public entry point :func:`dfg` / :func:`dfg_from_repository` mirrors the
paper's single Cypher query, including the WHERE-clause dicing (a time
window mask applied to pairs) and access-control views.  Both run on the
card unless ``device="cpu"`` is passed.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device

from .repository import EventRepository, GraphRepo

__all__ = [
    "dfg_algorithm1",
    "dfg_scatter",
    "dfg_onehot",
    "dfg",
    "dfg_from_repository",
    "dfg_numpy",
]


# ---------------------------------------------------------------------------
# Oracle: the paper's Algorithm 1, verbatim
# ---------------------------------------------------------------------------


def dfg_algorithm1(g: GraphRepo) -> Tuple[np.ndarray, list]:
    """Literal Algorithm 1 on the explicit graph: for each pair of attributes
    (a, b), ``c = Σ_{e ∈ •a, e' ∈ •b} |(e, e') ∈ R|``.

    Returns (matrix, activity_names) with activities sorted by name.
    """
    acts = sorted(g.attributes)
    idx = {a: i for i, a in enumerate(acts)}
    psi = np.zeros((len(acts), len(acts)), dtype=np.int64)
    for a in acts:
        ea = g.preset(a) & g.events
        for b in acts:
            eb = g.preset(b) & g.events
            c = sum(1 for e in ea for e2 in eb if (e, e2) in g.relations)
            psi[idx[a], idx[b]] = c
    return psi, acts


# ---------------------------------------------------------------------------
# numpy reference on pair columns (used by streaming tier & tests)
# ---------------------------------------------------------------------------


def dfg_numpy(
    src: np.ndarray, dst: np.ndarray, valid: np.ndarray, num_activities: int
) -> np.ndarray:
    psi = np.zeros((num_activities, num_activities), dtype=np.int64)
    if src.shape[0]:
        np.add.at(psi, (src[valid], dst[valid]), 1)
    return psi


# ---------------------------------------------------------------------------
# torch formulations (run on whatever device the columns lie on)
# ---------------------------------------------------------------------------


def _in_range(src, dst, valid, a: int) -> torch.Tensor:
    """``valid`` restricted to ids in ``[0, a)`` — an out-of-range index
    would be a device-side fault, so such pairs are dropped (as the kernel
    and the reference oracle drop them)."""
    return valid.bool() & (src >= 0) & (src < a) & (dst >= 0) & (dst < a)


def dfg_scatter(
    src: torch.Tensor, dst: torch.Tensor, valid: torch.Tensor, *,
    num_activities: int,
) -> torch.Tensor:
    """Scatter-add formulation: ``Ψ.index_put_((src, dst), 1,
    accumulate=True)`` in int64 over the valid pairs."""
    psi = torch.zeros(
        (num_activities, num_activities), dtype=torch.int64, device=src.device
    )
    m = _in_range(src, dst, valid, num_activities)
    ones = torch.ones((), dtype=torch.int64, device=src.device)
    return psi.index_put_(
        (src[m].long(), dst[m].long()), ones.expand(int(m.sum())),
        accumulate=True,
    )


def dfg_onehot(
    src: torch.Tensor,
    dst: torch.Tensor,
    valid: torch.Tensor,
    *,
    num_activities: int,
    chunk: int = 4096,
) -> torch.Tensor:
    """One-hot formulation: Ψ = Σ_chunks OneHot(src)ᵀ · (valid ⊙ OneHot(dst)).

    Each chunk's product is an f32 matmul whose cells are at most ``chunk``
    (exact in f32); the chunks accumulate in int64, so the total is exact at
    any size.  The one-hot working set is ``2 · chunk · A``."""
    a = num_activities
    acc = torch.zeros((a, a), dtype=torch.int64, device=src.device)
    m = _in_range(src, dst, valid, a)
    # out-of-range ids carry v == 0; clamp them so one_hot stays in bounds
    src, dst = src.clamp(0, max(a - 1, 0)), dst.clamp(0, max(a - 1, 0))
    for lo in range(0, src.shape[0], chunk):
        s = src[lo : lo + chunk].long()
        d = dst[lo : lo + chunk].long()
        v = m[lo : lo + chunk].to(torch.float32)
        oh_s = torch.nn.functional.one_hot(s, a).to(torch.float32) * v[:, None]
        oh_d = torch.nn.functional.one_hot(d, a).to(torch.float32)
        acc += torch.matmul(oh_s.T, oh_d).to(torch.int64)
    return acc


# ---------------------------------------------------------------------------
# Public entry points
# ---------------------------------------------------------------------------


def _column(x, dtype: torch.dtype, dev: torch.device) -> torch.Tensor:
    """A pair column (numpy or torch) as a ``dtype`` tensor on ``dev``."""
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x))
    if dtype == torch.bool and x.dtype != torch.bool:
        x = x != 0
    return x.to(device=dev, dtype=dtype)


def dfg(
    src,
    dst,
    valid,
    num_activities: int,
    backend: str = "auto",
    device="cuda",
) -> np.ndarray:
    """Compute the DFG count matrix from aligned pair columns.

    backend ∈ {"auto", "scatter", "onehot", "kernel"}.  "auto" picks
    scatter on a CPU device and the CUDA kernel on a card.  Returns a host
    int64 matrix."""
    dev = resolve_device(device)
    src = _column(src, torch.int32, dev)
    dst = _column(dst, torch.int32, dev)
    valid = _column(valid, torch.bool, dev)
    if backend == "auto":
        backend = "scatter" if dev.type == "cpu" else "kernel"
    if backend == "scatter":
        out = dfg_scatter(src, dst, valid, num_activities=num_activities)
    elif backend == "onehot":
        out = dfg_onehot(src, dst, valid, num_activities=num_activities)
    elif backend == "kernel":
        from repro_torch.kernels.dfg_count import ops as _ops

        out = _ops.dfg_count(src, dst, valid, num_activities=num_activities)
    else:
        raise ValueError(f"unknown backend {backend!r}")
    return out.cpu().numpy()


def dfg_from_repository(
    repo: EventRepository,
    *,
    backend: str = "auto",
    time_window: Optional[Tuple[float, float]] = None,
    view=None,
    device="cuda",
) -> np.ndarray:
    """The paper's §4 query: MATCH (a1)<-[]-(e1)-[]->(e2)-[]->(a2) count(*),
    optionally with a WHERE timestamp clause (``time_window``) and an
    access-control ``view`` (see :mod:`repro_torch.core.views`).

    Paper semantics for dicing: the E×E relation is *fixed*; a pair counts
    iff **both** endpoint events satisfy the WHERE clause.  (pm4py-style
    re-linking after filtering is available via
    :func:`repro_torch.core.dicing.dice_repository`.)
    """
    src, dst, valid = repo.df_pairs()
    if time_window is not None:
        from .dicing import pair_mask_for_window

        valid = valid & pair_mask_for_window(repo, time_window)
    psi = dfg(
        src, dst, valid, repo.num_activities, backend=backend, device=device
    )
    if view is not None:
        psi = view.apply_to_dfg(psi, repo.activity_names)
    return psi
