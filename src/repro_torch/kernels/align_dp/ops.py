"""Alignment DP — the hand-written CUDA kernel's wrapper, its plain version
and the host oracle.

The layered DP of :mod:`repro_torch.conformance.align`: for each variant
(a sequence of activity ids) the (S,) cost front starts at ``d0``; each
event ``a`` either is skipped (``d += 1``) or is reached by model moves and
a sync (``min_s d[s] + M[s, a]``, landing on state ``a``); the variant's
cost is ``min_s d[s] + endcost[s]``.

The kernel takes the variants **ragged**: their ids back to back (int32,
Σ len) and int64 offsets (V + 1), as the variant table holds them, so no
padded (V, L) matrix is built, checked or copied.

* :func:`align_dp_ragged` — the entry on ragged ``(ids, offsets)``, the
  engine's path (:func:`repro_torch.conformance.align.align_variants`),
  with a host float32 ``(V,)`` result.  ``backend="auto"`` launches
  ``csrc/align_dp.cu`` on a CUDA device and runs the plain version on the
  CPU; ``"kernel"`` does the same (on a card it launches or raises — there
  is no fallback); ``"numpy"`` runs :func:`align_dp_numpy` on the host.
* :func:`align_dp` — the same with the reference's padded arguments
  ``(seqs (V, L), lens (V,), m (S, A), d0 (S,), endcost (S,))``, turned
  ragged first.
* :func:`prepare` / :func:`prepare_ragged` — the device tensors the kernel
  takes: ids, offsets, ``Mt`` as (A, S) contiguous rows, ``d0``,
  ``endcost``; ids checked.  :func:`prepare` turns a padded input ragged.
* :func:`align_dp_device` — one DP on prepared tensors: the kernel on a
  CUDA tensor (each launch adds one to :data:`launch_counts`), the plain
  version on a CPU tensor.
* :func:`align_dp_plain` — the same DP in PyTorch over (V, S) tensors.
* :func:`align_dp_numpy` — the reference package's padded numpy oracle,
  copied.

The reference pads the state axis to a lane multiple with ``BIG_COST``
states; the port does not.  A padded state never wins a min: every real
front value stays at most ``BIG_COST`` (each update is ``min(d + 1, …)`` with
``d + 1`` rounding back to ``BIG_COST`` at the top), so a real ``d + M`` or
``d + endcost`` is at most ``2·BIG_COST``, which is what a padded state
gives.  That needs every cost at most ``BIG_COST``, which the wrapper
checks; :func:`~repro_torch.conformance.align.alignment_cost_tables` clips
its tables there.  The kernel relies on the same bound to drop the
per-state select (``fminf(d + 1, BIG_COST) == d + 1``; see its source), so
:func:`align_dp_device` takes tensors from :func:`prepare` or
:func:`prepare_ragged` only: it checks shapes and types, not values.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import device_scope, resolve_device

from ..timing import timed_kernel

__all__ = [
    "BIG_COST",
    "REGISTER_INSTANCES",
    "align_dp",
    "align_dp_ragged",
    "align_dp_device",
    "align_dp_plain",
    "align_dp_numpy",
    "prepare",
    "prepare_ragged",
    "launch",
    "launch_counts",
    "reset_launch_counts",
    "last_launch",
]

#: "unreachable" sentinel — large enough that no real alignment cost ever
#: reaches it, small enough that f32 sums of a few of them stay finite
BIG_COST = 1e9

#: kernel launches — one per launch, nowhere else
launch_counts: Dict[str, int] = {"align_dp": 0}
#: configuration of the most recent launch (shapes, tier, K, grid, smem)
last_launch: Dict[str, object] = {}

_TIERS = {0: "global", 1: "shared", 2: "registers"}
#: the register tier's instances (K, KLO): K state slots per lane, serving
#: 32 KLO < S <= 32 K (``ALIGN_DP_REGISTER_INSTANCES`` in csrc/align_dp.cu)
REGISTER_INSTANCES = ((20, 16), (32, 20))


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def align_dp_numpy(
    seqs: np.ndarray,
    lens: np.ndarray,
    m: np.ndarray,
    d0: np.ndarray,
    endcost: np.ndarray,
) -> np.ndarray:
    """Reference layered DP, vectorized across variants (f32 throughout, the
    kernel's bit-exact oracle)."""
    v, lp = seqs.shape
    s = m.shape[0]
    d = np.broadcast_to(d0.astype(np.float32), (v, s)).copy()
    cols = np.arange(s, dtype=np.int64)[None, :]
    for i in range(lp):
        a = seqs[:, i].astype(np.int64)
        mcol = m.T[a].astype(np.float32)  # (V, S): M[s, a_v]
        sync = (d + mcol).min(axis=1)
        onehot = cols == a[:, None]
        nd = np.minimum(
            d + np.float32(1.0),
            np.where(onehot, sync[:, None], np.float32(BIG_COST)),
        )
        d = np.where((lens > i)[:, None], nd, d)
    return (d + endcost.astype(np.float32)[None, :]).min(axis=1)


def align_dp_plain(
    ids: torch.Tensor,
    offsets: torch.Tensor,
    mt: torch.Tensor,
    d0: torch.Tensor,
    endcost: torch.Tensor,
) -> torch.Tensor:
    """The DP in PyTorch on the tensors' device: ``ids`` (Σ len,) int,
    ``offsets`` (V + 1,) int64, ``mt`` (A, S) f32 (Mᵀ), ``d0`` / ``endcost``
    (S,) f32.  A loop over the layers on (V, S) tensors; returns (V,) f32."""
    v = offsets.shape[0] - 1
    s = mt.shape[1]
    starts = offsets[:-1].to(torch.int64)
    lens = offsets[1:].to(torch.int64) - starts
    d = d0.to(torch.float32).expand(v, s).clone()
    cols = torch.arange(s, device=ids.device)[None, :]
    big = torch.tensor(BIG_COST, dtype=torch.float32, device=ids.device)
    for i in range(int(lens.max()) if v else 0):
        active = lens > i
        at = torch.where(active, starts + i, 0)
        a = torch.where(active, ids[at].to(torch.int64), 0)
        sync = (d + mt[a]).amin(dim=1)
        nd = torch.minimum(
            d + 1.0, torch.where(cols == a[:, None], sync[:, None], big)
        )
        d = torch.where(active[:, None], nd, d)
    return (d + endcost.to(torch.float32)[None, :]).amin(dim=1)


def _host_tables(
    m: np.ndarray, d0: np.ndarray, endcost: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(Mt (A, S'), d0 (S',), endcost (S',)) f32 with S' = max(S, A, 1): the
    state axis covers every sync column, extra states carry ``BIG_COST``."""
    m = np.asarray(m, dtype=np.float32)
    if m.ndim != 2:
        raise ValueError(f"m must be (S, A), got shape {m.shape}")
    s_real, a_real = m.shape
    d0 = np.asarray(d0, dtype=np.float32).reshape(-1)
    endcost = np.asarray(endcost, dtype=np.float32).reshape(-1)
    if d0.shape[0] != s_real or endcost.shape[0] != s_real:
        raise ValueError(
            f"d0 {d0.shape} and endcost {endcost.shape} must have m's "
            f"{s_real} states"
        )
    for name, x in (("m", m), ("d0", d0), ("endcost", endcost)):
        if x.size and (np.isnan(x).any() or x.max() > BIG_COST):
            raise ValueError(
                f"{name} holds NaN or a cost above BIG_COST ({BIG_COST:g})"
            )
    sp = max(s_real, a_real, 1)
    mt = np.full((a_real, sp), BIG_COST, dtype=np.float32)
    mt[:, :s_real] = m.T
    d0p = np.full((sp,), BIG_COST, dtype=np.float32)
    d0p[:s_real] = d0
    endp = np.full((sp,), BIG_COST, dtype=np.float32)
    endp[:s_real] = endcost
    return mt, d0p, endp


def _check_ids(ids: np.ndarray, num_sync: int) -> None:
    if ids.size and (ids.min() < 0 or ids.max() >= num_sync):
        raise ValueError(
            f"activity ids at active positions must lie in [0, {num_sync})"
        )


def _ragged_of_padded(seqs, lens) -> Tuple[np.ndarray, np.ndarray]:
    """(ids at active positions row after row, offsets (V + 1,) int64) of
    ``seqs`` (V, L) with ``lens`` (V,) clamped to [0, L]."""
    seqs = np.asarray(seqs)
    if seqs.ndim != 2:
        raise ValueError(f"seqs must be (V, L), got shape {seqs.shape}")
    v, l = seqs.shape
    lens = np.asarray(lens).reshape(-1)
    if lens.shape[0] != v:
        raise ValueError(f"lens has {lens.shape[0]} rows, seqs {v}")
    lens = np.clip(lens.astype(np.int64), 0, l)
    offsets = np.zeros(v + 1, dtype=np.int64)
    np.cumsum(lens, out=offsets[1:])
    return seqs[np.arange(l)[None, :] < lens[:, None]], offsets


def _host_ragged(ids, offsets, num_sync: int) -> Tuple[np.ndarray, np.ndarray]:
    """(ids (Σ len,) int32, offsets (V + 1,) int64), checked: offsets run
    from 0 to ``len(ids)`` without falling, every id lies in ``[0, A)``."""
    ids = np.asarray(ids).reshape(-1)
    offsets = np.asarray(offsets).reshape(-1)
    if offsets.shape[0] < 1 or not np.issubdtype(offsets.dtype, np.integer):
        raise ValueError("offsets must hold V + 1 integer bounds")
    offsets = offsets.astype(np.int64, copy=False)
    lens = np.diff(offsets)
    if offsets[0] != 0 or offsets[-1] != ids.shape[0] or (lens < 0).any():
        raise ValueError(
            f"offsets must rise from 0 to the {ids.shape[0]} ids"
        )
    if lens.size and lens.max() >= 1 << 31:
        raise ValueError("a variant of 2**31 events or more")
    _check_ids(ids, num_sync)
    return np.ascontiguousarray(ids, dtype=np.int32), offsets


def _padded_of_ragged(
    ids: np.ndarray, offsets: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """(seqs (V, max(L, 1)) int32 zero-padded, lens (V,) int64): the numpy
    oracle's input."""
    lens = np.diff(offsets)
    v = lens.shape[0]
    seqs = np.zeros((v, max(int(lens.max()) if v else 0, 1)), dtype=np.int32)
    cols = np.arange(ids.shape[0]) - np.repeat(offsets[:-1], lens)
    seqs[np.repeat(np.arange(v), lens), cols] = ids
    return seqs, lens


def _to_device(arrays, device) -> Tuple[torch.Tensor, ...]:
    dev = torch.device(device)
    return tuple(torch.from_numpy(x).to(dev) for x in arrays)


def prepare_ragged(
    ids, offsets, m, d0, endcost, device
) -> Tuple[torch.Tensor, ...]:
    """The DP's inputs as the kernel takes them, on ``device``: (ids
    (Σ len,) int32, offsets (V + 1,) int64, Mt (A, S) f32, d0 (S,) f32,
    endcost (S,) f32), all contiguous."""
    mt, d0p, endp = _host_tables(m, d0, endcost)
    ids, offsets = _host_ragged(ids, offsets, mt.shape[0])
    return _to_device((ids, offsets, mt, d0p, endp), device)


def prepare(seqs, lens, m, d0, endcost, device) -> Tuple[torch.Tensor, ...]:
    """:func:`prepare_ragged` of a padded input: ``seqs`` (V, L) with
    ``lens`` (V,) clamped to ``[0, L]``; positions at or past a row's
    length are not read."""
    return prepare_ragged(*_ragged_of_padded(seqs, lens), m, d0, endcost,
                          device)


# ---------------------------------------------------------------------------
# CUDA launch
# ---------------------------------------------------------------------------

_lib: Optional[ctypes.CDLL] = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from ..build import load

        lib = load("align_dp")
        p, i = ctypes.c_void_p, ctypes.c_int
        ip = ctypes.POINTER(ctypes.c_int)
        lib.align_dp_plan.argtypes = [
            ctypes.c_longlong, i, ip, ip, ip, ip, ip,
            ctypes.POINTER(ctypes.c_longlong),
        ]
        lib.align_dp_plan.restype = i
        lib.align_dp_launch.argtypes = [
            p, p, ctypes.c_longlong, p, i, p, p, p, p, p, i, i, i, i, i, p,
        ]
        lib.align_dp_launch.restype = i
        lib.align_dp_error_string.argtypes = [i]
        lib.align_dp_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _raise(lib, what: str, rc: int) -> None:
    raise RuntimeError(
        f"align_dp {what} failed: CUDA error {rc} "
        f"({lib.align_dp_error_string(rc).decode()})"
    )


def launch(ids, offsets, mt, d0, endcost, out) -> None:
    """One launch on prepared device tensors (see :func:`prepare_ragged`)
    into a (V,) f32 ``out``.  Counts nothing: :func:`align_dp_device`
    counts its launches."""
    v = int(offsets.shape[0]) - 1
    s = int(mt.shape[1])
    dev = ids.device
    lib = _library()
    cfg = [ctypes.c_int() for _ in range(5)]
    tier, k, grid, threads, smem = cfg
    scratch_n = ctypes.c_longlong()
    with device_scope(dev):
        rc = lib.align_dp_plan(
            v, s, *(ctypes.byref(c) for c in cfg), ctypes.byref(scratch_n),
        )
        if rc != 0:
            _raise(lib, "plan", rc)
        counter = torch.empty((1,), dtype=torch.int64, device=dev)
        scratch = (
            torch.empty((scratch_n.value,), dtype=torch.float32, device=dev)
            if scratch_n.value else None
        )
        rc = lib.align_dp_launch(
            ids.data_ptr(), offsets.data_ptr(), v, mt.data_ptr(), s,
            d0.data_ptr(), endcost.data_ptr(),
            out.data_ptr(), counter.data_ptr(),
            scratch.data_ptr() if scratch is not None else None,
            tier.value, k.value, grid.value, threads.value, smem.value,
            torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        _raise(lib, "launch", rc)
    last_launch.update(
        variants=v, events=int(ids.shape[0]), states=s,
        branch=_TIERS[tier.value], k=k.value, grid=grid.value,
        threads=threads.value, smem_bytes=smem.value,
    )


def align_dp_device(ids, offsets, mt, d0, endcost) -> torch.Tensor:
    """One DP on prepared tensors (see :func:`prepare_ragged`), on their
    device: the CUDA kernel for CUDA tensors, :func:`align_dp_plain` for
    CPU ones.  Returns (V,) f32 on that device.

    Preconditions that :func:`prepare_ragged` establishes and this function
    does not check (it would have to read the tensors): every cost in
    ``mt``, ``d0`` and ``endcost`` is at most :data:`BIG_COST` and not NaN,
    every id lies in ``[0, A)``, and ``offsets`` rise from 0 to ``len(ids)``.
    It checks shapes, types and ``A <= S`` (``mt`` has no more rows than
    states), so that an id below ``A`` always names a state of the front."""
    v = offsets.shape[0] - 1
    s = mt.shape[1] if mt.dim() == 2 else -1
    if (ids.dim() != 1 or offsets.dim() != 1 or mt.dim() != 2
            or d0.shape != (s,) or endcost.shape != (s,)):
        raise ValueError("ids, offsets, mt, d0 or endcost has the wrong shape")
    if mt.shape[0] > s:
        raise ValueError(
            f"mt has {mt.shape[0]} rows (sync columns) but {s} states: "
            "prepare_ragged pads the states to cover every sync column"
        )
    if not ids.is_cuda:
        return align_dp_plain(ids, offsets, mt, d0, endcost)
    t = (ids, offsets, mt, d0, endcost)
    if any(x.device != ids.device for x in t):
        raise ValueError("all inputs of a launch must lie on one card")
    want = (torch.int32, torch.int64, torch.float32, torch.float32,
            torch.float32)
    if any(x.dtype != w or not x.is_contiguous() for x, w in zip(t, want)):
        raise ValueError(
            "align_dp_device takes contiguous int32 ids, int64 offsets and "
            "float32 mt/d0/endcost (see prepare_ragged)"
        )
    out = torch.empty((v,), dtype=torch.float32, device=ids.device)
    if v:
        launch(ids, offsets, mt, d0, endcost, out)
        launch_counts["align_dp"] += 1
    return out


def _align_dp_ragged(
    ids,
    offsets,
    m,
    d0,
    endcost,
    *,
    backend: str = "auto",
    device="cuda",
) -> np.ndarray:
    """Per-variant alignment cost of the layered DFG-alignment DP, as a host
    (V,) float32 array.

    ``ids`` (Σ len,) activity ids back to back, ``offsets`` (V + 1,) their
    bounds (variant ``v`` is ``ids[offsets[v]:offsets[v + 1]]``), ``m``
    (S, A) the model-move+sync cost closure, ``d0`` / ``endcost`` (S,) the
    virtual-START/END folds.  ``backend``: ``auto`` or ``kernel`` (the CUDA
    kernel on a CUDA ``device``, the plain version on the CPU) | ``numpy``
    (the host oracle)."""
    if backend not in ("auto", "kernel", "numpy"):
        raise ValueError(f"unknown align_dp backend {backend!r}")
    if backend == "numpy":
        mt, d0p, endp = _host_tables(m, d0, endcost)
        ids, offsets = _host_ragged(ids, offsets, mt.shape[0])
        if offsets.shape[0] == 1:
            return np.zeros((0,), dtype=np.float32)
        seqs, lens = _padded_of_ragged(ids, offsets)
        return align_dp_numpy(seqs, lens, mt.T, d0p, endp)
    inputs = prepare_ragged(ids, offsets, m, d0, endcost, resolve_device(device))
    return align_dp_device(*inputs).cpu().numpy()


def _align_dp(
    seqs, lens, m, d0, endcost, *, backend: str = "auto", device="cuda"
) -> np.ndarray:
    """:func:`align_dp_ragged` of a padded input: ``seqs`` (V, L) activity
    ids, positions at or past ``lens`` not read."""
    return _align_dp_ragged(*_ragged_of_padded(seqs, lens), m, d0, endcost,
                            backend=backend, device=device)


# every call lands in the process-global kernel registry as
# kernel_seconds{kernel=align_dp} (see repro_torch.kernels.timing)
align_dp = timed_kernel("align_dp", _align_dp)
align_dp_ragged = timed_kernel("align_dp", _align_dp_ragged)
