"""Alignment DP — the hand-written CUDA kernel's wrapper, its plain version
and the host oracle.

The layered DP of :mod:`repro_torch.conformance.align`: for each variant
(a padded row of activity ids with its length) the (S,) cost front starts at
``d0``; each event ``a`` either is skipped (``d += 1``) or is reached by model
moves and a sync (``min_s d[s] + M[s, a]``, landing on state ``a``); the
variant's cost is ``min_s d[s] + endcost[s]``.

* :func:`align_dp` — the public entry, with the reference's arguments
  ``(seqs (V, L), lens (V,), m (S, A), d0 (S,), endcost (S,))`` and a host
  float32 ``(V,)`` result.  ``backend="auto"`` launches
  ``csrc/align_dp.cu`` on a CUDA device and runs the plain version on the
  CPU; ``"kernel"`` does the same (on a card it launches or raises — there
  is no fallback); ``"numpy"`` runs :func:`align_dp_numpy` on the host.
* :func:`prepare` — the device tensors the kernel takes: ``Mt`` as (A, S)
  contiguous rows, lengths clamped to ``[0, L]``, ids checked.
* :func:`align_dp_device` — one DP on prepared tensors: the kernel on a
  CUDA tensor (each launch adds one to :data:`launch_counts`), the plain
  version on a CPU tensor.
* :func:`align_dp_plain` — the same DP in PyTorch over (V, S) tensors.
* :func:`align_dp_numpy` — the reference package's numpy oracle, copied.

The reference pads the state axis to a lane multiple with ``BIG_COST``
states; the port does not.  A padded state never wins a min: every real
front value stays at most ``BIG_COST`` (each update is ``min(d + 1, …)`` with
``d + 1`` rounding back to ``BIG_COST`` at the top), so a real ``d + M`` or
``d + endcost`` is at most ``2·BIG_COST``, which is what a padded state
gives.  That needs every cost at most ``BIG_COST``, which the wrapper
checks; :func:`~repro_torch.conformance.align.alignment_cost_tables` clips
its tables there.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device

from ..timing import timed_kernel

__all__ = [
    "BIG_COST",
    "align_dp",
    "align_dp_device",
    "align_dp_plain",
    "align_dp_numpy",
    "prepare",
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
#: configuration of the most recent launch (shapes, grid, smem bytes, branch)
last_launch: Dict[str, object] = {}


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
    seqs: torch.Tensor,
    lens: torch.Tensor,
    mt: torch.Tensor,
    d0: torch.Tensor,
    endcost: torch.Tensor,
) -> torch.Tensor:
    """The DP in PyTorch on the tensors' device: ``seqs`` (V, L) int, ``lens``
    (V,) int, ``mt`` (A, S) f32 (Mᵀ), ``d0`` / ``endcost`` (S,) f32.  A loop
    over the layers on (V, S) tensors; returns (V,) f32."""
    v, l = seqs.shape
    s = mt.shape[1]
    d = d0.to(torch.float32).expand(v, s).clone()
    cols = torch.arange(s, device=seqs.device)[None, :]
    big = torch.tensor(BIG_COST, dtype=torch.float32, device=seqs.device)
    lens = lens.to(torch.int64)
    for i in range(min(l, int(lens.max())) if v else 0):
        active = lens > i
        a = torch.where(active, seqs[:, i].to(torch.int64), 0)
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


def _host_seqs(seqs, lens, num_sync: int) -> Tuple[np.ndarray, np.ndarray]:
    """(seqs (V, L) int32, lens (V,) int32 clamped to [0, L]); raises
    ``ValueError`` for an activity id outside ``[0, A)`` at an active
    position."""
    seqs = np.asarray(seqs)
    if seqs.ndim != 2:
        raise ValueError(f"seqs must be (V, L), got shape {seqs.shape}")
    v, l = seqs.shape
    lens = np.asarray(lens).reshape(-1)
    if lens.shape[0] != v:
        raise ValueError(f"lens has {lens.shape[0]} rows, seqs {v}")
    lens = np.clip(lens.astype(np.int64), 0, l)
    active = np.arange(l)[None, :] < lens[:, None]
    ids = seqs[active]
    if ids.size and (ids.min() < 0 or ids.max() >= num_sync):
        raise ValueError(
            f"activity ids at active positions must lie in [0, {num_sync})"
        )
    return np.ascontiguousarray(seqs, dtype=np.int32), lens.astype(np.int32)


def prepare(seqs, lens, m, d0, endcost, device) -> Tuple[torch.Tensor, ...]:
    """The DP's inputs as the kernel takes them, on ``device``: (seqs (V, L)
    int32, lens (V,) int32, Mt (A, S) f32, d0 (S,) f32, endcost (S,) f32),
    all contiguous."""
    mt, d0p, endp = _host_tables(m, d0, endcost)
    seqs, lens = _host_seqs(seqs, lens, mt.shape[0])
    dev = torch.device(device)
    return tuple(
        torch.from_numpy(x).to(dev) for x in (seqs, lens, mt, d0p, endp)
    )


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
            ctypes.c_longlong, i, i, ip, ip, ip,
            ctypes.POINTER(ctypes.c_longlong),
        ]
        lib.align_dp_plan.restype = i
        lib.align_dp_launch.argtypes = [
            p, p, ctypes.c_longlong, i, p, i, p, p, p, p, i, i, i, p,
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


def launch(seqs, lens, mt, d0, endcost, out) -> None:
    """One launch on prepared device tensors (see :func:`prepare`) into a
    (V,) f32 ``out``.  Counts nothing: :func:`align_dp_device` counts its
    launches."""
    v, l = seqs.shape
    s = mt.shape[1]
    dev = seqs.device
    lib = _library()
    grid, smem, branch = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    scratch_n = ctypes.c_longlong()
    with torch.cuda.device(dev):
        rc = lib.align_dp_plan(
            v, s, torch.cuda.get_device_properties(dev).multi_processor_count,
            ctypes.byref(grid), ctypes.byref(smem), ctypes.byref(branch),
            ctypes.byref(scratch_n),
        )
        if rc != 0:
            _raise(lib, "plan", rc)
        scratch = (
            torch.empty((scratch_n.value,), dtype=torch.float32, device=dev)
            if branch.value == 0 else None
        )
        rc = lib.align_dp_launch(
            seqs.data_ptr(), lens.data_ptr(), v, l, mt.data_ptr(), s,
            d0.data_ptr(), endcost.data_ptr(), out.data_ptr(),
            scratch.data_ptr() if scratch is not None else None,
            grid.value, smem.value, branch.value,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        _raise(lib, "launch", rc)
    last_launch.update(
        variants=v, layers=l, states=s, grid=grid.value, threads=256,
        smem_bytes=smem.value,
        branch="shared" if branch.value == 1 else "global",
    )


def align_dp_device(seqs, lens, mt, d0, endcost) -> torch.Tensor:
    """One DP on prepared tensors (see :func:`prepare`), on their device:
    the CUDA kernel for CUDA tensors, :func:`align_dp_plain` for CPU ones.
    Returns (V,) f32 on that device."""
    if not seqs.is_cuda:
        return align_dp_plain(seqs, lens, mt, d0, endcost)
    t = (seqs, lens, mt, d0, endcost)
    if any(x.device != seqs.device for x in t):
        raise ValueError("all inputs of a launch must lie on one card")
    want = (torch.int32, torch.int32, torch.float32, torch.float32, torch.float32)
    if any(x.dtype != w or not x.is_contiguous() for x, w in zip(t, want)):
        raise ValueError(
            "align_dp_device takes contiguous int32 seqs/lens and float32 "
            "mt/d0/endcost (see prepare)"
        )
    v = seqs.shape[0]
    s = mt.shape[1]
    if lens.shape != (v,) or d0.shape != (s,) or endcost.shape != (s,):
        raise ValueError("lens, d0 or endcost has the wrong shape")
    out = torch.empty((v,), dtype=torch.float32, device=seqs.device)
    if v:
        launch(seqs, lens, mt, d0, endcost, out)
        launch_counts["align_dp"] += 1
    return out


def _align_dp(
    seqs,
    lens,
    m,
    d0,
    endcost,
    *,
    backend: str = "auto",
    device="cuda",
) -> np.ndarray:
    """Per-variant alignment cost of the layered DFG-alignment DP, as a host
    (V,) float32 array.

    ``seqs`` (V, L) activity ids (positions at or past ``lens`` are not
    read), ``m`` (S, A) the model-move+sync cost closure, ``d0`` /
    ``endcost`` (S,) the virtual-START/END folds.  ``backend``: ``auto`` or
    ``kernel`` (the CUDA kernel on a CUDA ``device``, the plain version on
    the CPU) | ``numpy`` (the host oracle)."""
    if backend not in ("auto", "kernel", "numpy"):
        raise ValueError(f"unknown align_dp backend {backend!r}")
    if backend == "numpy":
        mt, d0p, endp = _host_tables(m, d0, endcost)
        seqs, lens = _host_seqs(seqs, lens, mt.shape[0])
        if seqs.shape[0] == 0:
            return np.zeros((0,), dtype=np.float32)
        return align_dp_numpy(seqs, lens, mt.T, d0p, endp)
    inputs = prepare(seqs, lens, m, d0, endcost, resolve_device(device))
    return align_dp_device(*inputs).cpu().numpy()


# every call lands in the process-global kernel registry as
# kernel_seconds{kernel=align_dp} (see repro_torch.kernels.timing)
align_dp = timed_kernel("align_dp", _align_dp)
