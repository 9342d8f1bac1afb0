"""DFG count — the hand-written CUDA kernel's wrappers and plain versions.

``dfg_count`` / ``dfg_count_diced`` take pair columns (ids of any integer
dtype, ``valid`` of bool / int / float) and return the int64 ``(A, A)``
count matrix Ψ on the tensors' device:

* on a CUDA tensor they launch ``csrc/dfg_count.cu`` (built at first use,
  see :mod:`repro_torch.kernels.build`) or raise — there is no fallback;
* on a CPU tensor they run the plain PyTorch version
  (:func:`dfg_count_plain` / :func:`dfg_count_diced_plain`), a masked
  ``bincount`` on the key ``src·A + dst``.

The window ``[t0, t1)`` is compared in float64 on both paths.  Ids outside
``[0, A)`` are dropped.  Each launch adds one to :data:`launch_counts`.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..timing import timed_kernel

__all__ = [
    "dfg_count",
    "dfg_count_diced",
    "dfg_count_plain",
    "dfg_count_diced_plain",
    "launch_counts",
    "reset_launch_counts",
    "last_launch",
    "MAX_PAIRS",
    "MAX_ACTIVITIES",
]

#: the kernel indexes pairs with 64-bit offsets but the wrapper keeps the
#: pair count below 2**31, like the int32 columns that feed it
MAX_PAIRS = (1 << 31) - 1
#: the key ``src·A + dst`` is an int32 in the kernel
MAX_ACTIVITIES = 46340

#: kernel launches per entry point — one per launch, nowhere else
launch_counts: Dict[str, int] = {"dfg_count": 0, "dfg_count_diced": 0}
#: configuration of the most recent launch (grid, smem bytes, branch)
last_launch: Dict[str, object] = {}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


# ---------------------------------------------------------------------------
# Plain versions (CPU path, and the yardstick the kernel is held against)
# ---------------------------------------------------------------------------


def _as_tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(np.asarray(x))


def _valid_mask(valid: torch.Tensor) -> torch.Tensor:
    return valid if valid.dtype == torch.bool else valid != 0


def dfg_count_plain(src, dst, valid, *, num_activities: int) -> torch.Tensor:
    a = int(num_activities)
    src = _as_tensor(src).to(torch.int64)
    dst = _as_tensor(dst).to(torch.int64)
    m = _valid_mask(_as_tensor(valid))
    m = m & (src >= 0) & (src < a) & (dst >= 0) & (dst < a)
    key = src[m] * a + dst[m]
    return torch.bincount(key, minlength=a * a).reshape(a, a)


def dfg_count_diced_plain(
    src, dst, valid, ts_src, ts_dst, window, *, num_activities: int
) -> torch.Tensor:
    t0, t1 = _window(window)
    ts_src = _as_tensor(ts_src).to(torch.float64)
    ts_dst = _as_tensor(ts_dst).to(torch.float64)
    m = _valid_mask(_as_tensor(valid))
    m = m & (ts_src >= t0) & (ts_src < t1) & (ts_dst >= t0) & (ts_dst < t1)
    return dfg_count_plain(src, dst, m, num_activities=num_activities)


def _window(window) -> tuple:
    w = window.tolist() if isinstance(window, torch.Tensor) else window
    w = np.asarray(w, dtype=np.float64).reshape(-1)
    if w.shape[0] != 2:
        raise ValueError(f"window must hold [t0, t1), got {w.shape[0]} values")
    return float(w[0]), float(w[1])


# ---------------------------------------------------------------------------
# CUDA launch
# ---------------------------------------------------------------------------

_lib: Optional[ctypes.CDLL] = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from ..build import load

        lib = load("dfg_count")
        p = ctypes.c_void_p
        lib.dfg_count_launch.argtypes = [
            p, p, p, p, p, ctypes.c_double, ctypes.c_double, ctypes.c_int,
            ctypes.c_longlong, ctypes.c_int, p, ctypes.c_int, p,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.dfg_count_launch.restype = ctypes.c_int
        lib.dfg_count_error_string.argtypes = [ctypes.c_int]
        lib.dfg_count_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check_limits(num_pairs: int, num_activities: int) -> None:
    """The card-side limits of one launch (raises ``ValueError``)."""
    if num_pairs > MAX_PAIRS:
        raise ValueError(
            f"{num_pairs} pairs: the kernel takes fewer than 2**31 per launch"
        )
    if not 0 <= num_activities <= MAX_ACTIVITIES:
        raise ValueError(
            f"num_activities={num_activities}: the kernel's int32 key "
            f"src*A+dst needs 0 <= A <= {MAX_ACTIVITIES}"
        )


def launch(
    src: torch.Tensor,
    dst: torch.Tensor,
    valid: torch.Tensor,
    out: torch.Tensor,
    num_activities: int,
    ts_src: Optional[torch.Tensor] = None,
    ts_dst: Optional[torch.Tensor] = None,
    window: Optional[Sequence[float]] = None,
) -> None:
    """One launch on already-converted device columns (int32 ids, uint8
    valid, float64 timestamps, all contiguous) into a zeroed int64 ``out``.
    Counts nothing: the public wrappers count their launches."""
    n = src.shape[0]
    has_window = window is not None
    t0, t1 = window if has_window else (0.0, 0.0)
    dev = src.device
    grid, smem, branch = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    lib = _library()
    with torch.cuda.device(dev):
        rc = lib.dfg_count_launch(
            src.data_ptr(), dst.data_ptr(), valid.data_ptr(),
            ts_src.data_ptr() if has_window else None,
            ts_dst.data_ptr() if has_window else None,
            float(t0), float(t1), int(has_window), n, int(num_activities),
            out.data_ptr(),
            torch.cuda.get_device_properties(dev).multi_processor_count,
            torch.cuda.current_stream(dev).cuda_stream,
            ctypes.byref(grid), ctypes.byref(smem), ctypes.byref(branch),
        )
    if rc != 0:
        raise RuntimeError(
            f"dfg_count launch failed: CUDA error {rc} "
            f"({lib.dfg_count_error_string(rc).decode()})"
        )
    last_launch.update(
        pairs=n, num_activities=int(num_activities), window=has_window,
        grid=grid.value, threads=256, smem_bytes=smem.value,
        branch="shared" if branch.value == 1 else "global",
    )


def _narrow_ids(ids: torch.Tensor, num_activities: int) -> torch.Tensor:
    """Contiguous int32 ids for the kernel.  Ids of another dtype are
    checked against ``[0, A)`` before the cast and set to -1 outside it, so
    an int64 id such as ``2**32 + 5`` is dropped, as the plain version
    drops it, instead of wrapping into range."""
    if ids.dtype != torch.int32:
        wide = ids.to(torch.int64)
        ids = torch.where((wide >= 0) & (wide < num_activities), wide, -1)
    return ids.to(torch.int32).contiguous()


def _device_columns(src, dst, valid, num_activities):
    for t in (dst, valid):
        if t.device != src.device:
            raise ValueError(
                f"pair columns on {src.device} and {t.device}: all inputs of "
                "a launch must lie on one card"
            )
    src = _narrow_ids(src, int(num_activities))
    dst = _narrow_ids(dst, int(num_activities))
    valid = _valid_mask(valid).contiguous().view(torch.uint8)
    n = src.shape[0]
    if dst.shape[0] != n or valid.shape[0] != n:
        raise ValueError("src, dst and valid must have the same length")
    check_limits(n, int(num_activities))
    return src, dst, valid


def _dfg_count(src, dst, valid, *, num_activities: int) -> torch.Tensor:
    """DFG count matrix (num_activities², int64) from pair columns."""
    src, dst, valid = (_as_tensor(x) for x in (src, dst, valid))
    if not src.is_cuda:
        return dfg_count_plain(src, dst, valid, num_activities=num_activities)
    src, dst, valid = _device_columns(src, dst, valid, num_activities)
    a = int(num_activities)
    out = torch.zeros((a, a), dtype=torch.int64, device=src.device)
    if src.shape[0]:
        launch(src, dst, valid, out, a)
        launch_counts["dfg_count"] += 1
    return out


def _dfg_count_diced(
    src, dst, valid, ts_src, ts_dst, window, *, num_activities: int
) -> torch.Tensor:
    """Fused WHERE-clause dicing + counting (paper §4, Experiment 2)."""
    src, dst, valid, ts_src, ts_dst = (
        _as_tensor(x) for x in (src, dst, valid, ts_src, ts_dst)
    )
    if not src.is_cuda:
        return dfg_count_diced_plain(
            src, dst, valid, ts_src, ts_dst, window,
            num_activities=num_activities,
        )
    src, dst, valid = _device_columns(src, dst, valid, num_activities)
    ts_src = ts_src.to(torch.float64).contiguous()
    ts_dst = ts_dst.to(torch.float64).contiguous()
    n = src.shape[0]
    if ts_src.shape[0] != n or ts_dst.shape[0] != n:
        raise ValueError("timestamps must align with the pair columns")
    if ts_src.device != src.device or ts_dst.device != src.device:
        raise ValueError("timestamps must lie on the same card as the pairs")
    a = int(num_activities)
    out = torch.zeros((a, a), dtype=torch.int64, device=src.device)
    if n:
        launch(src, dst, valid, out, a, ts_src, ts_dst, _window(window))
        launch_counts["dfg_count_diced"] += 1
    return out


# every call lands in the process-global kernel registry as
# kernel_seconds{kernel=...} (see repro_torch.kernels.timing)
dfg_count = timed_kernel("dfg_count", _dfg_count)
dfg_count_diced = timed_kernel("dfg_count_diced", _dfg_count_diced)
