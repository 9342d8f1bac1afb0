"""DFG count — the hand-written CUDA kernel's wrappers and plain versions.

``dfg_count`` / ``dfg_count_diced`` take pair columns (ids of any integer
dtype, ``valid`` of bool / int / float) and return the int64 ``(A, A)``
count matrix Ψ on the tensors' device:

* on a CUDA tensor they launch ``csrc/dfg_count.cu`` (built at first use,
  see :mod:`repro_torch.kernels.build`) or raise — there is no fallback.
  The kernel counts in shared memory: a dense counter per cell for small
  A (branch ``"shared"``), an open-addressing table of :data:`HASH_SLOTS`
  slots above (``"hash"``), whose overflow adds straight into the output;
  ``last_launch`` names the branch.  When ``dst`` is ``src``'s successor
  view of one column (``src = x[:-1]``, ``dst = x[1:]``, as the query
  engine passes them), and likewise the timestamps, the kernel reads that
  one column (``last_launch["columns"] == "shifted"``);
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
    "BRANCHES",
    "RUN",
    "HASH_SLOTS",
    "MAX_PROBES",
]

#: the kernel indexes pairs with 64-bit offsets but the wrapper keeps the
#: pair count below 2**31, like the int32 columns that feed it
MAX_PAIRS = (1 << 31) - 1
#: the key ``src·A + dst`` is an int32 in the kernel
MAX_ACTIVITIES = 46340

#: the kernel's branches, by the code ``dfg_count_launch`` reports
#: (``kBranchNames`` in ``csrc/dfg_count.cu``)
BRANCHES = ("shared", "hash")
#: consecutive pairs a thread counts (``kRun``)
RUN = 8
#: slots of the "hash" branch's table and the probes a pair may take
#: before it overflows into a global atomic (``kHashSlots``, ``kMaxProbes``)
HASH_SLOTS = 16384
MAX_PROBES = 8

#: kernel launches per entry point — one per launch, nowhere else
launch_counts: Dict[str, int] = {"dfg_count": 0, "dfg_count_diced": 0}
#: configuration of the most recent launch (branch, columns, grid, threads,
#: smem bytes, table slots)
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


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a library built from ``dfg_count.cu``
    and check that its branch names are :data:`BRANCHES`."""
    p, i = ctypes.c_void_p, ctypes.c_int
    out = ctypes.POINTER(ctypes.c_int)
    lib.dfg_count_launch.argtypes = [
        p, p, p, p, p, ctypes.c_double, ctypes.c_double, i, i,
        ctypes.c_longlong, i, p, p, p, out, out, out, out,
    ]
    lib.dfg_count_launch.restype = i
    lib.dfg_count_branch_name.argtypes = [i]
    lib.dfg_count_branch_name.restype = ctypes.c_char_p
    lib.dfg_count_error_string.argtypes = [i]
    lib.dfg_count_error_string.restype = ctypes.c_char_p
    names = tuple(
        lib.dfg_count_branch_name(code).decode() for code in range(len(BRANCHES))
    )
    if names != BRANCHES or lib.dfg_count_branch_name(len(BRANCHES)):
        raise RuntimeError(f"dfg_count library names its branches {names}")
    return lib


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from ..build import load

        _lib = _bind(load("dfg_count"))
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


def _is_successor(a: torch.Tensor, b: torch.Tensor) -> bool:
    """True when ``a = x[:-1]`` and ``b = x[1:]`` for one column ``x``: both
    1-D and contiguous, one dtype, one storage, ``b`` starting one element
    after ``a``.  The cheap tests come first; this runs on every launch."""
    return (
        b.storage_offset() == a.storage_offset() + 1
        and a.dim() == 1 and a.shape == b.shape and a.shape[0] > 0
        and a.dtype == b.dtype and a.device == b.device
        and a.is_contiguous() and b.is_contiguous()
        and a.untyped_storage().data_ptr() == b.untyped_storage().data_ptr()
    )


def _successor_column(a: torch.Tensor, b: torch.Tensor) -> Optional[torch.Tensor]:
    """The column ``x`` of ``n + 1`` entries with ``a = x[:-1]`` and
    ``b = x[1:]`` (:func:`_is_successor`), else None."""
    return a.as_strided((a.shape[0] + 1,), (1,)) if _is_successor(a, b) else None


def _call(
    lib: ctypes.CDLL,
    src: torch.Tensor,
    dst: torch.Tensor,
    valid: torch.Tensor,
    out: torch.Tensor,
    num_activities: int,
    ts_src: Optional[torch.Tensor],
    ts_dst: Optional[torch.Tensor],
    window: Optional[Sequence[float]],
    stats: Optional[torch.Tensor],
    stream: Optional[int],
) -> None:
    """One ``dfg_count_launch`` on the tensors' memory through ``lib``."""
    n = src.shape[0]
    if not n:
        return
    has_window = window is not None
    t0, t1 = window if has_window else (0.0, 0.0)
    if stats is not None and (stats.dtype != torch.int64 or stats.numel() != 2):
        raise ValueError("stats must be a zeroed int64 tensor of 2 entries")
    shifted = _is_successor(src, dst) and (
        not has_window or _is_successor(ts_src, ts_dst)
    )
    grid, threads = ctypes.c_int(), ctypes.c_int()
    smem, branch = ctypes.c_int(), ctypes.c_int()
    rc = lib.dfg_count_launch(
        src.data_ptr(), None if shifted else dst.data_ptr(), valid.data_ptr(),
        ts_src.data_ptr() if has_window else None,
        ts_dst.data_ptr() if has_window and not shifted else None,
        float(t0), float(t1), int(has_window), int(shifted), n,
        int(num_activities), out.data_ptr(),
        None if stats is None else stats.data_ptr(), stream,
        ctypes.byref(grid), ctypes.byref(threads), ctypes.byref(smem),
        ctypes.byref(branch),
    )
    if rc != 0:
        raise RuntimeError(
            f"dfg_count launch failed: CUDA error {rc} "
            f"({lib.dfg_count_error_string(rc).decode()})"
        )
    name = BRANCHES[branch.value]
    last_launch.update(
        pairs=n, num_activities=int(num_activities), window=has_window,
        columns="shifted" if shifted else "separate", grid=grid.value,
        threads=threads.value, smem_bytes=smem.value, branch=name,
        table_slots=HASH_SLOTS if name == "hash" else int(num_activities) ** 2,
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
    stats: Optional[torch.Tensor] = None,
) -> None:
    """One launch on already-converted device columns (int32 ids, uint8
    valid, float64 timestamps, each contiguous; ``dst`` may be ``src``'s
    successor view, and ``ts_dst`` ``ts_src``'s) into a zeroed int64
    ``out``.  ``stats``, a zeroed int64 tensor of 2 entries, receives the
    pairs that overflowed the hash table and the flush's global atomics.
    Counts nothing: the public wrappers count their launches."""
    dev = src.device
    with torch.cuda.device(dev):
        _call(
            _library(), src, dst, valid, out, num_activities, ts_src, ts_dst,
            window, stats, torch.cuda.current_stream(dev).cuda_stream,
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
    col = _successor_column(src, dst)
    if col is not None:
        # successor views stay views of one converted column
        col = _narrow_ids(col, int(num_activities))
        src, dst = col[:-1], col[1:]
    else:
        src = _narrow_ids(src, int(num_activities))
        dst = _narrow_ids(dst, int(num_activities))
    valid = _valid_mask(valid).contiguous().view(torch.uint8)
    n = src.shape[0]
    if dst.shape[0] != n or valid.shape[0] != n:
        raise ValueError("src, dst and valid must have the same length")
    check_limits(n, int(num_activities))
    return src, dst, valid


def _device_timestamps(ts_src, ts_dst):
    col = _successor_column(ts_src, ts_dst)
    if col is not None:
        col = col.to(torch.float64).contiguous()
        return col[:-1], col[1:]
    return ts_src.to(torch.float64).contiguous(), ts_dst.to(torch.float64).contiguous()


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
    ts_src, ts_dst = _device_timestamps(ts_src, ts_dst)
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
