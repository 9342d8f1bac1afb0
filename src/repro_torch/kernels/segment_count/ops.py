"""Segment count — the hand-written CUDA kernel's wrapper and plain version.

``segment_count(ids, valid=None, *, num_segments)`` returns the int64
``(num_segments,)`` histogram ``bincount(ids[valid], minlength=S)`` on the
tensors' device, ids outside ``[0, S)`` dropped:

* on a CUDA tensor it launches ``csrc/segment_count.cu`` (built at first
  use, see :mod:`repro_torch.kernels.build`) or raises — there is no
  fallback;
* on a CPU tensor it runs the plain PyTorch version
  (:func:`segment_count_plain`), a masked ``torch.bincount``.

``ids`` may be of any integer dtype, ``valid`` of bool / int / float, or
``None`` (count every id).  Each launch adds one to :data:`launch_counts`.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from ..dfg_count.ops import _as_tensor, _valid_mask
from ..timing import timed_kernel

__all__ = [
    "segment_count",
    "segment_count_plain",
    "launch",
    "launch_counts",
    "reset_launch_counts",
    "last_launch",
    "MAX_SEGMENTS",
]

#: the kernel takes the segment count as a C int
MAX_SEGMENTS = (1 << 31) - 1

#: kernel launches — one per launch, nowhere else
launch_counts: Dict[str, int] = {"segment_count": 0}
#: configuration of the most recent launch (grid, smem bytes, branch)
last_launch: Dict[str, object] = {}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def segment_count_plain(ids, valid=None, *, num_segments: int) -> torch.Tensor:
    """``bincount(ids[valid & (0 <= ids < S)], minlength=S)`` in int64."""
    s = int(num_segments)
    ids = _as_tensor(ids).to(torch.int64)
    m = (ids >= 0) & (ids < s)
    if valid is not None:
        m = m & _valid_mask(_as_tensor(valid))
    return torch.bincount(ids[m], minlength=s)


# ---------------------------------------------------------------------------
# CUDA launch
# ---------------------------------------------------------------------------

_lib: Optional[ctypes.CDLL] = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from ..build import load

        lib = load("segment_count")
        p = ctypes.c_void_p
        lib.segment_count_launch.argtypes = [
            p, p, ctypes.c_longlong, ctypes.c_int, p, ctypes.c_int, p,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.segment_count_launch.restype = ctypes.c_int
        lib.segment_count_error_string.argtypes = [ctypes.c_int]
        lib.segment_count_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def launch(
    ids: torch.Tensor,
    valid: Optional[torch.Tensor],
    out: torch.Tensor,
    num_segments: int,
) -> None:
    """One launch on already-converted device columns (contiguous int32
    ids, contiguous uint8 valid or ``None``) into a zeroed int64 ``out``.
    Counts nothing: the public wrapper counts its launches."""
    n = ids.shape[0]
    dev = ids.device
    grid, smem, branch = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    lib = _library()
    with torch.cuda.device(dev):
        rc = lib.segment_count_launch(
            ids.data_ptr(), valid.data_ptr() if valid is not None else None,
            n, int(num_segments), out.data_ptr(),
            torch.cuda.get_device_properties(dev).multi_processor_count,
            torch.cuda.current_stream(dev).cuda_stream,
            ctypes.byref(grid), ctypes.byref(smem), ctypes.byref(branch),
        )
    if rc != 0:
        raise RuntimeError(
            f"segment_count launch failed: CUDA error {rc} "
            f"({lib.segment_count_error_string(rc).decode()})"
        )
    last_launch.update(
        ids=n, num_segments=int(num_segments), valid=valid is not None,
        grid=grid.value, threads=256, smem_bytes=smem.value,
        branch="shared" if branch.value == 1 else "global",
    )


def _narrow_ids(ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Contiguous int32 ids for the kernel.  Ids of another dtype are
    checked against ``[0, S)`` before the cast and set to -1 outside it, so
    an int64 id such as ``2**32 + 5`` is dropped, as the plain version drops
    it, instead of wrapping into range."""
    if ids.dtype != torch.int32:
        wide = ids.to(torch.int64)
        ids = torch.where((wide >= 0) & (wide < num_segments), wide, -1)
    return ids.to(torch.int32).contiguous()


def _segment_count(ids, valid=None, *, num_segments: int) -> torch.Tensor:
    """Per-segment counts (num_segments, int64) of the valid ids."""
    ids = _as_tensor(ids)
    if valid is not None:
        valid = _as_tensor(valid)
    if not ids.is_cuda:
        return segment_count_plain(ids, valid, num_segments=num_segments)
    s = int(num_segments)
    if not 0 <= s <= MAX_SEGMENTS:
        raise ValueError(
            f"num_segments={s}: the kernel takes 0 <= S <= {MAX_SEGMENTS}"
        )
    if ids.dim() != 1:
        raise ValueError(f"ids must be one-dimensional, got {tuple(ids.shape)}")
    if valid is not None:
        if valid.device != ids.device:
            raise ValueError(
                f"ids on {ids.device} and valid on {valid.device}: all inputs "
                "of a launch must lie on one card"
            )
        if valid.shape != ids.shape:
            raise ValueError("ids and valid must have the same length")
        valid = _valid_mask(valid).contiguous().view(torch.uint8)
    ids = _narrow_ids(ids, s)
    out = torch.zeros((s,), dtype=torch.int64, device=ids.device)
    if ids.shape[0] and s:
        launch(ids, valid, out, s)
        launch_counts["segment_count"] += 1
    return out


# every call lands in the process-global kernel registry as
# kernel_seconds{kernel=segment_count} (see repro_torch.kernels.timing)
segment_count = timed_kernel("segment_count", _segment_count)
