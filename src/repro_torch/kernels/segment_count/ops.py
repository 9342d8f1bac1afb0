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

from ...device import device_scope
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
    "BRANCHES",
]

#: the kernel takes the segment count as a C int
MAX_SEGMENTS = (1 << 31) - 1

#: the kernel's branches, by the code ``segment_count_launch`` reports
#: (``kBranchNames`` in ``csrc/segment_count.cu``)
BRANCHES = ("global", "shared")

#: kernel launches — one per launch, nowhere else
launch_counts: Dict[str, int] = {"segment_count": 0}
#: configuration of the most recent launch (branch, grid, the blocks per
#: SM the card's occupancy allows, threads, smem bytes, and
#: ``flush_bound``: at most grid × S global atomics flush the shared
#: branch's bins, 0 on the global branch)
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
#: a launch's configuration as the library writes it back: grid, blocks per
#: SM, threads, dynamic shared-memory bytes, branch code
_Config = ctypes.c_int * 5


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a library built from
    ``segment_count.cu`` and check that its branch names are
    :data:`BRANCHES`."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.segment_count_launch.argtypes = [
        p, p, ctypes.c_longlong, i, p, p, ctypes.POINTER(_Config),
    ]
    lib.segment_count_launch.restype = i
    lib.segment_count_branch_name.argtypes = [i]
    lib.segment_count_branch_name.restype = ctypes.c_char_p
    lib.segment_count_error_string.argtypes = [i]
    lib.segment_count_error_string.restype = ctypes.c_char_p
    names = tuple(
        lib.segment_count_branch_name(code).decode()
        for code in range(len(BRANCHES))
    )
    if names != BRANCHES or lib.segment_count_branch_name(len(BRANCHES)):
        raise RuntimeError(f"segment_count library names its branches {names}")
    return lib


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from ..build import load

        _lib = _bind(load("segment_count"))
    return _lib


def _call(
    lib: ctypes.CDLL,
    ids: torch.Tensor,
    valid: Optional[torch.Tensor],
    out: torch.Tensor,
    num_segments: int,
    stream: Optional[int],
) -> None:
    """One ``segment_count_launch`` on the tensors' memory through ``lib``."""
    n = ids.shape[0]
    if not n:
        return
    s = int(num_segments)
    config = _Config()
    rc = lib.segment_count_launch(
        ids.data_ptr(), valid.data_ptr() if valid is not None else None, n, s,
        out.data_ptr(), stream, config,
    )
    if rc != 0:
        raise RuntimeError(
            f"segment_count launch failed: CUDA error {rc} "
            f"({lib.segment_count_error_string(rc).decode()})"
        )
    grid, per_sm, threads, smem, branch = config
    name = BRANCHES[branch]
    last_launch.update(
        ids=n, num_segments=s, valid=valid is not None, grid=grid,
        blocks_per_sm=per_sm, threads=threads, smem_bytes=smem, branch=name,
        flush_bound=grid * s if name == "shared" else 0,
    )


def launch(
    ids: torch.Tensor,
    valid: Optional[torch.Tensor],
    out: torch.Tensor,
    num_segments: int,
) -> None:
    """One launch on already-converted device columns (int32 ids, uint8
    valid or ``None``, each contiguous, at any offset) into a zeroed int64
    ``out``.  Counts nothing: the public wrapper counts its launches."""
    with device_scope(ids.device):
        _call(_library(), ids, valid, out, num_segments,
              torch.cuda.current_stream().cuda_stream)


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
