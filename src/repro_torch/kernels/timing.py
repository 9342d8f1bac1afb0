"""Wall-clock timing hook for the CUDA kernel entry points.

Each public op (``dfg_count``, ``dfg_count_diced``) is wrapped once at
import time; every call lands in the process-global
:func:`repro_torch.obs.kernel_registry` as a ``kernel_seconds{kernel=<name>}``
histogram.  Kernels are process-wide entry points shared by every engine,
so their timings live in the global registry rather than any per-engine one.

The wrapper waits for the card (``torch.cuda.synchronize``) when the result
is a CUDA tensor, so the histogram records true wall time, not the enqueue
time; callers copy the result back to the host right after anyway, so
nothing is serialized that was not already.  The first call of a kernel
includes building its library — that *is* the wall time the triggering
query paid.
"""

from __future__ import annotations

import functools
from time import perf_counter

import torch

from repro_torch.obs.metrics import kernel_registry

__all__ = ["timed_kernel"]


def timed_kernel(name: str, fn):
    """Wrap a kernel entry point; records wall seconds per call."""
    hist = kernel_registry().histogram("kernel_seconds", kernel=name)

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        t0 = perf_counter()
        out = fn(*args, **kwargs)
        if isinstance(out, torch.Tensor) and out.is_cuda:
            torch.cuda.synchronize(out.device)
        hist.observe(perf_counter() - t0)
        return out

    return wrapper
