"""Device resolution for the port's entry points.

Every entry point (``QueryEngine``, ``core.dfg.dfg``, ``launch/mine.py``)
runs on the card unless the caller asks for the CPU.  There is no silent
fallback: asking for ``cuda`` on a host without a card is an error.
"""

from __future__ import annotations

import contextlib

import torch

__all__ = ["resolve_device", "device_scope"]


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a :class:`torch.device`; raises ``RuntimeError`` when it
    names CUDA and no card is present."""
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but no CUDA card is available "
            "(torch.cuda.is_available() is False); pass device='cpu' to run "
            "on the host"
        )
    return dev


def device_scope(dev: torch.device):
    """A context in which CUDA device ``dev`` is current: no context at all
    when it is already current, so a kernel launch on the current card does
    not switch devices twice."""
    if dev.index is None or dev.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(dev)
