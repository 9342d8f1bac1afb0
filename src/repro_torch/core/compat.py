"""The device mesh of the port.

The reference builds ``jax.sharding.Mesh`` objects through one helper
(``make_mesh``) so every mesh-shaped caller sees the same type.  The port's
counterpart is a small :class:`Mesh`: an array of ``torch.device`` entries
laid out in the mesh's shape, with one name per axis.  Code that reduces
over the mesh (:mod:`repro_torch.core.distributed`) walks the axes in
order, so the shape and the names are all it needs.

A position of the mesh is one slot of ``devices``.  In one process, each
position counts its shard on its own device and the partial sums are
reduced in the host process; across processes (a ``torch.distributed``
process group), rank ``r`` owns position ``r`` of the flattened mesh.
Several positions may name the same device: two ranks that share one card,
or a test that lays a 2×2 mesh over the CPU.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device

__all__ = ["Mesh", "make_mesh", "visible_cards"]


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """``devices`` (an object array of ``torch.device``, one per position,
    in the mesh's shape) and one name per axis.  Every device is resolved on
    construction, so a mesh that names ``cuda`` on a host without a card
    raises ``RuntimeError``."""

    devices: np.ndarray
    axis_names: Tuple[str, ...]

    def __post_init__(self):
        devs = np.asarray(self.devices, dtype=object)
        names = tuple(str(n) for n in self.axis_names)
        if devs.ndim != len(names):
            raise ValueError(
                f"a mesh of shape {devs.shape} needs {devs.ndim} axis names, "
                f"got {names}"
            )
        if len(set(names)) != len(names):
            raise ValueError(f"mesh axis names repeat: {names}")
        if devs.size == 0:
            raise ValueError("a mesh needs at least one position")
        resolved = np.empty(devs.shape, dtype=object)
        for idx, d in np.ndenumerate(devs):
            resolved[idx] = resolve_device(d)
        object.__setattr__(self, "devices", resolved)
        object.__setattr__(self, "axis_names", names)

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name → size, in axis order (``jax.sharding.Mesh.shape``)."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def flat_devices(self) -> Tuple[torch.device, ...]:
        """The devices of the positions in row-major order (position ``r``
        is rank ``r`` across processes)."""
        return tuple(self.devices.reshape(-1))

    def __repr__(self) -> str:
        shape = "×".join(f"{n}={s}" for n, s in self.shape.items())
        return f"Mesh({shape}, devices={[str(d) for d in self.flat_devices()]})"


def visible_cards() -> Tuple[torch.device, ...]:
    """Every CUDA card this process sees (none on a host without one)."""
    if not torch.cuda.is_available():
        return ()
    return tuple(torch.device("cuda", i) for i in range(torch.cuda.device_count()))


def make_mesh(
    axis_shapes: Sequence[int],
    axis_names: Sequence[str],
    *,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """A :class:`Mesh` of ``axis_shapes`` over ``devices`` (default: the
    first ``prod(axis_shapes)`` visible cards).  Without enough cards it
    raises ``RuntimeError``: the port never lays a mesh on the CPU unless
    the caller passes CPU devices."""
    n = math.prod(int(s) for s in axis_shapes)
    if devices is None:
        cards = visible_cards()
        if len(cards) < n:
            raise RuntimeError(
                f"a mesh of {n} positions needs {n} CUDA cards; this host has "
                f"{len(cards)} (torch.cuda.is_available() is "
                f"{torch.cuda.is_available()}); pass devices= to lay it out "
                "explicitly"
            )
        devices = cards[:n]
    devices = list(devices)
    if len(devices) != n:
        raise ValueError(
            f"a mesh of shape {tuple(axis_shapes)} needs {n} devices, got "
            f"{len(devices)}"
        )
    arr = np.empty(n, dtype=object)
    for i, d in enumerate(devices):
        arr[i] = d
    return Mesh(arr.reshape(tuple(int(s) for s in axis_shapes)), tuple(axis_names))
