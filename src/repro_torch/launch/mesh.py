"""Production meshes.

Built as FUNCTIONS so importing this module never touches a process group.
A ``DeviceMesh`` of more than one position needs ``torch.distributed``
initialized with at least as many ranks (``dryrun.py`` starts a fake group
of 256 or 512 ranks in one process; a real run starts one rank per card).
"""

from __future__ import annotations

import math

__all__ = ["make_production_mesh", "make_test_mesh", "mesh_devices"]


def _world_size() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 0


def make_production_mesh(*, multi_pod: bool = False, device_type="cuda"):
    """The (16, 16) ``("data", "model")`` mesh, or (2, 16, 16) with a
    leading ``"pod"`` axis, over the ranks of the default process group."""
    from torch.distributed.device_mesh import init_device_mesh

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    have = _world_size()
    if have < n:
        raise RuntimeError(
            f"need {n} devices for the production mesh, have {have} — "
            "run under dryrun.py (placeholder host devices) or on the pod"
        )
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_test_mesh(shape=(1, 1), axes=("data", "model"), device_type="cuda"):
    """A small mesh: a ``DeviceMesh`` over the default process group's
    ranks when one is initialized, else (one position only) the port's
    plain :class:`~repro_torch.core.compat.Mesh` of one device, which needs
    no process group."""
    n = math.prod(shape)
    if _world_size():
        from torch.distributed.device_mesh import init_device_mesh

        return init_device_mesh(device_type, tuple(shape),
                                mesh_dim_names=tuple(axes))
    if n != 1:
        raise RuntimeError(
            f"a test mesh of {n} positions needs torch.distributed "
            "initialized with at least as many ranks")
    from repro_torch.core.compat import make_mesh

    return make_mesh(tuple(shape), tuple(axes), devices=[device_type])


def mesh_devices(mesh) -> int:
    from repro_torch.sharding.spec import mesh_axis_sizes

    return math.prod(mesh_axis_sizes(mesh).values())
