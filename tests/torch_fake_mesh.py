"""Child process of ``tests/test_torch_sharding_lm.py``: on a fake process
group of 256 (``16x16``) or 512 (``2x16x16``) ranks (this process rank 0),
builds the production ``DeviceMesh`` and checks, for one (arch, shape)
cell, every parameter's, batch leaf's and cache leaf's placements: the
local shard DTensor gives (``distribute_tensor`` of a ``meta`` tensor)
against ``NamedSharding.local_shape`` and against the global shape divided
by the product of the spec's axes' sizes.

    python tests/torch_fake_mesh.py ARCH SHAPE MESH OUT.json

The process group is destroyed in a ``finally``."""

import json
import math
import sys


def main(arch, shape_name, mesh_name, out):
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import Shard, distribute_tensor

    from repro_torch.configs import get_config, get_shape
    from repro_torch.launch.dryrun import _fake_process_group
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.steps import _abstract_batch, abstract_params
    from repro_torch.models import init_caches
    from repro_torch.sharding.spec import (
        batch_shardings, cache_shardings, make_rules, mesh_axis_sizes,
        param_shardings,
    )

    multi = mesh_name == "2x16x16"
    _fake_process_group(512 if multi else 256)
    try:
        mesh = make_production_mesh(multi_pod=multi, device_type="cpu")
        cfg, shape = get_config(arch), get_shape(shape_name)
        rules = make_rules(mesh, shape)
        sizes = mesh_axis_sizes(mesh)
        leaves = []
        p = abstract_params(cfg)
        for n, sh in param_shardings(rules, p, cfg).items():
            leaves.append((n, tuple(p.get_parameter(n).shape), sh))
        b = _abstract_batch(cfg, shape, True)
        for k, sh in batch_shardings(rules, b).items():
            leaves.append((k, tuple(b[k].shape), sh))
        caches = init_caches(cfg, shape.global_batch, shape.seq_len,
                             device="meta")
        for u, (unit, shs) in enumerate(zip(caches, cache_shardings(rules, caches))):
            for e, entry in unit.items():
                flat = dict(entry)
                flat.update(flat.pop("self", {}))
                sflat = dict(shs[e])
                sflat.update(sflat.pop("self", {}))
                for k, t in flat.items():
                    leaves.append((f"cache.{u}.{e}.{k}", tuple(t.shape), sflat[k]))
        bad, split = [], 0
        for name, gshape, sh in leaves:
            pl = sh.placements()
            local = tuple(distribute_tensor(
                torch.empty(gshape, device="meta"), mesh, pl).to_local().shape)
            want = []
            for d, n in enumerate(gshape):
                entry = sh.spec[d] if d < len(sh.spec) else None
                axes = (entry,) if isinstance(entry, str) else tuple(entry or ())
                want.append(n // math.prod(sizes[a] for a in axes))
                names = mesh.mesh_dim_names
                on = {names[i] for i, x in enumerate(pl)
                      if isinstance(x, Shard) and x.dim == d}
                if on != set(axes):
                    bad.append([name, "placements", str(pl), str(sh.spec)])
            split += tuple(want) != gshape
            if local != tuple(want) or sh.local_shape(gshape) != tuple(want):
                bad.append([name, list(gshape), list(local), want])
        with open(out, "w") as f:
            json.dump({"leaves": len(leaves), "split": split,
                       "mismatches": bad}, f)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(*sys.argv[1:5])
