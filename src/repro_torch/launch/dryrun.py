"""Multi-pod dry run: one rank's step of every (arch × shape × mesh) cell,
counted on ``meta`` tensors, with the H100 roofline.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch whisper-tiny \\
        --shape decode_32k --mesh single

For each cell, ``main()`` starts a fake process group of 256 (``16x16``)
or 512 (``2x16x16``) ranks in this process (this process is the rank
:func:`counted_rank` picks; the collectives return at once and move
nothing), builds the production ``DeviceMesh`` on it, builds the step
(:mod:`repro_torch.launch.steps`), runs the rank's step once on ``meta``
tensors of its local shapes and writes
:func:`repro_torch.roofline.analyze.analyze_step`'s result to
``{out}/{arch}__{shape}__{mesh}__{tag}.json``.  The group is destroyed
before the next cell and when ``main()`` returns or fails.  Importing this
module changes nothing: no environment variable, no process group.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

from repro_torch.configs import LONG_CONTEXT_SKIPS, SHAPES, cells, get_config, get_shape
from repro_torch.launch.mesh import make_production_mesh, mesh_devices
from repro_torch.launch.steps import (
    local_abstract_args,
    make_decode_step,
    make_prefill_step,
    make_train_step,
)
from repro_torch.roofline.analyze import analyze_step

__all__ = ["lower_cell", "run_cell", "counted_rank", "main", "ARTIFACT_DIR"]

#: default artifact directory: ``build/`` of the checkout (git-ignored)
ARTIFACT_DIR = os.path.join(
    os.path.dirname(__file__), "..", "..", "..", "build", "artifacts", "dryrun"
)


#: the size of the production meshes' ``model`` axis, their innermost:
#: position ``i`` of it (of the first ``data`` and ``pod`` position) is
#: rank ``i``
MODEL_RANKS = 16


def counted_rank(cfg) -> int:
    """The rank whose step a cell counts, one that holds and computes the
    most.  Where attention splits over query positions (fewer query heads
    than ``model`` ranks, whisper:
    :func:`~repro_torch.models.attention.splits_queries`) a rank's causal
    keys reach its block's end, so the last position of ``model``: rank
    15.  Elsewhere the first rank with the largest block of query heads
    (:meth:`~repro_torch.sharding.parallel.TensorParallel.block`: rank 1
    where 24 or 56 heads split unevenly over 16), which is rank 0 where the
    heads split evenly or there are none (mamba2)."""
    heads = cfg.n_heads
    if 0 < heads < MODEL_RANKS:
        return MODEL_RANKS - 1
    blocks = [(r + 1) * heads // MODEL_RANKS - r * heads // MODEL_RANKS
              for r in range(MODEL_RANKS)]
    return blocks.index(max(blocks))


def _config(arch: str, opts=None):
    cfg = get_config(arch)
    return dataclasses.replace(cfg, **opts) if opts else cfg


def _fake_process_group(world_size: int, rank: int = 0) -> None:
    """A fake process group of ``world_size`` ranks, this process ``rank``.
    ``FakeStore`` is private to PyTorch's test utilities (checked on torch
    2.13.0 for the CPU and 2.11.0 with CUDA 12.8); it needs no rendezvous
    and its collectives do nothing."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world_size)


def lower_cell(arch: str, shape_name: str, *, multi_pod: bool, opts=None):
    """Build one cell's step on the production mesh (a fake process group
    must be up); returns (fn, local args, donate, meta, cfg, shape, mesh)."""
    cfg = _config(arch, opts)
    shape = get_shape(shape_name)
    mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")

    t0 = time.time()
    if shape.kind == "train":
        fn, in_sh, out_sh, args, donate = make_train_step(cfg, shape, mesh)
    elif shape.kind == "prefill":
        fn, in_sh, out_sh, args, donate = make_prefill_step(cfg, shape, mesh)
    else:
        fn, in_sh, out_sh, args, donate = make_decode_step(cfg, shape, mesh)
    local = local_abstract_args(args, in_sh)
    meta = {
        "arch": arch,
        "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "chips": mesh_devices(mesh),
        "kind": shape.kind,
        "lower_s": round(time.time() - t0, 2),
    }
    return fn, local, donate, meta, cfg, shape, mesh


def run_cell(arch: str, shape_name: str, *, multi_pod: bool, opts=None,
             tag: str = "baseline") -> dict:
    import torch.distributed as dist

    _fake_process_group(512 if multi_pod else 256,
                        counted_rank(_config(arch, opts)))
    try:
        fn, local, donate, meta, cfg, shape, mesh = lower_cell(
            arch, shape_name, multi_pod=multi_pod, opts=opts
        )
        t0 = time.time()
        result = analyze_step(fn, local, cfg, shape, mesh, donate=donate)
        meta["compile_s"] = round(time.time() - t0, 2)
    finally:
        dist.destroy_process_group()
    meta["tag"] = tag
    meta.update(result)
    return meta


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true", help="run every assigned cell")
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--out", default=ARTIFACT_DIR)
    ap.add_argument("--opts", default=None,
                    help="JSON dict of ModelConfig overrides (perf iteration)")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    opts = json.loads(args.opts) if args.opts else None

    if args.all:
        todo = cells()
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        todo = [(args.arch, args.shape)]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    failures = 0
    for arch, shape_name in todo:
        if shape_name == "long_500k" and arch in LONG_CONTEXT_SKIPS:
            print(f"SKIP {arch} × long_500k (pure full attention, DESIGN §4)")
            continue
        for mp in meshes:
            mesh_tag = "2x16x16" if mp else "16x16"
            out_path = os.path.join(
                args.out, f"{arch}__{shape_name}__{mesh_tag}__{args.tag}.json"
            )
            try:
                result = run_cell(
                    arch, shape_name, multi_pod=mp, opts=opts, tag=args.tag
                )
                with open(out_path, "w") as f:
                    json.dump(result, f, indent=1)
                print(
                    f"OK   {arch} × {shape_name} × {mesh_tag}: "
                    f"step counted in {result['compile_s']}s, "
                    f"{result['per_device_bytes'] / 2**30:.2f} GiB/chip, "
                    f"dominant={result['dominant_term']}"
                )
            except Exception as e:  # noqa: BLE001 — report, keep sweeping
                failures += 1
                print(f"FAIL {arch} × {shape_name} × {mesh_tag}: {e!r}")
                traceback.print_exc()
    if failures:
        raise SystemExit(f"{failures} cell(s) failed")


if __name__ == "__main__":
    main()
