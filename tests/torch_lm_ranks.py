"""Rank launcher for ``tests/test_torch_launch_steps.py``: starts 2 gloo
ranks on the CPU (``spawn``), each on the same seeded inputs:

* ``moe`` — ``models.moe._moe_sharded`` on a 1-D ``("data",)`` mesh of 2,
  rank ``r`` routing half ``r`` of the batch; saves its output and ``aux``;
* ``train`` — one ``launch.steps.make_train_step`` step of a reduced dense
  arch (f32 throughout: no ``cast_params_once``) on a (2, 1) and a (1, 2) ``("data", "model")`` mesh (parameters and
  moments sharded by the rules, the batch split over ``data``); rank 0
  saves the loss, the gradient norm and the new parameters and moments,
  all-gathered whole.

    python tests/torch_lm_ranks.py OUT_DIR

Rendezvous is a ``file://`` path inside ``OUT_DIR``; every rank destroys
its process group in a ``finally``, and the launcher exits non-zero when a
rank fails or outlives ``RANK_TIMEOUT_S``."""

import dataclasses
import datetime
import json
import multiprocessing
import os
import sys

RANK_TIMEOUT_S = 120
WORLD = 2
TRAIN_ARCH = "starcoder2-3b"
B, S = 4, 32


def moe_config():
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config("olmoe-1b-7b").reduced(),
                               dtype="float32")


def moe_inputs(cfg):
    import numpy as np

    rng = np.random.default_rng(3)
    x = rng.normal(size=(B, 8, cfg.d_model)).astype(np.float32)
    return x


def train_config():
    from repro_torch.configs import get_config

    return dataclasses.replace(
        get_config(TRAIN_ARCH).reduced(), vocab_size=128, loss_chunk=16,
        q_chunk=16, microbatches=1, ssm_chunk=8, dtype="float32",
        cast_params_once=False)  # f32 gradients: halves sum as the whole


def train_inputs(cfg):
    import numpy as np

    rng = np.random.default_rng(5)
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}


def init_model(cfg):
    import torch

    from repro_torch.models import init_params

    return init_params(cfg, torch.Generator().manual_seed(0), "cpu")


def _train_on(mesh_shape, rank, out_dir):
    import numpy as np
    import torch

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.train.optimizer import init_opt_state

    cfg = train_config()
    shape = ShapeConfig("t", seq_len=S, global_batch=B, kind="train")
    mesh = make_test_mesh(mesh_shape, device_type="cpu")
    fn, in_sh, _, _, _ = make_train_step(cfg, shape, mesh)
    p_sh, o_sh, b_sh = in_sh
    model = init_model(cfg)
    with torch.no_grad():  # keep this rank's shards
        for n, p in model.named_parameters():
            p.data = _shard(p.data, p_sh[n], mesh)
    opt = init_opt_state(model)
    batch = {k: _shard(torch.from_numpy(v), b_sh[k], mesh)
             for k, v in train_inputs(cfg).items()}
    new_p, new_o, loss, metrics = fn(model, opt, batch)
    whole = {}
    for n, p in new_p.named_parameters():
        whole["p:" + n] = _unshard(p.data, p_sh[n], mesh)
        whole["mu:" + n] = _unshard(new_o.mu[n], o_sh.mu[n], mesh)
        whole["nu:" + n] = _unshard(new_o.nu[n], o_sh.nu[n], mesh)
    if rank == 0:
        tag = "x".join(map(str, mesh_shape))
        np.savez(os.path.join(out_dir, f"train_{tag}.npz"),
                 loss=loss.numpy(), grad_norm=metrics["grad_norm"].numpy(),
                 **{k: v.numpy() for k, v in whole.items()})


def _shard(t, sh, mesh):
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(t, mesh, sh.placements()).to_local().clone()


def _unshard(t, sh, mesh):
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(t, mesh, sh.placements(),
                              run_check=False).full_tensor()


def rank_main(rank, out_dir):
    import numpy as np
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(out_dir, 'rendezvous')}",
        world_size=WORLD, rank=rank,
        timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S),
    )
    try:
        from torch.distributed.device_mesh import init_device_mesh

        from repro_torch.models.moe import DistCtx, _moe_sharded

        cfg = moe_config()
        mesh = init_device_mesh("cpu", (WORLD,), mesh_dim_names=("data",))
        model = init_model(cfg).units[0]["e0"].moe
        x = torch.from_numpy(moe_inputs(cfg))
        half = x.shape[0] // WORLD
        xl = x[rank * half:(rank + 1) * half]
        out, aux = _moe_sharded(cfg, model, xl, DistCtx(mesh, ("data",)))
        np.savez(os.path.join(out_dir, f"moe{rank}.npz"), out=out.detach().numpy(),
                 aux=aux.detach().numpy())
        for mesh_shape in ((2, 1), (1, 2)):
            _train_on(mesh_shape, rank, out_dir)
    finally:
        dist.destroy_process_group()


def main(argv):
    out_dir = argv[0]
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=rank_main, args=(r, out_dir))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    codes = []
    for p in procs:
        p.join(RANK_TIMEOUT_S)
        if p.is_alive():
            p.kill()
            p.join()
        codes.append(p.exitcode)
    print(json.dumps({"exitcodes": codes}))
    return 0 if all(c == 0 for c in codes) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
