"""Rank launcher for ``tests/test_torch_launch_steps.py`` and
``tests/test_torch_tensor_parallel.py``: starts gloo ranks on the CPU
(``spawn``), each on the same seeded inputs.

    python tests/torch_lm_ranks.py OUT_DIR

starts 2 ranks:

* ``moe`` — ``models.moe._moe_sharded`` on a 1-D ``("data",)`` mesh of 2,
  rank ``r`` routing half ``r`` of the batch; saves its output and ``aux``;
* ``train`` — one ``launch.steps.make_train_step`` step of a reduced dense
  arch (f32 throughout: no ``cast_params_once``) on a (2, 1) and a (1, 2) ``("data", "model")`` mesh (parameters and
  moments sharded by the rules, the batch split over ``data``); rank 0
  saves the loss, the gradient norm and the new parameters and moments,
  all-gathered whole.

    python tests/torch_lm_ranks.py OUT_DIR tp

starts 4 ranks: one train step of each arch of ``TP_ARCHS`` (reduced, f32,
cut so that each takes the tensor-parallel path named beside it) on a
(2, 2) ``("data", "model")`` mesh, saved as above; on rank 0 a hook
counts, per unit, the storages of the leaves the step gathers and of the
gradients its gathers' backward receives (``tp_gathers.json``); then one
train step of each case of ``ROWS_CASES`` (whisper, its attention split
over query positions) on the case's mesh, on the weights the test wrote
(``weights_<case>.npz``), saved with its gradients.  Then
the launcher itself, once the ranks are gone, starts a fake process group
of 4, counts reduced olmoe's step on a (2, 2) mesh of it on ``meta``
(``roofline.analyze.analyze_step``) and writes ``tp_analysis.json``.

    python tests/torch_lm_ranks.py OUT_DIR serve

starts 4 ranks on a (2, 2) ``("data", "model")`` mesh: for each case of
``SERVE_CASES`` (reduced, f32 with f32 caches or bf16 with bf16 caches,
cut so that each takes the cache layout named beside it),
``launch.steps.make_prefill_step`` of a
full prompt, then ``make_decode_step`` twice on caches that a plain
``prefill`` of a shorter prompt filled, each rank given its shards; the
logits and caches all-gathered whole (``serve_<case>.npz``, in f32); on every
rank the bytes its steps hold at their peak (``serve_peak_<rank>.json``:
its arguments plus the storages the steps create, counted as
``roofline.analyze`` counts them) beside the whole model's and caches'.
The long-context cases decode one sequence, fewer than the ``data``
positions, so the caches' slots split over ``data``.  Then
``make_prefill_step`` of each case of ``ROWS_CASES`` on its mesh
(``rows_<case>.npz``).

Rendezvous is a ``file://`` path inside ``OUT_DIR``; every rank (and the
launcher's fake group) destroys its process group in a ``finally``, and
the launcher exits non-zero when a rank fails or outlives
``RANK_TIMEOUT_S``."""

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
TP_WORLD = 4
#: the MoE archs' cut: a capacity of every assignment and one microbatch.
#: A data shard routes its own tokens (the reference's GShard semantics:
#: capacity and auxiliary loss per shard), which equals routing the whole
#: batch only where no assignment overflows and the shards hold alike
#: tokens, so these archs' batch is two sequences, each on both shards
#: (``tp_inputs``)
_EVERY_ASSIGNMENT = {"microbatches": 1, "capacity_factor": 4.0}
#: each arch's cut of its reduced config (4 heads, 2 KV heads, 4 experts)
#: and the path it takes on the (2, 2) mesh
TP_ARCHS = {
    # expert parallelism (4 experts over 2), local heads
    "olmoe-1b-7b": dict(_EVERY_ASSIGNMENT),
    # 3 experts: each splits F; 6 query heads over 3 key heads, so a rank's
    # 3 query heads read key heads 0, 0, 1 (keys all-gathered, picked)
    "mixtral-8x7b": {"n_experts": 3, "n_heads": 6, "n_kv_heads": 3,
                     **_EVERY_ASSIGNMENT},
    # one key head for a rank's 2 query heads; both softcaps, post-norms,
    # the scaled, tied embedding; 2 microbatches
    "gemma2-9b": {"n_kv_heads": 1, "microbatches": 2},
    # 3 query heads do not divide 2: rank 0 computes 1, rank 1 2, from
    # wq / wk / wv / wo all-gathered
    "starcoder2-3b": {"n_heads": 3, "n_kv_heads": 1},
    # mamba mixers split by heads (the gated norm's mean square
    # all-reduced), MoE expert-parallel
    "jamba-v0.1-52b": dict(_EVERY_ASSIGNMENT),
    # a vocabulary of 127 (the embedding splits D), 15 encoder frames (the
    # encoder's stream whole on every rank), one head: fewer than the
    # ranks, so every rank computes it
    "whisper-tiny": {"vocab_size": 127, "enc_seq": 15, "n_heads": 1,
                     "n_kv_heads": 1},
    # 8 patches before the text: the prefix counted once in the sum
    "llava-next-34b": {},
}


#: whisper's attention split over query positions (fewer query heads than
#: ``model`` ranks), on the reference's weights (``weights_<case>.npz``,
#: which the test writes before the ranks start): each case's mesh and cut
ROWS_CASES = {
    # 1 head over a model axis of 2: each rank computes it for its 16 of
    # the 32 positions; the encoder's 15 frames in blocks of 7 and 8
    "whisper-2x2": ((2, 2), {"vocab_size": 127, "enc_seq": 15,
                             "n_heads": 1, "n_kv_heads": 1}),
    # 3 query heads over 1 KV head on a model axis of 4: the rank's columns
    # of wq straddle two heads; 15 frames in uneven blocks of 3 and 4
    "whisper-1x4": ((1, 4), {"vocab_size": 127, "enc_seq": 15,
                             "n_heads": 3, "n_kv_heads": 1}),
    # the same in bf16 compute, with the steps' default bf16 caches
    "whisper-1x4-bf16": ((1, 4), {"vocab_size": 127, "enc_seq": 15,
                                  "n_heads": 3, "n_kv_heads": 1,
                                  "dtype": "bfloat16"}),
}


def rows_config(case, get_config=None):
    """A rows case's reduced whisper, from ``get_config`` (the port's by
    default; the tests pass the reference's for its twin)."""
    import dataclasses

    if get_config is None:
        from repro_torch.configs import get_config

    return dataclasses.replace(
        get_config("whisper-tiny").reduced(),
        **{"loss_chunk": 16, "q_chunk": 16, "microbatches": 1,
           "dtype": "float32", "cast_params_once": False,
           **ROWS_CASES[case][1]})


def reference_weights(case):
    """The JAX package's init of a rows case (seed 0) carried across by
    ``params_from_reference``: {port name: array}.  Called in the test's
    process, which imports the reference; the ranks load the file."""
    import jax
    import numpy as np

    import repro.models as RM
    from repro.configs import get_config as ref_config
    from repro_torch.models.convert import params_from_reference

    tree = jax.tree.map(np.asarray, RM.init_params(
        rows_config(case, ref_config), jax.random.PRNGKey(0)))
    model = params_from_reference(rows_config(case), tree)
    return tree, {n: p.detach().numpy() for n, p in model.named_parameters()}


def rows_model(case, out_dir):
    """The port's model of a rows case on the weights the test wrote."""
    import numpy as np
    import torch

    model = init_model(rows_config(case))
    with np.load(os.path.join(out_dir, f"weights_{case}.npz")) as w:
        with torch.no_grad():
            for n, p in model.named_parameters():
                p.data = torch.from_numpy(w[n].copy())
    return model


#: serving: a prompt of ``SERVE_S`` positions fills caches of ``SERVE_S``
#: slots (a local layer's ring of 8 wraps); decode starts from a plain
#: prefill of ``DECODE_PROMPT`` positions and steps at ``DECODE_POS``.
#: Where ``model`` splits the slots in two, position 12 lies in the first
#: block of a global cache (slots 0-15) and in the second of a ring (slot
#: 12 % 8 = 4 of 0-7), position 17 in the second and the first (17 % 8 =
#: 1).  ``SERVE_B`` sequences (1 in the long-context cases)
SERVE_S, SERVE_B, DECODE_PROMPT, DECODE_POS = 32, 4, 12, (12, 17)
#: each case: its arch, its cut, and the layout it takes on the (2, 2) mesh
SERVE_CASES = {
    # 2 KV heads over 2: the rank's KV head, every slot (local ring and
    # global layers, both softcaps, the scaled tied embedding)
    "gemma2-9b": ("gemma2-9b", {}),
    # 1 KV head: every head, the cache's slots split over model
    "gemma2-9b-kv1": ("gemma2-9b", {"n_kv_heads": 1}),
    # 3 query heads over 1 KV head: heads that do not divide the ranks,
    # slots split over model, a ring
    "starcoder2-3b": ("starcoder2-3b", {"n_heads": 3, "n_kv_heads": 1}),
    # a vocabulary of 127 (the embedding splits D), 15 frames (the
    # encoder whole, the cross caches whole on every rank), 1 KV head
    # (the self caches' slots split)
    "whisper-tiny": ("whisper-tiny", {"vocab_size": 127, "enc_seq": 15,
                                      "n_kv_heads": 1}),
    # 16 frames, 2 KV heads: the cross caches' heads split
    "whisper-tiny-kv2": ("whisper-tiny", {"enc_seq": 16}),
    # mamba mixers: the state's heads and the conv's channels split
    "mamba2-370m": ("mamba2-370m", {}),
    # mamba, attention (KV split) and expert-parallel MoE
    "jamba-v0.1-52b": ("jamba-v0.1-52b", {"capacity_factor": 4.0}),
    # 3 experts (each splits F), 3 KV heads (slots split), a ring
    "mixtral-8x7b": ("mixtral-8x7b", {"n_experts": 3, "n_heads": 6,
                                      "n_kv_heads": 3,
                                      "capacity_factor": 4.0}),
    # 8 patches before the text
    "llava-next-34b": ("llava-next-34b", {}),
    # long-context decode: 2 KV heads over model, the slots over data
    "long-gemma2-9b": ("gemma2-9b", {}),
    # long-context decode: 1 KV head, the slots over data and model
    "long-gemma2-9b-kv1": ("gemma2-9b", {"n_kv_heads": 1}),
    # the default bf16 compute and caches through the split slots'
    # partial attention and its combine, in prefill and decode
    "gemma2-9b-kv1-bf16": ("gemma2-9b", {"n_kv_heads": 1,
                                         "dtype": "bfloat16"}),
    "long-gemma2-9b-kv1-bf16": ("gemma2-9b", {"n_kv_heads": 1,
                                              "dtype": "bfloat16"}),
}
#: the cases whose ranks count their peak bytes
SERVE_PEAK_CASES = ("gemma2-9b-kv1", "jamba-v0.1-52b")


def serve_config(case, get_config=None):
    """A case's reduced config, from ``get_config`` (the port's by
    default; the tests pass the reference's for its twin)."""
    import dataclasses

    if get_config is None:
        from repro_torch.configs import get_config

    arch, cut = SERVE_CASES[case]
    return dataclasses.replace(
        get_config(arch).reduced(),
        **{"vocab_size": 128, "q_chunk": 16, "ssm_chunk": 8,
           "dtype": "float32", **cut})


def serve_cache_dtype(cfg):
    """f32 caches for the f32 cases (so that a sharded step can equal the
    one-position step within 1e-5), else the steps' default bf16."""
    import torch

    return torch.float32 if cfg.dtype == "float32" else torch.bfloat16


def serve_shapes(case):
    """(prefill shape, decode shape) of a case."""
    from repro_torch.configs.base import ShapeConfig

    b = 1 if case.startswith("long-") else SERVE_B
    return (ShapeConfig("p", seq_len=SERVE_S, global_batch=b, kind="prefill"),
            ShapeConfig("d", seq_len=SERVE_S, global_batch=b, kind="decode"))


def serve_inputs(cfg, batch, seed=11):
    """The prompt of the prefill step, the shorter one of the decode
    steps' caches and the decode steps' tokens."""
    import numpy as np

    rng = np.random.default_rng(seed)

    def prompt(s):
        out = {"tokens": rng.integers(0, cfg.vocab_size,
                                      (batch, s - cfg.n_patches)).astype(np.int32)}
        if cfg.family == "vlm":
            out["vision_embeds"] = rng.normal(
                size=(batch, cfg.n_patches, cfg.d_model)).astype(np.float32)
        if cfg.family == "encdec":
            out["frames"] = rng.normal(
                size=(batch, cfg.enc_seq, cfg.d_model)).astype(np.float32)
        return out

    full, short = prompt(SERVE_S), prompt(DECODE_PROMPT)
    toks = rng.integers(0, cfg.vocab_size,
                        (len(DECODE_POS), batch, 1)).astype(np.int32)
    return full, short, toks


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


def tp_config(arch):
    import dataclasses

    from repro_torch.configs import get_config

    cfg = get_config(arch).reduced()
    return dataclasses.replace(
        cfg, **{"vocab_size": 128, "loss_chunk": 16, "q_chunk": 16,
                "microbatches": 2 if cfg.n_experts else 1, "ssm_chunk": 8,
                "dtype": "float32", "cast_params_once": False,
                **TP_ARCHS[arch]})


def analysis_config():
    """Reduced olmoe made wide enough (d_model 256, experts of F = 512)
    that its parameters, not its activations, hold most of a rank's
    bytes, as at full size."""
    import dataclasses

    return dataclasses.replace(tp_config("olmoe-1b-7b"), d_model=256,
                               head_dim=64, d_ff_expert=512)


def tp_inputs(cfg):
    import numpy as np

    rng = np.random.default_rng(7)
    s_text = S - cfg.n_patches
    rows = B // 2 if cfg.n_experts else B  # MoE: 2 sequences, each twice
    out = {"tokens": rng.integers(0, cfg.vocab_size, (rows, s_text)).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab_size, (rows, s_text)).astype(np.int32)}
    if cfg.family == "vlm":
        out["vision_embeds"] = rng.normal(size=(rows, cfg.n_patches, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        out["frames"] = rng.normal(size=(rows, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    return {k: np.concatenate([v] * (B // rows)) for k, v in out.items()}


def init_model(cfg):
    import torch

    from repro_torch.models import init_params

    return init_params(cfg, torch.Generator().manual_seed(0), "cpu")


def _train_on(mesh_shape, rank, out_dir, cfg=None, inputs=None, tag=None,
              model=None):
    """One train step on ``mesh_shape``; rank 0 saves the loss, the
    gradient norm and the new parameters, μ, ν and the gradients (the
    shards the step hands ``adamw_update``), each reassembled whole."""
    import numpy as np
    import torch

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.train.optimizer import init_opt_state

    cfg = cfg or train_config()
    inputs = inputs or train_inputs(cfg)
    shape = ShapeConfig("t", seq_len=S, global_batch=B, kind="train")
    mesh = make_test_mesh(mesh_shape, device_type="cpu")
    fn, in_sh, _, _, _ = steps.make_train_step(cfg, shape, mesh)
    p_sh, o_sh, b_sh = in_sh
    model = model or init_model(cfg)
    with torch.no_grad():  # keep this rank's shards
        for n, p in model.named_parameters():
            p.data = _shard(p.data, p_sh[n], mesh)
    opt = init_opt_state(model)
    batch = {k: _shard(torch.from_numpy(v), b_sh[k], mesh)
             for k, v in inputs.items()}
    grads, update = {}, steps.adamw_update

    def seen(hp, params, g, state, grad_norm=None):
        grads.update(g)
        return update(hp, params, g, state, grad_norm=grad_norm)

    steps.adamw_update = seen
    try:
        new_p, new_o, loss, metrics = fn(model, opt, batch)
    finally:
        steps.adamw_update = update
    whole = {}
    for n, p in new_p.named_parameters():
        whole["p:" + n] = _unshard(p.data, p_sh[n], mesh)
        whole["mu:" + n] = _unshard(new_o.mu[n], o_sh.mu[n], mesh)
        whole["nu:" + n] = _unshard(new_o.nu[n], o_sh.nu[n], mesh)
        whole["g:" + n] = _unshard(grads[n], p_sh[n], mesh)
    if rank == 0:
        tag = tag or "x".join(map(str, mesh_shape))
        np.savez(os.path.join(out_dir, f"train_{tag}.npz"),
                 loss=loss.float().numpy(),
                 grad_norm=metrics["grad_norm"].numpy(),
                 **{k: v.float().numpy() for k, v in whole.items()})


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


class _GatherCount:
    """Counts, per unit, the live storages of the leaves ``ShardedUnit``
    gathers and of the gradients its gathers' backward receives; keeps the
    most units alive at once of each, and the gradients' shapes."""

    def __init__(self):
        import weakref

        from repro_torch.sharding import parallel

        self.live = {"leaves": {}, "grads": {}}
        self.most = {"leaves": 0, "grads": 0}
        self.unit_of = {}  # id of a gathered leaf's grad_fn → its unit
        self.units = 0
        gather, backward = parallel.ShardedUnit.gather, parallel._GatherParam.backward
        count = self

        def counted_gather(unit):
            leaves = gather(unit)
            if not hasattr(unit, "counted_as"):  # gathered again backward
                unit.counted_as = count.units
                count.units += 1
            tag = unit.counted_as
            rest = {t.untyped_storage()._cdata for t in unit.shards.values()}
            for t in _tensors_of(leaves):
                if t.untyped_storage()._cdata in rest:
                    continue  # a view of the shard itself: nothing gathered
                count.unit_of[id(t.grad_fn)] = tag
                count._hold("leaves", tag, t)
            return leaves

        def counted_backward(ctx, g):
            tag = count.unit_of.get(id(ctx))
            if tag is not None:
                count._hold("grads", tag, g)
            return backward(ctx, g)

        self._weakref = weakref
        self._restore = (gather, parallel._GatherParam.__dict__["backward"])
        parallel.ShardedUnit.gather = counted_gather
        parallel._GatherParam.backward = staticmethod(counted_backward)

    def close(self):
        from repro_torch.sharding import parallel

        parallel.ShardedUnit.gather, parallel._GatherParam.backward = self._restore

    def _hold(self, kind, tag, t):
        live = self.live[kind]
        st = t.untyped_storage()
        key = st._cdata
        live.setdefault(tag, set()).add(key)
        self.most[kind] = max(self.most[kind],
                              sum(1 for keys in live.values() if keys))
        self._weakref.finalize(st, live[tag].discard, key)


def _tensors_of(leaves):
    tree = leaves.__dict__["_tree"]
    stack = [tree]
    while stack:
        node = stack.pop()
        for v in node.values():
            if isinstance(v, dict):
                stack.append(v)
            elif v.grad_fn is not None:
                yield v


def tp_rank_main(rank, out_dir):
    import numpy as np
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(out_dir, 'rendezvous')}",
        world_size=TP_WORLD, rank=rank,
        timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S),
    )
    try:
        for arch in TP_ARCHS:
            count = _GatherCount() if rank == 0 and arch == "olmoe-1b-7b" else None
            cfg = tp_config(arch)
            _train_on((2, 2), rank, out_dir, cfg, tp_inputs(cfg), f"tp_{arch}")
            if count is not None:
                count.close()
                with open(os.path.join(out_dir, "tp_gathers.json"), "w") as f:
                    json.dump({"most": count.most, "units": count.units}, f)
        for case, (mesh_shape, _) in ROWS_CASES.items():
            cfg = rows_config(case)
            _train_on(mesh_shape, rank, out_dir, cfg, tp_inputs(cfg),
                      f"rows_{case}", rows_model(case, out_dir))
    finally:
        dist.destroy_process_group()


def tp_analysis(out_dir):
    """Reduced olmoe's step on a (2, 2) mesh of a fake group of 4 ranks,
    counted on ``meta`` (this process is rank 0)."""
    import torch.distributed as dist

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.dryrun import _fake_process_group
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.steps import local_abstract_args, make_train_step
    from repro_torch.roofline.analyze import analyze_step

    cfg = analysis_config()
    shape = ShapeConfig("t", seq_len=S, global_batch=B, kind="train")
    _fake_process_group(TP_WORLD)
    try:
        mesh = make_test_mesh((2, 2), device_type="cpu")
        fn, in_sh, _, args, donate = make_train_step(cfg, shape, mesh)
        res = analyze_step(fn, local_abstract_args(args, in_sh), cfg, shape,
                           mesh, donate=donate)
        whole = 4 * sum(p.numel() for p in args[0].parameters())
        with open(os.path.join(out_dir, "tp_analysis.json"), "w") as f:
            json.dump({"memory_analysis": res["memory_analysis"],
                       "whole_model_bytes": whole,
                       "collectives": res["collectives"]["num_collectives"]}, f)
    finally:
        dist.destroy_process_group()


def decode_start(cfg, model, short):
    """The whole caches that the decode steps start from: a plain
    ``prefill`` of the short prompt into ``SERVE_S`` slots, in the case's
    cache dtype."""
    import torch

    from repro_torch.models import prefill

    caches, _ = prefill(cfg, model, {k: torch.from_numpy(v) for k, v in short.items()},
                        SERVE_S, q_chunk=cfg.q_chunk,
                        cache_dtype=serve_cache_dtype(cfg))
    return caches


def flat_caches(caches, prefix=""):
    """``{"u<unit>.<entry>.<leaf>": leaf}`` of a cache tree (a leaf may be
    a tensor or a sharding)."""
    out = {}
    for u, unit in enumerate(caches):
        for e, entry in unit.items():
            for name, leaf in entry.items():
                if isinstance(leaf, dict):
                    for sub, t in leaf.items():
                        out[f"{prefix}u{u}.{e}.{name}.{sub}"] = t
                else:
                    out[f"{prefix}u{u}.{e}.{name}"] = leaf
    return out


def _map_tree(fn, tree, shardings):
    """``fn(leaf, its sharding)`` over a cache tree (lists and dicts)."""
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_tree(fn, v, s) for v, s in zip(tree, shardings)]
    return fn(tree, shardings)


def _counted(fn, args):
    """``fn(*args)`` and the bytes it holds at its peak: its arguments'
    storages plus the peak of the storages its operators create (counted
    as ``roofline.analyze.analyze_step`` counts them)."""
    from repro_torch.roofline.analyze import (
        _leaves, _storage_bytes, _tensors, _Traffic,
    )

    inputs = _tensors([_leaves(a) for a in args])
    traffic = _Traffic(inputs)
    with traffic:
        out = fn(*args)
    return out, _storage_bytes(inputs) + traffic.peak


def _serve_on(case, rank, out_dir, peaks):
    import copy

    import numpy as np
    import torch

    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.steps import make_decode_step, make_prefill_step

    cfg = serve_config(case)
    pshape, dshape = serve_shapes(case)
    mesh = make_test_mesh((2, 2), device_type="cpu")
    model = init_model(cfg)
    full, short, toks = serve_inputs(cfg, pshape.global_batch)
    count = case in SERVE_PEAK_CASES
    whole_model = 4 * sum(p.numel() for p in model.parameters())

    def local_model(p_sh):
        m = copy.deepcopy(model)
        with torch.no_grad():
            for n, p in m.named_parameters():
                p.data = _shard(p.data, p_sh[n], mesh)
        return m

    out, peak = {}, {}
    if not case.startswith("long-"):
        fn, (p_sh, b_sh), (c_sh, l_sh), _, _ = make_prefill_step(
            cfg, pshape, mesh, _cache_dtype=serve_cache_dtype(cfg))
        args = (local_model(p_sh),
                {k: _shard(torch.from_numpy(v), b_sh[k], mesh)
                 for k, v in full.items()})
        if count:
            (caches, logits), peak["prefill"] = _counted(fn, args)
        else:
            caches, logits = fn(*args)
        out["prefill:logits"] = _unshard(logits, l_sh, mesh)
        shs = flat_caches(c_sh)
        for name, t in flat_caches(caches).items():
            out[f"prefill:{name}"] = _unshard(t, shs[name], mesh)
        if count:
            peak["prefill_whole"] = whole_model + sum(
                4 * out[f"prefill:{n}"].numel() for n in shs)

    start = decode_start(cfg, model, short)
    fn, (p_sh, t_sh, c_sh, _), (l_sh, _), _, _ = make_decode_step(
        cfg, dshape, mesh)
    params = local_model(p_sh)
    shs = flat_caches(c_sh)
    caches = _map_tree(lambda t, sh: _shard(t, sh, mesh), start, c_sh)
    for i, pos in enumerate(DECODE_POS):
        args = (params, _shard(torch.from_numpy(toks[i]), t_sh, mesh), caches, pos)
        if count and i == 0:
            (logits, caches), peak["decode"] = _counted(fn, args)
        else:
            logits, caches = fn(*args)
        out[f"decode{i}:logits"] = _unshard(logits, l_sh, mesh)
    for name, t in flat_caches(caches).items():
        out[f"decode:{name}"] = _unshard(t, shs[name], mesh)
    if count:
        peak["decode_whole"] = whole_model + sum(
            4 * t.numel() for t in flat_caches(start).values())
        peaks[case] = peak
    if rank == 0:
        np.savez(os.path.join(out_dir, f"serve_{case}.npz"),
                 **{k: v.float().numpy() for k, v in out.items()})


def _rows_prefill_on(case, rank, out_dir):
    """``make_prefill_step`` of a rows case on its mesh (caches in the
    case's dtype: f32, or the steps' default bf16); rank 0 saves the
    logits and caches reassembled whole (``rows_<case>.npz``, in f32)."""
    import numpy as np
    import torch

    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.steps import make_prefill_step

    cfg = rows_config(case)
    pshape, _ = serve_shapes(case)
    mesh = make_test_mesh(ROWS_CASES[case][0], device_type="cpu")
    full, _, _ = serve_inputs(cfg, pshape.global_batch)
    fn, (p_sh, b_sh), (c_sh, l_sh), _, _ = make_prefill_step(
        cfg, pshape, mesh, _cache_dtype=serve_cache_dtype(cfg))
    model = rows_model(case, out_dir)
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.data = _shard(p.data, p_sh[n], mesh)
    caches, logits = fn(model, {k: _shard(torch.from_numpy(v), b_sh[k], mesh)
                                for k, v in full.items()})
    out = {"logits": _unshard(logits, l_sh, mesh)}
    shs = flat_caches(c_sh)
    for name, t in flat_caches(caches).items():
        out[name] = _unshard(t, shs[name], mesh)
    if rank == 0:
        np.savez(os.path.join(out_dir, f"rows_{case}.npz"),
                 **{k: v.float().numpy() for k, v in out.items()})


def serve_rank_main(rank, out_dir):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(out_dir, 'rendezvous')}",
        world_size=TP_WORLD, rank=rank,
        timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S),
    )
    try:
        peaks = {}
        for case in SERVE_CASES:
            _serve_on(case, rank, out_dir, peaks)
        for case in ROWS_CASES:
            _rows_prefill_on(case, rank, out_dir)
        with open(os.path.join(out_dir, f"serve_peak_{rank}.json"), "w") as f:
            json.dump(peaks, f)
    finally:
        dist.destroy_process_group()


def main(argv):
    out_dir = argv[0]
    mode = argv[1] if len(argv) > 1 else None
    tp = mode == "tp"
    world, target = {"tp": (TP_WORLD, tp_rank_main),
                     "serve": (TP_WORLD, serve_rank_main)}.get(
                         mode, (WORLD, rank_main))
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=target, args=(r, out_dir))
             for r in range(world)]
    for p in procs:
        p.start()
    codes = []
    for p in procs:
        p.join(RANK_TIMEOUT_S)
        if p.is_alive():
            p.kill()
            p.join()
        codes.append(p.exitcode)
    ok = all(c == 0 for c in codes)
    if tp and ok:
        tp_analysis(out_dir)
    print(json.dumps({"exitcodes": codes}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
