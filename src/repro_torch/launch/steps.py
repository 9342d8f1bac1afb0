"""Step functions + abstract inputs + placements per (cfg, shape, mesh).

Used by the dry run (one rank's step on ``meta`` tensors) and by a real
run on the cards — the same code path.  Each builder returns the
reference's 5-tuple: the step function, its input and output shardings
(:class:`~repro_torch.sharding.spec.NamedSharding` trees, whose
``placements()`` are DTensor placements), its abstract arguments (global
shapes, on ``meta``) and the indices of the arguments it donates (updates
in place).

The state at rest is laid out as the reference's rules say (FSDP over the
batch axes for training, tensor-parallel dimensions over ``model``).  The
train step computes as the reference's partition does
(:mod:`repro_torch.sharding.parallel`): each rank runs its batch shard
through the columns, heads, experts and vocabulary rows that its
``model`` shards hold, with the residual stream split over ``model`` on
its sequence dimension between the units; a unit's leaves are cast (bf16
for the matrices under ``cast_params_once``) and all-gathered over the
batch axes inside the unit's rematerialised function, and the backward
reduce-scatters each unit's gradients back to the shards as it finishes,
in f32, so no rank ever holds the whole model's parameters or gradients.
AdamW then updates the shards in place.  Prefill and decode compute the
same partition from the rank's shards (no FSDP axes when serving) and keep
every cache in its layout at rest (``cache_shardings``: the rank's KV
heads, or every head over the rank's block of the cache's slots, which
decode joins by the log-sum-exp combine); they return the caches and the
logits (the rank's vocabulary rows) as the rank holds them, and gather no
parameter and no cache.  On a mesh of one position every placement is the
whole tensor and no collective runs except the MoE auxiliary loss's
all-reduce over a group of one.

A step's arguments are one rank's local tensors: ``params`` a
``DecoderLM`` whose parameters are its shards, an ``OptState`` of shards,
the batch shard; :func:`local_abstract_args` gives them on ``meta``.
"""

from __future__ import annotations

import copy
from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig, TrainHParams
from repro_torch.models import init_caches, train_loss
from repro_torch.models import decode_step as _decode_step
from repro_torch.models import prefill as _prefill
from repro_torch.models.model import DecoderLM
from repro_torch.models.moe import DistCtx
from repro_torch.sharding.parallel import (
    FSDP, CacheLayout, LeafPlan, Leaves, ShardedUnit, TensorParallel,
    all_reduce,
)
from repro_torch.sharding.spec import (
    P,
    NamedSharding,
    _entry_axes,
    batch_shardings,
    cache_seq_axes,
    cache_shardings,
    make_rules,
    mesh_axis_sizes,
    param_shardings,
)
from repro_torch.train.optimizer import (
    OptState, adamw_update, init_opt_state, stacked_rank,
)

__all__ = [
    "make_train_step",
    "make_prefill_step",
    "make_decode_step",
    "abstract_train_args",
    "abstract_prefill_args",
    "abstract_decode_args",
    "abstract_params",
    "local_abstract_args",
    "train_microbatches",
]


def abstract_params(cfg: ModelConfig) -> DecoderLM:
    """The model's parameters on ``meta`` (global shapes, no memory)."""
    return DecoderLM(cfg, None, "meta")


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def _abstract_batch(cfg: ModelConfig, shape: ShapeConfig, with_labels: bool):
    B, S = shape.global_batch, shape.seq_len
    s_text = S - (cfg.n_patches if cfg.family == "vlm" else 0)
    batch = {"tokens": _meta((B, s_text), torch.int32)}
    if with_labels:
        batch["labels"] = _meta((B, s_text), torch.int32)
    if cfg.family == "vlm":
        batch["vision_embeds"] = _meta((B, cfg.n_patches, cfg.d_model),
                                       torch.float32)
    if cfg.family == "encdec":
        batch["frames"] = _meta((B, cfg.enc_seq, cfg.d_model), torch.float32)
    return batch


def _q_chunk(shape: ShapeConfig, cfg: ModelConfig = None) -> int:
    if cfg is not None and cfg.q_chunk:
        return cfg.q_chunk
    return 512 if shape.seq_len > 8192 else 1024


def train_microbatches(cfg: ModelConfig) -> int:
    """Gradient-accumulation microbatches: MoE dispatch transients scale
    with per-device tokens — accumulate to stay inside device memory."""
    return cfg.microbatches or (
        4 if cfg.top_k >= 8 else (2 if cfg.n_experts else 1)
    )


# ---------------------------------------------------------------------------
# Layout: local shards ↔ whole tensors
# ---------------------------------------------------------------------------


def _split(sh: NamedSharding) -> bool:
    """Whether ``sh`` splits any dimension over an axis of more than one
    position (else a rank's shard is the whole tensor)."""
    sizes = mesh_axis_sizes(sh.mesh)
    for entry in sh.spec:
        axes = (entry,) if isinstance(entry, str) else (entry or ())
        if any(sizes[a] > 1 for a in axes):
            return True
    return False


def _global_norm(grads, shardings, mesh) -> torch.Tensor:
    """sqrt(Σ x²) over every rank's shards: local sums of squares, summed
    over the axes that split each group of leaves."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    groups: Dict = {}
    for n, g in grads.items():
        key = shardings[n].placements()
        sq = g.float().square().sum()
        groups[key] = sq if key not in groups else groups[key] + sq
    total = None
    for key, sq in groups.items():
        src = [Partial() if isinstance(pl, Shard) else Replicate()
               for pl in key]
        full = DTensor.from_local(sq, mesh, src, run_check=False).full_tensor()
        total = full if total is None else total + full
    return torch.sqrt(total)


def local_abstract_args(args, in_shardings):
    """The step's arguments as one rank holds them, on ``meta``: every
    tensor of ``args`` (global shapes) replaced by its local shard under
    ``in_shardings``.  A host scalar (the decode position) stays."""

    def loc(x, sh):
        if isinstance(x, DecoderLM):
            m = copy.deepcopy(x)
            for n, p in m.named_parameters():
                p.data = _meta(sh[n].local_shape(p.shape), p.dtype)
            return m
        if isinstance(x, OptState):
            return OptState(loc(x.step, sh.step), loc(x.mu, sh.mu),
                            loc(x.nu, sh.nu))
        if isinstance(x, dict):
            return {k: loc(v, sh[k]) for k, v in x.items()}
        if isinstance(x, list):
            return [loc(v, s) for v, s in zip(x, sh)]
        if isinstance(x, torch.Tensor) and x.device.type == "meta":
            return _meta(sh.local_shape(x.shape), x.dtype)
        return x

    return tuple(loc(a, s) for a, s in zip(args, in_shardings))


# ---------------------------------------------------------------------------
# train
# ---------------------------------------------------------------------------


def abstract_train_args(cfg, shape):
    p = abstract_params(cfg)
    o = init_opt_state(p)
    b = _abstract_batch(cfg, shape, with_labels=True)
    return p, o, b


def _cast_once(cfg: ModelConfig, name: str, t: torch.Tensor) -> torch.Tensor:
    """The reference's ``cast_params_once``: a matrix (stacked rank ≥ 2)
    outside the MoE experts goes to bf16 before it is gathered."""
    if (cfg.cast_params_once and "moe" not in name.split(".")
            and stacked_rank(name, t) >= 2):
        return t.to(torch.bfloat16)
    return t


def _leaf_plans(cfg: ModelConfig, p, p_sh, rules) -> Dict[str, LeafPlan]:
    """Each leaf's :class:`LeafPlan`: its ``cast_params_once`` dtype, the
    dimension its spec splits over the batch axes, and whether ``model``
    splits it (on an axis of more than one position)."""
    plans = {}
    for n, t in p.named_parameters():
        fsdp_dim, model_split = None, False
        for d, entry in enumerate(p_sh[n].spec):
            axes = _entry_axes(entry)
            if axes and set(axes) <= set(rules.fsdp_axes):
                fsdp_dim = d
            model_split |= "model" in axes and rules.model_size > 1
        cast = _cast_once(cfg, n, t)
        plans[n] = LeafPlan(cast.dtype if cast.dtype != t.dtype else None,
                            fsdp_dim, model_split)
    return plans


def _sharded_model(leaves: Dict[str, torch.Tensor], plans, fsdp: FSDP) -> Leaves:
    """The model ``train_loss`` reads: the top-level leaves gathered (once
    per microbatch: a tied embedding is one tensor for both of its uses),
    each unit a :class:`ShardedUnit` that gathers itself when it runs."""
    top, stacks = {}, {}
    for n, t in leaves.items():
        stack, _, rest = n.partition(".")
        if stack in ("units", "enc_units"):
            u, _, rel = rest.partition(".")
            stacks.setdefault(stack, {}).setdefault(int(u), {})[rel] = t
        else:
            top[n] = fsdp.gather(t, plans[n])
    units = {
        stack: [ShardedUnit(shards, {rel: plans[f"{stack}.{u}.{rel}"]
                                     for rel in shards}, fsdp)
                for u, shards in sorted(by_unit.items())]
        for stack, by_unit in stacks.items()}
    return Leaves(top, **units)


def make_train_step(
    cfg: ModelConfig,
    shape: ShapeConfig,
    mesh,
    hp: TrainHParams = TrainHParams(),
):
    rules = make_rules(mesh, shape)
    p, o, b = abstract_train_args(cfg, shape)
    p_sh = param_shardings(rules, p, cfg)
    o_sh = OptState(
        step=rules.nd(P()),
        mu=param_shardings(rules, o.mu, cfg),
        nu=param_shardings(rules, o.nu, cfg),
    )
    b_sh = batch_shardings(rules, b)
    scalar = rules.nd(P())
    qc = _q_chunk(shape, cfg)
    sizes = mesh_axis_sizes(mesh)
    # the reference's DistCtx (sequence-parallel activations, the
    # data-local MoE dispatch) and, where ``model`` has more than one
    # position, tensor parallelism
    tp = TensorParallel(mesh) if rules.model_size > 1 else None
    sp = ("model",) if rules.model_axis else ()
    dist = DistCtx(mesh, rules.batch_axes, sp_axes=sp, tp=tp)
    batch_groups = [mesh.get_group(a) for a in rules.fsdp_axes if sizes[a] > 1]
    fsdp = FSDP(batch_groups, tp.group if tp is not None else None)
    plans = _leaf_plans(cfg, p, p_sh, rules)
    k = train_microbatches(cfg)
    n_data = rules.axes_size(rules.fsdp_axes)
    split = n_data > 1 or any(_split(s) for s in p_sh.values())

    def train_step(params, opt_state, batch):
        leaves = {n: t.detach().requires_grad_()
                  for n, t in params.named_parameters()}
        names = list(leaves)

        def loss_and_grads(bb):
            model = _sharded_model(leaves, plans, fsdp)
            loss = train_loss(cfg, model, bb, q_chunk=qc, dist=dist)
            return loss, torch.autograd.grad(loss, [leaves[n] for n in names])

        if k == 1:
            loss, g = loss_and_grads(batch)
            grads = dict(zip(names, g))
        else:
            mb = {key: v.reshape((k, v.shape[0] // k) + tuple(v.shape[1:]))
                  for key, v in batch.items()}
            loss = torch.zeros((), dtype=torch.float32, device=batch["tokens"].device)
            gsum = {n: torch.zeros(leaves[n].shape, dtype=torch.float32,
                                   device=leaves[n].device) for n in names}
            for i in range(k):
                l, g = loss_and_grads({key: v[i] for key, v in mb.items()})
                loss = loss + l.detach()
                for n, gg in zip(names, g):
                    gsum[n].add_(gg.float())
                del g
            loss = loss / k
            for s in gsum.values():
                s.div_(k)
            grads = gsum
        del leaves
        grad_norm = None
        if n_data > 1:  # the gathers' backward summed over the batch axes
            grads = {n: g / n_data for n, g in grads.items()}
            for group in batch_groups:
                loss = all_reduce(loss, group)
            loss = loss / n_data
        if split:
            grad_norm = _global_norm(grads, p_sh, mesh)
        new_p, new_o, metrics = adamw_update(hp, params, grads, opt_state,
                                             grad_norm=grad_norm)
        return new_p, new_o, loss.detach(), metrics

    in_sh = (p_sh, o_sh, b_sh)
    out_sh = (p_sh, o_sh, scalar, {"lr": scalar, "grad_norm": scalar})
    return train_step, in_sh, out_sh, (p, o, b), (0, 1)


# ---------------------------------------------------------------------------
# prefill
# ---------------------------------------------------------------------------


def abstract_prefill_args(cfg, shape):
    p = abstract_params(cfg)
    b = _abstract_batch(cfg, shape, with_labels=False)
    return p, b


def _serving_dist(cfg: ModelConfig, rules, mesh, batch: int,
                  cache_len: int, moe_axes, **extra) -> DistCtx:
    """The serving steps' ``DistCtx``: tensor parallelism where ``model``
    has more than one position, and the layout of the rank's caches
    (:class:`~repro_torch.sharding.parallel.CacheLayout`) where their heads
    or slots are split; with neither, the plain ``DistCtx(mesh,
    moe_axes)``."""
    sizes = mesh_axis_sizes(mesh)
    tp = TensorParallel(mesh) if rules.model_size > 1 else None
    lengths = {cache_len}  # and a local layer's ring, the encoder's frames
    lengths |= {min(cfg.window, cache_len)} if cfg.window else set()
    lengths |= {cfg.enc_seq} if cfg.family == "encdec" else set()
    seq = {}
    for n in lengths:
        axes = cache_seq_axes(rules, (batch, n, cfg.n_kv_heads, cfg.head_dim))
        seq[n] = tuple(a for a in axes if sizes[a] > 1)
    kv_split = (tp is not None
                and rules.model_if(cfg.n_kv_heads) is not None)
    cache = (CacheLayout(mesh, kv_split, seq, cache_len)
             if tp is not None or any(seq.values()) else None)
    return DistCtx(mesh, moe_axes, tp=tp, cache=cache, **extra)


def make_prefill_step(cfg: ModelConfig, shape: ShapeConfig, mesh,
                      _cache_dtype=torch.bfloat16):
    """The reference's prefill step.  ``_cache_dtype`` is for tests only:
    f32 caches let a sharded step be held to the one-position step's
    values."""
    rules = make_rules(mesh, shape)
    p, b = abstract_prefill_args(cfg, shape)
    p_sh = param_shardings(rules, p, cfg)
    b_sh = batch_shardings(rules, b)
    qc = _q_chunk(shape, cfg)
    cache_len = shape.seq_len
    B = shape.global_batch
    # all archs: the head-shard hint + data-local MoE dispatch
    sp = ("model",) if rules.model_axis else ()
    dist = _serving_dist(cfg, rules, mesh, B, cache_len, rules.batch_axes,
                         sp_axes=sp, head_shard=True)

    caches_shape = init_caches(cfg, B, cache_len, _cache_dtype, device="meta")
    c_sh = cache_shardings(rules, caches_shape)
    logits_sh = rules.nd(
        P(
            rules.batch_if(shape.global_batch),
            rules.model_if(cfg.vocab_size),
        )
    )

    def prefill_step(params, batch):
        return _prefill(cfg, params, batch, cache_len, q_chunk=qc,
                        cache_dtype=_cache_dtype, dist=dist)

    return prefill_step, (p_sh, b_sh), (c_sh, logits_sh), (p, b), ()


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def abstract_decode_args(cfg, shape):
    """Parameters, tokens and caches on ``meta``; the position is a host
    scalar (the last slot of the cache: the port's decode step reads it on
    the host)."""
    p = abstract_params(cfg)
    B = shape.global_batch
    toks = _meta((B, 1), torch.int32)
    caches = init_caches(cfg, B, shape.seq_len, device="meta")
    pos = torch.tensor(shape.seq_len - 1, dtype=torch.int32)
    return p, toks, caches, pos


def make_decode_step(cfg: ModelConfig, shape: ShapeConfig, mesh):
    rules = make_rules(mesh, shape)
    p, toks, caches, pos = abstract_decode_args(cfg, shape)
    p_sh = param_shardings(rules, p, cfg)
    c_sh = cache_shardings(rules, caches)
    B = shape.global_batch
    b = rules.batch_if(B)
    tok_sh = rules.nd(P(b, None))
    pos_sh = rules.nd(P())
    logits_sh = rules.nd(P(b, rules.model_if(cfg.vocab_size)))
    dist = _serving_dist(cfg, rules, mesh, B, shape.seq_len,
                         rules.batch_axes if cfg.n_experts else ())

    def serve_step(params, tokens, cache, position):
        # the caches are the rank's, updated in place
        return _decode_step(cfg, params, tokens, cache, position, dist=dist)

    in_sh = (p_sh, tok_sh, c_sh, pos_sh)
    out_sh = (logits_sh, c_sh)
    return serve_step, in_sh, out_sh, (p, toks, caches, pos), (2,)
