"""Top-k Mixture-of-Experts with sort-based capacity dispatch.

No per-expert ragged shapes: tokens pick top-k experts; a stable argsort
groups (token, expert) assignments by expert; each expert processes a
fixed-capacity slab gathered from the token stream; results scatter-add back
weighted by the router gate.  Overflowing tokens beyond ``capacity_factor``
drop (standard Switch/GShard semantics).

The router load-balancing auxiliary loss (Switch §2.2) is returned alongside.

Distribution (``dist.moe_axes``, the reference's ``_moe_sharded``): each
rank routes only the tokens of its own batch shard, with a per-shard
capacity (GShard semantics), and the auxiliary loss is averaged over the
ranks of the batch axes.  Raw tokens never leave their batch shard.  On a
mesh of one position (or a group of one rank) this is the dense dispatch,
bit for bit.  Under tensor parallelism (``dist.tp``) every rank of
``model`` routes the same tokens (its batch shard's, the whole sequence)
alike, then runs only its own experts' capacity slabs where ``model``
splits the experts (expert parallelism), else every expert on its block
of the experts' F; its output is a partial sum.

The dispatch has no shape that depends on the data (overflowing
assignments write to a spare slot column that is dropped), so it runs on
``meta`` tensors, as the dry run needs, and never waits for the card.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ModelConfig
from .common import activation, normal_init

__all__ = ["MoE", "init_moe", "moe_apply", "DistCtx"]


class DistCtx(NamedTuple):
    """Static distribution context threaded through the model."""

    mesh: object  # a DeviceMesh, or any mesh with ``.shape`` / axis names
    moe_axes: Tuple[str, ...]  # mesh axes carrying the token batch
    # sequence-parallel axes of the inter-layer activations: under ``tp``
    # the residual stream is split over them on its sequence dimension
    # (empty where the sequence does not divide); without ``tp`` each rank
    # holds its batch shard's whole sequence
    sp_axes: Tuple[str, ...] = ()
    # the reference's explicit attention head-shard hint (its compiler's
    # placement; the port's heads follow ``tp``, ``attention._head_shard``)
    head_shard: bool = False
    # tensor parallelism over ``model`` (a ``sharding.parallel.
    # TensorParallel``; the sharded steps'), or None
    tp: object = None
    # where the serving steps' caches lie on this rank (a ``sharding.
    # parallel.CacheLayout``), or None: every cache whole but its batch
    cache: object = None


class MoE(nn.Module):
    """router (D, E); w_up / w_gate (E, D, F); w_down (E, F, D)."""

    def __init__(self, cfg: ModelConfig, generator=None, device=None):
        super().__init__()
        pd = getattr(torch, cfg.param_dtype)
        E, D, Fe = cfg.n_experts, cfg.d_model, cfg.d_ff_expert

        def init(shape):
            return nn.Parameter(normal_init(generator, shape, dtype=pd,
                                      device=device))

        self.router = init((D, E))
        self.w_up = init((E, D, Fe))
        self.w_down = init((E, Fe, D))
        if cfg.mlp_gated:
            self.w_gate = init((E, D, Fe))


def init_moe(cfg: ModelConfig, generator=None, device=None) -> MoE:
    return MoE(cfg, generator, device)


def moe_capacity(cfg: ModelConfig, n_tokens: int) -> int:
    """Slots per expert: ``max(1, ceil(N·K / E) · capacity_factor)``."""
    E, K = cfg.n_experts, cfg.top_k
    return int(max(1, -(-n_tokens * K // E) * cfg.capacity_factor))


def moe_apply(
    cfg: ModelConfig, params: MoE, x: torch.Tensor,
    dist: "DistCtx | None" = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) → (out, aux_loss).  With ``dist`` the dispatch is
    local to the rank's batch shard (see the module's docstring)."""
    if dist is not None and dist.moe_axes:
        return _moe_sharded(cfg, params, x, dist)
    return _moe_dense_dispatch(cfg, params, x,
                               dist.tp if dist is not None else None)


def moe_groups(dist: DistCtx):
    """One process group per batch axis of ``dist`` that is a dimension of
    its ``DeviceMesh`` (none for a mesh that holds no process group, such
    as a mesh of one position outside ``torch.distributed``)."""
    names = getattr(dist.mesh, "mesh_dim_names", None) or ()
    return [dist.mesh.get_group(a) for a in dist.moe_axes if a in names]


class _SumOverGroups(torch.autograd.Function):
    """The sum of a tensor over every rank of ``groups`` (all-reduced axis
    by axis); its gradient is the sum of the ranks' gradients, the same
    all-reduce."""

    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return _all_reduce(x, groups)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.groups), None


def _all_reduce(x: torch.Tensor, groups) -> torch.Tensor:
    out = x.clone()
    for group in groups:
        torch.distributed.all_reduce(out, group=group)
    return out


def _moe_sharded(cfg: ModelConfig, params: MoE, x: torch.Tensor,
                 dist: DistCtx) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x`` is this rank's batch shard: its tokens go through the dense
    dispatch here, and ``aux`` becomes the mean of every rank's over the
    batch axes."""
    out, aux = _moe_dense_dispatch(cfg, params, x, dist.tp)
    groups = moe_groups(dist)
    if groups:
        size = 1
        for group in groups:
            size *= torch.distributed.get_world_size(group)
        aux = _SumOverGroups.apply(aux, groups) / size
    return out, aux


def _moe_dense_dispatch(
    cfg: ModelConfig, params: MoE, x: torch.Tensor, tp=None
) -> Tuple[torch.Tensor, torch.Tensor]:
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    N = B * S
    dt = x.dtype
    dev = x.device
    act = activation(cfg.act)

    xt = x.reshape(N, D)
    logits = (xt @ params.router.to(dt)).float()  # (N, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, topk_idx = torch.topk(probs, K, dim=-1)  # (N, K)
    gate_vals = gate_vals / torch.clamp(
        gate_vals.sum(dim=-1, keepdim=True), min=1e-9
    )

    # ---- load-balancing aux loss (fraction_tokens · fraction_router_prob) --
    me = probs.mean(dim=0)  # (E,)
    one_hot_top1 = F.one_hot(topk_idx[:, 0], E).float()
    ce = one_hot_top1.mean(dim=0)
    aux = (me * ce).sum() * E

    # ---- sort-based capacity dispatch ---------------------------------------
    capacity = moe_capacity(cfg, N)
    flat_e = topk_idx.reshape(-1)  # (N·K,)
    flat_g = gate_vals.reshape(-1)
    sort_idx = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[sort_idx]
    # position within the expert's group
    group_start = torch.searchsorted(sorted_e, sorted_e, side="left")
    pos = torch.arange(N * K, device=dev) - group_start
    ok = pos < capacity
    token_of = sort_idx // K

    # slots (E, C): token index feeding each expert slot (N = dummy row).
    # Overflowing assignments write to the spare column ``capacity``, which
    # is dropped.
    col = torch.where(ok, pos, capacity)
    slot_tok = torch.full((E, capacity + 1), N, dtype=torch.int64, device=dev)
    slot_tok[sorted_e, col] = token_of
    slot_tok = slot_tok[:, :capacity]
    slot_gate = torch.zeros((E, capacity + 1), dtype=torch.float32,
                            device=dev)
    slot_gate[sorted_e, col] = flat_g[sort_idx]
    slot_gate = slot_gate[:, :capacity]

    w_up, w_down = params.w_up, params.w_down
    w_gate = params.w_gate if cfg.mlp_gated else None
    if tp is not None and w_up.shape[0] != E:  # this rank's experts
        e0 = tp.rank * w_up.shape[0]
        slot_tok = slot_tok[e0:e0 + w_up.shape[0]]
        slot_gate = slot_gate[e0:e0 + w_up.shape[0]]
    elif tp is not None:  # every expert, this rank's block of F
        Fe = cfg.d_ff_expert
        w_up, w_down = tp.cols(w_up, 2, Fe), tp.cols(w_down, 1, Fe)
        w_gate = tp.cols(w_gate, 2, Fe) if cfg.mlp_gated else None

    x_pad = torch.cat([xt, xt.new_zeros((1, D))], dim=0)
    xe = x_pad[slot_tok]  # (E, C, D)

    up = torch.bmm(xe, w_up.to(dt))
    if cfg.mlp_gated:
        gate = act(torch.bmm(xe, w_gate.to(dt)))
        h = gate * up
    else:
        h = act(up)
    ye = torch.bmm(h, w_down.to(dt))
    ye = ye * slot_gate[..., None].to(dt)

    # combine: scatter-add expert outputs back to tokens
    out = torch.zeros((N + 1, D), dtype=dt, device=dev)
    out.index_add_(0, slot_tok.reshape(-1), ye.reshape(-1, D))
    return out[:N].reshape(B, S, D), aux
