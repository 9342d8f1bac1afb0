"""Top-level models: decoder-only LM (dense / MoE / SSM / hybrid / VLM) and
encoder–decoder (whisper), built from ``n_units`` repetitions of the layer
pattern.

Public API (the reference's):
  init_params(cfg, generator, device)   → :class:`DecoderLM`
  train_loss(cfg, params, batch)        → scalar loss (differentiable)
  prefill(cfg, params, batch, cache_len) → (caches, last_logits)
  decode_step(cfg, params, tokens, caches, pos) → (logits, caches)
  init_caches(cfg, batch, cache_len)    → zeroed caches
  count_params(cfg, active_only=False)  → exact count, on the meta device

Caches are a list with one dict per unit (``{"e0": {...}, ...}``), each
entry's cache a dict of tensors.  :func:`decode_step` **updates the caches
in place** (the cache tensors and the dicts) and returns the same list, so a
cache that went through a decode step holds the state after it.

``dist`` (a :class:`~repro_torch.models.moe.DistCtx`) makes the MoE dispatch
local to the rank's batch shard; ``dist=None`` is the single-device model.
With ``dist.tp`` (the sharded steps') :func:`train_loss`, :func:`prefill`
and :func:`decode_step` compute the rank's part of the tensor-parallel
model from its shards, and a unit given as a
:class:`~repro_torch.sharding.parallel.ShardedUnit` is gathered inside its
rematerialised function.  The serving caches are then the rank's parts in
their layout at rest (``dist.cache``), and the logits its vocabulary rows.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts,
)

from ..configs.base import ModelConfig
from ..sharding.parallel import ShardedUnit
from .attention import init_attn_cache
from .blocks import entry_decode, entry_prefill, entry_train, init_entry
from .common import (
    chunked_cross_entropy, matmul_f32, normal_init, rms_norm, sinusoidal_at,
    sinusoidal_positions, softcap,
)
from .mamba import init_mamba_cache
from .moe import DistCtx

__all__ = [
    "DecoderLM",
    "init_params",
    "train_loss",
    "prefill",
    "decode_step",
    "init_caches",
    "count_params",
    "serving_weights",
]


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


class DecoderLM(nn.Module):
    """The model's parameters, named as the reference's pytree: ``embed``
    (V, D), ``final_norm``, ``units`` (one ``ModuleDict`` of entries
    ``e0``… per unit), [``lm_head`` (V, D)], [``enc_units``, ``enc_norm``]."""

    def __init__(self, cfg: ModelConfig, generator=None, device=None):
        super().__init__()
        pd = getattr(torch, cfg.param_dtype)
        pattern = cfg.layer_pattern
        cross = cfg.family == "encdec"
        self.units = nn.ModuleList(
            nn.ModuleDict({
                f"e{i}": init_entry(cfg, kind, i, generator, device,
                                    cross=cross)
                for i, kind in enumerate(pattern)
            })
            for _ in range(cfg.n_units)
        )
        if cfg.family == "encdec":
            self.enc_units = nn.ModuleList(
                nn.ModuleDict({"e0": init_entry(cfg, "global", 0, generator,
                                                device)})
                for _ in range(cfg.n_enc_layers)
            )
            self.enc_norm = nn.Parameter(
                torch.zeros(cfg.d_model, dtype=pd, device=device))
        self.embed = nn.Parameter(normal_init(
            generator, (cfg.vocab_size, cfg.d_model), dtype=pd, device=device))
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(normal_init(
                generator, (cfg.vocab_size, cfg.d_model), dtype=pd,
                device=device))
        self.final_norm = nn.Parameter(
            torch.zeros(cfg.d_model, dtype=pd, device=device))


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> DecoderLM:
    """Random weights (N(0, 0.02²) matrices, zero norms) drawn from
    ``generator`` on ``device`` (by default the generator's device)."""
    return DecoderLM(cfg, generator,
                     generator.device if device is None else device)


def count_params(cfg: ModelConfig, active_only: bool = False) -> int:
    """Exact parameter count from a model built on the ``meta`` device (no
    allocation).  ``active_only`` counts top-k of the experts' matrices."""
    model = DecoderLM(cfg, None, "meta")
    total = 0
    for name, p in model.named_parameters():
        n = p.numel()
        parts = name.split(".")
        if active_only and "moe" in parts and parts[-1] in (
            "w_up", "w_down", "w_gate"
        ):
            n = n * cfg.top_k // cfg.n_experts
        total += n
    return total


# ---------------------------------------------------------------------------
# Shared forward plumbing
# ---------------------------------------------------------------------------


def _save_products(ctx, op, *args, **kwargs):
    """The ``"dots"`` policy: keep the outputs of the matrix products with
    no batch dimension (``aten.mm``: ``x @ W`` and the f32 logits), recompute
    the rest — the reference's ``checkpoint_dots_with_no_batch_dims``."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.mm.dtype):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat_wrap(cfg: ModelConfig, fn):
    """``fn`` under ``cfg.remat`` when autograd records: ``"full"`` keeps
    only the unit's inputs (non-reentrant ``torch.utils.checkpoint``),
    ``"dots"`` also the outputs of its matrix products, ``"none"`` all."""
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn
    if cfg.remat == "dots":
        context = functools.partial(create_selective_checkpoint_contexts,
                                    _save_products)
        return functools.partial(checkpoint, fn, use_reentrant=False,
                                 context_fn=context)
    if cfg.remat != "full":
        raise ValueError(f"unknown remat {cfg.remat!r}")
    return functools.partial(checkpoint, fn, use_reentrant=False)


def _gathering(entry_fn):
    def run(unit, x):
        return entry_fn(unit.gather(), x)

    return run


def _run_units(cfg: ModelConfig, units, x, entry_fn):
    """The pattern units in order, each under ``cfg.remat``.
    ``entry_fn(unit, x) -> (x, aux)``; returns (x, summed aux).  A
    :class:`ShardedUnit` is gathered inside the rematerialised function:
    its leaves live while the unit runs, forward and again backward."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for unit in units:
        fn = _gathering(entry_fn) if isinstance(unit, ShardedUnit) else entry_fn
        x, a = _remat_wrap(cfg, fn)(unit, x)
        aux = aux + a
    return x, aux


def _scaled(cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    if cfg.scale_embed:  # sqrt(d_model) in f32, rounded to the compute dtype
        scale = torch.full((), float(cfg.d_model), dtype=torch.float32,
                           device=h.device).sqrt()
        h = h * scale.to(h.dtype)
    return h


def _embed_tokens(cfg: ModelConfig, params: DecoderLM, tokens):
    return _scaled(cfg, params.embed[tokens.long()].to(getattr(torch, cfg.dtype)))


def _embed_tp(cfg: ModelConfig, params: DecoderLM, tokens, tp):
    """Token embeddings under tensor parallelism, from this rank's shard of
    ``embed``, and whether they are a partial sum over ``model``: each
    token's row on the rank whose vocabulary rows hold it (zeros on the
    others), or, where the rules split D (a vocabulary that does not divide
    the axis), the rank's columns of every row all-gathered."""
    dt = getattr(torch, cfg.dtype)
    w, V = params.embed, cfg.vocab_size
    if w.shape[0] != V:
        n = w.shape[0]
        idx = tokens.long() - tp.rank * n
        mine = (idx >= 0) & (idx < n)
        h = torch.where(mine[..., None], w[idx.clamp(0, n - 1)], 0).to(dt)
        return _scaled(cfg, h), True
    h = tp.full(w[tokens.long()].to(dt), -1, cfg.d_model)
    return _scaled(cfg, h), False


def _vocab_weight(cfg: ModelConfig, params: DecoderLM):
    return params.embed if cfg.tie_embeddings else params.lm_head


def _logits(cfg: ModelConfig, params: DecoderLM, h: torch.Tensor, tp=None):
    """(B, D) → (B, V) f32 logits against the vocabulary matrix, softcapped.
    Under tensor parallelism (``tp``, ``h`` whole on every rank) the rank's
    block of the vocabulary (B, V / size), or, where the rules split D,
    the rank's partial products all-reduced."""
    w = _vocab_weight(cfg, params).to(h.dtype)
    if tp is not None and w.shape[1] != cfg.d_model:
        logits = tp.reduce(matmul_f32(tp.cols(h, -1, cfg.d_model), w.t()))
        return softcap(logits, cfg.final_logit_softcap)
    return softcap(matmul_f32(h, w.t()), cfg.final_logit_softcap)


def _encode(cfg: ModelConfig, params: DecoderLM, frames,
            dist: Optional[DistCtx] = None):
    """Whisper encoder over stub frame embeddings (B, S_enc, D).  Under
    tensor parallelism (``dist.tp``) the encoder's stream is split over
    ``model`` where its sequence divides, else whole on every rank (its
    attention then split over query positions where the heads are fewer
    than the ranks: each rank's block of frames, the rows all-gathered);
    the output is whole."""
    dt = getattr(torch, cfg.dtype)
    pos = torch.as_tensor(sinusoidal_positions(frames.shape[1], cfg.d_model))
    h = frames.to(dt) + pos.to(dtype=dt, device=frames.device)[None]
    tp = dist.tp if dist is not None else None
    if tp is not None:
        split = tp.splits(h.shape[1])
        dist = dist._replace(sp_axes=("model",) if split else ())
        h = tp.seq_slice(h) if split else h
    h, _ = _run_units(
        cfg, params.enc_units, h,
        lambda unit, hh: entry_train(cfg, "global", 0, unit["e0"], hh,
                                     causal=False, dist=dist),
    )
    h = rms_norm(h, params.enc_norm, cfg.rms_eps)
    return h if tp is None else tp.enter(h, split)


def _decoder_inputs(cfg: ModelConfig, params: DecoderLM, batch) -> Tuple[torch.Tensor, int]:
    """Token (+modality) embeddings.  Returns (embeds, n_prefix) where
    n_prefix = positions that carry no next-token loss (VLM patches)."""
    h = _embed_tokens(cfg, params, batch["tokens"])
    n_prefix = 0
    if cfg.family == "vlm" and "vision_embeds" in batch:
        vis = batch["vision_embeds"].to(h.dtype)
        h = torch.cat([vis, h], dim=1)
        n_prefix = vis.shape[1]
    if cfg.family == "encdec":
        pos = torch.as_tensor(sinusoidal_positions(h.shape[1], cfg.d_model))
        h = h + pos.to(dtype=h.dtype, device=h.device)[None]
    return h, n_prefix


# ---------------------------------------------------------------------------
# Train
# ---------------------------------------------------------------------------


def _decoder_units(cfg: ModelConfig, params, h, enc_out, q_chunk: int,
                   dist: Optional[DistCtx]):
    """The decoder's units over ``h``: (h, the summed MoE aux)."""
    pattern = cfg.layer_pattern

    def entry_fn(unit, hh):
        aux = torch.zeros((), dtype=torch.float32, device=hh.device)
        for i, kind in enumerate(pattern):
            hh, a = entry_train(cfg, kind, i, unit[f"e{i}"], hh,
                                enc_out=enc_out, q_chunk=q_chunk, dist=dist)
            aux = aux + a
        return hh, aux

    return _run_units(cfg, params.units, h, entry_fn)


def train_loss(
    cfg: ModelConfig, params: DecoderLM, batch: Dict, *, q_chunk: int = 1024,
    dist: Optional[DistCtx] = None,
) -> torch.Tensor:
    """Next-token cross-entropy (+ MoE aux), differentiable with respect to
    ``params``.  ``batch`` (tensors on the model's device):
      tokens (B, S) int; labels (B, S) int
      [vlm]  vision_embeds (B, P, D)
      [encdec] frames (B, S_enc, D)
    """
    if dist is not None and dist.tp is not None:
        return _train_loss_tp(cfg, params, batch, q_chunk, dist)
    h, n_prefix = _decoder_inputs(cfg, params, batch)
    enc_out = (
        _encode(cfg, params, batch["frames"]) if cfg.family == "encdec" else None
    )
    h, aux = _decoder_units(cfg, params, h, enc_out, q_chunk, dist)
    h = rms_norm(h, params.final_norm, cfg.rms_eps)
    if n_prefix:
        h = h[:, n_prefix:]
    loss = chunked_cross_entropy(
        h,
        _vocab_weight(cfg, params).to(h.dtype),
        batch["labels"],
        chunk=cfg.loss_chunk,
        final_softcap=cfg.final_logit_softcap,
    )
    return loss + cfg.router_aux_coef * aux


def _train_loss_tp(cfg: ModelConfig, params, batch: Dict, q_chunk: int,
                   dist: DistCtx) -> torch.Tensor:
    """:func:`train_loss` under tensor parallelism (``dist.tp``): this
    rank's part of the reference's partition.  The embedding lookup is
    vocabulary-parallel (each rank its rows, masked; the partial sums
    reduce-scattered to the rank's sequence slice where the sequence
    divides the axis, else all-reduced), the units run on the rank's
    shards (:func:`~repro_torch.models.blocks.entry_train`), the final
    norm's output is all-gathered and the cross-entropy is
    vocabulary-parallel.  The loss is every rank's, its gradient shared
    out (:meth:`~repro_torch.sharding.parallel.TensorParallel.share`)."""
    tp = dist.tp
    dt = getattr(torch, cfg.dtype)
    tokens = batch["tokens"]
    vis = batch.get("vision_embeds") if cfg.family == "vlm" else None
    n_prefix = 0 if vis is None else vis.shape[1]
    S = tokens.shape[1] + n_prefix
    split = tp.splits(S)
    dist = dist._replace(sp_axes=("model",) if split else ())

    rows, v0 = tp.vocab_rows(params.embed, cfg.vocab_size, cfg.d_model)
    idx = tokens.long() - v0
    mine = (idx >= 0) & (idx < rows.shape[0])
    h = torch.where(mine[..., None], rows[idx.clamp(0, rows.shape[0] - 1)],
                    0).to(dt)
    if vis is not None:  # the patches, counted once in the sum
        vis = vis.to(h.dtype)
        h = torch.cat([vis if tp.rank == 0 else torch.zeros_like(vis), h],
                      dim=1)
    h = tp.exit(h, split)
    if cfg.scale_embed:
        scale = torch.full((), float(cfg.d_model), dtype=torch.float32,
                           device=h.device).sqrt()
        h = h * scale.to(h.dtype)
    if cfg.family == "encdec":
        a, b = tp.block(S) if split else (0, S)
        pos = torch.as_tensor(sinusoidal_positions(S, cfg.d_model))[a:b]
        h = h + pos.to(dtype=h.dtype, device=h.device)[None]
    enc_out = (_encode(cfg, params, batch["frames"], dist)
               if cfg.family == "encdec" else None)
    h, aux = _decoder_units(cfg, params, h, enc_out, q_chunk, dist)
    h = tp.enter(rms_norm(h, params.final_norm, cfg.rms_eps), split)
    if n_prefix:
        h = h[:, n_prefix:]
    rows, v0 = tp.vocab_rows(_vocab_weight(cfg, params), cfg.vocab_size,
                             cfg.d_model)
    loss = chunked_cross_entropy(
        h, rows.to(h.dtype), batch["labels"], chunk=cfg.loss_chunk,
        final_softcap=cfg.final_logit_softcap, tp=tp, v0=v0)
    return tp.share(loss + cfg.router_aux_coef * aux)


# ---------------------------------------------------------------------------
# Serve: prefill + decode
# ---------------------------------------------------------------------------


def init_caches(
    cfg: ModelConfig, batch: int, cache_len: int, cache_dtype=torch.bfloat16,
    device="cpu",
) -> List[Dict]:
    """Zeroed caches with the exact decode-time structure (one dict per
    unit)."""
    pattern = cfg.layer_pattern
    cross = cfg.family == "encdec"
    unit_caches = []
    for _ in range(cfg.n_units):
        entry = {}
        for i, kind in enumerate(pattern):
            if kind == "mamba":
                c = init_mamba_cache(cfg, batch, device=device)
            else:
                c = init_attn_cache(cfg, kind, batch, cache_len, cache_dtype,
                                    device)
            if cross:
                shape = (batch, cfg.enc_seq, cfg.n_kv_heads, cfg.head_dim)
                c = {
                    "self": c,
                    "cross_k": torch.zeros(shape, dtype=cache_dtype,
                                           device=device),
                    "cross_v": torch.zeros(shape, dtype=cache_dtype,
                                           device=device),
                }
            entry[f"e{i}"] = c
        unit_caches.append(entry)
    return unit_caches


@torch.inference_mode()
def prefill(
    cfg: ModelConfig,
    params: DecoderLM,
    batch: Dict,
    cache_len: int,
    *,
    q_chunk: int = 1024,
    cache_dtype=torch.bfloat16,
    dist: Optional[DistCtx] = None,
    last_index: Optional[torch.Tensor] = None,
) -> Tuple[List[Dict], torch.Tensor]:
    """Run the full prompt, build caches, return f32 logits at the last
    position (per sequence ``last_index`` for right-padded prompts).
    Under tensor parallelism (``dist.tp``): :func:`_prefill_tp`."""
    if dist is not None and dist.tp is not None:
        return _prefill_tp(cfg, params, batch, cache_len, q_chunk,
                           cache_dtype, dist, last_index)
    h, _ = _decoder_inputs(cfg, params, batch)
    enc_out = (
        _encode(cfg, params, batch["frames"]) if cfg.family == "encdec" else None
    )
    h, caches = _prefill_units(cfg, params, h, enc_out, cache_len, q_chunk,
                               cache_dtype, dist)
    h = rms_norm(h, params.final_norm, cfg.rms_eps)
    if last_index is None:
        last = h[:, -1]
    else:  # ragged prompts (batched serving): per-seq last real position
        rows = torch.arange(h.shape[0], device=h.device)
        last = h[rows, last_index.to(device=h.device, dtype=torch.int64)]
    return caches, _logits(cfg, params, last)


def _prefill_units(cfg, params, h, enc_out, cache_len, q_chunk, cache_dtype,
                   dist):
    """The decoder's units over ``h``, each entry building its cache:
    (the output stream, the caches, one dict per unit)."""
    pattern = cfg.layer_pattern
    caches = []
    for unit in params.units:
        unit_c = {}
        for i, kind in enumerate(pattern):
            h, c = entry_prefill(
                cfg, kind, i, unit[f"e{i}"], h, cache_len,
                enc_out=enc_out, q_chunk=q_chunk, cache_dtype=cache_dtype,
                dist=dist,
            )
            unit_c[f"e{i}"] = c
        caches.append(unit_c)
    return h, caches


def _prefill_tp(cfg: ModelConfig, params, batch: Dict, cache_len: int,
                q_chunk: int, cache_dtype, dist: DistCtx,
                last_index: Optional[torch.Tensor]):
    """:func:`prefill` under tensor parallelism: this rank's part of the
    reference's partition.  The embedding is vocabulary-parallel, as in
    :func:`_train_loss_tp`; the residual stream is split over ``model`` on
    its sequence where the sequence divides; each unit computes on the
    rank's shards and leaves its caches in their layout at rest
    (:func:`~repro_torch.models.blocks.entry_prefill`); the last position
    comes from the rank that holds it and the logits are the rank's
    vocabulary rows."""
    tp = dist.tp
    tokens = batch["tokens"]
    vis = batch.get("vision_embeds") if cfg.family == "vlm" else None
    n_prefix = 0 if vis is None else vis.shape[1]
    S = tokens.shape[1] + n_prefix
    split = tp.splits(S)
    dist = dist._replace(sp_axes=("model",) if split else ())

    h, partial = _embed_tp(cfg, params, tokens, tp)
    if vis is not None:  # the patches, counted once in a partial sum
        vis = vis.to(h.dtype)
        h = torch.cat([vis if tp.rank == 0 or not partial
                       else torch.zeros_like(vis), h], dim=1)
    if partial:
        h = tp.exit(h, split)
    elif split:
        h = tp.seq_slice(h)
    a, b = tp.block(S) if split else (0, S)
    if cfg.family == "encdec":
        pos = torch.as_tensor(sinusoidal_positions(S, cfg.d_model))[a:b]
        h = h + pos.to(dtype=h.dtype, device=h.device)[None]
    enc_out = (_encode(cfg, params, batch["frames"], dist)
               if cfg.family == "encdec" else None)
    h, caches = _prefill_units(cfg, params, h, enc_out, cache_len, q_chunk,
                               cache_dtype, dist)
    h = rms_norm(h, params.final_norm, cfg.rms_eps)
    B = h.shape[0]
    last = (torch.full((B,), S - 1, dtype=torch.int64, device=h.device)
            if last_index is None
            else last_index.to(device=h.device, dtype=torch.int64))
    local = last - a
    mine = ((local >= 0) & (local < b - a))[:, None]
    rows = torch.arange(B, device=h.device)
    last = torch.where(mine, h[rows, local.clamp(0, b - a - 1)], 0)
    if split:  # from the rank whose slice holds it
        last = tp.reduce(last)
    return caches, _logits(cfg, params, last, tp)


@torch.inference_mode()
def decode_step(
    cfg: ModelConfig,
    params: DecoderLM,
    tokens: torch.Tensor,  # (B, 1)
    caches: List[Dict],
    pos,  # int / 0-d tensor, or (B,) tensor: tokens already in cache
    *,
    dist: Optional[DistCtx] = None,
) -> Tuple[torch.Tensor, List[Dict]]:
    """One token per sequence: f32 logits (B, V), and ``caches`` updated in
    place (returned for convenience).  Under tensor parallelism
    (``dist.tp``) or with split caches (``dist.cache``) the stream is whole
    on every rank, each unit computes on the rank's shards and caches, and
    the logits are the rank's vocabulary rows."""
    tp = dist.tp if dist is not None else None
    if dist is not None and (tp is not None or dist.cache is not None):
        dist = dist._replace(sp_axes=())
    if tp is None:
        h = _embed_tokens(cfg, params, tokens)
    else:
        h, partial = _embed_tp(cfg, params, tokens, tp)
        h = tp.exit(h, False) if partial else h
    if cfg.family == "encdec":
        # sinusoidal position for the current (dynamic) step; handles scalar
        # or per-sequence vector positions
        if isinstance(pos, torch.Tensor):
            posv = pos.to(h.device).reshape(-1)  # (1,) or (B,)
        else:
            posv = torch.full((1,), int(pos), device=h.device)
        pe = sinusoidal_at(posv, cfg.d_model)
        h = h + pe[:, None, :].to(h.dtype)
    pattern = cfg.layer_pattern
    for unit, unit_c in zip(params.units, caches):
        for i, kind in enumerate(pattern):
            h, _ = entry_decode(cfg, kind, i, unit[f"e{i}"], h,
                                unit_c[f"e{i}"], pos, dist=dist)
    h = rms_norm(h, params.final_norm, cfg.rms_eps)
    return _logits(cfg, params, h[:, 0], tp), caches


def serving_weights(cfg: ModelConfig, params: DecoderLM) -> DecoderLM:
    """Cast, in place and once, every parameter whose every use first casts
    it to ``cfg.dtype``: the matrices (attention, MLP, MoE, ``embed`` /
    ``lm_head``, ``in_proj``, ``out_proj``) but ``conv_w``.  The vectors
    (norm weights, ``A_log``, ``D``, ``dt_bias``, ``conv_b``) stay, and so
    does ``conv_w``: the decode step uses it at the f32 of its conv cache.
    The model's outputs do not change: a use of a cast weight reads the
    values it would have cast."""
    dt = getattr(torch, cfg.dtype)
    for name, p in params.named_parameters():
        if p.dim() >= 2 and not name.endswith("conv_w"):
            p.data = p.data.to(dt)
    return params
