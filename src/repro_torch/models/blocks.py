"""Per-layer ("entry") assembly: norm → mixer (attn | mamba) → norm → ffn
(dense MLP | MoE), with gemma-style optional post-norms.  Entries are the
elements of ``cfg.layer_pattern``; the model holds ``n_units`` repetitions
of the pattern as an ``nn.ModuleList`` (the reference scans over stacked
unit parameters)."""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..configs.base import ModelConfig
from .attention import (
    attn_decode, attn_train, cross_cache, init_attn, prefill_cache_split,
    prefill_fill_cache, splits_queries,
)
from .common import rms_norm
from .mamba import init_mamba, mamba_decode, mamba_train
from .mlp import init_mlp, mlp
from .moe import DistCtx, init_moe, moe_apply

__all__ = ["Entry", "init_entry", "entry_train", "entry_prefill",
           "entry_decode"]


def _has_ffn(cfg: ModelConfig, idx: int) -> Optional[str]:
    """What follows the mixer at pattern position ``idx``:
    'moe' | 'mlp' | None (pure-mamba archs fold the MLP into the mixer)."""
    if cfg.is_moe_layer(idx):
        return "moe"
    if cfg.d_ff > 0:
        return "mlp"
    return None


class Entry(nn.Module):
    """One layer: ``ln1``, ``attn`` or ``mamba``, [``ln1_post``], [``ln_x``,
    ``xattn``], [``ln2``, [``ln2_post``], ``mlp`` or ``moe``] — the
    reference's parameter names."""

    def __init__(self, cfg: ModelConfig, kind: str, idx: int, generator=None,
                 device=None, cross: bool = False):
        super().__init__()
        pd = getattr(torch, cfg.param_dtype)
        D = cfg.d_model

        def norm():
            return nn.Parameter(torch.zeros(D, dtype=pd, device=device))

        self.ln1 = norm()
        if kind == "mamba":
            self.mamba = init_mamba(cfg, generator, device)
        else:
            self.attn = init_attn(cfg, generator, device)
        if cfg.post_norms:
            self.ln1_post = norm()
        if cross:  # whisper decoder: add a cross-attention sub-block
            self.ln_x = norm()
            self.xattn = init_attn(cfg, generator, device)
        ffn = _has_ffn(cfg, idx)
        if ffn:
            self.ln2 = norm()
            if cfg.post_norms:
                self.ln2_post = norm()
            if ffn == "moe":
                self.moe = init_moe(cfg, generator, device)
            else:
                self.mlp = init_mlp(cfg, generator, device)


def init_entry(cfg: ModelConfig, kind: str, idx: int, generator=None,
               device=None, cross: bool = False) -> Entry:
    return Entry(cfg, kind, idx, generator, device, cross)


def _enter(dist, h):
    """A tensor-parallel region's input: the whole sequence (see
    :class:`~repro_torch.sharding.parallel.TensorParallel`)."""
    if dist is None or dist.tp is None:
        return h
    return dist.tp.enter(h, bool(dist.sp_axes))


def _exit(dist, y):
    """A region's output (a partial sum) in the residual stream's layout."""
    if dist is None or dist.tp is None:
        return y
    return dist.tp.exit(y, bool(dist.sp_axes))


def _attn_exit(cfg, dist, y, n):
    """An attention region's output in the residual stream's layout: where
    the queries are split (:func:`~repro_torch.models.attention.
    splits_queries`) the rank's rows, all-gathered where the stream is
    whole (``n`` positions), else as :func:`_exit`."""
    if splits_queries(cfg, dist):
        return dist.tp.rows_out(y, bool(dist.sp_axes), n)
    return _exit(dist, y)


def _cross(cfg, p, x, enc_out, q_chunk, dist):
    """Whisper's cross-attention sub-block on the stream ``x``: its output
    in the stream's layout.  Where the queries are split the rank's own
    positions query, and no gather of the stream is needed."""
    h = rms_norm(x, p.ln_x, cfg.rms_eps)
    if splits_queries(cfg, dist):
        h = h if dist.sp_axes else dist.tp.seq_slice(h)
    else:
        h = _enter(dist, h)
    return _attn_exit(cfg, dist, attn_train(
        cfg, p.xattn, h, "global", kv_source=enc_out, causal=False,
        q_chunk=q_chunk, dist=dist), x.shape[1])


def _ffn_apply(cfg, idx, p, x, dist=None):
    ffn = _has_ffn(cfg, idx)
    if ffn is None:
        return x, 0.0
    h = _enter(dist, rms_norm(x, p.ln2, cfg.rms_eps))
    if ffn == "moe":
        h, aux = moe_apply(cfg, p.moe, h, dist)
    else:
        h, aux = mlp(cfg, p.mlp, h, dist.tp if dist is not None else None), 0.0
    h = _exit(dist, h)
    if cfg.post_norms:
        h = rms_norm(h, p.ln2_post, cfg.rms_eps)
    return x + h, aux


def entry_train(
    cfg: ModelConfig,
    kind: str,
    idx: int,
    p: Entry,
    x: torch.Tensor,
    *,
    causal: bool = True,
    enc_out: Optional[torch.Tensor] = None,
    q_chunk: int = 1024,
    dist: Optional[DistCtx] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward. Returns (x, aux_loss).

    Under tensor parallelism (``dist.tp``) ``x`` is this rank's part of the
    residual stream (its sequence slice where ``dist.sp_axes``) and each
    mixer and FFN runs on the rank's shards between :func:`_enter` and
    :func:`_exit` (an attention split over query positions leaves through
    :func:`_attn_exit`)."""
    h = _enter(dist, rms_norm(x, p.ln1, cfg.rms_eps))
    if kind == "mamba":
        h = _exit(dist, mamba_train(cfg, p.mamba, h,
                                    tp=dist.tp if dist is not None else None))
    else:
        h = _attn_exit(cfg, dist, attn_train(cfg, p.attn, h, kind,
                                             causal=causal, q_chunk=q_chunk,
                                             dist=dist), h.shape[1])
    if cfg.post_norms:
        h = rms_norm(h, p.ln1_post, cfg.rms_eps)
    x = x + h
    if enc_out is not None:  # whisper decoder cross-attention
        x = x + _cross(cfg, p, x, enc_out, q_chunk, dist)
    return _ffn_apply(cfg, idx, p, x, dist)


def entry_prefill(
    cfg: ModelConfig,
    kind: str,
    idx: int,
    p: Entry,
    x: torch.Tensor,
    cache_len: int,
    *,
    enc_out: Optional[torch.Tensor] = None,
    q_chunk: int = 1024,
    cache_dtype=torch.bfloat16,
    dist: Optional[DistCtx] = None,
) -> Tuple[torch.Tensor, Dict]:
    """Forward + build this entry's decode cache.  Under tensor
    parallelism (``dist.tp``) ``x`` is the rank's part of the residual
    stream, as in :func:`entry_train`, and the cache is the rank's part in
    its layout at rest (``dist.cache``)."""
    tp = dist.tp if dist is not None else None
    h = _enter(dist, rms_norm(x, p.ln1, cfg.rms_eps))
    if kind == "mamba":
        y, cache = mamba_train(cfg, p.mamba, h, return_cache=True, tp=tp)
        h = _exit(dist, y)
    else:
        y, kv = attn_train(cfg, p.attn, h, kind, q_chunk=q_chunk,
                           return_kv=True, dist=dist)
        cache = (prefill_fill_cache(cfg, kind, *kv, cache_len, cache_dtype)
                 if tp is None else
                 prefill_cache_split(cfg, p.attn, h, kind, kv, cache_len,
                                     dist, cache_dtype))
        h = _attn_exit(cfg, dist, y, h.shape[1])
    if cfg.post_norms:
        h = rms_norm(h, p.ln1_post, cfg.rms_eps)
    x = x + h
    if enc_out is not None:
        x = x + _cross(cfg, p, x, enc_out, q_chunk, dist)
        kx, vx = cross_cache(cfg, p.xattn, enc_out, dist, cache_dtype)
        cache = {"self": cache, "cross_k": kx, "cross_v": vx}
    x, _ = _ffn_apply(cfg, idx, p, x, dist)
    return x, cache


def entry_decode(
    cfg: ModelConfig,
    kind: str,
    idx: int,
    p: Entry,
    x: torch.Tensor,  # (B, 1, D)
    cache: Dict,
    pos,
    dist: Optional[DistCtx] = None,
) -> Tuple[torch.Tensor, Dict]:
    """One token; updates ``cache`` in place and returns it.  Under tensor
    parallelism (``dist.tp``) ``x`` is whole on every rank, each mixer and
    FFN computes on the rank's shards and caches and an all-reduce closes
    it (``dist.sp_axes`` is empty)."""
    tp = dist.tp if dist is not None else None
    h = rms_norm(x, p.ln1, cfg.rms_eps)
    is_encdec_entry = "cross_k" in cache
    self_cache = cache["self"] if is_encdec_entry else cache
    if kind == "mamba":
        h, _ = mamba_decode(cfg, p.mamba, h, self_cache, tp=tp)
    else:
        h, _ = attn_decode(cfg, p.attn, h, kind, self_cache, pos, dist=dist)
    h = _exit(dist, h)
    if cfg.post_norms:
        h = rms_norm(h, p.ln1_post, cfg.rms_eps)
    x = x + h
    if is_encdec_entry:
        h = rms_norm(x, p.ln_x, cfg.rms_eps)
        h, _ = attn_decode(
            cfg, p.xattn, h, "global", {}, pos,
            cross_kv=(cache["cross_k"], cache["cross_v"]), dist=dist,
        )
        x = x + _exit(dist, h)
    x, _ = _ffn_apply(cfg, idx, p, x, dist)
    return x, cache
