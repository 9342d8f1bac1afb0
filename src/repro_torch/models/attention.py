"""GQA attention for the assigned architectures.

Covers: grouped-query attention, RoPE (per-kind base for gemma3), sliding
window / local layers, attention-logit softcapping (gemma2), QK-norm
(gemma3/olmoe), gemma2 query scaling, encoder (bidirectional) and
cross-attention (whisper), KV caches (full, ring/window), and
**q-chunked attention** for long sequences: scores are materialized only
per q-chunk — (B, KV, G, chunk, S_k) — which bounds activation memory;
local layers additionally slice keys to the window, so their compute is
O(S · W), not O(S²).

Under tensor parallelism (``dist.tp``, the sharded steps) a rank
computes the heads its ``model`` shards hold (:func:`_head_shard`): the
projections are column-parallel, ``wo`` row-parallel, and the output is
the rank's partial sum of the layer's output.  With fewer query heads than
ranks (whisper) the split is over the query positions instead
(:func:`splits_queries`): each rank computes every head for its block of
the positions, and its output rows are complete.  The sharded prefill and
decode keep each cache in its layout at rest (``dist.cache``, a
:class:`~repro_torch.sharding.parallel.CacheLayout`): the rank's KV heads
over every slot, or every KV head over the rank's block of slots, where
decode attends per block and joins the blocks by the log-sum-exp combine
(:func:`prefill_cache_split`, :func:`attn_decode`).

Cache contract: :func:`attn_decode` writes the new key / value into the
cache tensors **in place** and returns the same dict.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch
from torch import nn

from ..configs.base import ModelConfig
from .common import (
    apply_rope, matmul_f32, normal_init, rms_norm, softcap,
)

__all__ = ["Attention", "init_attn", "attn_train", "attn_decode",
           "init_attn_cache", "prefill_fill_cache", "prefill_cache_split",
           "cross_cache", "splits_queries"]

NEG_INF = -2.0**30  # large-but-finite: keeps fully-masked rows NaN-free


def splits_queries(cfg: ModelConfig, dist) -> bool:
    """Whether tensor parallelism (``dist.tp``) splits the attention over
    query positions: fewer query heads than ``model`` ranks (whisper's 6
    over 16), where each rank computes every head for its block of the
    positions (:func:`attn_train`)."""
    return (dist is not None and dist.tp is not None
            and cfg.n_heads < dist.tp.size)


def _head_shard(cfg: ModelConfig, tp, x, src, params: Attention):
    """q, k and v of the heads this rank computes under tensor parallelism
    (``tp``, the ``model`` axis), the reference's head-axis sharding
    written out, and the rows of ``wo`` that meet them: (B, S, Hl·hd)
    queries and (B, Sk, KVl·hd) keys / values, Hl a multiple of KVl, query
    head ``j`` reading key head ``j // (Hl / KVl)``.  There are at least
    as many query heads as ranks (else :func:`splits_queries`).

    The rank's query heads are its block of the heads (its shard of
    ``wq`` where the heads divide the axis, else its heads of ``wq``
    all-gathered); its key heads are its shard of ``wk`` / ``wv`` where
    both divide, else the groups its query heads read, from ``wk`` / ``wv``
    all-gathered (one key head per query head where a group straddles two
    ranks)."""
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = x.dtype
    a, b = tp.block(H)
    if H % tp.size == 0:
        q = x @ tp.cols(params.wq, 1, H * hd).to(dt)
        wo = tp.cols(params.wo, 0, H * hd)
        if KV % tp.size == 0:
            k = src @ tp.cols(params.wk, 1, KV * hd).to(dt)
            v = src @ tp.cols(params.wv, 1, KV * hd).to(dt)
            return q, k, v, wo
    else:
        q = x @ tp.full(params.wq, 1, H * hd)[:, a * hd:b * hd].to(dt)
        wo = tp.full(params.wo, 0, H * hd)[a * hd:b * hd]
    G, Hl = H // KV, b - a
    heads = [j // G for j in range(a, b)]
    k0, n = heads[0], heads[-1] - heads[0] + 1
    k = src @ tp.full(params.wk, 1, KV * hd)[:, k0 * hd:(k0 + n) * hd].to(dt)
    v = src @ tp.full(params.wv, 1, KV * hd)[:, k0 * hd:(k0 + n) * hd].to(dt)
    if Hl % n == 0 and heads == [k0 + j // (Hl // n) for j in range(Hl)]:
        return q, k, v, wo  # whole groups
    B, Sk = k.shape[:2]  # one key head per query head
    pick = torch.tensor([h - k0 for h in heads], device=k.device)
    return (q, k.reshape(B, Sk, n, hd)[:, :, pick].reshape(B, Sk, Hl * hd),
            v.reshape(B, Sk, n, hd)[:, :, pick].reshape(B, Sk, Hl * hd), wo)


def _rope_base(cfg: ModelConfig, kind: str) -> float:
    if kind == "local" and cfg.rope_base_local is not None:
        return cfg.rope_base_local
    return cfg.rope_base


def _scale(cfg: ModelConfig) -> float:
    if cfg.query_scale is not None:
        return cfg.query_scale**-0.5
    return float(cfg.head_dim) ** -0.5


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------


class Attention(nn.Module):
    """Attention parameters, stored fused as in the reference:
    wq (D, H·hd), wk/wv (D, KV·hd), wo (H·hd, D)."""

    def __init__(self, cfg: ModelConfig, generator=None, device=None):
        super().__init__()
        D = cfg.d_model
        H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        pd = getattr(torch, cfg.param_dtype)

        def init(shape):
            return nn.Parameter(normal_init(generator, shape, dtype=pd,
                                      device=device))

        self.wq = init((D, H * hd))
        self.wk = init((D, KV * hd))
        self.wv = init((D, KV * hd))
        self.wo = init((H * hd, D))
        if cfg.qk_norm:
            self.q_norm = nn.Parameter(torch.zeros(hd, dtype=pd, device=device))
            self.k_norm = nn.Parameter(torch.zeros(hd, dtype=pd, device=device))


def init_attn(cfg: ModelConfig, generator=None, device=None) -> Attention:
    return Attention(cfg, generator, device)


def init_attn_cache(
    cfg: ModelConfig, kind: str, batch: int, cache_len: int,
    dtype=torch.bfloat16, device=None,
) -> Dict:
    """KV cache for one attention layer.  Local layers keep a ring buffer of
    ``window`` slots (keys cached post-RoPE, so ring order is irrelevant —
    softmax is permutation-invariant over the key set)."""
    cap = cache_len
    if kind == "local" and cfg.window:
        cap = min(cfg.window, cache_len)
    KV, hd = cfg.n_kv_heads, cfg.head_dim
    return {
        "k": torch.zeros((batch, cap, KV, hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, cap, KV, hd), dtype=dtype, device=device),
    }


# ---------------------------------------------------------------------------
# Products: scores (f32) and probs @ v
# ---------------------------------------------------------------------------


def _scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """einsum("bqkgh,bskh->bkgqs") in f32: q (B, qc, KV, G, hd), k (B, Sk,
    KV, hd) → (B, KV, G, qc, Sk)."""
    B, qc, KV, G, hd = q.shape
    Sk = k.shape[1]
    qq = q.permute(0, 2, 3, 1, 4).reshape(B * KV, G * qc, hd)
    kk = k.permute(0, 2, 3, 1).reshape(B * KV, hd, Sk)
    return matmul_f32(qq, kk).reshape(B, KV, G, qc, Sk)


def _probs_v(probs: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """einsum("bkgqs,bskh->bqkgh"): probs (B, KV, G, qc, Sk), v (B, Sk, KV,
    hd) → (B, qc, KV, G, hd) in their common dtype."""
    B, KV, G, qc, Sk = probs.shape
    hd = v.shape[-1]
    pp = probs.reshape(B * KV, G * qc, Sk)
    vv = v.permute(0, 2, 1, 3).reshape(B * KV, Sk, hd)
    out = torch.bmm(pp, vv).reshape(B, KV, G, qc, hd)
    return out.permute(0, 3, 1, 2, 4)


# ---------------------------------------------------------------------------
# q-chunked attention (train / prefill)
# ---------------------------------------------------------------------------


class _CappedSoftmax(torch.autograd.Function):
    """``softmax(mask(softcap(s, cap)))`` of the f32 scores ``s`` (gemma2's
    attention logits), computed in f32 and returned in ``dtype``.  It saves
    one f32 tensor, ``tanh(s / cap)``, where autograd's chain of the same
    operators saves that and the f32 probabilities: the backward recomputes
    the probabilities from it, then takes the chain's backward steps in
    their order, so values and gradients are the chain's bit for bit."""

    @staticmethod
    def forward(ctx, s, cap, hidden, dtype):
        t = torch.tanh(s / cap)
        p = torch.softmax(_capped(t, cap, hidden), dim=-1)
        ctx.cap = cap
        ctx.save_for_backward(t, hidden)
        return p.to(dtype)

    @staticmethod
    def backward(ctx, g):
        t, hidden = ctx.saved_tensors
        cap = ctx.cap
        p = torch.softmax(_capped(t, cap, hidden), dim=-1)
        g = torch._softmax_backward_data(g.to(p.dtype), p, -1, p.dtype)
        del p
        if hidden is not None:
            g = g.masked_fill(hidden, 0.0)
        g = torch.ops.aten.tanh_backward(g * cap, t)
        return g / cap, None, None, None


def _capped(t, cap, hidden):
    """``cap · t`` with the ``hidden`` positions at ``NEG_INF``."""
    x = cap * t
    return x if hidden is None else x.masked_fill(hidden, NEG_INF)


def _attend_chunk(q, k, v, mask, scale, cap):
    """q (B, qc, KV, G, hd); k/v (B, Sk, KV, hd); mask (qc, Sk) or None."""
    scores = _scores(q, k) * scale
    if cap is not None:
        hidden = None if mask is None else ~mask
        probs = _CappedSoftmax.apply(scores, cap, hidden, v.dtype)
        return _probs_v(probs, v)
    if mask is not None:
        scores = scores.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return _probs_v(probs, v)


def attn_train(
    cfg: ModelConfig,
    params: Attention,
    x: torch.Tensor,
    kind: str,
    *,
    positions: Optional[torch.Tensor] = None,
    q_chunk: int = 1024,
    causal: bool = True,
    kv_source: Optional[torch.Tensor] = None,
    return_kv: bool = False,
    dist=None,
) -> Union[torch.Tensor, Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]]:
    """Full-sequence attention (forward of training / prefill).

    ``kind``: "global" (causal full), "local" (causal windowed).
    ``causal=False`` gives the whisper encoder (bidirectional).
    ``kv_source``: cross-attention (keys/values from the encoder output).

    Where tensor parallelism splits the queries (:func:`splits_queries`)
    the rank computes every head, from ``wq`` / ``wk`` / ``wv`` / ``wo``
    all-gathered whole, for its block of the query positions
    (:meth:`~repro_torch.sharding.parallel.TensorParallel.block`): of a
    self-attention's ``x`` (the whole sequence) the rows of the block,
    against the keys of the positions up to the block's end (causal) or of
    every position; a cross-attention's ``x`` holds the rank's rows
    already.  The output is then those rows' output, complete (no partial
    sum), and the keys and values returned are every head's over the
    positions it read.
    """
    B, S, D = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    G = H // KV
    dt = x.dtype
    dev = x.device

    src = x if kv_source is None else kv_source
    tp = dist.tp if dist is not None else None
    q0 = 0  # the position of the first query
    if tp is None or splits_queries(cfg, dist):
        wq, wk, wv, wo = params.wq, params.wk, params.wv, params.wo
        if tp is not None:
            wq, wk, wv = (tp.full(w, 1, n * hd) for w, n in (
                (wq, H), (wk, KV), (wv, KV)))
            wo = tp.full(wo, 0, H * hd)
            if kv_source is None:
                q0, end = tp.block(S)
                x, src = x[:, q0:end], (x[:, :end] if causal else x)
                S = end - q0
        Sk = src.shape[1]
        q = (x @ wq.to(dt)).reshape(B, S, KV, G, hd)
        k = (src @ wk.to(dt)).reshape(B, Sk, KV, hd)
        v = (src @ wv.to(dt)).reshape(B, Sk, KV, hd)
    else:
        Sk = src.shape[1]
        q, k, v, wo = _head_shard(cfg, tp, x, src, params)
        KV = k.shape[-1] // hd
        G = q.shape[-1] // hd // KV
        q = q.reshape(B, S, KV, G, hd)
        k = k.reshape(B, Sk, KV, hd)
        v = v.reshape(B, Sk, KV, hd)

    if cfg.qk_norm:
        q = rms_norm(q, params.q_norm, cfg.rms_eps)
        k = rms_norm(k, params.k_norm, cfg.rms_eps)

    if kv_source is None:  # self-attention gets RoPE
        pos = (
            positions
            if positions is not None
            else torch.arange(Sk, dtype=torch.int32, device=dev)[None, :]
        )
        base = _rope_base(cfg, kind)
        q = apply_rope(q.reshape(B, S, KV * G, hd), pos[:, q0:q0 + S],
                       base).reshape(B, S, KV, G, hd)
        k = apply_rope(k, pos[:, :Sk], base)

    scale = _scale(cfg)
    cap = cfg.attn_logit_softcap
    window = cfg.window if kind == "local" else None

    qc = min(q_chunk, S)
    pad = (-S) % qc
    if pad:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, 0, 0, pad))
    nq = (S + pad) // qc
    ar = torch.arange(qc, device=dev)

    outs = []
    if window is not None and causal and kv_source is None and Sk > window + qc:
        # local layers: slice keys to [start, start + W + qc) per q chunk —
        # compute is O(S·W) instead of O(S²)
        W = window
        kwin = W + qc
        karange = torch.arange(kwin, device=dev)
        for i in range(nq):
            qs = q0 + i * qc
            # clamp so the fixed-size slice stays in bounds
            start = min(max(0, qs - W), Sk - kwin)
            ks = k[:, start:start + kwin]
            vs = v[:, start:start + kwin]
            qpos = qs + ar
            kpos = start + karange
            m = (
                (qpos[:, None] >= kpos[None, :])
                & (qpos[:, None] - kpos[None, :] < W)
            )
            outs.append(_attend_chunk(q[:, i * qc:(i + 1) * qc], ks, vs, m,
                                      scale, cap))
    else:
        kpos = torch.arange(Sk, device=dev)
        for i in range(nq):
            qpos = q0 + i * qc + ar
            if causal and kv_source is None:
                m = qpos[:, None] >= kpos[None, :]
                if window is not None:
                    m &= qpos[:, None] - kpos[None, :] < window
            else:
                m = None
            outs.append(
                _attend_chunk(q[:, i * qc:(i + 1) * qc], k, v, m, scale, cap))

    out = torch.cat(outs, dim=1).reshape(B, S + pad, KV * G * hd)[:, :S]
    # under a head shard row-parallel: the rank's heads, a partial sum
    out = out @ wo.to(dt)
    if return_kv:
        return out, (k, v)
    return out


# ---------------------------------------------------------------------------
# decode (one token against a cache)
# ---------------------------------------------------------------------------


def attn_decode(
    cfg: ModelConfig,
    params: Attention,
    x: torch.Tensor,  # (B, 1, D)
    kind: str,
    cache: Dict,
    pos,  # int / 0-d tensor, or (B,) per-sequence: tokens already in cache
    *,
    cross_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    dist=None,
) -> Tuple[torch.Tensor, Dict]:
    """One token against the cache.  Self-attention writes the token's key
    and value into ``cache`` in place and returns it.  With a cache layout
    (``dist.cache``) the caches are this rank's part
    (:func:`_attn_decode_split`)."""
    if dist is not None and dist.cache is not None:
        return _attn_decode_split(cfg, params, x, kind, cache, pos, cross_kv,
                                  dist)
    B, _, D = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    G = H // KV
    dt = x.dtype
    dev = x.device

    q = (x @ params.wq.to(dt)).reshape(B, 1, KV, G, hd)
    if cfg.qk_norm:
        q = rms_norm(q, params.q_norm, cfg.rms_eps)
    vector_pos = isinstance(pos, torch.Tensor) and pos.dim() == 1
    if vector_pos:
        posb = pos[:, None].to(torch.int32)
    else:
        posb = torch.full((B, 1), int(pos), dtype=torch.int32, device=dev)
    base = _rope_base(cfg, kind)
    q = apply_rope(q.reshape(B, 1, KV * G, hd), posb, base).reshape(
        B, 1, KV, G, hd
    )
    scale = _scale(cfg)
    cap = cfg.attn_logit_softcap

    if cross_kv is not None:
        k, v = cross_kv  # (B, S_enc, KV, hd) — static, no cache update
        scores = _scores(q, k) * scale
        scores = softcap(scores, cap)
        probs = torch.softmax(scores, dim=-1).to(v.dtype)
        out = _probs_v(probs, v).reshape(B, 1, H * hd).to(dt)
        return out @ params.wo.to(dt), cache

    k_new = (x @ params.wk.to(dt)).reshape(B, 1, KV, hd)
    v_new = (x @ params.wv.to(dt)).reshape(B, 1, KV, hd)
    if cfg.qk_norm:
        k_new = rms_norm(k_new, params.k_norm, cfg.rms_eps)
    k_new = apply_rope(k_new, posb, base)

    ck, cv = cache["k"], cache["v"]
    cap_len = ck.shape[1]
    is_ring = kind == "local" and cfg.window is not None
    idx = torch.arange(cap_len, device=dev)
    if vector_pos:
        pos = pos.to(device=dev, dtype=torch.int64)
        slot = pos % cap_len if is_ring else torch.clamp(pos, max=cap_len - 1)
        rows = torch.arange(B, device=dev)
        ck[rows, slot] = k_new[:, 0].to(ck.dtype)
        cv[rows, slot] = v_new[:, 0].to(cv.dtype)
        valid = (idx[None, :] <= slot[:, None]) | (pos[:, None] >= cap_len)
        vmask = valid[:, None, None, None, :]
    else:
        p = int(pos)
        slot = p % cap_len if is_ring else min(p, cap_len - 1)
        ck[:, slot] = k_new[:, 0].to(ck.dtype)
        cv[:, slot] = v_new[:, 0].to(cv.dtype)
        # validity: ring buffers are fully valid once wrapped; otherwise ≤ pos
        valid = (idx <= slot) | (p >= cap_len)
        vmask = valid[None, None, None, None, :]
    scores = _scores(q, ck.to(dt)) * scale
    scores = softcap(scores, cap)
    scores = scores.masked_fill(~vmask, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(dt)
    out = _probs_v(probs, cv.to(dt)).reshape(B, 1, H * hd)
    out = out @ params.wo.to(dt)
    return out, cache


def _attn_decode_split(cfg: ModelConfig, params: Attention, x, kind: str,
                       cache: Dict, pos, cross_kv, dist):
    """:func:`attn_decode` on this rank's part of the caches (the layout of
    ``dist.cache``) and of the weights.  ``x`` is whole on every rank.
    Where ``model`` splits the KV heads the rank computes its query heads
    against its KV heads; else every head, its q, k and v the column
    blocks of every rank all-gathered, and its output's rows meet the
    rank's rows of ``wo``.  Where the cache's slots are split, each rank
    attends over its block, the blocks joined by the log-sum-exp combine
    (:meth:`~repro_torch.sharding.parallel.SeqSplit.combine`), and the new
    key / value are written by the rank whose block holds the slot.
    ``pos`` is one position for every sequence (a host integer or a 0-d
    tensor).  The output is the rank's partial sum (the whole output
    without ``tp``)."""
    tp, layout = dist.tp, dist.cache
    B = x.shape[0]
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    G = H // KV
    dt = x.dtype
    dev = x.device
    heads_split = tp is not None and layout.kv_split
    KVl = KV // tp.size if heads_split else KV

    def proj(w, n):  # x @ w: the rank's heads, or every head
        y = x @ w.to(dt)
        return y if tp is None or heads_split else tp.full(y, -1, n)

    q = proj(params.wq, H * hd).reshape(B, 1, KVl, G, hd)
    if cfg.qk_norm:
        q = rms_norm(q, params.q_norm, cfg.rms_eps)
    p = int(pos)  # one position for every sequence, on the host
    posb = torch.full((B, 1), p, dtype=torch.int32, device=dev)
    base = _rope_base(cfg, kind)
    q = apply_rope(q.reshape(B, 1, KVl * G, hd), posb, base).reshape(
        B, 1, KVl, G, hd)

    vmask = None
    if cross_kv is not None:
        ck, cv = cross_kv
        seq = layout.seq(cfg.enc_seq)
    else:
        k_new = proj(params.wk, KV * hd).reshape(B, 1, KVl, hd)
        v_new = proj(params.wv, KV * hd).reshape(B, 1, KVl, hd)
        if cfg.qk_norm:
            k_new = rms_norm(k_new, params.k_norm, cfg.rms_eps)
        k_new = apply_rope(k_new, posb, base)
        ck, cv = cache["k"], cache["v"]
        ring = kind == "local" and cfg.window is not None
        n = min(cfg.window, layout.cache_len) if ring else layout.cache_len
        seq = layout.seq(n)
        a, b = seq.block(n) if seq is not None else (0, n)
        if ck.shape[1] != b - a:
            raise ValueError(f"cache of {ck.shape[1]} slots, layout {b - a}")
        slot = p % n if ring else min(p, n - 1)
        if a <= slot < b:  # this rank's block holds the slot
            ck[:, slot - a] = k_new[:, 0].to(ck.dtype)
            cv[:, slot - a] = v_new[:, 0].to(cv.dtype)
        # validity on the global slots: ring buffers are fully valid once
        # wrapped; otherwise ≤ pos
        idx = a + torch.arange(b - a, device=dev)
        vmask = ((idx <= slot) | (p >= n))[None, None, None, None, :]

    scores = _scores(q, ck.to(dt)) * _scale(cfg)
    scores = softcap(scores, cfg.attn_logit_softcap)  # before the max
    if vmask is not None:
        scores = scores.masked_fill(~vmask, NEG_INF)
    if seq is None:
        probs = torch.softmax(scores, dim=-1).to(dt)
        out = _probs_v(probs, cv.to(dt))
    else:  # this block's partials, joined over the ranks' blocks
        m = scores.amax(dim=-1, keepdim=True)
        e = torch.exp(scores - m)
        acc = _probs_v(e, cv.float())  # (B, 1, KVl, G, hd)
        m, l = (t.permute(0, 3, 1, 2, 4) for t in (m, e.sum(-1, keepdim=True)))
        out = seq.combine(m, l, acc).to(dt)
    out = out.reshape(B, 1, KVl * G * hd)
    if tp is None or heads_split:
        return out @ params.wo.to(dt), cache
    return tp.cols(out, -1, H * hd) @ tp.cols(params.wo, 0, H * hd).to(dt), cache


def _slot_positions(S: int, cap: int, ring: bool, a: int, b: int, device):
    """The position that each slot of ``[a, b)`` of a cache of ``cap``
    slots holds after a prefill of ``S`` positions (the layout of
    :func:`prefill_fill_cache`), -1 where a slot holds none."""
    j = torch.arange(a, b, device=device)
    if S < cap:
        return torch.where(j < S, j, -1)
    if ring:  # position p lives in slot p % cap
        return S - cap + (j - (S - cap)) % cap
    return S - cap + j


def _kv_rows(cfg: ModelConfig, params: Attention, rows: torch.Tensor,
             heads_split: bool, tp):
    """Keys and values (B, n, KV·, hd) of ``rows`` (B, n, D): this rank's
    KV heads where ``heads_split``, else every head, from ``wk`` / ``wv``
    all-gathered over ``model`` where they are split."""
    B, n = rows.shape[:2]
    KV, hd = cfg.n_kv_heads, cfg.head_dim
    dt = rows.dtype

    def w(t):
        return t if tp is None or heads_split else tp.full(t, 1, KV * hd)

    k = (rows @ w(params.wk).to(dt)).reshape(B, n, -1, hd)
    v = (rows @ w(params.wv).to(dt)).reshape(B, n, -1, hd)
    return k, v


def prefill_cache_split(cfg: ModelConfig, params: Attention, x: torch.Tensor,
                        kind: str, kv, cache_len: int, dist,
                        dtype=torch.bfloat16) -> Dict:
    """This rank's cache of a self-attention layer after a prefill, in its
    layout at rest (``dist.cache``).  ``x`` is the layer's normalised
    input, the whole sequence; ``kv`` the keys and values that
    :func:`attn_train` computed (the rank's KV heads under ``dist.tp``).
    Where ``model`` splits the KV heads and not the slots, the cache is
    built from ``kv``; else each slot of the rank's block is computed from
    the position it holds (a local layer's ring keeps its slot order), for
    the rank's KV heads or every head (``wk`` / ``wv`` all-gathered)."""
    layout, tp = dist.cache, dist.tp
    heads_split = tp is not None and layout.kv_split
    ring = kind == "local" and bool(cfg.window)
    cap = min(cfg.window, cache_len) if ring else cache_len
    seq = layout.seq(cap)
    if heads_split and seq is None:
        k, v = kv
        return prefill_fill_cache(cfg, kind, k, v, cache_len, dtype)
    a, b = seq.block(cap) if seq is not None else (0, cap)
    pos = _slot_positions(x.shape[1], cap, ring, a, b, x.device)
    at = pos.clamp(min=0)
    k, v = _kv_rows(cfg, params, x[:, at], heads_split, tp)
    if cfg.qk_norm:
        k = rms_norm(k, params.k_norm, cfg.rms_eps)
    k = apply_rope(k, at[None, :], _rope_base(cfg, kind))
    keep = (pos >= 0)[None, :, None, None]
    return {"k": torch.where(keep, k, 0).to(dtype),
            "v": torch.where(keep, v, 0).to(dtype)}


def cross_cache(cfg: ModelConfig, params: Attention, enc_out: torch.Tensor,
                dist=None, dtype=torch.bfloat16):
    """Whisper's cross keys and values (B, S_enc, KV, hd) of the encoder
    output, whole on every rank; with a cache layout (``dist.cache``) this
    rank's part of them."""
    layout = dist.cache if dist is not None else None
    n = enc_out.shape[1]
    if layout is None:
        return tuple(t.to(dtype) for t in _kv_rows(cfg, params, enc_out,
                                                   False, None))
    seq = layout.seq(n)
    a, b = seq.block(n) if seq is not None else (0, n)
    k, v = _kv_rows(cfg, params, enc_out[:, a:b],
                    dist.tp is not None and layout.kv_split, dist.tp)
    return k.to(dtype), v.to(dtype)


def prefill_fill_cache(
    cfg: ModelConfig,
    kind: str,
    k: torch.Tensor,
    v: torch.Tensor,
    cache_len: int,
    dtype=torch.bfloat16,
) -> Dict:
    """Build a cache from full-sequence K/V (post-RoPE) after prefill."""
    B, S = k.shape[0], k.shape[1]
    dev = k.device
    cap = cache_len
    ring = kind == "local" and bool(cfg.window)
    if ring:
        cap = min(cfg.window, cache_len)
    ck = torch.zeros((B, cap) + tuple(k.shape[2:]), dtype=dtype, device=dev)
    cv = torch.zeros((B, cap) + tuple(v.shape[2:]), dtype=dtype, device=dev)
    if S >= cap:
        ks, vs = k[:, S - cap:S], v[:, S - cap:S]
        # ring layout: element at position p lives in slot p % cap
        if ring:
            slots = torch.arange(S - cap, S, device=dev) % cap
        else:
            slots = torch.arange(cap, device=dev)
        ck[:, slots] = ks.to(dtype)
        cv[:, slots] = vs.to(dtype)
    else:
        ck[:, :S] = k.to(dtype)
        cv[:, :S] = v.to(dtype)
    return {"k": ck, "v": cv}
