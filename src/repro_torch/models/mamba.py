"""Mamba-2 SSD (state-space duality) block.

The selective scan is computed in its *dual* chunked-matmul form
(arXiv 2405.21060 §6): within chunks of length Q the recurrence becomes
dense attention-like matmuls; across chunks a short loop passes the
(H, P, N) state.  Jamba's Mamba-1 layers also run through this block
(d_state 16 preserved), as in the reference package.

Block layout (mamba_ssm convention):
  in_proj: D → [z (d_inner), x (d_inner), B (G·N), C (G·N), dt (H)]
  causal depthwise conv (width 4) over the [x, B, C] channels
  SSD core, per-head RMS-norm gated by z, out_proj: d_inner → D.

Cache contract: :func:`mamba_decode` stores the new conv window and state in
``cache`` (the same dict) and returns it.  Under tensor parallelism
(``tp``) the caches are the rank's as they rest: ``state`` its block of
the heads, ``conv`` its block of the fused conv channels, which does not
follow the heads.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ModelConfig
from .common import normal_init, rms_norm

__all__ = ["Mamba2", "init_mamba", "mamba_train", "mamba_decode",
           "init_mamba_cache", "ssd_chunked"]


def _dims(cfg: ModelConfig):
    d_in = cfg.d_inner
    H = cfg.ssm_n_heads
    P = cfg.ssm_head_dim
    N = cfg.ssm_d_state
    G = cfg.ssm_n_groups
    conv_ch = d_in + 2 * G * N
    return d_in, H, P, N, G, conv_ch


class Mamba2(nn.Module):
    """The mixer's parameters, named as in the reference."""

    def __init__(self, cfg: ModelConfig, generator=None, device=None):
        super().__init__()
        pd = getattr(torch, cfg.param_dtype)
        d_in, H, P, N, G, conv_ch = _dims(cfg)
        proj_out = 2 * d_in + 2 * G * N + H

        def init(shape):
            return nn.Parameter(normal_init(generator, shape, dtype=pd,
                                      device=device))

        def const(n, value):
            return nn.Parameter(torch.full((n,), value, dtype=pd, device=device))

        self.in_proj = init((cfg.d_model, proj_out))
        self.conv_w = init((cfg.conv_width, conv_ch))
        self.conv_b = const(conv_ch, 0.0)
        self.A_log = const(H, 0.0)  # A = -exp(A_log) ∈ (-∞, 0)
        self.D = const(H, 1.0)
        self.dt_bias = const(H, 0.0)
        self.norm_w = const(d_in, 0.0)
        self.out_proj = init((d_in, cfg.d_model))


def init_mamba(cfg: ModelConfig, generator=None, device=None) -> Mamba2:
    return Mamba2(cfg, generator, device)


def _head_block(cfg: ModelConfig, params: Mamba2, tp):
    """This rank's block of the mixer's heads under tensor parallelism
    (``tp``): the weights all-gathered over ``model`` (the fused columns of
    ``in_proj`` and the conv's channels do not follow the heads), cut to
    the rank's heads (their z, x and dt columns and x channels).  B and C
    are read by every head of a group, so the rank projects and convolves
    its block of their 2·G·N columns, as the reference's spec splits the
    fused columns (a rank projects 2·d_inner / ranks + 2·G·N / ranks +
    H / ranks columns), and ``gather_bc`` all-gathers the blocks and cuts
    the groups its heads read.  Returns (weights, d_inner, heads, groups,
    gather_bc) of the block."""
    from ..sharding.parallel import Leaves

    d_in, H, P, N, G, conv_ch = _dims(cfg)
    dims = {"in_proj": (1, 2 * d_in + 2 * G * N + H), "conv_w": (1, conv_ch),
            "conv_b": (0, conv_ch), "A_log": (0, H), "D": (0, H),
            "dt_bias": (0, H), "norm_w": (0, d_in), "out_proj": (0, d_in)}
    w = {name: tp.full(getattr(params, name), dim, n)
         for name, (dim, n) in dims.items()}
    h0, h1 = tp.block(H)
    g0, g1 = h0 * G // H, (h1 - 1) * G // H + 1
    if (h1 - h0) % (g1 - g0):
        raise ValueError(f"{h1 - h0} heads over {g1 - g0} groups")
    if (2 * G * N) % tp.size:
        raise ValueError(f"{2 * G * N} B / C columns do not divide "
                         f"{tp.size} ranks")
    dev = w["in_proj"].device

    def span(a, b):
        return torch.arange(a, b, device=dev)

    xs, bc = span(h0 * P, h1 * P), span(*tp.block(2 * G * N))

    def gather_bc(t):
        whole = tp.full(t, -1, 2 * G * N)
        if (g0, g1) == (0, G):
            return whole
        return torch.cat([whole[..., g0 * N:g1 * N],
                          whole[..., (G + g0) * N:(G + g1) * N]], dim=-1)

    proj = torch.cat([xs, d_in + xs, 2 * d_in + bc,
                      2 * d_in + 2 * G * N + span(h0, h1)])
    conv = torch.cat([xs, d_in + bc])
    block = Leaves({
        "in_proj": w["in_proj"][:, proj], "conv_w": w["conv_w"][:, conv],
        "conv_b": w["conv_b"][conv], "A_log": w["A_log"][h0:h1],
        "D": w["D"][h0:h1], "dt_bias": w["dt_bias"][h0:h1],
        "norm_w": w["norm_w"][h0 * P:h1 * P],
        "out_proj": w["out_proj"][h0 * P:h1 * P]})
    return block, (h1 - h0) * P, h1 - h0, g1 - g0, gather_bc


def init_mamba_cache(cfg: ModelConfig, batch: int, dtype=torch.float32,
                     device=None) -> Dict:
    d_in, H, P, N, G, conv_ch = _dims(cfg)
    return {
        "conv": torch.zeros((batch, cfg.conv_width - 1, conv_ch), dtype=dtype,
                            device=device),
        "state": torch.zeros((batch, H, P, N), dtype=dtype, device=device),
    }


def _split_proj(cfg: ModelConfig, proj: torch.Tensor):
    d_in, H, P, N, G, _ = _dims(cfg)
    return torch.split(proj, [d_in, d_in + 2 * G * N, H], dim=-1)


def _causal_conv(xBC: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv along time. xBC (B, L, C); w (W, C)."""
    W = w.shape[0]
    L = xBC.shape[1]
    pad = F.pad(xBC, (0, 0, W - 1, 0))
    out = torch.zeros_like(xBC)
    for i in range(W):  # width is 4 — unrolled taps
        out = out + pad[:, i:i + L] * w[i]
    return F.silu(out + b)


def _segsum(dA: torch.Tensor) -> torch.Tensor:
    """Lower-triangular pairwise cumulative sums: out[..., i, j] =
    Σ_{k=j+1..i} dA[..., k] for i ≥ j, -inf above the diagonal."""
    Q = dA.shape[-1]
    cs = torch.cumsum(dA, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    i = torch.arange(Q, device=dA.device)
    mask = i[:, None] >= i[None, :]
    return diff.masked_fill(~mask, float("-inf"))


def ssd_chunked(
    x: torch.Tensor,  # (B, L, H, P)
    dt: torch.Tensor,  # (B, L, H) — post-softplus
    A: torch.Tensor,  # (H,) negative
    Bm: torch.Tensor,  # (B, L, G, N)
    Cm: torch.Tensor,  # (B, L, G, N)
    chunk: int,
    init_state: Optional[torch.Tensor] = None,  # (B, H, P, N)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B, L, H, P), final_state (B, H, P, N)), both f32."""
    Bsz, L, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    Q = min(chunk, L)
    pad = (-L) % Q
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, 0, 0, pad))
    nc = (L + pad) // Q

    f32 = torch.float32
    xc = x.reshape(Bsz, nc, Q, H, P)
    dtc = dt.reshape(Bsz, nc, Q, H).to(f32)
    Bc = torch.repeat_interleave(Bm.reshape(Bsz, nc, Q, G, N), rep, dim=3).to(f32)
    Cc = torch.repeat_interleave(Cm.reshape(Bsz, nc, Q, G, N), rep, dim=3).to(f32)

    dA = dtc * A.to(f32)  # (B, c, Q, H)
    dA_cs = torch.cumsum(dA, dim=2)  # within-chunk cumsum

    # ---- intra-chunk (block-diagonal) term --------------------------------
    Lmat = torch.exp(_segsum(dA.permute(0, 1, 3, 2)))  # (B, c, H, Q, Q)
    CB = torch.einsum("bcqhn,bckhn->bchqk", Cc, Bc)
    xdt = xc.to(f32) * dtc[..., None]  # (B,c,Q,H,P)
    y_diag = torch.einsum("bchqk,bckhp->bcqhp", CB * Lmat, xdt)

    # ---- chunk states -------------------------------------------------------
    decay_tail = torch.exp(dA_cs[:, :, -1:, :] - dA_cs)  # (B,c,Q,H)
    S_chunk = torch.einsum(
        "bcqhn,bcqh,bcqhp->bchpn", Bc, decay_tail, xdt
    )
    chunk_decay = torch.exp(dA_cs[:, :, -1, :])  # (B, c, H)

    # ---- inter-chunk recurrence (short loop over nc) -----------------------
    state = (
        init_state.to(f32)
        if init_state is not None
        else torch.zeros((Bsz, H, P, N), dtype=f32, device=x.device)
    )
    S_in = []
    for c in range(nc):
        S_in.append(state)  # the state *entering* this chunk
        state = S_chunk[:, c] + chunk_decay[:, c, :, None, None] * state
    S_in = torch.stack(S_in, dim=1)  # (B, c, H, P, N)

    # ---- inter-chunk output term ---------------------------------------------
    state_decay = torch.exp(dA_cs)  # (B,c,Q,H)
    y_off = torch.einsum(
        "bcqhn,bchpn,bcqh->bcqhp", Cc, S_in, state_decay
    )

    y = (y_diag + y_off).reshape(Bsz, nc * Q, H, P)[:, :L]
    return y, state


def mamba_train(
    cfg: ModelConfig,
    params: Mamba2,
    x: torch.Tensor,
    *,
    return_cache: bool = False,
    tp=None,
) -> Union[torch.Tensor, Tuple[torch.Tensor, Dict]]:
    """Full-sequence SSD forward. x: (B, L, D).  Under tensor parallelism
    (``tp``) this rank computes its block of the heads (:func:`_head_block`)
    on the whole sequence, B and C from the ranks' blocks of their columns
    all-gathered: the gated norm's mean square is all-reduced over
    ``model`` and the output is the rank's partial sum; the cache is the
    rank's (its heads' state, its block of the conv channels)."""
    Bsz, L, D = x.shape
    d_in, H, P, N, G, conv_ch = _dims(cfg)
    d_inner = d_in
    in_proj, proj_out = params.in_proj, 2 * d_in + 2 * G * N + H
    gather_bc = None
    if tp is not None:
        if return_cache and H % tp.size:
            raise ValueError(f"{H} heads do not divide {tp.size} ranks: "
                             "the state cache would be whole")
        params, d_in, H, G, gather_bc = _head_block(cfg, params, tp)
    dt_ = x.dtype

    proj = x @ params.in_proj.to(dt_)
    z, xBC, dt_raw = torch.split(proj, [d_in, proj.shape[-1] - d_in - H, H],
                                 dim=-1)
    xBC = _causal_conv(xBC, params.conv_w.to(dt_), params.conv_b.to(dt_))
    xs, BC = torch.split(xBC, [d_in, xBC.shape[-1] - d_in], dim=-1)
    if gather_bc is not None:
        BC = gather_bc(BC)
    Bm, Cm = torch.split(BC, [G * N, G * N], dim=-1)
    xs = xs.reshape(Bsz, L, H, P)
    Bm = Bm.reshape(Bsz, L, G, N)
    Cm = Cm.reshape(Bsz, L, G, N)
    dt = F.softplus(dt_raw.float() + params.dt_bias.float())
    A = -torch.exp(params.A_log.float())

    y, last_state = ssd_chunked(xs, dt, A, Bm, Cm, cfg.ssm_chunk)
    y = y + xs.float() * params.D.float()[None, None, :, None]
    y = y.reshape(Bsz, L, d_in).to(dt_)
    if tp is None:
        y = rms_norm(y * F.silu(z), params.norm_w, cfg.rms_eps)
    else:
        y = _rms_norm_tp(y * F.silu(z), params.norm_w, cfg.rms_eps, tp,
                         d_inner)
    out = y @ params.out_proj.to(dt_)
    if return_cache:
        # conv cache holds the *pre-conv* channel inputs of the last
        # (width-1) steps, taken from the pre-conv projection:
        tail = slice(max(0, L - (cfg.conv_width - 1)), L)
        if tp is None:
            proj_tail = proj[:, tail]
        else:  # every channel of the tail, then the rank's block
            proj_tail = tp.full(x[:, tail] @ in_proj.to(dt_), -1, proj_out)
        _, xBC_tail, _ = _split_proj(cfg, proj_tail)
        if tp is not None and conv_ch % tp.size == 0:
            xBC_tail = tp.cols(xBC_tail, -1, conv_ch)
        pad_t = cfg.conv_width - 1 - xBC_tail.shape[1]
        if pad_t:
            xBC_tail = F.pad(xBC_tail, (0, 0, pad_t, 0))
        cache = {"conv": xBC_tail.float(), "state": last_state}
        return out, cache
    return out


def _rms_norm_tp(x, weight, eps: float, tp, n: int) -> torch.Tensor:
    """:func:`rms_norm` of a tensor whose last dimension (``n`` whole) is
    split over ``model``: the sum of squares all-reduced."""
    dt = x.dtype
    x = x.float()
    var = tp.reduce(x.square().sum(dim=-1, keepdim=True)) / n
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + weight.float())).to(dt)


def mamba_decode(
    cfg: ModelConfig, params: Mamba2, x: torch.Tensor, cache: Dict, tp=None
) -> Tuple[torch.Tensor, Dict]:
    """Single-token recurrent step. x: (B, 1, D) — O(1) in context length.
    Under tensor parallelism (``tp``) on the rank's caches and weights
    (:func:`_decode_tp`)."""
    if tp is not None:
        return _decode_tp(cfg, params, x, cache, tp)
    Bsz = x.shape[0]
    d_in, H, P, N, G, conv_ch = _dims(cfg)
    dt_ = x.dtype

    proj = x[:, 0] @ params.in_proj.to(dt_)  # (B, proj_out)
    z, xBC_new, dt_raw = _split_proj(cfg, proj)

    # conv ring: window = [cache, new]
    conv = cache["conv"]
    win = torch.cat([conv, xBC_new[:, None].to(conv.dtype)], dim=1)  # (B, W, C)
    conv_out = torch.einsum("bwc,wc->bc", win, params.conv_w.to(win.dtype))
    xBC = F.silu(conv_out + params.conv_b.to(win.dtype))
    new_conv = win[:, 1:]

    xs, Bm, Cm = torch.split(xBC, [d_in, G * N, G * N], dim=-1)
    xs = xs.reshape(Bsz, H, P).float()
    rep = H // G
    Bm = torch.repeat_interleave(Bm.reshape(Bsz, G, N), rep, dim=1).float()
    Cm = torch.repeat_interleave(Cm.reshape(Bsz, G, N), rep, dim=1).float()
    dt = F.softplus(dt_raw.float() + params.dt_bias.float())  # (B, H)
    A = -torch.exp(params.A_log.float())
    decay = torch.exp(dt * A)  # (B, H)

    # S' = decay·S + dt·x ⊗ B ;  y = (S'·C) + D·x
    state = cache["state"] * decay[..., None, None] + torch.einsum(
        "bhp,bhn,bh->bhpn", xs, Bm, dt
    )
    y = torch.einsum("bhpn,bhn->bhp", state, Cm)
    y = y + xs * params.D.float()[None, :, None]
    y = y.reshape(Bsz, d_in).to(dt_)
    y = rms_norm(y * F.silu(z), params.norm_w, cfg.rms_eps)
    out = (y @ params.out_proj.to(dt_))[:, None]
    cache["conv"] = new_conv
    cache["state"] = state
    return out, cache


def _decode_tp(cfg: ModelConfig, params: Mamba2, x: torch.Tensor, cache: Dict,
               tp) -> Tuple[torch.Tensor, Dict]:
    """:func:`mamba_decode` on this rank's shards: the token's projection
    from the rank's columns of ``in_proj``, all-gathered (``x`` is whole on
    every rank, so the blocks make the whole row); the conv on the rank's
    block of the channels against its window, the block all-gathered; the
    state update, the gated norm (mean square all-reduced) and the rows of
    ``out_proj`` for the rank's heads (the heads must divide the ranks, as
    ``cache_shardings`` then splits the state).  The caches keep the
    rank's blocks; the output is its partial sum."""
    Bsz = x.shape[0]
    d_in, H, P, N, G, conv_ch = _dims(cfg)
    dt_ = x.dtype

    proj = tp.full(x[:, 0] @ params.in_proj.to(dt_), -1,
                   2 * d_in + 2 * G * N + H)
    z, xBC_new, dt_raw = _split_proj(cfg, proj)

    conv = cache["conv"]
    c0, c1 = (tp.block(conv_ch) if conv.shape[-1] != conv_ch
              else (0, conv_ch))
    win = torch.cat([conv, xBC_new[:, None, c0:c1].to(conv.dtype)], dim=1)
    conv_out = torch.einsum("bwc,wc->bc", win, params.conv_w.to(win.dtype))
    xBC = tp.full(F.silu(conv_out + params.conv_b.to(win.dtype)), -1,
                  conv_ch)

    if H % tp.size:
        raise ValueError(f"{H} heads do not divide {tp.size} ranks")
    h0, h1 = tp.block(H)  # the rank's block of the state's heads
    xs, Bm, Cm = torch.split(xBC, [d_in, G * N, G * N], dim=-1)
    xs = xs.reshape(Bsz, H, P)[:, h0:h1].float()
    rep = H // G
    Bm = torch.repeat_interleave(Bm.reshape(Bsz, G, N), rep, dim=1)[:, h0:h1].float()
    Cm = torch.repeat_interleave(Cm.reshape(Bsz, G, N), rep, dim=1)[:, h0:h1].float()
    dt = F.softplus(dt_raw[:, h0:h1].float() + params.dt_bias.float())
    A = -torch.exp(params.A_log.float())
    decay = torch.exp(dt * A)

    state = cache["state"] * decay[..., None, None] + torch.einsum(
        "bhp,bhn,bh->bhpn", xs, Bm, dt
    )
    y = torch.einsum("bhpn,bhn->bhp", state, Cm)
    y = y + xs * params.D.float()[None, :, None]
    y = y.reshape(Bsz, (h1 - h0) * P).to(dt_) * F.silu(z[:, h0 * P:h1 * P])
    y = _rms_norm_tp(y, params.norm_w, cfg.rms_eps, tp, d_in)
    out = y @ params.out_proj.to(dt_)
    cache["conv"] = win[:, 1:]
    cache["state"] = state
    return out[:, None], cache
