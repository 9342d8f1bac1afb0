"""Shared model components: norms, RoPE, activations, losses, init, and the
products whose output stays f32."""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

__all__ = [
    "rms_norm",
    "apply_rope",
    "rope_angles",
    "softcap",
    "activation",
    "sinusoidal_positions",
    "chunked_cross_entropy",
    "normal_init",
    "matmul_f32",
]


def normal_init(generator: Optional[torch.Generator], shape, scale: float = 0.02,
                dtype=torch.float32, device=None) -> torch.Tensor:
    """``scale · N(0, 1)`` drawn from ``generator`` (an explicit
    :class:`torch.Generator` on ``device``).  On the ``meta`` device nothing
    is drawn: the tensor only has a shape, for counting."""
    device = torch.device(device if device is not None else "cpu")
    if device.type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    x = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=device)
    x.mul_(scale)
    return x if dtype == torch.float32 else x.to(dtype)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in f32, gemma-style (1 + w) scaling with zeros-init weight."""
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + weight.float())).to(dt)


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    """Logit soft-capping: cap * tanh(x / cap) (gemma2)."""
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def activation(name: str):
    if name == "silu":
        return F.silu
    if name == "gelu":
        return _gelu_tanh
    raise ValueError(name)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_angles(positions: torch.Tensor, head_dim: int, base: float) -> torch.Tensor:
    """(…, head_dim/2) angles for given integer positions."""
    dev = positions.device
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=dev) / head_dim
    # the f32 base is filled on the device: a host tensor copied over would
    # synchronize the stream at every call
    base_f32 = torch.full((), base, dtype=torch.float32, device=dev)
    inv_freq = 1.0 / torch.pow(base_f32, exps)
    return positions.float()[..., None] * inv_freq


def apply_rope(x: torch.Tensor, positions: torch.Tensor, base: float) -> torch.Tensor:
    """x: (..., S, H, head_dim); positions: (..., S). Pairs split as
    [first half, second half] (HF convention)."""
    if base <= 0:  # architecture without RoPE (whisper/jamba)
        return x
    hd = x.shape[-1]
    ang = rope_angles(positions, hd, base)  # (..., S, hd/2)
    sin = torch.sin(ang)[..., None, :]  # broadcast over heads
    cos = torch.cos(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(length: int, dim: int) -> np.ndarray:
    """Whisper-style sinusoidal embedding table (length, dim)."""
    log_timescale = np.log(10_000.0) / (dim // 2 - 1)
    inv = np.exp(-log_timescale * np.arange(dim // 2))
    scaled = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(scaled), np.cos(scaled)], axis=1).astype(
        np.float32
    )


def sinusoidal_at(pos: torch.Tensor, dim: int) -> torch.Tensor:
    """The sinusoidal embedding at dynamic positions ``pos`` ((B,) or (1,)),
    computed in f32 on ``pos``'s device (the decode step's position)."""
    half = dim // 2
    inv = torch.exp(
        -math.log(10_000.0) / (half - 1)
        * torch.arange(half, dtype=torch.float32, device=pos.device)
    )
    ang = pos.float()[:, None] * inv[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------------
# Products with an f32 output
# ---------------------------------------------------------------------------


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The bf16-in / f32-out GEMM of 2-D or batched 3-D operands (cuBLAS's
    ``out_dtype``): on the card, and on ``meta`` for the dry run's count."""
    if a.dim() == 2:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.bmm(a, b, out_dtype=torch.float32)


class _MatmulF32(torch.autograd.Function):
    """``a @ b`` of bf16 operands with an f32 result, and its gradient.

    cuBLAS's ``out_dtype`` GEMM has no derivative in PyTorch, so the
    backward is written here with the same products: the f32 cotangent is
    rounded to the operands' dtype, multiplied by the other operand with an
    f32 result, and the operand's gradient rounded to its dtype.  The
    reference's ``jax.grad`` of its ``preferred_element_type=float32``
    einsum multiplies the f32 cotangent itself (tests/test_torch_train_loss
    holds the two apart on the host, the card run in ``chip_smoke.py``)."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _mm_f32(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.to(a.dtype)
        da = db = None
        if ctx.needs_input_grad[0]:
            da = _mm_f32(g, b.transpose(-1, -2)).to(a.dtype)
        if ctx.needs_input_grad[1]:
            db = _mm_f32(a.transpose(-1, -2), g).to(b.dtype)
        return da, db


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with an f32 result, for 2-D or batched 3-D operands: the
    reference's ``preferred_element_type=float32`` (products of the operands'
    values, summed in f32).  f32 operands multiply as they are; bf16
    operands on the card go through cuBLAS's bf16-in / f32-out GEMM
    (``out_dtype``), so a weight is never upcast, with the gradient of
    :class:`_MatmulF32`, and so do they on ``meta``, where the dry run
    counts what the card runs; elsewhere the operands are upcast, which
    gives the same products (a bf16 × bf16 product is exact in f32) and
    autograd's gradient, the reference's."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return a @ b
    if (a.is_cuda or a.is_meta) and a.dtype == b.dtype == torch.bfloat16:
        return _MatmulF32.apply(a, b)
    return a.float() @ b.float()


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------


def _chunk_nll(hc, w_vocab, lc, mc, final_softcap):
    """One chunk's summed masked NLL: hc (B, c, D), w_vocab (V, D), lc / mc
    (B, c)."""
    B, c, D = hc.shape
    logits = matmul_f32(hc.reshape(B * c, D), w_vocab.t()).reshape(B, c, -1)
    logits = softcap(logits, final_softcap)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, lc[..., None]).squeeze(-1)
    return ((lse - ll) * mc).sum()


def _chunk_nll_tp(hc, rows, lc, mc, v0, tp, final_softcap):
    """:func:`_chunk_nll` against this rank's vocabulary rows ``rows``
    (token ids ``v0`` onwards) under tensor parallelism (``tp``): the max
    and the sum of exponentials all-reduced over ``model``, the label's
    logit from the rank that holds it."""
    B, c, D = hc.shape
    logits = matmul_f32(hc.reshape(B * c, D), rows.t()).reshape(B, c, -1)
    logits = softcap(logits, final_softcap)
    top = tp.max(logits.detach().amax(dim=-1))
    lse = top + torch.log(tp.reduce(torch.exp(logits - top[..., None]).sum(-1)))
    idx = lc - v0
    mine = (idx >= 0) & (idx < logits.shape[-1])
    ll = torch.gather(logits, -1, idx.clamp(0, logits.shape[-1] - 1)[..., None])
    ll = tp.reduce(torch.where(mine, ll.squeeze(-1), 0.0))
    return ((lse - ll) * mc).sum()


def chunked_cross_entropy(
    h: torch.Tensor,
    w_vocab: torch.Tensor,
    labels: torch.Tensor,
    *,
    chunk: int = 512,
    final_softcap: Optional[float] = None,
    label_mask: Optional[torch.Tensor] = None,
    tp=None,
    v0: int = 0,
) -> torch.Tensor:
    """Mean NLL with the (B, S, V) logits never materialized for full S.

    ``h`` (B, S, D); ``w_vocab`` (V, D); ``labels`` (B, S) integer.  Loops
    over sequence chunks: per step the logits tensor is (B, chunk, V), and
    each chunk runs under ``torch.utils.checkpoint`` (non-reentrant), so the
    backward recomputes its logits: the (B, S, V) tensor never exists,
    neither forward nor as saved tensors (the reference's
    ``jax.checkpoint`` on its scan body).  The last chunk is padded with
    masked positions, as the reference pads it.

    Under tensor parallelism (``tp``) ``h`` is whole on every rank of
    ``model`` and ``w_vocab`` is this rank's rows of the vocabulary
    matrix, from token id ``v0`` (:func:`_chunk_nll_tp`); the mean NLL is
    every rank's.
    """
    B, S, D = h.shape
    c = min(chunk, S)
    pad = (-S) % c
    lm = (torch.ones((B, S), dtype=torch.float32, device=h.device)
          if label_mask is None else label_mask.float())
    labels = labels.long()
    if pad:
        h = F.pad(h, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad))
        lm = F.pad(lm, (0, pad))
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    denom = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(0, S + pad, c):
        hc, lc, mc = h[:, i:i + c], labels[:, i:i + c], lm[:, i:i + c]
        if tp is None:
            nll = checkpoint(_chunk_nll, hc, w_vocab, lc, mc, final_softcap,
                             use_reentrant=False)
        else:
            nll = checkpoint(_chunk_nll_tp, hc, w_vocab, lc, mc, v0, tp,
                             final_softcap, use_reentrant=False)
        total = total + nll
        denom = denom + mc.sum()
    return total / torch.clamp(denom, min=1.0)
