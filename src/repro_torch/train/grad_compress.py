"""Int8 gradient compression with error feedback — the cross-node
reduction trick.

Where an all-reduce crosses a slow link (between hosts), quantizing the
gradient to int8 (per-tensor scale) cuts the wire traffic 4× against f32
and 2× against bf16.  The quantization residual is carried in an
error-feedback accumulator (Seide et al., 1-bit SGD lineage), which
restores convergence to near-exact.

Entry points:
  * :func:`quantize` / :func:`dequantize` — the codec (the reference's,
    bit for bit);
  * :func:`compressed_psum` — the quantized mean over a
    ``torch.distributed`` group: an all-reduce MAX of the local amax makes
    the scale common, an all-reduce SUM of the int32 payloads adds them
    exactly, and the sum is divided by the group's size (the reference's
    ``pmax`` / ``psum`` inside ``shard_map``);
  * :class:`ErrorFeedback` — stateful wrapper for the trainer.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch
import torch.distributed as dist

__all__ = ["quantize", "dequantize", "compressed_psum", "ErrorFeedback"]


def quantize(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8. Returns (q int8, scale f32 0-d)."""
    g32 = g.float()
    scale = torch.clamp(g32.abs().max(), min=1e-30) / 127.0
    q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compressed_psum(g: torch.Tensor, group=None) -> torch.Tensor:
    """Quantized all-reduce mean of ``g`` over ``group`` (the default
    group when None) of an initialized ``torch.distributed``.

    Scales are made common through an all-reduce MAX so the int payloads
    add exactly; the sum rides in int32 (no overflow for ≤ 2²³ ranks)."""
    g32 = g.float()
    amax = torch.clamp(g32.abs().max(), min=1e-30)
    dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    scale = amax / 127.0
    q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int32)
    dist.all_reduce(q, op=dist.ReduceOp.SUM, group=group)
    n = float(dist.get_world_size(group))
    return q.float() * scale / n  # mean, like pmean


class ErrorFeedback:
    """g_eff = Q(g + e);  e ← (g + e) − g_eff  (per-leaf state).
    ``params_like`` and the gradients are mappings name → tensor."""

    def __init__(self, params_like: Mapping[str, torch.Tensor]):
        self.e = {n: torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device)
                  for n, p in params_like.items()}

    def compress(self, grads: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        out = {}
        for n, g in grads.items():
            v = g.float() + self.e[n]
            q, s = quantize(v)
            deq = dequantize(q, s)
            out[n] = deq
            self.e[n] = v - deq
        return out
