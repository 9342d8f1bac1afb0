"""Dense MLP blocks: gated (llama/gemma-style) and plain (starcoder/whisper)."""

from __future__ import annotations

import torch
from torch import nn

from ..configs.base import ModelConfig
from .common import activation, normal_init

__all__ = ["MLP", "init_mlp", "mlp"]


class MLP(nn.Module):
    """w_up (D, F), w_down (F, D) and, when gated, w_gate (D, F)."""

    def __init__(self, cfg: ModelConfig, generator=None, device=None):
        super().__init__()
        d_ff = cfg.d_ff
        pd = getattr(torch, cfg.param_dtype)

        def init(shape):
            return nn.Parameter(normal_init(generator, shape, dtype=pd,
                                      device=device))

        self.w_up = init((cfg.d_model, d_ff))
        self.w_down = init((d_ff, cfg.d_model))
        if cfg.mlp_gated:
            self.w_gate = init((cfg.d_model, d_ff))


def init_mlp(cfg: ModelConfig, generator=None, device=None) -> MLP:
    return MLP(cfg, generator, device)


def mlp(cfg: ModelConfig, params: MLP, x: torch.Tensor, tp=None) -> torch.Tensor:
    """The block's output; under tensor parallelism (``tp``) this rank's
    block of F (``w_up`` / ``w_gate`` column-parallel, ``w_down``
    row-parallel), whose output is a partial sum."""
    dt = x.dtype
    act = activation(cfg.act)

    def w(name, dim):
        t = getattr(params, name)
        return (t if tp is None else tp.cols(t, dim, cfg.d_ff)).to(dt)

    up = x @ w("w_up", 1)
    if cfg.mlp_gated:
        gate = act(x @ w("w_gate", 1))
        h = gate * up
    else:
        h = act(up)
    return h @ w("w_down", 0)
