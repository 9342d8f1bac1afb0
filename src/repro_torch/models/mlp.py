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


def mlp(cfg: ModelConfig, params: MLP, x: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    act = activation(cfg.act)
    up = x @ params.w_up.to(dt)
    if cfg.mlp_gated:
        gate = act(x @ params.w_gate.to(dt))
        h = gate * up
    else:
        h = act(up)
    return h @ params.w_down.to(dt)
