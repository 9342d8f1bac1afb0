"""Hand-rolled optimizer stack: AdamW with decoupled weight decay,
global-norm clipping, and a linear-warmup + cosine-decay schedule.

The reference's is a pure pytree transform; the port's is the same
per-leaf f32 arithmetic, in the same order, applied **in place** under
``torch.no_grad()`` to the parameters and the moments, with every scalar
(schedule, clip scale, bias corrections) a 0-d f32 tensor on the
parameters' device, so a step never waits for the host.

Parameters are an ``nn.Module`` (its named parameters) or a flat mapping
name → tensor; the moments are mappings with the same names.

Weight decay follows the reference's *stacked* rank: the reference stacks
the units along a leading axis, so it decays a leaf iff that stacked leaf
has ``ndim >= 2`` — every unit's norm weights (``units::e0::ln1`` is
``(n_units, D)``) but not ``final_norm`` ``(D,)``.  The port keeps one
module per unit, so a ``units.<u>.`` / ``enc_units.<u>.`` leaf counts one
axis more than its own (:func:`stacked_rank`).
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, NamedTuple, Tuple

import torch
from torch import nn

from ..configs.base import TrainHParams

__all__ = ["OptState", "init_opt_state", "adamw_update", "lr_schedule",
           "global_norm"]

_STACKED = ("units.", "enc_units.")


class OptState(NamedTuple):
    step: torch.Tensor  # 0-d int32
    mu: Dict[str, torch.Tensor]  # first moment (f32, the parameters' names)
    nu: Dict[str, torch.Tensor]  # second moment


def _named(params) -> Dict[str, torch.Tensor]:
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def stacked_rank(name: str, p: torch.Tensor) -> int:
    """The rank the reference's leaf of ``name`` has: one more for a unit's
    leaf, which the reference stacks over the units."""
    return p.dim() + (1 if name.startswith(_STACKED) else 0)


def init_opt_state(params) -> OptState:
    named = _named(params)
    device = next(iter(named.values())).device if named else None
    zeros = {n: torch.zeros_like(p, dtype=torch.float32)
             for n, p in named.items()}
    return OptState(
        step=torch.zeros((), dtype=torch.int32, device=device),
        mu=zeros,
        nu={n: z.clone() for n, z in zeros.items()},
    )


def lr_schedule(hp: TrainHParams, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (a tensor), in f32."""
    s = torch.as_tensor(step).to(torch.float32)
    warm = hp.learning_rate * s / max(hp.warmup_steps, 1)
    prog = torch.clamp(
        (s - hp.warmup_steps) / max(hp.total_steps - hp.warmup_steps, 1), 0, 1
    )
    cos = hp.learning_rate * 0.5 * (1 + torch.cos(math.pi * prog))
    return torch.where(s < hp.warmup_steps, warm, cos)


def global_norm(tree) -> torch.Tensor:
    """sqrt(Σ leaves Σ x²) in f32; ``tree`` a mapping name → tensor (or a
    module's parameters)."""
    leaves = list(_named(tree).values())
    total = sum((l.float().square().sum() for l in leaves),
                torch.zeros((), dtype=torch.float32,
                            device=leaves[0].device if leaves else None))
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(
    hp: TrainHParams, params, grads: Mapping[str, torch.Tensor],
    state: OptState, grad_norm: "torch.Tensor | None" = None,
) -> Tuple[object, OptState, Dict[str, torch.Tensor]]:
    """One AdamW step, in place: the parameters and ``state``'s moments are
    updated where they are.  Returns ``(params, new_state, metrics)``:
    the same parameters, an ``OptState`` with the next step holding the
    same moment tensors, and ``{"lr", "grad_norm"}`` (0-d tensors).

    ``grad_norm`` is the global norm of the gradients when ``grads`` hold
    only this rank's shards of them (a sharded step computes it across the
    ranks); by default it is :func:`global_norm` of ``grads``."""
    named = _named(params)
    step = state.step + 1
    gnorm = (global_norm({n: grads[n] for n in named}) if grad_norm is None
             else grad_norm)
    scale = torch.clamp(hp.grad_clip / (gnorm + 1e-9), max=1.0)
    lr = lr_schedule(hp, step)
    b1, b2 = hp.beta1, hp.beta2
    s = step.to(torch.float32)
    bc1 = 1 - torch.pow(torch.full_like(s, b1), s)
    bc2 = 1 - torch.pow(torch.full_like(s, b2), s)

    for name, p in named.items():
        m, v = state.mu[name], state.nu[name]
        g = grads[name].float() * scale
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g.square())
        mhat = m / bc1
        vhat = v / bc2
        delta = mhat / (torch.sqrt(vhat) + hp.eps)
        if stacked_rank(name, p) >= 2:  # decay matrices only (standard)
            delta = delta + hp.weight_decay * p.float()
        p.copy_((p.float() - lr * delta).to(p.dtype))
    metrics = {"lr": lr, "grad_norm": gnorm}
    return params, OptState(step, state.mu, state.nu), metrics
