"""The reference's weights and optimizer state carried across, both ways.

The reference keeps a model's parameters as a pytree of nested dicts whose
``units`` / ``enc_units`` leaves are stacked ``(n_units, …)``; the port
keeps one module per unit, so a port name such as ``units.3.e0.attn.wq``
is unit 3 of the reference's ``units/e0/attn/wq``.  The port keeps the
reference's fused layouts (``wq`` (D, H·hd), ``wk`` / ``wv`` (D, KV·hd),
``wo`` (H·hd, D), MoE weights (E, D, F)), so the conversion is an
(un)stack with no transposes.

* :func:`params_from_reference` — the reference's pytree (nested dicts of
  numpy arrays: ``jax.tree.map(np.asarray, params)`` on the caller's side)
  → the port's :class:`DecoderLM`;
* :func:`params_to_reference` — the port's model → that pytree;
* :func:`opt_state_from_reference` / :func:`opt_state_to_reference` — the
  optimizer state ``(step, mu, nu)``, whose moments are trees of the
  parameters' structure (the reference's ``OptState``);
* :func:`tree_from_named` / :func:`named_from_tree` — the (un)stacking of
  any such tree, e.g. a checkpoint template of ``meta`` tensors.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from ..configs.base import ModelConfig
from .model import DecoderLM

__all__ = [
    "params_from_reference", "params_to_reference", "opt_state_from_reference",
    "opt_state_to_reference", "tree_from_named", "named_from_tree",
]

_STACKED = ("units", "enc_units")


def _leaf(tree: Dict, name: str) -> np.ndarray:
    parts = name.split(".")
    unit = None
    if parts[0] in _STACKED:
        unit = int(parts[1])
        parts = [parts[0]] + parts[2:]
    node = tree
    for part in parts:
        node = node[part]
    arr = np.asarray(node)
    return arr[unit] if unit is not None else arr


def _count_leaves(tree) -> int:
    if isinstance(tree, dict):
        return sum(_count_leaves(v) for v in tree.values())
    return 1


def _n_stacked(cfg: ModelConfig, key: str) -> int:
    return cfg.n_units if key == "units" else cfg.n_enc_layers


def _names(cfg: ModelConfig):
    return [n for n, _ in DecoderLM(cfg, None, "meta").named_parameters()]


def named_from_tree(cfg: ModelConfig, tree: Dict) -> Dict[str, np.ndarray]:
    """The port's flat names → arrays of the reference's stacked tree
    (every leaf used once, every unit taken)."""
    names = _names(cfg)
    out = {n: _leaf(tree, n) for n in names}
    stacked = sum(_count_leaves(tree[k]) * _n_stacked(cfg, k)
                  for k in _STACKED if k in tree)
    total = stacked + sum(_count_leaves(v) for k, v in tree.items()
                          if k not in _STACKED)
    if len(out) != total:
        raise ValueError(f"port model has {len(out)} parameters, the "
                         f"reference tree {total} leaves")
    return out


def tree_from_named(cfg: ModelConfig, named: Mapping) -> Dict:
    """The reference's nested tree from the port's flat names: a stacked
    unit leaf is ``torch.stack`` (tensors, any device, ``meta`` included)
    or ``np.stack`` of the units' leaves, in unit order."""
    tree: Dict = {}
    stacks: Dict = {}
    for name in _names(cfg):
        parts = name.split(".")
        if parts[0] in _STACKED:
            key = (parts[0],) + tuple(parts[2:])
            stacks.setdefault(key, []).append(named[name])
        else:
            _put(tree, tuple(parts), named[name])
    for key, leaves in stacks.items():
        if len(leaves) != _n_stacked(cfg, key[0]):
            raise ValueError(f"{'/'.join(key)}: {len(leaves)} units")
        stack = torch.stack if isinstance(leaves[0], torch.Tensor) else np.stack
        _put(tree, key, stack(leaves))
    return tree


def _put(tree: Dict, path, value) -> None:
    for part in path[:-1]:
        tree = tree.setdefault(part, {})
    tree[path[-1]] = value


def params_from_reference(cfg: ModelConfig, tree: Dict,
                          device="cpu") -> DecoderLM:
    """The port's model with the values of the reference's pytree ``tree``
    (every leaf used once, every shape checked)."""
    arrays = named_from_tree(cfg, tree)
    model = DecoderLM(cfg, None, "meta").to_empty(device=device)
    with torch.no_grad():
        for name, p in model.named_parameters():
            arr = arrays[name]
            if tuple(arr.shape) != tuple(p.shape):
                raise ValueError(
                    f"{name}: reference shape {arr.shape} != port {tuple(p.shape)}")
            p.copy_(torch.tensor(arr, dtype=p.dtype))
    return model


def _host(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t`` (never a view of a tensor that the trainer
    updates in place)."""
    return t.detach().to("cpu", copy=True).numpy()


def params_to_reference(cfg: ModelConfig, params: DecoderLM) -> Dict:
    """The reference's pytree (numpy, units stacked) of the port's model."""
    return tree_from_named(
        cfg, {n: _host(p) for n, p in params.named_parameters()})


def opt_state_to_reference(cfg: ModelConfig, opt):
    """The port's ``OptState`` as the same named tuple holding the
    reference's structure: ``step`` an int32 0-d array, ``mu`` / ``nu``
    stacked trees."""
    return type(opt)(
        np.asarray(_host(opt.step), dtype=np.int32),
        tree_from_named(cfg, {n: _host(t) for n, t in opt.mu.items()}),
        tree_from_named(cfg, {n: _host(t) for n, t in opt.nu.items()}),
    )


def opt_state_from_reference(cfg: ModelConfig, opt, device="cpu"):
    """The reference's ``OptState`` (or any ``(step, mu, nu)``) → the
    port's, on ``device``."""
    from ..train.optimizer import OptState

    step, mu, nu = opt

    def moments(tree):
        return {n: torch.tensor(a, dtype=torch.float32, device=device)
                for n, a in named_from_tree(cfg, tree).items()}

    return OptState(
        torch.tensor(int(np.asarray(step)), dtype=torch.int32, device=device),
        moments(mu), moments(nu))
