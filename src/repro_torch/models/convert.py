"""The reference's weights carried across.

:func:`params_from_reference` takes the JAX package's parameter pytree as
nested dicts of numpy arrays (``jax.tree.map(np.asarray, params)`` on the
caller's side), whose ``units`` / ``enc_units`` leaves are stacked
``(n_units, …)``, and returns the port's :class:`DecoderLM` holding exactly
those values.  The port keeps the reference's fused layouts (``wq`` (D,
H·hd), ``wk`` / ``wv`` (D, KV·hd), ``wo`` (H·hd, D), MoE weights (E, D, F)),
so the conversion is an unstack with no transposes.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..configs.base import ModelConfig
from .model import DecoderLM

__all__ = ["params_from_reference"]

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


def params_from_reference(cfg: ModelConfig, tree: Dict,
                          device="cpu") -> DecoderLM:
    """The port's model with the values of the reference's pytree ``tree``
    (every leaf used once, every shape checked)."""
    model = DecoderLM(cfg, None, "meta").to_empty(device=device)
    used = 0
    with torch.no_grad():
        for name, p in model.named_parameters():
            arr = _leaf(tree, name)
            if tuple(arr.shape) != tuple(p.shape):
                raise ValueError(
                    f"{name}: reference shape {arr.shape} != port {tuple(p.shape)}")
            p.copy_(torch.tensor(arr, dtype=p.dtype))
            used += 1
    stacked = sum(
        _count_leaves(tree[k]) * (cfg.n_units if k == "units" else cfg.n_enc_layers)
        for k in _STACKED if k in tree
    )
    total = stacked + sum(_count_leaves(v) for k, v in tree.items()
                          if k not in _STACKED)
    if used != total:
        raise ValueError(f"port model has {used} parameters, the reference "
                         f"tree {total} leaves")
    return model
