"""Logical-axis sharding rules, and the graph tier's shard assignment.

**The LM half** (the reference's rules, spec for spec).  Weights carry
*logical axes*; a :class:`ShardingRules` maps logical names to mesh axes.
Key decisions (the reference's):

* Fused projection dims (`qkv` = heads·head_dim, `ffn`, `vocab`, experts'
  ffn) shard over ``model`` — divisible by 16 for every assigned arch.
* Every rule is **divisibility-guarded**: a dim that doesn't divide
  (whisper's 51865 vocab, kv_heads=8 on a 16-way model axis) falls back to
  the next-best axis or replication, never to an invalid spec.
* ``batch`` shards over (``pod``, ``data``) for train/prefill/decode.
* ``long_500k`` (batch=1) swaps the batch rule for **sequence sharding** of
  the KV cache (context parallelism for single-stream decode).
* KV caches shard kv_heads over ``model`` when divisible, else the cache
  *sequence* dim over ``model``.
* Stacked-unit leading dims are never sharded.

A spec is a :class:`P`: one entry per tensor dimension, each ``None``, a
mesh-axis name or a tuple of names (major first), exactly the reference's
``PartitionSpec``.  The rules read only ``mesh.shape`` and the axis names,
so they run on any mesh (a ``DeviceMesh``, the port's ``Mesh``, or a stand-in
with those two attributes) and need no process group.  A
:class:`NamedSharding` pairs a spec with its mesh; on a ``DeviceMesh`` it
translates to DTensor placements (:meth:`NamedSharding.placements`) and
gives each rank's local shape (:meth:`NamedSharding.local_shape`).

The rules' leaf names are the reference's pytree paths; the port's
parameter names (``units.<u>.e0.attn.wq``) are those paths with the unit
index inserted, which :func:`param_shardings` removes.  A unit's leaf in
the port has no stacked leading dimension, so its spec drops the
reference's leading ``None``.

**The graph half**: the static description of a case partition, the
stable ``case % K`` rule, and a 1-D mesh over the visible cards for
running the shard merge on them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, Optional, Tuple

import numpy as np

from repro_torch.configs.base import ShapeConfig
from repro_torch.core.compat import Mesh, make_mesh, visible_cards

__all__ = [
    "P", "NamedSharding", "ShardingRules", "make_rules", "param_shardings",
    "batch_shardings", "cache_shardings", "attn_cache_spec", "cache_seq_axes",
    "mesh_axis_sizes",
    "GraphShardSpec", "shard_of_cases", "graph_mesh",
]

_STACKED = ("units", "enc_units")


class P(tuple):
    """A partition spec: one entry per tensor dimension (``None``, a mesh
    axis name, or a tuple of names, major first)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def mesh_axis_sizes(mesh) -> Dict[str, int]:
    """Axis name → size, in axis order, of any mesh: ``shape`` is a mapping
    (the port's ``Mesh``, the reference's) or a tuple beside
    ``mesh_dim_names`` (a ``DeviceMesh``)."""
    shape = mesh.shape
    if isinstance(shape, Mapping):
        return dict(shape)
    names = getattr(mesh, "mesh_dim_names", None) or mesh.axis_names
    return dict(zip(names, shape))


def _axis_names(mesh) -> Tuple[str, ...]:
    names = getattr(mesh, "axis_names", None)
    if names is None:
        names = mesh.mesh_dim_names
    return tuple(names)


def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the reference's ``NamedSharding``)."""

    mesh: object
    spec: P

    def placements(self, partial_axes=()):
        """The spec as DTensor placements, one per mesh dimension: ``Shard(d)``
        on each axis that dimension ``d`` is split over, ``Partial()`` (a
        partial sum) on ``partial_axes``, ``Replicate()`` on the others.  A
        dimension split over several axes (``("pod", "data")``) lists them
        in mesh order, major first, which DTensor applies in that order —
        the reference's layout."""
        from torch.distributed.tensor import Partial, Replicate, Shard

        names = _axis_names(self.mesh)
        out = [Partial() if n in partial_axes else Replicate() for n in names]
        for d, entry in enumerate(self.spec):
            axes = _entry_axes(entry)
            idx = [names.index(a) for a in axes]
            if idx != sorted(idx):
                raise ValueError(
                    f"{self.spec}: dimension {d} splits over {axes}, not in "
                    f"the mesh's order {names}")
            for i in idx:
                out[i] = Shard(d)
        return tuple(out)

    def local_shape(self, shape) -> Tuple[int, ...]:
        """Each rank's shard of a tensor of global ``shape``: every dimension
        divided by the product of its axes' sizes (the rules guarantee that
        they divide)."""
        sizes = mesh_axis_sizes(self.mesh)
        out = []
        for n, entry in zip(shape, tuple(self.spec) + (None,) * len(shape)):
            k = math.prod(sizes[a] for a in _entry_axes(entry))
            if n % k:
                raise ValueError(f"dimension {n} of {tuple(shape)} does not "
                                 f"divide over {entry} ({k})")
            out.append(n // k)
        return tuple(out)


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    mesh: object
    batch_axes: Tuple[str, ...]  # mesh axes carrying the batch
    model_axis: Optional[str]  # mesh axis carrying tensor parallelism
    seq_axes: Tuple[str, ...] = ()  # cache sequence sharding (long decode)
    # ZeRO/FSDP: params + grads + optimizer state additionally sharded over
    # these axes for training
    fsdp_axes: Tuple[str, ...] = ()

    @property
    def sizes(self) -> Dict[str, int]:
        return mesh_axis_sizes(self.mesh)

    @property
    def model_size(self) -> int:
        return self.sizes[self.model_axis] if self.model_axis else 1

    def axes_size(self, axes) -> int:
        n = 1
        for a in axes:
            n *= self.sizes[a]
        return n

    def nd(self, spec: P) -> NamedSharding:
        return NamedSharding(self.mesh, spec)

    # -- divisibility-guarded axis pickers ---------------------------------
    def model_if(self, dim: int):
        m = self.model_axis
        return m if (m and dim % self.sizes[m] == 0) else None

    def batch_if(self, dim: int):
        if self.batch_axes and dim % self.axes_size(self.batch_axes) == 0:
            return self.batch_axes
        return None

    def fsdp_if(self, dim: int):
        if self.fsdp_axes and dim % self.axes_size(self.fsdp_axes) == 0:
            return self.fsdp_axes
        return None


def make_rules(mesh, shape: ShapeConfig) -> ShardingRules:
    axes = list(_axis_names(mesh))
    sizes = mesh_axis_sizes(mesh)
    model_axis = "model" if "model" in axes else None
    data_axes = tuple(a for a in axes if a in ("pod", "data"))
    dsize = int(np.prod([sizes[a] for a in data_axes])) if data_axes else 1
    if shape.kind == "decode" and shape.global_batch < dsize:
        # long-context single-stream decode: batch unshardable → shard cache
        # sequence over the data axes instead (context parallelism)
        return ShardingRules(
            mesh, batch_axes=(), model_axis=model_axis, seq_axes=data_axes
        )
    return ShardingRules(
        mesh, batch_axes=data_axes, model_axis=model_axis,
        fsdp_axes=data_axes if shape.kind == "train" else (),
    )


# ---------------------------------------------------------------------------
# Parameter shardings (path-pattern → P)
# ---------------------------------------------------------------------------


def _param_spec(path_keys, shape, r: ShardingRules, moe_ep: bool = False) -> P:
    """The reference's spec of the leaf at ``path_keys`` (its pytree path)
    with (stacked) ``shape``."""
    name = path_keys[-1]
    inside_unit = "units" in path_keys or "enc_units" in path_keys
    u = (None,) if inside_unit else ()  # stacked-unit leading dim
    d = shape[len(u):]  # logical dims past the unit stack

    def mi(i):  # model axis iff divisible
        return r.model_if(d[i])

    def fi(i):  # fsdp axes iff training + divisible
        return r.fsdp_if(d[i])

    if name in ("embed", "lm_head"):
        v = r.model_if(d[0])
        return P(v, fi(1) if v else r.model_if(d[1]))
    if name in ("wq", "wk", "wv"):  # (D, fused)
        return P(*u, fi(0), mi(1))
    if name == "wo":  # (fused, D)
        return P(*u, mi(0), fi(1))
    if name in ("w_up", "w_gate"):
        if "moe" in path_keys:  # (E, D, F)
            if moe_ep and r.model_if(d[0]):
                return P(*u, "model", fi(1), None)  # expert parallel
            return P(*u, None, fi(1), mi(2))
        return P(*u, fi(0), mi(1))  # (D, F)
    if name == "w_down":
        if "moe" in path_keys:  # (E, F, D)
            if moe_ep and r.model_if(d[0]):
                return P(*u, "model", None, fi(2))
            return P(*u, None, mi(1), fi(2))
        return P(*u, mi(0), fi(1))  # (F, D)
    if name == "router":  # (D, E) — small, replicated
        return P(*u, None, None)
    if name == "in_proj":  # mamba (D, proj_out)
        return P(*u, fi(0), mi(1))
    if name == "out_proj":  # mamba (d_inner, D)
        return P(*u, mi(0), fi(1))
    if name == "conv_w":  # (W, C)
        return P(*u, None, mi(1))
    if name in ("conv_b", "norm_w", "A_log", "D", "dt_bias"):
        return P(*u, mi(0))
    # norms and anything else: replicated beyond the unit stack
    return P(*u, *([None] * len(d)))


def _map_tree(fn, tree, path=()):
    """``fn(path, leaf)`` over a tree of mappings and lists (a list's index
    is a path element, as a unit's index is in the port's caches)."""
    if isinstance(tree, Mapping):
        return {k: _map_tree(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_tree(fn, v, path + (i,)) for i, v in enumerate(tree)]
    return fn(path, tree)


def param_shardings(r: ShardingRules, params, cfg=None) -> Dict[str, NamedSharding]:
    """``{name: NamedSharding}`` for the port's parameters: a module
    (``named_parameters``, e.g. on ``meta``) or a mapping name → tensor
    (the optimizer's moments)."""
    moe_ep = bool(cfg is not None and getattr(cfg, "moe_expert_parallel", False))
    named = (dict(params.named_parameters())
             if hasattr(params, "named_parameters") else dict(params))
    out = {}
    for name, leaf in named.items():
        parts = name.split(".")
        unit = parts[0] in _STACKED
        keys = [parts[0]] + parts[2:] if unit else parts
        shape = ((1,) if unit else ()) + tuple(leaf.shape)
        spec = _param_spec(keys, shape, r, moe_ep=moe_ep)
        if len(spec) != len(shape):
            raise ValueError(f"{name}: spec {spec} for shape {shape}")
        out[name] = r.nd(P(*spec[1:]) if unit else spec)
    return out


# ---------------------------------------------------------------------------
# Batch / cache shardings
# ---------------------------------------------------------------------------


def batch_shardings(r: ShardingRules, batch) -> Dict[str, NamedSharding]:
    """tokens/labels (B, S); vision_embeds/frames (B, S', D)."""
    return {k: r.nd(P(r.batch_if(v.shape[0]), *([None] * (len(v.shape) - 1))))
            for k, v in batch.items()}


def attn_cache_spec(r: ShardingRules, shape) -> P:
    """The spec of an attention cache of global ``shape`` ``(B, S, KV,
    hd)`` (self k / v, or whisper's cross k / v): the KV heads over
    ``model`` where they divide, else the cache's sequence over ``model``;
    in long-context decode (``r.seq_axes``) the sequence over the data
    axes, with ``model`` folded in where the KV heads do not divide."""
    B, S, KV, _ = shape
    b = r.batch_if(B)
    if r.seq_axes:  # long-context mode: context parallelism
        seq = (
            r.seq_axes
            if S % r.axes_size(r.seq_axes) == 0
            else None
        )
        kv = r.model_if(KV)
        if kv is None and seq is not None:
            # fold model into the seq shard when kv can't split
            both = tuple(r.seq_axes) + (r.model_axis,)
            if r.model_axis and S % r.axes_size(both) == 0:
                seq = both
        return P(b, seq, kv if kv else None, None)
    kv = r.model_if(KV)
    if kv is not None:
        return P(b, None, kv, None)
    m = r.model_if(S)  # fall back: shard the cache sequence over model
    return P(b, m, None, None)


def cache_seq_axes(r: ShardingRules, shape) -> Tuple[str, ...]:
    """The mesh axes (major first) that split the sequence (slot)
    dimension of an attention cache of global ``shape``: a rank holds the
    block of slots its position on them indexes, in that order."""
    return _entry_axes(attn_cache_spec(r, shape)[1])


def cache_shardings(r: ShardingRules, caches):
    """The same structure as ``caches`` (the port's list of units), each
    leaf a :class:`NamedSharding`.  The reference's caches are stacked over
    the units (``(U, B, S, KV, hd)`` …); the port's unit caches drop that
    leading dimension and so does their spec.  Attention k / v
    ``(B, S, KV, hd)`` (:func:`attn_cache_spec`); mamba conv ``(B, W, C)``
    and state ``(B, H, P, N)``; cross k / v ``(B, S_enc, KV, hd)``."""

    def one(path, leaf):
        name = path[-1]
        nd = len(leaf.shape)
        if name in ("k", "v", "cross_k", "cross_v") and nd == 4:
            return r.nd(attn_cache_spec(r, leaf.shape))
        if name == "conv" and nd == 3:  # (B, W, C)
            return r.nd(P(r.batch_if(leaf.shape[0]), None,
                          r.model_if(leaf.shape[2])))
        if name == "state" and nd == 4:  # (B, H, P, N)
            return r.nd(P(r.batch_if(leaf.shape[0]),
                          r.model_if(leaf.shape[1]), None, None))
        return r.nd(P(*([None] * nd)))

    return _map_tree(one, caches)


# ---------------------------------------------------------------------------
# Graph-tier shard assignment (case-partitioned event-log shards)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class GraphShardSpec:
    """Static description of a case-partitioned log sharding.

    Cases are assigned whole to shards (``assignment="case_mod"`` maps case
    ``c`` to shard ``c % num_shards``), so every directly-follows pair is
    shard-local and the global Ψ is a pure sum of per-shard (A, A) counts on
    the aligned union vocabulary — the contract of
    :func:`repro_torch.core.distributed.distributed_dfg`.
    """

    num_shards: int
    assignment: str = "case_mod"

    def __post_init__(self):
        if self.num_shards < 1:
            raise ValueError("num_shards must be >= 1")
        if self.assignment != "case_mod":
            raise ValueError(f"unknown shard assignment {self.assignment!r}")

    def shard_of(self, case_ids: np.ndarray) -> np.ndarray:
        return shard_of_cases(case_ids, self.num_shards)


def shard_of_cases(case_ids, num_shards: int) -> np.ndarray:
    """Owning shard per case id under the stable ``case % K`` rule.

    Stability across appends is the load-bearing property: new events for an
    existing case always land on the shard that already holds that case, so
    an append touches only the owning shards and every other shard's
    prefix-preserving fingerprint (and therefore its cached graph) survives.
    """
    ids = np.asarray(case_ids, dtype=np.int64)
    if num_shards < 1:
        raise ValueError("num_shards must be >= 1")
    return ids % np.int64(num_shards)


def graph_mesh(num_shards: int) -> Optional[Mesh]:
    """1-D ``("shard",)`` mesh over up to ``num_shards`` visible cards, for
    running the shard merge on the cards; ``None`` when at most one card is
    visible (the host's aligned-sum merge needs no mesh)."""
    cards = visible_cards()
    n = min(num_shards, len(cards))
    if n <= 1:
        return None
    return make_mesh((n,), ("shard",), devices=cards[:n])
