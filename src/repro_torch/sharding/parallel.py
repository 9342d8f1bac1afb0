"""The sharded steps' collectives: per-unit FSDP gathers over the batch
axes and tensor parallelism over ``model`` (the reference's GSPMD
partition of its train, prefill and decode steps, written out), and the
split caches of serving.

**FSDP.**  A parameter rests as its shard (the rules of
:mod:`repro_torch.sharding.spec`: a dimension over the batch axes, a
dimension over ``model``).  :class:`FSDP` gathers a leaf over the batch
axes where it is used — a unit's leaves inside the unit's rematerialised
function (:class:`ShardedUnit`), so the backward pass gathers them again —
after the ``cast_params_once`` cast, so the wire carries bf16.  The
gather's backward is the reduction of the leaf's gradient back to its
shard, in f32: a reduce-scatter over the batch axes (a sum; the step
divides by their size), and an all-reduce over ``model`` for a leaf that
``model`` does not split.  No rank holds more than one unit gathered, or
any gradient larger than its shard.

**Tensor parallelism** (:class:`TensorParallel`).  A rank computes the
columns, heads, experts and vocabulary rows that its ``model`` shards
hold.  Between the units the residual stream is split over ``model`` on
its sequence dimension where the sequence divides (sequence parallelism:
:meth:`TensorParallel.enter` all-gathers it, :meth:`TensorParallel.exit`
reduce-scatters a row-parallel partial sum back), else it is whole on
every rank (an all-reduce closes a region).  Where the query heads are
fewer than the ranks (whisper) attention splits over query positions
instead: a rank's output rows are complete, so a split stream takes them
as they are (:meth:`TensorParallel.rows_out`) and a whole one all-gathers
every rank's rows.

The gradient convention: a tensor that differs between the ranks of
``model`` (a sequence slice, a partial sum, a column block) carries its
whole gradient; a tensor that every rank of ``model`` holds alike carries
a *share*, and the shares of the ranks sum to its gradient.  So entering
a region is the identity backward, an all-reduce that closes one
all-reduces its gradient, the loss seeds ``1 / size`` on each rank
(:meth:`TensorParallel.share`), and the gradient of a leaf that ``model``
does not split is the all-reduce of the ranks' shares.

**Split caches** (:class:`CacheLayout`, prefill and decode).  A rank
holds its caches as ``cache_shardings`` lays them at rest: its KV heads
over the whole sequence where the heads divide ``model``, else every KV
head over its block of the cache's slots (:class:`SeqSplit`: the slots
split over ``model``, or in long-context decode over the data axes with
``model`` folded in).  Attention over split slots is computed per block
and joined by :meth:`SeqSplit.combine`, the log-sum-exp combine: each
rank's partial (max, Σexp, Σexp·v), rescaled to the all-reduced max and
summed.  Serving runs under ``torch.inference_mode()`` and needs no
gradient.

Every collective is a functional collective (``_c10d_functional``), so it
runs on ``meta`` tensors under the dry run's fake group and
``CommDebugMode`` counts it.  A group of one position is never called.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence

import torch
from torch.autograd import Function

__all__ = [
    "TensorParallel", "FSDP", "LeafPlan", "ShardedUnit", "Leaves",
    "SeqSplit", "CacheLayout", "all_gather", "reduce_scatter", "all_reduce",
]


def _ops():
    import torch.distributed  # noqa: F401 — registers the functional ops

    return torch.ops._c10d_functional


def all_gather(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The ranks' ``t`` concatenated along ``dim``, in the group's order."""
    ops = _ops()
    dim %= t.dim()
    x = t.movedim(dim, 0).contiguous()
    out = ops.wait_tensor(ops.all_gather_into_tensor(x, group.size(),
                                                     group.group_name))
    return out.movedim(0, dim)


def reduce_scatter(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The sum of the ranks' ``t``, this rank's block of ``dim``."""
    ops = _ops()
    dim %= t.dim()
    x = t.movedim(dim, 0).contiguous()
    out = ops.wait_tensor(ops.reduce_scatter_tensor(x, "sum", group.size(),
                                                    group.group_name))
    return out.movedim(0, dim)


def all_reduce(t: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    ops = _ops()
    return ops.wait_tensor(ops.all_reduce(t.contiguous(), op,
                                          group.group_name))


class _Gather(Function):
    """All-gather along ``dim``; the backward reduce-scatters (sums the
    ranks' shares)."""

    @staticmethod
    def forward(ctx, t, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather(t, dim, group)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.dim, ctx.group), None, None


class _Scatter(Function):
    """Reduce-scatter of partial sums along ``dim``; the backward
    all-gathers."""

    @staticmethod
    def forward(ctx, t, dim, group):
        ctx.dim, ctx.group = dim, group
        return reduce_scatter(t, dim, group)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.dim, ctx.group), None, None


class _GatherRows(Function):
    """Every rank's block of ``n`` rows along dim 1 (the blocks of
    :meth:`TensorParallel.block`, uneven where ``n`` does not divide)
    all-gathered into the whole ``n``: each block padded to the largest,
    gathered and cut.  The backward pads the gradient's blocks alike,
    reduce-scatters them (sums the ranks' shares) and returns the rank's
    rows."""

    @staticmethod
    def forward(ctx, t, n, tp):
        ctx.n, ctx.tp = n, tp
        m = -(-n // tp.size)
        whole = all_gather(_pad_rows(t, m), 1, tp.group)
        return whole.index_select(1, _row_index(tp, n, m, t.device))

    @staticmethod
    def backward(ctx, g):
        tp, n = ctx.tp, ctx.n
        m = -(-n // tp.size)
        padded = g.new_zeros((g.shape[0], tp.size * m) + tuple(g.shape[2:]))
        padded = padded.index_copy(1, _row_index(tp, n, m, g.device), g)
        a, b = tp.block(n)
        return reduce_scatter(padded, 1, tp.group)[:, :b - a], None, None


def _pad_rows(t: torch.Tensor, m: int) -> torch.Tensor:
    """``t`` with zero rows appended along dim 1 up to ``m``."""
    pad = t.new_zeros((t.shape[0], m - t.shape[1]) + tuple(t.shape[2:]))
    return torch.cat([t, pad], dim=1)


def _row_index(tp, n: int, m: int, device) -> torch.Tensor:
    """Where each of the ``n`` rows lies among the ranks' blocks padded to
    ``m`` rows each."""
    rows = []
    for r in range(tp.size):
        a, b = r * n // tp.size, (r + 1) * n // tp.size
        rows.extend(range(r * m, r * m + b - a))
    return torch.tensor(rows, dtype=torch.int64, device=device)


class _Reduce(Function):
    """All-reduce of partial sums; the backward all-reduces the shares."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return all_reduce(t, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _Share(Function):
    """The identity, whose backward passes ``1 / n`` of the gradient."""

    @staticmethod
    def forward(ctx, t, n):
        ctx.n = n
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


class TensorParallel:
    """The ``model`` axis of a ``DeviceMesh``: its group, its size and this
    rank's position on it, with the operations of the module's docstring."""

    def __init__(self, mesh, axis: str = "model"):
        self.group = mesh.get_group(axis)
        self.size = self.group.size()
        self.rank = mesh.get_local_rank(axis)

    def splits(self, n: int) -> bool:
        """Whether a sequence of ``n`` positions is split over the axis."""
        return n % self.size == 0

    def block(self, n: int):
        """This rank's ``[start, stop)`` of ``n`` (blocks as even as
        ``n`` allows; exactly the shard's where the rules split ``n``)."""
        return self.rank * n // self.size, (self.rank + 1) * n // self.size

    def enter(self, h: torch.Tensor, split: bool) -> torch.Tensor:
        """The whole sequence on every rank, from this rank's slice."""
        return _Gather.apply(h, 1, self.group) if split else h

    def exit(self, y: torch.Tensor, split: bool) -> torch.Tensor:
        """A region's partial sums back in the residual stream's layout:
        reduce-scattered to the rank's sequence slice, or all-reduced."""
        if split:
            return _Scatter.apply(y, 1, self.group)
        return _Reduce.apply(y, self.group)

    def seq_slice(self, y: torch.Tensor) -> torch.Tensor:
        a, b = self.block(y.shape[1])
        return y[:, a:b]

    def rows_out(self, y: torch.Tensor, split: bool, n: int) -> torch.Tensor:
        """A region's output rows, complete, for this rank's block of the
        positions, in the residual stream's layout: the rank's slice as it
        is where the stream is split (no collective), else every rank's
        rows all-gathered into the whole ``n`` (:class:`_GatherRows`)."""
        return y if split else _GatherRows.apply(y, n, self)

    def cols(self, w: torch.Tensor, dim: int, n: int) -> torch.Tensor:
        """This rank's block of dimension ``dim`` (of global size ``n``):
        ``w`` itself where the rules split it, else its slice."""
        if w.shape[dim] != n:
            return w
        a, b = self.block(n)
        return w.narrow(dim, a, b - a)

    def full(self, w: torch.Tensor, dim: int, n: int) -> torch.Tensor:
        """``w`` whole along ``dim``: all-gathered where it is split."""
        if w.shape[dim] == n:
            return w
        return _Gather.apply(w, dim, self.group)

    def reduce(self, t: torch.Tensor) -> torch.Tensor:
        return _Reduce.apply(t, self.group)

    def max(self, t: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return all_reduce(t, self.group, "max")

    def share(self, loss: torch.Tensor) -> torch.Tensor:
        return _Share.apply(loss, self.size)

    def vocab_rows(self, w: torch.Tensor, vocab: int, d_model: int):
        """This rank's rows of a (V, D) vocabulary matrix and the first
        token id they hold.  Where the rules split D instead (a vocabulary
        that does not divide the axis), the matrix is all-gathered over
        ``model`` and sliced."""
        if w.shape[0] != vocab:
            return w, self.rank * w.shape[0]
        w = self.full(w, 1, d_model)
        a, b = self.block(vocab)
        return w[a:b], a


# ---------------------------------------------------------------------------
# Serving: caches split as they rest
# ---------------------------------------------------------------------------


class SeqSplit:
    """The mesh axes (major first) that split a cache's slots: this rank's
    block of them and the log-sum-exp combine over them."""

    def __init__(self, mesh, axes: Sequence[str]):
        self.groups = [mesh.get_group(a) for a in axes
                       if mesh.get_group(a).size() > 1]
        self.index, self.size = 0, 1
        for a in axes:
            n = mesh.get_group(a).size()
            self.index = self.index * n + mesh.get_local_rank(a)
            self.size *= n

    def block(self, n: int):
        """This rank's ``[start, stop)`` of ``n`` slots."""
        return self.index * n // self.size, (self.index + 1) * n // self.size

    def combine(self, m: torch.Tensor, l: torch.Tensor,
                acc: torch.Tensor) -> torch.Tensor:
        """Softmax-weighted values over every rank's slots, from this
        rank's partials over its own: ``m`` the max of its scores, ``l``
        the sum of ``exp(score - m)`` and ``acc`` the sum of ``exp(score -
        m) · v``, ``m`` and ``l`` with a trailing 1 in place of ``acc``'s
        last dimension.  The max is all-reduced, each partial rescaled to
        it, the sums all-reduced in one tensor: two collectives per
        axis."""
        top = m
        for group in self.groups:
            top = all_reduce(top, group, "max")
        w = torch.exp(m - top)
        both = torch.cat([acc * w, l * w], dim=-1)
        for group in self.groups:
            both = all_reduce(both, group)
        return both[..., :-1] / both[..., -1:]


class CacheLayout:
    """Where a rank's caches lie (``spec.cache_shardings``): ``kv_split``,
    whether ``model`` splits the KV heads; ``seq_axes``, for each global
    slot count a cache can have (the cache length, a local layer's ring,
    the encoder's sequence), the axes that split its slots; and
    ``cache_len``, the steps' cache length."""

    def __init__(self, mesh, kv_split: bool, seq_axes: Dict[int, tuple],
                 cache_len: int):
        self.kv_split, self.cache_len = kv_split, cache_len
        self._seq = {n: SeqSplit(mesh, axes) if axes else None
                     for n, axes in seq_axes.items()}

    def seq(self, n: int) -> Optional[SeqSplit]:
        """The split of a cache of ``n`` slots, or None where every rank
        holds all of them."""
        return self._seq[n]


# ---------------------------------------------------------------------------
# FSDP: per-unit gathers over the batch axes
# ---------------------------------------------------------------------------


class LeafPlan(NamedTuple):
    """How a leaf is used: the dtype it is cast to first (or None), the
    dimension its shard splits over the batch axes (or None), and whether
    ``model`` splits it."""

    cast: Optional[torch.dtype]
    fsdp_dim: Optional[int]
    model_split: bool


class _GatherParam(Function):
    @staticmethod
    def forward(ctx, t, plan, fsdp):
        ctx.plan, ctx.fsdp, ctx.dtype = plan, fsdp, t.dtype
        out = t.to(plan.cast) if plan.cast is not None else t
        if plan.fsdp_dim is not None:
            for group in reversed(fsdp.groups):  # minor axis first
                out = all_gather(out, plan.fsdp_dim, group)
        return out if out is not t else t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        plan, fsdp = ctx.plan, ctx.fsdp
        g = g.to(ctx.dtype)
        for group in fsdp.groups:  # major axis first
            g = (reduce_scatter(g, plan.fsdp_dim, group)
                 if plan.fsdp_dim is not None else all_reduce(g, group))
        if fsdp.model is not None and not plan.model_split:
            g = all_reduce(g, fsdp.model)
        return g, None, None


class FSDP:
    """The batch axes' groups (major first, those of more than one
    position) and, with tensor parallelism, the ``model`` group."""

    def __init__(self, groups: Sequence, model_group=None):
        self.groups = list(groups)
        self.model = model_group

    def gather(self, t: torch.Tensor, plan: LeafPlan) -> torch.Tensor:
        """``t`` cast and gathered over the batch axes (differentiable:
        the gradient comes back reduced to ``t``'s shard, in its dtype)."""
        if (plan.cast is None and not self.groups
                and (self.model is None or plan.model_split)):
            return t
        return _GatherParam.apply(t, plan, self)


class Leaves:
    """Tensors under dotted names, read as a module's attributes and items
    (``unit["e0"].attn.wq``); ``extra`` adds attributes as they are."""

    def __init__(self, flat: Dict[str, torch.Tensor], **extra):
        tree: Dict = {}
        for name, t in flat.items():
            *path, leaf = name.split(".")
            node = tree
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = t
        tree.update(extra)
        self.__dict__["_tree"] = tree

    @classmethod
    def _of(cls, node):
        if isinstance(node, dict):
            out = cls.__new__(cls)
            out.__dict__["_tree"] = node
            return out
        return node

    def __getattr__(self, key):
        try:
            return Leaves._of(self.__dict__["_tree"][key])
        except KeyError:
            raise AttributeError(key) from None

    __getitem__ = __getattr__


class ShardedUnit:
    """One unit's shards (names relative to the unit) and their plans;
    :meth:`gather` gives the unit's leaves gathered, as a :class:`Leaves`."""

    def __init__(self, shards: Dict[str, torch.Tensor],
                 plans: Dict[str, LeafPlan], fsdp: FSDP):
        self.shards, self.plans, self.fsdp = shards, plans, fsdp

    def gather(self) -> Leaves:
        return Leaves({n: self.fsdp.gather(t, self.plans[n])
                       for n, t in self.shards.items()})
