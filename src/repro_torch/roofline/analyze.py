"""Three-term roofline of a step, per device.

  compute_s    = flops / PEAK_FLOPS_BF16
  memory_s     = bytes_accessed / HBM_BW
  collective_s = Σ wire_bytes(op) / ICI_BW (NVLink)

The reference reads these from the compiled XLA module (``cost_analysis``,
``memory_analysis`` and the partitioned HLO text).  The port has no
compiler between the step and the card, so :func:`analyze_step` runs the
step once on ``meta`` tensors of one rank's local shapes (no memory, no
kernel) and counts what that rank executes:

* FLOPs — ``torch.utils.flop_counter.FlopCounterMode`` (matrix products and
  attention: the reference's ``dot_flops``);
* bytes accessed — every operator that is not a view reads its tensor
  inputs once and writes its outputs once (eager PyTorch has no fusion, so
  each operator boundary is device-memory traffic: the analogue of the
  HLO model's fusion-boundary bytes);
* collectives — ``torch.distributed.tensor.debug.CommDebugMode`` over the
  step, each collective's result bytes weighted by the ring factor on its
  group size (as :func:`parse_collectives` weighs the HLO's);
* memory — the arguments' bytes (the exact sum of the rank's local shards),
  the peak of the bytes that the step's own tensors hold at once (every
  storage that an operator creates counts from its creation to its
  release, and CUDA's ``_softmax_backward_data`` one more buffer of its
  output's size while it runs, which the card's kernel holds), the
  outputs, and the donated inputs that the outputs alias.  Not counted:
  cuBLAS's workspaces, allocated once per handle and stream and kept (their
  size depends on the card, the build and ``CUBLAS_WORKSPACE_CONFIG``, and
  the autograd thread has a handle of its own), and what other kernels
  hold inside while they run.

On ``meta`` a product of bf16 operands with an f32 result
(:func:`repro_torch.models.common.matmul_f32`) runs as on the card, one
bf16-in / f32-out GEMM (``out_dtype``) with no f32 copy of an operand.

:func:`parse_collectives` and :func:`model_flops` are the reference's.
"""

from __future__ import annotations

import contextlib
import os
import re
import weakref
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from ..configs.base import ModelConfig, ShapeConfig
from . import hw

__all__ = ["parse_collectives", "analyze_step", "model_flops", "wire_bytes"]

_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "bf16": 2, "f16": 2, "f8e4m3fn": 1, "f8e5m2": 1,
    "s64": 8, "u64": 8, "s32": 4, "u32": 4, "s16": 2, "u16": 2,
    "s8": 1, "u8": 1, "pred": 1, "c64": 8, "c128": 16,
}

_COLL_KINDS = (
    "all-reduce", "all-gather", "reduce-scatter", "all-to-all",
    "collective-permute",
)

# `%all-reduce.1 = f32[4,32]{1,0} all-reduce(` or tuple results
_OP_RE = re.compile(
    r"=\s*(\(?[a-z0-9fbsupc]+\[[^=]*?)\s*"
    r"(all-reduce-start|all-gather-start|collective-permute-start|"
    r"all-reduce|all-gather|reduce-scatter|all-to-all|collective-permute)\("
)
_SHAPE_RE = re.compile(r"([a-z0-9]+)\[([0-9,]*)\]")
_GROUPS_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]")
_GROUPS_BRACE_RE = re.compile(r"replica_groups=\{\{([0-9,]+)\}")


def _shape_bytes(text: str) -> int:
    total = 0
    for dt, dims in _SHAPE_RE.findall(text):
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def wire_bytes(kind: str, bytes_: int, n: int) -> float:
    """Per-device wire bytes of one collective of ``kind`` whose result is
    ``bytes_`` on a group of ``n`` (ring factors)."""
    n = max(n, 2)
    if kind == "all-reduce":
        return 2.0 * (n - 1) / n * bytes_
    if kind == "all-gather":
        return (n - 1) / n * bytes_
    if kind == "reduce-scatter":
        return float(n - 1) * bytes_
    if kind == "all-to-all":
        return (n - 1) / n * bytes_
    return float(bytes_)  # collective-permute


def _inventory(ops) -> Dict:
    by_kind: Dict[str, Dict] = {}
    for o in ops:
        k = by_kind.setdefault(o["kind"], {"count": 0, "bytes": 0, "wire": 0.0})
        k["count"] += 1
        k["bytes"] += o["bytes"]
        k["wire"] += o["wire"]
    return {
        "ops": by_kind,
        "num_collectives": len(ops),
        "wire_bytes": sum(o["wire"] for o in ops),
    }


def parse_collectives(hlo_text: str) -> Dict:
    """Per-device collective inventory from partitioned HLO text (the
    reference's dry-run artifacts)."""
    ops = []
    for line in hlo_text.splitlines():
        m = _OP_RE.search(line)
        if m is None:
            continue
        if "-done" in line:
            continue  # async pair: count the start only
        shape_txt, kind = m.group(1), m.group(2)
        kind = kind.replace("-start", "")
        bytes_ = _shape_bytes(shape_txt)
        gm = _GROUPS_RE.search(line)
        if gm:
            n = int(gm.group(2))
        else:
            gb = _GROUPS_BRACE_RE.search(line)
            n = len(gb.group(1).split(",")) if gb else 2
        n = max(n, 2)
        ops.append({"kind": kind, "bytes": bytes_, "group": n,
                    "wire": wire_bytes(kind, bytes_, n)})
    return _inventory(ops)


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """Reference MODEL_FLOPS = 6·N·D (train) / 2·N·D (inference), with
    N = active params for MoE.  Global (whole step, all chips)."""
    n = cfg.active_params_count() if cfg.n_experts else cfg.params_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    # decode: one token per sequence
    return 2.0 * n * shape.global_batch


# ---------------------------------------------------------------------------
# Counting one rank's step
# ---------------------------------------------------------------------------

#: the collective kind of each c10d operator (functional and in place)
_COLL_OF = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "allreduce_": "all-reduce",
    "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "alltoall_base_": "all-to-all",
    "broadcast": "collective-permute",
    "broadcast_": "collective-permute",
}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _group_size(func, args, kwargs) -> int:
    """The group size of a collective operator's call, from its schema's
    ``group_size`` (an int), ``group_name`` (a registered group) or process
    group argument."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group

    bound = dict(zip((a.name for a in func._schema.arguments), args))
    bound.update(kwargs or {})
    if isinstance(bound.get("group_size"), int):
        return bound["group_size"]
    if isinstance(bound.get("group_name"), str):
        return dist.get_world_size(_resolve_process_group(bound["group_name"]))
    group = bound.get("process_group")
    if group is None:
        return 2
    if not isinstance(group, dist.ProcessGroup):  # a boxed script object
        group = dist.ProcessGroup.unbox(group)
    return group.size()


def _collective_log_mode():
    """A ``CommDebugMode`` that also records each collective's kind, result
    bytes, group size and wire bytes (``.ops``)."""
    from torch.distributed.tensor.debug import CommDebugMode

    class CollectiveLog(CommDebugMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            before = sum(self.comm_counts.values())
            out = super().__torch_dispatch__(func, types, args, kwargs)
            if out is NotImplemented or sum(self.comm_counts.values()) == before:
                return out
            name = func._overloadpacket.__name__
            kind = _COLL_OF.get(name, "collective-permute")
            res = _tensors(out)
            if name.endswith("_") and not name.startswith("_"):  # in place
                res = _tensors(args[0])
            bytes_ = sum(_nbytes(t) for t in res)
            n = _group_size(func, args, kwargs)
            self.ops.append({"kind": kind, "bytes": bytes_, "group": n,
                             "wire": wire_bytes(kind, bytes_, n)})
            return out

    return CollectiveLog()


class _Traffic(TorchDispatchMode):
    """Bytes accessed (each operator's tensor inputs read once, outputs
    written once; views, collectives and metadata operators free) and the
    peak bytes held by the storages that the step's operators create, with
    the buffer that an operator of ``_HELD`` holds while it runs."""

    _FREE = {"detach", "alias", "lift_fresh", "empty", "empty_like",
             "empty_strided", "new_empty", "new_empty_strided", "set_",
             "resize_", "record_stream", "wait_tensor"}
    #: operators whose CUDA kernel holds one more buffer of its output's
    #: size while it runs (the softmax backward's, measured on an H100 with
    #: torch 2.11.0+cu128)
    _HELD = {"_softmax_backward_data"}

    def __init__(self, inputs):
        super().__init__()
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self._new = set()
        self._old = {t.untyped_storage()._cdata for t in inputs}

    def _release(self, key, n):
        self.live -= n
        self._new.discard(key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(t is not torch.Tensor and t is not torch.nn.Parameter
               for t in types):
            return NotImplemented  # a DTensor: count its local operators
        out = func(*args, **(kwargs or {}))
        name = func._overloadpacket.__name__
        if not (func.is_view or name in self._FREE or name in _COLL_OF):
            self.bytes += sum(_nbytes(t) for t in _tensors((args, kwargs)))
            self.bytes += sum(_nbytes(t) for t in _tensors(out))
        for t in _tensors(out):
            st = t.untyped_storage()
            key = st._cdata
            if key in self._new or key in self._old:
                continue
            n = st.nbytes()
            self._new.add(key)
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._release, key, n)
        if name in self._HELD:
            held = sum(_nbytes(t) for t in _tensors(out))
            self.peak = max(self.peak, self.live + held)
        return out

    def is_new(self, t: torch.Tensor) -> bool:
        return t.untyped_storage()._cdata in self._new


def _bmm_flops(a_shape, b_shape, *args, out_shape=None, **kwargs) -> int:
    """``FlopCounterMode``'s count of a batched product, which also takes
    ``bmm.dtype``'s ``out_dtype`` (torch's own formula takes it for its
    ``out_shape`` and fails)."""
    from torch.utils.flop_counter import bmm_flop

    return bmm_flop(a_shape, b_shape)


def _storage_bytes(tensors) -> int:
    seen, total = set(), 0
    for t in tensors:
        st = t.untyped_storage()
        if st._cdata not in seen:
            seen.add(st._cdata)
            total += st.nbytes()
    return total


@contextlib.contextmanager
def _environment_kept():
    """Undo what the counters write to ``os.environ`` (``FlopCounterMode``
    imports ``torch._dynamo``, which sets ``TORCHINDUCTOR_CACHE_DIR``)."""
    before = dict(os.environ)
    try:
        yield
    finally:
        for key in set(os.environ) - set(before):
            del os.environ[key]
        for key, value in before.items():
            if os.environ.get(key) != value:
                os.environ[key] = value


def analyze_step(fn, local_args, cfg: ModelConfig, shape: ShapeConfig, mesh,
                 donate=()) -> Dict:
    """The reference's ``analyze_compiled`` keys for one rank's step:
    ``fn(*local_args)`` run once on ``meta`` tensors of the rank's local
    shapes (the step's arguments as the step builder's placements shard
    them) under the counters of the module's docstring."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.launch.mesh import mesh_devices

    chips = mesh_devices(mesh)
    inputs = _tensors([_leaves(a) for a in local_args])
    donated = _tensors([_leaves(local_args[i]) for i in donate])
    argument_bytes = _storage_bytes(inputs)
    traffic = _Traffic(inputs)
    with _environment_kept():
        comm = _collective_log_mode()
        flops = FlopCounterMode(display=False,
                                custom_mapping={torch.ops.aten.bmm: _bmm_flops})
        with comm, flops, traffic:
            out = fn(*local_args)
            outs = _tensors(_leaves(out))
    new_out = _storage_bytes([t for t in outs if traffic.is_new(t)])
    donated_keys = {t.untyped_storage()._cdata for t in donated}
    alias = _storage_bytes([t for t in outs
                            if t.untyped_storage()._cdata in donated_keys])
    mem = {
        "argument_bytes": argument_bytes,
        "output_bytes": _storage_bytes(outs),
        "temp_bytes": max(traffic.peak - new_out, 0),
        "alias_bytes": alias,
    }
    per_device_bytes = (mem["argument_bytes"] + mem["temp_bytes"]
                        + mem["output_bytes"] - mem["alias_bytes"])
    coll = _inventory(comm.ops)

    n_flops = float(flops.get_total_flops())
    bytes_accessed = float(traffic.bytes)
    compute_s = n_flops / hw.PEAK_FLOPS_BF16
    memory_s = bytes_accessed / hw.HBM_BW
    collective_s = coll["wire_bytes"] / hw.ICI_BW
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": collective_s}
    dominant = max(terms, key=terms.get)

    mflops = model_flops(cfg, shape)
    mflops_per_chip = mflops / chips
    return {
        "chips": chips,
        "flops_per_device": n_flops,
        "bytes_accessed_per_device": bytes_accessed,
        # eager execution runs every operator it counts: no loop body is
        # counted once, so the uncorrected numbers are the same
        "flops_per_device_raw": n_flops,
        "bytes_accessed_per_device_raw": bytes_accessed,
        "unknown_trip_whiles": 0,
        "memory_analysis": mem,
        "per_device_bytes": per_device_bytes,
        "fits_hbm": per_device_bytes <= hw.HBM_BYTES,
        "collectives": {
            "ops": coll["ops"],
            "num_collectives": coll["num_collectives"],
            "wire_bytes": coll["wire_bytes"],
        },
        **{k: round(v, 6) for k, v in terms.items()},
        "dominant_term": dominant.replace("_s", ""),
        "model_flops_global": mflops,
        "model_flops_per_chip": mflops_per_chip,
        "useful_flops_ratio": (mflops_per_chip / n_flops) if n_flops else 0.0,
        "roofline_bound_s": max(terms.values()),
        "roofline_fraction": (
            (mflops_per_chip / hw.PEAK_FLOPS_BF16) / max(terms.values())
            if max(terms.values()) > 0
            else 0.0
        ),
    }


def _leaves(x):
    """The tensors of a step's argument or result: a module's parameters,
    a named tuple's fields, mappings and lists, or a tensor."""
    if isinstance(x, torch.nn.Module):
        return list(x.parameters())
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return [_leaves(v) for v in x]
    if isinstance(x, dict):
        return [_leaves(v) for v in x.values()]
    if isinstance(x, (list, tuple)):
        return [_leaves(v) for v in x]
    return x
