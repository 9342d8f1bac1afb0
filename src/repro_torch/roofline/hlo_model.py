"""Static execution model over compiled (SPMD-partitioned) HLO text.

``compiled.cost_analysis()`` counts while-loop bodies ONCE — under a
scan-over-layers design that under-reports FLOPs/bytes/collectives by the
trip count (×n_layers, ×microbatches, …).  This module parses the HLO text
into its computation graph, walks calls/whiles/fusions with **multipliers
from ``known_trip_count`` annotations**, and accumulates:

* ``dot_flops``  — 2 · |result| · contracted-dim, per dot, × multiplier
  (matmul FLOPs, the quantity MFU is defined on);
* ``hbm_bytes``  — fusion-boundary traffic: Σ (operands + result) bytes of
  top-level ops (free ops excluded; dynamic-slice/gather charge the slice,
  not the sliced operand), × multiplier;
* ``collective_wire`` — per-device wire bytes with ring factors, × mult.

This is an analytic model of the *per-device execution*, exact on the
structure the compiler actually emitted.

The port's copy of the reference's parser (pure Python, no compiler
behind it): the port reads the reference's dry-run HLO text and artifacts
with it, and holds its own analysis (:mod:`repro_torch.roofline.analyze`)
to the same key set.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Tuple

__all__ = ["HloModel", "parse_hlo", "DTYPE_BYTES"]

DTYPE_BYTES = {
    "f64": 8, "f32": 4, "bf16": 2, "f16": 2, "f8e4m3fn": 1, "f8e5m2": 1,
    "s64": 8, "u64": 8, "s32": 4, "u32": 4, "s16": 2, "u16": 2,
    "s8": 1, "u8": 1, "pred": 1, "c64": 8, "c128": 16, "token": 0,
}

_COMP_RE = re.compile(r"^(ENTRY\s+)?%?([\w.\-]+)\s*\((.*)\)\s*->\s*.*\{\s*$")
_OP_RE = re.compile(
    r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=\s*(\(.*?\)|[\w\[\]{},]+)\s+([\w\-]+)\((.*)$"
)
_SHAPE_RE = re.compile(r"([a-z0-9]+)\[([0-9,]*)\]")
_TRIP_RE = re.compile(r'known_trip_count[^0-9]*"(\d+)"')
_GROUPS_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]")
_GROUPS_BRACE_RE = re.compile(r"replica_groups=\{\{([0-9,]+)\}")
_CALL_ATTR_RE = re.compile(
    r"(?:calls|to_apply|body|condition)=%?([\w.\-]+)"
)
_BRANCH_RE = re.compile(r"branch_computations=\{([^}]*)\}")

FREE_OPS = {
    "parameter", "constant", "get-tuple-element", "tuple", "bitcast",
    "after-all", "iota", "partition-id", "replica-id",
    # control ops: their carried buffers alias in place; the traffic is
    # charged inside the body computations (× trip count)
    "while", "conditional", "call",
}
SLICE_RESULT_ONLY = {"dynamic-slice", "gather", "slice", "broadcast"}
UPDATE_CHARGED = {"dynamic-update-slice", "scatter"}
COLLECTIVES = {
    "all-reduce", "all-gather", "reduce-scatter", "all-to-all",
    "collective-permute", "all-reduce-start", "all-gather-start",
    "collective-permute-start",
}


def _shapes(text: str) -> List[Tuple[str, List[int]]]:
    out = []
    for dt, dims in _SHAPE_RE.findall(text):
        if dt in DTYPE_BYTES:
            out.append((dt, [int(d) for d in dims.split(",") if d]))
    return out


def _shape_bytes(text: str) -> int:
    total = 0
    for dt, dims in _shapes(text):
        n = 1
        for d in dims:
            n *= d
        total += n * DTYPE_BYTES[dt]
    return total


@dataclasses.dataclass
class Op:
    name: str
    result: str  # type text
    instr: str
    line: str
    args: List[str]


@dataclasses.dataclass
class Computation:
    name: str
    params: Dict[str, str]  # param name -> type text
    ops: Dict[str, Op]


def parse_hlo(text: str) -> Dict[str, Computation]:
    comps: Dict[str, Computation] = {}
    cur: Optional[Computation] = None
    entry_name = None
    for raw in text.splitlines():
        m = _COMP_RE.match(raw)
        if m:
            name = m.group(2)
            params: Dict[str, str] = {}
            for p in re.finditer(r"%?([\w.\-]+):\s*((?:\([^)]*\))|[^,)]+)",
                                 m.group(3)):
                params[p.group(1)] = p.group(2)
            cur = Computation(name=name, params=params, ops={})
            comps[name] = cur
            if m.group(1):
                entry_name = name
            continue
        if cur is None:
            continue
        if raw.strip() == "}":
            cur = None
            continue
        om = _OP_RE.match(raw)
        if om:
            name, rtype, instr, rest = om.groups()
            args = re.findall(r"%([\w.\-]+)", rest.split("),", 1)[0])
            cur.ops[name] = Op(name, rtype, instr, raw, args)
    if entry_name:
        comps["__entry__"] = comps[entry_name]
    return comps


class HloModel:
    def __init__(self, text: str):
        self.comps = parse_hlo(text)
        self.dot_flops = 0.0
        self.hbm_bytes = 0.0
        self.collective_wire = 0.0
        self.collective_ops: Dict[str, Dict] = {}
        self.unknown_trip_whiles = 0
        self._fused: set = set()
        self._mark_fused()
        entry = self.comps.get("__entry__")
        if entry is not None:
            self._walk(entry, 1.0, set())

    # -- helpers ----------------------------------------------------------
    def _mark_fused(self):
        for comp in self.comps.values():
            for op in comp.ops.values():
                if op.instr == "fusion":
                    cm = _CALL_ATTR_RE.search(op.line)
                    if cm:
                        self._fused.add(cm.group(1))

    def _type_of(self, comp: Computation, name: str) -> Optional[str]:
        if name in comp.ops:
            return comp.ops[name].result
        if name in comp.params:
            return comp.params[name]
        return None

    def _dot_flops(self, comp: Computation, op: Op) -> float:
        res = _shapes(op.result)
        n_out = 0
        for dt, dims in res:
            k = 1
            for d in dims:
                k *= d
            n_out += k
        cm = re.search(r"lhs_contracting_dims=\{([0-9,]*)\}", op.line)
        contract = 1
        if cm and op.args:
            lhs_t = self._type_of(comp, op.args[0])
            if lhs_t:
                lhs_shapes = _shapes(lhs_t)
                if lhs_shapes:
                    dims = lhs_shapes[0][1]
                    for idx in cm.group(1).split(","):
                        if idx and int(idx) < len(dims):
                            contract *= dims[int(idx)]
        return 2.0 * n_out * contract

    def _op_bytes(self, comp: Computation, op: Op) -> float:
        if op.instr in FREE_OPS:
            return 0.0
        if op.instr in SLICE_RESULT_ONLY:
            return 2.0 * _shape_bytes(op.result)  # read slice + write result
        if op.instr in UPDATE_CHARGED and len(op.args) >= 2:
            t = self._type_of(comp, op.args[1])
            return 2.0 * _shape_bytes(t or op.result)
        if op.instr == "fusion":
            cm = _CALL_ATTR_RE.search(op.line)
            sub = self.comps.get(cm.group(1)) if cm else None
            if sub:
                return self._fusion_bytes(sub)
        total = _shape_bytes(op.result)
        for a in op.args:
            t = self._type_of(comp, a)
            if t:
                total += _shape_bytes(t)
        return float(total)

    def _chase(self, sub: Computation, name: str) -> str:
        """Follow convert/bitcast/copy chains back to the producing op."""
        seen = set()
        while (
            name in sub.ops
            and sub.ops[name].instr in ("convert", "bitcast", "copy")
            and sub.ops[name].args
            and name not in seen
        ):
            seen.add(name)
            name = sub.ops[name].args[0]
        return name

    def _fusion_bytes(self, sub: Computation) -> float:
        """Fusion I/O model: internal ops are in-register; HBM traffic is
        what the fusion *reads from parameters* and *writes as result*.

        - a parameter that is the (convert-chained) target of an internal
          dynamic-update-slice is an in-place update → charge 2×update;
        - a parameter consumed only through dynamic-slice/gather → charge
          the slices, not the buffer (a 60-layer stacked cache read per
          scan step would otherwise be charged wholesale);
        - the result is a write unless the root chains to an in-place DUS.
        """
        uses: Dict[str, List[Op]] = {p: [] for p in sub.params}
        root: Optional[Op] = None
        for o in sub.ops.values():
            if "ROOT" in o.line:
                root = o
            for a in o.args:
                if a in uses:
                    uses[a].append(o)

        total = 0.0
        dus_targets = set()
        for o in sub.ops.values():
            if o.instr in UPDATE_CHARGED and o.args:
                if len(o.args) >= 2:
                    t = self._type_of(sub, o.args[1])
                    total += 2.0 * _shape_bytes(t or "")
                dus_targets.add(self._chase(sub, o.args[0]))

        for p, ptype in sub.params.items():
            if p in dus_targets:
                continue  # charged via the update region
            pu = uses.get(p, [])
            direct = [u for u in pu if u.instr not in ("convert", "bitcast")]
            chained = [
                o for o in sub.ops.values()
                if o.args and self._chase(sub, o.args[0]) == p
            ]
            readers = direct or chained or pu
            if readers and all(
                u.instr in ("dynamic-slice", "gather") for u in readers
            ):
                for u in readers:
                    total += _shape_bytes(u.result)
            else:
                total += _shape_bytes(ptype)

        if root is not None:
            root_src = self._chase(sub, root.name)
            if not (
                root_src in sub.ops
                and sub.ops[root_src].instr in UPDATE_CHARGED
            ):
                total += _shape_bytes(root.result)
        return total

    def _collective(self, op: Op, mult: float):
        kind = op.instr.replace("-start", "")
        bytes_ = _shape_bytes(op.result)
        gm = _GROUPS_RE.search(op.line)
        if gm:
            n = int(gm.group(2))
        else:
            gb = _GROUPS_BRACE_RE.search(op.line)
            n = len(gb.group(1).split(",")) if gb else 2
        n = max(n, 2)
        if kind == "all-reduce":
            wire = 2.0 * (n - 1) / n * bytes_
        elif kind == "all-gather":
            wire = (n - 1) / n * bytes_
        elif kind == "reduce-scatter":
            wire = float(n - 1) * bytes_
        elif kind == "all-to-all":
            wire = (n - 1) / n * bytes_
        else:
            wire = float(bytes_)
        self.collective_wire += wire * mult
        slot = self.collective_ops.setdefault(
            kind, {"count": 0.0, "bytes": 0.0, "wire": 0.0}
        )
        slot["count"] += mult
        slot["bytes"] += bytes_ * mult
        slot["wire"] += wire * mult

    # -- traversal -------------------------------------------------------------
    def _walk(self, comp: Computation, mult: float, stack: set):
        if comp.name in stack:  # defensive: no recursion in HLO
            return
        stack = stack | {comp.name}
        in_fusion = comp.name in self._fused
        for op in comp.ops.values():
            if op.instr == "dot":
                self.dot_flops += self._dot_flops(comp, op) * mult
            if op.instr in COLLECTIVES and "-done" not in op.instr:
                self._collective(op, mult)
            if not in_fusion:
                self.hbm_bytes += self._op_bytes(comp, op) * mult

            if op.instr == "while":
                tm = _TRIP_RE.search(op.line)
                trip = float(tm.group(1)) if tm else 1.0
                if tm is None:
                    self.unknown_trip_whiles += 1
                for ref in _CALL_ATTR_RE.finditer(op.line):
                    sub = self.comps.get(ref.group(1))
                    if sub:
                        self._walk(sub, mult * trip, stack)
            elif op.instr == "fusion":
                cm = _CALL_ATTR_RE.search(op.line)
                if cm and cm.group(1) in self.comps:
                    self._walk(self.comps[cm.group(1)], mult, stack)
            elif op.instr in ("call", "custom-call", "reduce", "scatter",
                              "sort", "map", "reduce-window", "select-and-scatter"):
                for ref in _CALL_ATTR_RE.finditer(op.line):
                    sub = self.comps.get(ref.group(1))
                    if sub:
                        self._walk(sub, mult, stack)
            elif op.instr == "conditional":
                bm = _BRANCH_RE.search(op.line)
                if bm:
                    for nm in re.findall(r"%([\w.\-]+)", bm.group(1)):
                        sub = self.comps.get(nm)
                        if sub:
                            self._walk(sub, mult, stack)

    def summary(self) -> Dict:
        return {
            "dot_flops": self.dot_flops,
            "hbm_bytes": self.hbm_bytes,
            "collective_wire_bytes": self.collective_wire,
            "collective_ops": self.collective_ops,
            "num_collectives": sum(
                v["count"] for v in self.collective_ops.values()
            ),
            "unknown_trip_whiles": self.unknown_trip_whiles,
        }
