"""Hopper launch checker for the port's CUDA kernels.

The reference's checker walks ``pl.pallas_call`` BlockSpecs for a TPU's
VMEM and 128-lane tiling; none of that exists on Hopper.  Here each ``.cu``
launcher picks its grid, block and dynamic shared memory in C++ and writes
them back to Python as its wrapper's ``last_launch``, and nvcc's
``-Xptxas -v`` report (kept beside each built library,
:mod:`repro_torch.kernels.build`) gives every kernel entry's registers,
spills and static shared memory.  The checker is a pure function of those
two:

* :func:`check_launch` holds one launch against the H100 SXM's limits
  (compute capability 9.0) and returns :class:`LaunchFinding` s — *hard*
  when the launch cannot start (too many threads, registers or shared
  memory for a block or an SM), *warnings* for spills in a tier that must
  not spill and for an occupancy below the ``blocks_per_sm`` a launcher
  sized its persistent grid by;
* :func:`occupancy` gives the blocks of the launch that an SM holds at
  once and which limit sets that number;
* :func:`validate_launch` raises :class:`KernelLaunchError` on a hard
  finding (the analogue of the reference's ``KernelResourceError``);
* :func:`report_from` builds the report of a set of launches from given
  ptxas reports — the CPU tests call it on fixed inputs — and
  :func:`build_report` builds every kernel, launches each at the main
  path's ``PAPER_EVAL`` shapes (and each other tier once) on the card and
  reports them.  It raises on a host without a card: nothing is committed,
  so no report can go stale.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Mapping, Sequence, Tuple

__all__ = [
    "KernelLaunchError",
    "LaunchFinding",
    "Occupancy",
    "PALLAS_KERNELS",
    "KERNEL_TABLE",
    "launch_config",
    "ported_kernel",
    "entry_resources",
    "occupancy",
    "check_launch",
    "validate_launch",
    "report_from",
    "build_report",
]

# H100 SXM limits, compute capability 9.0: the CUDA C++ Programming Guide,
# "Technical Specifications per Compute Capability" (table of features and
# technical specifications, column 9.0).
MAX_THREADS_PER_BLOCK = 1_024
#: shared memory per block: 227 KB (with the opt-in attribute), static plus
#: dynamic
MAX_SMEM_PER_BLOCK = 232_448
#: shared memory per SM: 228 KB
SMEM_PER_SM = 233_472
#: 32-bit registers per SM (and per block)
REGS_PER_SM = 65_536
MAX_REGS_PER_THREAD = 255
MAX_BLOCKS_PER_SM = 32
MAX_WARPS_PER_SM = 64
WARP_SIZE = 32
#: shared memory the system reserves per resident block (the guide's
#: "Shared Memory" section for compute capability 8.x and 9.0: 1 KB)
SMEM_RESERVED_PER_BLOCK = 1_024
# Allocation rules of the CUDA Occupancy Calculator (``cuda_occupancy.h``
# in the toolkit) for compute capability 9.0: registers are allocated per
# warp in units of 256, each of an SM's 4 sub-partitions holds a quarter of
# the register file, and shared memory is allocated in units of 128 bytes.
REG_ALLOC_UNIT = 256
SUB_PARTITIONS = 4
SMEM_ALLOC_UNIT = 128
#: the largest grid.x of a launch
MAX_GRID_X = 2**31 - 1


class KernelLaunchError(RuntimeError):
    """A launch configuration that cannot start on the card."""


@dataclasses.dataclass(frozen=True)
class PallasKernel:
    """A TPU kernel of the reference that one of the port's entries ports."""

    key: str        # B1..B4
    name: str       # the Pallas kernel body's function
    location: str   # file:line of that body


#: the reference's four Pallas kernels (each reaches ``pl.pallas_call``)
PALLAS_KERNELS: Dict[str, PallasKernel] = {
    k.key: k for k in (
        PallasKernel("B1", "dfg_kernel",
                     "src/repro/kernels/dfg_count/kernel.py:34"),
        PallasKernel("B2", "dfg_dice_kernel",
                     "src/repro/kernels/dfg_count/kernel.py:61"),
        PallasKernel("B3", "segment_count_kernel",
                     "src/repro/kernels/segment_count/kernel.py:31"),
        PallasKernel("B4", "align_dp_kernel",
                     "src/repro/kernels/align_dp/kernel.py:39"),
    )
}


@dataclasses.dataclass(frozen=True)
class LibraryEntry:
    """One tier of a kernel library: the ``last_launch["branch"]`` it
    reports, the ptxas entry it launches (a pattern over the mangled name,
    formatted with the launch's template arguments), the Pallas kernels it
    ports and whether it must not spill."""

    library: str
    tier: str
    entry: str
    ports: Tuple[str, ...]
    no_spill: bool


#: (library, tier) → entry.  ``dfg_count`` ports B1, and B2 when its window
#: is on; ``segment_count`` keeps a thread's 16 ids in registers and
#: ``align_dp``'s register tier its DP front, so neither may spill.
KERNEL_TABLE: Dict[Tuple[str, str], LibraryEntry] = {
    (e.library, e.tier): e for e in (
        LibraryEntry("dfg_count", "shared",
                     r"dfg_count_kernelILb{window}ELb{shifted}ENS_\d+"
                     r"DenseTableE", ("B1", "B2"), False),
        LibraryEntry("dfg_count", "hash",
                     r"dfg_count_kernelILb{window}ELb{shifted}ENS_\d+"
                     r"HashTableE", ("B1", "B2"), False),
        LibraryEntry("segment_count", "shared",
                     r"segment_count_kernelILb{valid}ELb1E", ("B3",), True),
        LibraryEntry("segment_count", "global",
                     r"segment_count_kernelILb{valid}ELb0E", ("B3",), True),
        LibraryEntry("align_dp", "registers",
                     r"align_dp_registersILi{k}ELi\d+E", ("B4",), True),
        LibraryEntry("align_dp", "shared", r"align_dp_memoryILb1E",
                     ("B4",), False),
        LibraryEntry("align_dp", "global", r"align_dp_memoryILb0E",
                     ("B4",), False),
    )
}


@dataclasses.dataclass(frozen=True)
class LaunchFinding:
    severity: str   # "hard" or "warning"
    check: str      # the limit or rule
    message: str

    def format(self) -> str:
        return f"[{self.severity}] {self.check}: {self.message}"


@dataclasses.dataclass(frozen=True)
class Occupancy:
    """Resident blocks of one launch per SM and the limit that sets them."""

    blocks_per_sm: int
    limit: str


def launch_config(library: str, last_launch: Mapping) -> Dict[str, object]:
    """A wrapper's ``last_launch`` named by its library."""
    return {**dict(last_launch), "library": library}


def _entry(config: Mapping) -> LibraryEntry:
    key = (config["library"], config["branch"])
    if key not in KERNEL_TABLE:
        raise KeyError(f"no kernel entry for library {key[0]!r}, "
                       f"tier {key[1]!r}")
    return KERNEL_TABLE[key]


def ported_kernel(config: Mapping) -> PallasKernel:
    """The Pallas kernel that this launch stands in for."""
    ports = _entry(config).ports
    if config["library"] == "dfg_count":
        return PALLAS_KERNELS["B2" if config.get("window") else "B1"]
    return PALLAS_KERNELS[ports[0]]


def entry_resources(
    config: Mapping, resources: Mapping[str, Mapping[str, int]]
) -> Tuple[str, Dict[str, int]]:
    """``(mangled entry, its resources)`` of the kernel this launch ran,
    from a library's parsed ptxas report
    (:func:`repro_torch.kernels.build.ptxas_resources`)."""
    pattern = _entry(config).entry.format(
        window=int(bool(config.get("window"))),
        shifted=int(config.get("columns") == "shifted"),
        valid=int(bool(config.get("valid"))),
        k=config.get("k"),
    )
    hits = [e for e in resources if re.search(pattern, e)]
    if len(hits) != 1:
        raise KeyError(f"{len(hits)} ptxas entries match {pattern!r} "
                       f"(entries: {sorted(resources)})")
    return hits[0], dict(resources[hits[0]])


def _ceil_to(x: int, unit: int) -> int:
    return -(-x // unit) * unit


def _block_smem(config: Mapping, resources: Mapping) -> int:
    return int(config.get("smem_bytes", 0)) + int(resources.get("smem", 0))


def occupancy(config: Mapping, resources: Mapping) -> Occupancy:
    """Blocks of this launch an SM holds at once, by the Occupancy
    Calculator's rules: the least of the block slots, the warp slots, the
    registers (per warp, in 256-register units, per sub-partition) and the
    shared memory (static + dynamic + the 1 KB reserved, in 128-byte
    units).  0 when a block does not fit at all."""
    threads = int(config["threads"])
    warps = max(-(-threads // WARP_SIZE), 1)
    regs = int(resources.get("registers", 0))
    by = {"blocks": MAX_BLOCKS_PER_SM, "warps": MAX_WARPS_PER_SM // warps}
    if regs:
        per_warp = _ceil_to(regs * WARP_SIZE, REG_ALLOC_UNIT)
        per_part = (REGS_PER_SM // SUB_PARTITIONS) // per_warp
        by["registers"] = (per_part * SUB_PARTITIONS) // warps
    else:
        by["registers"] = MAX_BLOCKS_PER_SM
    smem = _ceil_to(_block_smem(config, resources) + SMEM_RESERVED_PER_BLOCK,
                    SMEM_ALLOC_UNIT)
    by["shared memory"] = SMEM_PER_SM // smem
    if threads > MAX_THREADS_PER_BLOCK or regs > MAX_REGS_PER_THREAD:
        by["threads" if threads > MAX_THREADS_PER_BLOCK else "registers"] = 0
    limit = min(by, key=lambda k: (by[k], list(by).index(k)))
    return Occupancy(by[limit], limit)


def check_launch(config: Mapping, resources: Mapping) -> List[LaunchFinding]:
    """Findings of one launch (``config``: a :func:`launch_config`;
    ``resources``: its entry's registers, spills and static shared memory)
    against the H100's limits.  Hard findings are launches that cannot
    start; warnings are spills where the tier must not spill and an
    occupancy below the ``blocks_per_sm`` the launcher wrote back."""
    entry = _entry(config)
    out: List[LaunchFinding] = []

    def hard(check, msg):
        out.append(LaunchFinding("hard", check, msg))

    threads = int(config["threads"])
    grid = int(config["grid"])
    regs = int(resources.get("registers", 0))
    smem = _block_smem(config, resources)
    if not 1 <= threads <= MAX_THREADS_PER_BLOCK:
        hard("threads per block", f"{threads} threads, the card allows "
             f"1..{MAX_THREADS_PER_BLOCK}")
    if not 1 <= grid <= MAX_GRID_X:
        hard("grid", f"grid {grid}, the card allows 1..{MAX_GRID_X}")
    if smem > MAX_SMEM_PER_BLOCK:
        hard("shared memory per block", f"{smem} B (static "
             f"{int(resources.get('smem', 0))} + dynamic "
             f"{int(config.get('smem_bytes', 0))}) over "
             f"{MAX_SMEM_PER_BLOCK} B")
    if smem + SMEM_RESERVED_PER_BLOCK > SMEM_PER_SM:
        hard("shared memory per SM", f"{smem} B + {SMEM_RESERVED_PER_BLOCK} "
             f"B reserved over {SMEM_PER_SM} B")
    if regs > MAX_REGS_PER_THREAD:
        hard("registers per thread", f"{regs} over {MAX_REGS_PER_THREAD}")
    block_regs = _ceil_to(regs * WARP_SIZE, REG_ALLOC_UNIT) \
        * -(-threads // WARP_SIZE)
    if block_regs > REGS_PER_SM:
        hard("registers per SM", f"{regs} registers x {threads} threads "
             f"allocate {block_regs} of {REGS_PER_SM}")
    occ = occupancy(config, resources)
    if not out and occ.blocks_per_sm < 1:
        hard("occupancy", f"no block fits an SM (limit: {occ.limit})")
    spills = int(resources.get("spill_stores", 0)) + int(
        resources.get("spill_loads", 0))
    if spills and entry.no_spill:
        out.append(LaunchFinding(
            "warning", "spills", f"{config['library']} {config['branch']} "
            f"spills {resources.get('spill_stores', 0)} B stored / "
            f"{resources.get('spill_loads', 0)} B loaded; this tier must "
            "not spill"))
    want = config.get("blocks_per_sm")
    if want is not None and occ.blocks_per_sm < int(want):
        out.append(LaunchFinding(
            "warning", "occupancy", f"the launcher sized its grid for "
            f"{int(want)} blocks per SM; the card holds "
            f"{occ.blocks_per_sm} (limit: {occ.limit})"))
    return out


def validate_launch(config: Mapping, resources: Mapping) -> List[LaunchFinding]:
    """:func:`check_launch`, raising :class:`KernelLaunchError` on any hard
    finding; returns the warnings."""
    found = check_launch(config, resources)
    hard = [f for f in found if f.severity == "hard"]
    if hard:
        raise KernelLaunchError(
            f"{config.get('library')} {config.get('branch')}: "
            + "; ".join(f.format() for f in hard))
    return found


def report_from(
    records: Mapping[str, Mapping[str, Mapping[str, int]]],
    launches: Sequence[Mapping],
) -> Dict[str, object]:
    """The launch report of ``launches`` (each a :func:`launch_config`,
    optionally with a ``scenario`` name) against ``records`` (library →
    parsed ptxas report).  Pure: the CPU tests call it on fixed inputs."""
    rows = []
    for config in launches:
        entry, res = entry_resources(config, records[config["library"]])
        occ = occupancy(config, res)
        pk = ported_kernel(config)
        rows.append({
            "scenario": config.get("scenario"),
            "library": config["library"],
            "tier": config["branch"],
            "ports": f"{pk.key} {pk.name} ({pk.location})",
            "entry": entry,
            "grid": int(config["grid"]),
            "threads": int(config["threads"]),
            "dynamic_smem_bytes": int(config.get("smem_bytes", 0)),
            "static_smem_bytes": int(res.get("smem", 0)),
            "registers": int(res.get("registers", 0)),
            "spill_bytes": int(res.get("spill_stores", 0))
            + int(res.get("spill_loads", 0)),
            "blocks_per_sm": occ.blocks_per_sm,
            "limit": occ.limit,
            "launcher_blocks_per_sm": config.get("blocks_per_sm"),
            "findings": [dataclasses.asdict(f)
                         for f in check_launch(config, res)],
        })
    count = {s: sum(f["severity"] == s for r in rows for f in r["findings"])
             for s in ("hard", "warning")}
    return {
        "limits": {
            "max_threads_per_block": MAX_THREADS_PER_BLOCK,
            "max_smem_per_block": MAX_SMEM_PER_BLOCK,
            "smem_per_sm": SMEM_PER_SM,
            "regs_per_sm": REGS_PER_SM,
            "max_regs_per_thread": MAX_REGS_PER_THREAD,
            "max_blocks_per_sm": MAX_BLOCKS_PER_SM,
            "max_warps_per_sm": MAX_WARPS_PER_SM,
        },
        "configurations": len(rows),
        "hard": count["hard"],
        "warnings": count["warning"],
        "launches": rows,
    }


# ---------------------------------------------------------------------------
# On the card: build, launch at the main path's shapes, report
# ---------------------------------------------------------------------------

#: PAPER_EVAL's main-path shapes (PERF.md §6): 7,200,010 events, 600
#: activities; the alignment DP over 294,838 variants of 5,901,760 ids in
#: all and 601 model states
PAPER_EVAL_PAIRS = 7_200_009
PAPER_EVAL_ACTIVITIES = 600
PAPER_EVAL_VARIANTS = 294_838
PAPER_EVAL_ALIGN_IDS = 5_901_760
PAPER_EVAL_STATES = 601


def _launches_on_card(device: str = "cuda") -> List[Dict[str, object]]:
    """Launch each kernel at the main path's shapes (and each other tier
    once at a small shape) on the card; returns their configurations."""
    import numpy as np
    import torch

    from repro_torch.device import resolve_device
    from repro_torch.kernels.align_dp import ops as dp_ops
    from repro_torch.kernels.dfg_count import ops as dfg_ops
    from repro_torch.kernels.segment_count import ops as seg_ops

    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("build_report launches the kernels on a CUDA card")
    gen = torch.Generator(device=dev).manual_seed(0)
    out: List[Dict[str, object]] = []

    def dfg(scenario, n, a, window, shifted):
        col = torch.randint(0, a, (n + 1,), generator=gen, device=dev,
                            dtype=torch.int32)
        src, dst = col[:-1], (col[1:] if shifted else col[1:].clone())
        valid = torch.ones(n, dtype=torch.uint8, device=dev)
        ts = torch.arange(n + 1, dtype=torch.float64, device=dev)
        psi = torch.zeros((a, a), dtype=torch.int64, device=dev)
        dfg_ops.launch(src, dst, valid, psi, a,
                       ts[:-1] if window else None,
                       ts[1:] if window else None,
                       (0.0, n / 4.0) if window else None)
        out.append(launch_config("dfg_count", dict(dfg_ops.last_launch,
                                                   scenario=scenario)))

    def seg(scenario, n, s, valid):
        ids = torch.randint(0, s, (n,), generator=gen, device=dev,
                            dtype=torch.int32)
        v = torch.ones(n, dtype=torch.uint8, device=dev) if valid else None
        counts = torch.zeros((s,), dtype=torch.int64, device=dev)
        seg_ops.launch(ids, v, counts, s)
        out.append(launch_config("segment_count", dict(
            seg_ops.last_launch, scenario=scenario)))

    def align(scenario, v, total, s, a=PAPER_EVAL_ACTIVITIES):
        # the DP's state axis is max(S, A): it covers every sync column
        rng = np.random.default_rng(0)
        cuts = np.sort(rng.choice(np.arange(1, total), v - 1, replace=False))
        offsets = np.concatenate([[0], cuts, [total]]).astype(np.int64)
        ids = rng.integers(0, a, total).astype(np.int32)
        m = rng.integers(0, 6, (s, a)).astype(np.float32)
        d0 = np.zeros(s, dtype=np.float32)
        end = np.zeros(s, dtype=np.float32)
        args = dp_ops.prepare_ragged(ids, offsets, m, d0, end, dev)
        cost = torch.empty((v,), dtype=torch.float32, device=dev)
        dp_ops.launch(*args, cost)
        out.append(launch_config("align_dp", dict(dp_ops.last_launch,
                                                  scenario=scenario)))

    n, a = PAPER_EVAL_PAIRS, PAPER_EVAL_ACTIVITIES
    dfg("B1 main-path DFG", n, a, False, True)
    dfg("B1 graph build (separate columns)", n, a, False, False)
    dfg("B2 30-day dice", n, a, True, True)
    seg("B3 graph build node counts", n + 1, a, False)
    align("B4 alignments", PAPER_EVAL_VARIANTS, PAPER_EVAL_ALIGN_IDS,
          PAPER_EVAL_STATES)
    # each other tier once, at a small shape
    dfg("B1 shared branch (the CLI's A = 32)", 1 << 20, 32, False, True)
    seg("B3 valid column", 1 << 20, a, True)
    seg("B3 global branch (S = 60,000)", 1 << 20, 60_000, False)
    align("B4 registers tier, K = 32", 4_096, 4_096 * 16, 1_024)
    align("B4 shared tier", 4_096, 4_096 * 16, 300, a=64)
    align("B4 global tier", 1_024, 1_024 * 16, 8_000)
    torch.cuda.synchronize(dev)
    return out


def build_report(device: str = "cuda") -> Dict[str, object]:
    """Build every kernel library, launch each kernel at the main path's
    ``PAPER_EVAL`` shapes on the card and report the launches against the
    builds' ptxas resources.  Raises on a host without a card."""
    from repro_torch.device import resolve_device
    from repro_torch.kernels import build

    resolve_device(device)
    records = {r.name: build.ptxas_resources(r.ptxas)
               for r in build.build_all()}
    return report_from(records, _launches_on_card(device))


def format_report(report: Mapping) -> List[str]:
    """One line per launch: scenario, tier, resident blocks per SM and the
    limit that sets them, findings."""
    lines = []
    for r in report["launches"]:
        found = "; ".join(f"[{f['severity']}] {f['check']}"
                          for f in r["findings"]) or "clean"
        lines.append(
            f"{r['scenario'] or r['library']}: {r['library']} {r['tier']} "
            f"grid {r['grid']} x {r['threads']}, {r['registers']} regs, "
            f"smem {r['dynamic_smem_bytes']} + {r['static_smem_bytes']} B "
            f"-> {r['blocks_per_sm']} blocks/SM (limit: {r['limit']}); "
            f"{found}")
    return lines
