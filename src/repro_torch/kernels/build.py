"""Build the port's CUDA sources into shared libraries at first use.

Each ``csrc/*.cu`` file exposes a plain C interface.  It is compiled with
``nvcc`` for Hopper (``sm_90a``) into ``build/kernels/`` at the root of the
checkout and loaded with :mod:`ctypes`; no PyTorch headers are involved, so
a build takes seconds.  The library name carries a digest of the source and
the flags, so an edited source is never served from a stale build.

Nothing here runs at import time: the first kernel launch (or an explicit
:func:`build_all`) compiles.  :func:`build_all` starts one ``nvcc`` per
source, all together, and waits for them all.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

__all__ = ["SOURCES", "BuildRecord", "build", "build_all", "load", "find_nvcc"]

_PKG = Path(__file__).resolve().parent
#: repo root for a source checkout (``src/repro_torch/kernels`` → root)
BUILD_DIR = _PKG.parents[2] / "build" / "kernels"

#: kernel library name → CUDA source
SOURCES: Dict[str, Path] = {
    "dfg_count": _PKG / "dfg_count" / "csrc" / "dfg_count.cu",
    "segment_count": _PKG / "segment_count" / "csrc" / "segment_count.cu",
}

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]


@dataclasses.dataclass
class BuildRecord:
    name: str
    path: Path
    seconds: float  # 0.0 when an identical build was already on disk
    ptxas: str  # nvcc's -Xptxas -v report (registers, shared memory, spills)


_libs: Dict[str, ctypes.CDLL] = {}
_records: Dict[str, BuildRecord] = {}
_lock = threading.Lock()


def find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found on PATH or under $CUDA_HOME/bin; the CUDA toolkit is "
        "needed to build the port's kernels"
    )


def _target(name: str) -> Path:
    h = hashlib.sha256(SOURCES[name].read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build_all(names: Optional[Sequence[str]] = None) -> List[BuildRecord]:
    """Compile the libraries ``names`` (default: every source) that are not
    on disk yet, one ``nvcc`` each, all started together.  Raises with the
    compiler's output when an ``nvcc`` fails."""
    names = list(SOURCES if names is None else names)
    with _lock:
        started = {}
        for name in names:
            if name in _records or name in started:
                continue
            out = _target(name)
            if out.exists():
                _records[name] = BuildRecord(name, out, 0.0, "(already built)")
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])]
            proc = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True,
            )
            started[name] = (proc, tmp, out, time.perf_counter())
        failed = []
        for name, (proc, tmp, out, t0) in started.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"nvcc failed for {name} (exit "
                              f"{proc.returncode}):\n{log}")
                continue
            os.replace(tmp, out)
            _records[name] = BuildRecord(
                name, out, time.perf_counter() - t0, log.strip()
            )
        if failed:
            raise RuntimeError("\n".join(failed))
        return [_records[name] for name in names]


def build(name: str) -> BuildRecord:
    """Compile library ``name`` unless it is on disk already."""
    return build_all([name])[0]


def load(name: str) -> ctypes.CDLL:
    """The built library ``name``, building it on first use."""
    rec = build(name)
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = ctypes.CDLL(str(rec.path))
    return lib
