"""Compile a kernel's CUDA source with g++ for the CPU.

``cuda_runtime.h`` in this directory stands in for the CUDA runtime and
device language: a block's threads are racing ``std::thread``s over one
shared-memory buffer, atomics are GCC's.  :func:`emulation_source` rewrites
the two constructs g++ cannot parse, and :func:`compile_emulated` builds the
result into a shared library that the kernel's own ctypes wrapper can
drive on CPU tensors.  It skips the calling test where g++ with C++20 is
missing."""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import pytest

SHIM = Path(__file__).parent


def emulation_source(cuda: str) -> str:
    """``cuda`` with its launch ``k<<<grid, block, smem, stream>>>(args)``
    turned into ``emu::launch(k, grid, block, smem, stream, args)`` and its
    dynamic shared-memory declaration ``extern __shared__ T name[];`` into
    a pointer to the emulated block's buffer.  Asserts that the source has
    exactly one of each, so a construct the rewrite misses fails here
    rather than in g++."""
    cuda, n_launches = re.subn(
        r"(\w+)<<<(.*?)>>>\((.*?)\);", r"emu::launch(\1, \2, \3);", cuda,
        flags=re.S,
    )
    cuda, n_shared = re.subn(
        r"extern\s+__shared__\s+(?:__align__\(\d+\)\s+)?"
        r"((?:unsigned\s+)?\w+)\s+(\w+)\[\];",
        r"\1* \2 = reinterpret_cast<\1*>(emu::dynamic_smem());", cuda,
    )
    assert (n_launches, n_shared) == (1, 1), (n_launches, n_shared)
    return cuda


def compile_emulated(source: Path, tmp: Path) -> ctypes.CDLL:
    """The library g++ builds from :func:`emulation_source` of ``source``
    in directory ``tmp``, loaded."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernel source for the CPU")
    cpp = tmp / f"{source.stem}_emu.cpp"
    cpp.write_text(emulation_source(source.read_text()))
    so = tmp / f"lib{source.stem}_emu.so"
    res = subprocess.run(
        [gxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
         f"-I{SHIM}", "-o", str(so), str(cpp)],
        capture_output=True, text=True, timeout=300,
    )
    if res.returncode and "barrier" in res.stderr:
        pytest.skip("needs a g++ with C++20's <barrier>")
    assert res.returncode == 0, res.stderr
    return ctypes.CDLL(str(so))
