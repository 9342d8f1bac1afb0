"""The port stands alone and never falls back: no file of ``repro_torch`` (or
``chip_smoke.py``) imports JAX or the reference package, it imports and
answers CPU queries (a DFG, a graph-store process map) with both blocked, and its entry points refuse to run
on a card that is not there."""

import ast
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.core.dfg import dfg
from repro_torch.core.repository import paper_example_repo
from repro_torch.query import Q, QueryEngine, set_default_engine

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"
]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize(
    "path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT))
)
def test_port_file_imports_neither_jax_nor_the_reference(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


BLOCKED_RUN = r"""
import importlib.abc, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro"):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
from repro_torch.core.repository import paper_example_repo
from repro_torch.data import generate_repository
from repro_torch.query import Q, QueryEngine
import repro_torch.launch.mine, repro_torch.configs
import repro_torch.graph

engine = QueryEngine(device="cpu", tiny_pairs=8)
repo = generate_repository(60, seed=1)
res = Q.log(repo).using(engine).window(0, 40 * 86400.0).dfg(backend="kernel")
assert res.physical.fused_dicing, res.physical
pm = Q.log(repo).using(engine).process_map(top=0.5, backend="graph")
assert pm.physical.backend == "graph" and pm.value.edges, pm.physical
print(int(res.value.sum()), sorted(m for m in sys.modules if m.startswith("jax")))
"""


def test_port_runs_with_jax_and_the_reference_blocked():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-c", BLOCKED_RUN], capture_output=True, text=True,
        env=env, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    total, jax_modules = out.stdout.split(maxsplit=1)
    assert int(total) > 0 and jax_modules.strip() == "[]"


def test_entry_points_refuse_a_missing_card(monkeypatch):
    """Without a card, the default device is an error, never the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    repo = paper_example_repo()
    src, dst, valid = repo.df_pairs()
    with pytest.raises(RuntimeError, match="CUDA"):
        QueryEngine()
    with pytest.raises(RuntimeError, match="CUDA"):
        dfg(src, dst, valid, repo.num_activities, backend="kernel")
    with pytest.raises(RuntimeError, match="CUDA"):
        dfg(src, dst, valid, repo.num_activities)
    set_default_engine(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        Q.log(repo).dfg()
    # asking for the host explicitly works
    psi = dfg(src, dst, valid, repo.num_activities, backend="kernel", device="cpu")
    np.testing.assert_array_equal(psi, [[0, 1, 0, 0], [0, 0, 2, 0],
                                        [0, 0, 0, 1], [0, 0, 0, 0]])


def test_mine_cli_refuses_a_missing_card():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.mine", "--events", "2000"],
        capture_output=True, text=True, env=env, timeout=120,
    )
    assert out.returncode != 0
    assert "CUDA" in out.stderr and out.stdout == ""


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_fails_without_card_or_checkout(tmp_path, where):
    """Run without a card (or from a directory holding only the script), the
    smoke test exits non-zero and prints no result line."""
    script = ROOT / "chip_smoke.py"
    if where == "alone":
        script = pathlib.Path(shutil.copy(script, tmp_path / "chip_smoke.py"))
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, str(script)], capture_output=True, text=True,
        env=env, cwd=script.parent, timeout=120,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
