"""The port stands alone and never falls back: no file of ``repro_torch`` (or
``chip_smoke.py``) imports JAX or the reference package, it imports and
answers CPU queries (a DFG, a graph-store process map, replay fitness and
alignments, service requests with their introspection sinks and a trace
store read back, a transport request and the lint rules over its own tree)
with both blocked, and its entry points refuse to run on a card that is not
there."""

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
import repro_torch.graph, repro_torch.sharding, repro_torch.core.distributed
import repro_torch.obs, repro_torch.serve, repro_torch.transport
import repro_torch.analysis.framework, repro_torch.analysis.kernels_check
from repro_torch.analysis.framework import Project, run_rules
from repro_torch.obs import SLOEngine, TraceStore
from repro_torch.serve import QueryService
from repro_torch.transport import TransportApp, TransportConfig

engine = QueryEngine(device="cpu", tiny_pairs=8)
repo = generate_repository(60, seed=1)
res = Q.log(repo).using(engine).window(0, 40 * 86400.0).dfg(backend="kernel")
assert res.physical.fused_dicing, res.physical
pm = Q.log(repo).using(engine).process_map(top=0.5, backend="graph")
assert pm.physical.backend == "graph" and pm.value.edges, pm.physical
fit = Q.log(repo).using(engine).fitness()
assert 0.0 < fit.value.fitness <= 1.0, fit.value
ali = Q.log(repo).using(engine).alignments()
assert ali.value.trace_cost.shape == (repo.num_traces,), ali.value
store = TraceStore(sys.argv[1])
svc = QueryService(QueryEngine(device="cpu", trace_store=store))
svc.register("main", repo)
out = svc.query({"log": "main", "sink": "dfg", "trace": True})
assert out["trace"]["spans"] and svc.probe({"log": "main"}).cached, out
for sink in ("forensics", "metrics", "slo"):
    assert svc.query({"sink": sink, "format": "prometheus"})["sink"] == sink
assert Q.log(store.to_repository()).using(engine).dfg().value.sum() > 0
assert "physical:" in Q.log(repo).using(engine).explain()
import asyncio
app = TransportApp(svc, TransportConfig(hot_cutoff_s=0.05))
try:
    resp = asyncio.run(app.handle({"log": "main", "sink": "histogram"}))
finally:
    app.close()
assert resp.status == 200 and resp.headers["X-Lane"] == "hot", resp
store.close()
assert run_rules(Project(sys.argv[2])) == []
print(int(res.value.sum()), sorted(m for m in sys.modules if m.startswith("jax")))
"""


def test_port_runs_with_jax_and_the_reference_blocked(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-c", BLOCKED_RUN, str(tmp_path / "traces"),
         str(ROOT)],
        capture_output=True, text=True, env=env, timeout=120,
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


def test_transport_and_launch_report_refuse_a_missing_card(monkeypatch):
    """The transport's default app serves ``QueryService()`` on the card,
    and the launch report builds and launches the kernels there: without a
    card each raises, with no fallback to the host."""
    from repro_torch.analysis.kernels_check import build_report
    from repro_torch.transport import TransportApp, TransportServer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TransportApp()
    with pytest.raises(RuntimeError, match="CUDA"):
        TransportServer()
    with pytest.raises(RuntimeError, match="CUDA"):
        build_report()


def test_analysis_cli_kernel_report_refuses_a_missing_card(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--kernel-report",
         str(tmp_path / "report.json")],
        capture_output=True, text=True, env=env, timeout=120,
    )
    assert out.returncode != 0 and "CUDA" in out.stderr
    assert not (tmp_path / "report.json").exists()


def test_mine_cli_refuses_a_missing_card():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.mine", "--events", "2000"],
        capture_output=True, text=True, env=env, timeout=120,
    )
    assert out.returncode != 0
    assert "CUDA" in out.stderr and out.stdout == ""


SERVING_BLOCKED_RUN = r"""
import importlib.abc, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro"):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
import torch
from repro_torch.configs import ARCHS, get_config
from repro_torch.models import count_params, init_params
from repro_torch.serve import ServeEngine
import repro_torch.launch.serve, repro_torch.models.convert

assert count_params(get_config("gemma2-9b")) == 9_241_705_984
cfg = get_config("jamba-v0.1-52b").reduced()
eng = ServeEngine(cfg, init_params(cfg, torch.Generator().manual_seed(0)),
                  max_batch=2, max_cache=32, device="cpu")
res = eng.generate([[1, 2, 3], [4, 5], [6]], max_new_tokens=3)
psi = eng.mine_telemetry().value
summary = repro_torch.launch.serve.main(
    ["--arch", "olmoe-1b-7b", "--requests", "2", "--max-new", "2",
     "--device", "cpu"])
assert summary["generated_tokens"] == 4, summary
print(len(res), int(psi.sum()), sorted(m for m in sys.modules
                                       if m.startswith("jax")))
"""


def test_serving_runs_with_jax_and_the_reference_blocked():
    """The LM zoo, the serving engine with its self-mined telemetry and the
    serving CLI run on the host with JAX and the reference blocked."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-c", SERVING_BLOCKED_RUN],
        capture_output=True, text=True, env=env, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    n, pairs, jax_modules = out.stdout.strip().splitlines()[-1].split(
        maxsplit=2)
    assert int(n) == 3 and int(pairs) > 0 and jax_modules.strip() == "[]"


def test_serve_engine_refuses_a_missing_card(monkeypatch):
    """``ServeEngine`` runs on the card unless it is given ``device="cpu"``:
    without a card the default raises, with no fallback to the host."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.serve import ServeEngine

    cfg = get_config("starcoder2-3b").reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(cfg, params)
    assert ServeEngine(cfg, params, device="cpu").device.type == "cpu"


def test_serve_cli_refuses_a_missing_card():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "gemma2-9b", "--requests", "2"],
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


TRAINING_BLOCKED_RUN = r"""
import importlib.abc, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro"):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
import repro_torch.train, repro_torch.checkpoint, repro_torch.data.lm_data
import repro_torch.launch.train

summary = repro_torch.launch.train.main(
    ["--arch", "mixtral-8x7b", "--preset", "tiny", "--device", "cpu",
     "--steps", "3", "--batch", "2", "--seq", "16", "--mine",
     "--ckpt-dir", sys.argv[1], "--ckpt-every", "2"])
assert summary["steps"] == 3, summary
print(sum(map(sum, summary["mined"]["psi"])),
      sorted(m for m in sys.modules if m.startswith("jax")))
"""


def test_training_runs_with_jax_and_the_reference_blocked(tmp_path):
    """The trainer, its checkpoints, the token pipeline and the training
    CLI with ``--mine`` run on the host with JAX and the reference
    blocked."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-c", TRAINING_BLOCKED_RUN, str(tmp_path / "ck")],
        capture_output=True, text=True, env=env, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    pairs, jax_modules = out.stdout.strip().splitlines()[-1].split(maxsplit=1)
    assert int(pairs) > 0 and jax_modules.strip() == "[]"
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == ["step-2"]


def test_trainer_refuses_a_missing_card(monkeypatch, tmp_path):
    """``Trainer`` runs on the card unless it is given ``device="cpu"``."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import TrainHParams
    from repro_torch.train import Trainer

    cfg = get_config("starcoder2-3b").reduced()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(cfg, TrainHParams(), lambda step: {}, str(tmp_path))
    assert Trainer(cfg, TrainHParams(), lambda step: {}, str(tmp_path),
                   device="cpu").device.type == "cpu"


def test_train_cli_refuses_a_missing_card(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "starcoder2-3b", "--steps", "2", "--ckpt-dir", str(tmp_path / "ck")],
        capture_output=True, text=True, env=env, timeout=120,
    )
    assert out.returncode != 0
    assert "CUDA" in out.stderr and out.stdout == ""
    assert not (tmp_path / "ck").exists()


SHARDED_BLOCKED_RUN = r"""
import importlib.abc, os, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro"):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
env = dict(os.environ)
import torch, torch.distributed as dist
import repro_torch.launch.dryrun as dryrun
import repro_torch.launch.mesh, repro_torch.launch.steps, repro_torch.roofline
import repro_torch.sharding, repro_torch.kernels.dfg_count.ref
assert dict(os.environ) == env and not dist.is_initialized()
import dataclasses
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.launch.steps import local_abstract_args, make_train_step
from repro_torch.models import init_params
from repro_torch.roofline import analyze_step
from repro_torch.train import init_opt_state

cfg = dataclasses.replace(get_config("olmoe-1b-7b").reduced(), vocab_size=64,
                          loss_chunk=8, q_chunk=8, dtype="float32")
shape = ShapeConfig("t", seq_len=16, global_batch=2, kind="train")
fn, in_sh, _, args, donate = make_train_step(cfg, shape,
                                             make_test_mesh((1, 1), device_type="cpu"))
model = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
batch = {"tokens": torch.zeros((2, 16), dtype=torch.int32),
         "labels": torch.ones((2, 16), dtype=torch.int32)}
_, _, loss, _ = fn(model, init_opt_state(model), batch)
res = analyze_step(fn, local_abstract_args(args, in_sh), cfg, shape,
                   make_test_mesh((1, 1), device_type="cpu"), donate=donate)
assert res["flops_per_device"] > 0 and torch.isfinite(loss)
env = dict(os.environ)  # (remat's checkpoint imports torch._dynamo, which
                        # sets TORCHINDUCTOR_CACHE_DIR on first use)
dryrun.main(["--arch", "whisper-tiny", "--shape", "decode_32k", "--mesh",
             "single", "--tag", "blocked", "--out", sys.argv[1]])
assert not dist.is_initialized() and dict(os.environ) == env
print(sorted(m for m in sys.modules if m.startswith("jax")))
"""


def test_sharded_lm_path_runs_with_jax_and_the_reference_blocked(tmp_path):
    """The step builders, the roofline and the dry run import and run with
    JAX and the reference blocked; importing the dry run changes no
    environment variable and starts no process group, and its ``main``
    leaves none behind."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-c", SHARDED_BLOCKED_RUN, str(tmp_path)],
        capture_output=True, text=True, env=env, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
    assert (tmp_path / "whisper-tiny__decode_32k__16x16__blocked.json").exists()


def test_meshes_without_a_process_group():
    """With no process group the 1 × 1 test mesh is the port's plain
    ``Mesh``; anything larger, and the production mesh, refuse with the
    reference's message."""
    import torch.distributed as dist

    from repro_torch.core.compat import Mesh
    from repro_torch.launch.mesh import (
        make_production_mesh, make_test_mesh, mesh_devices,
    )

    assert not dist.is_initialized()
    mesh = make_test_mesh((1, 1), device_type="cpu")
    assert isinstance(mesh, Mesh) and mesh_devices(mesh) == 1
    with pytest.raises(RuntimeError, match="torch.distributed"):
        make_test_mesh((2, 1), device_type="cpu")
    with pytest.raises(RuntimeError, match="need 256 devices for the "
                                           "production mesh, have 0"):
        make_production_mesh(device_type="cpu")
    with pytest.raises(RuntimeError, match="need 512 devices"):
        make_production_mesh(multi_pod=True, device_type="cpu")
    assert not dist.is_initialized()
