"""The port's dry run (``python -m repro_torch.launch.dryrun``) in a child
process, as ``tests/test_dryrun_integration.py`` runs the reference's:
whisper-tiny × ``decode_32k`` on the 16 × 16 and 2 × 16 × 16 meshes (a fake
process group of 256 / 512 ranks inside the child), and olmoe-1b-7b ×
``train_4k`` × 16 × 16.  Each artifact holds the reference's key set (its
``run_cell`` metadata and ``analyze_compiled``'s keys, the latter read off
the reference's analysis of a small compiled step), the right ``chips``,
``fits_hbm``, a ``dominant_term`` of the three, ``model_flops_global``
equal to the reference's ``model_flops``; olmoe's argument bytes are the
exact sum of rank 0's local shards under the reference's specs (f32
parameters, μ and ν, the int32 step, the batch shard), and its step, which
computes tensor-parallel and gathers one unit at a time, fits the H100's
80 GB within twice the reference's bytes (7.24 GB, the reference's dry
run of the cell) and spends at least 0.4 of its FLOPs on ``model_flops``
(the reference's 0.561).  gemma2-27b × ``decode_32k`` × 16 × 16, whose
prefill and decode compute tensor-parallel and keep the caches split as
the reference's specs lay them: its argument bytes are rank 0's local
parameters (f32), token shard, caches (bf16) and position, the caches
aliased by the updated ones, and it fits the H100's 80 GB (the
reference's dry run of the cell holds 18.16 GiB) with at least 0.4 of its
FLOPs on ``model_flops`` (the reference's 0.797).  The pytest process
imports no ``repro.launch.dryrun`` and starts no process group."""

import dataclasses
import json
import math
import os
import subprocess
import sys

import jax
import pytest

import repro.sharding.spec as R
from repro.configs import get_config as ref_config
from repro.configs import get_shape as ref_shape
from repro.configs.base import ShapeConfig as RefShape
from repro.launch.mesh import make_test_mesh as ref_test_mesh
from repro.launch.steps import _abstract_batch as ref_abstract_batch
from repro.launch.steps import abstract_decode_args as ref_abstract_decode_args
from repro.launch.steps import abstract_params as ref_abstract_params
from repro.launch.steps import make_decode_step as ref_decode_step
from repro.roofline.analyze import analyze_compiled, model_flops

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the metadata ``run_cell`` of ``src/repro/launch/dryrun.py`` writes beside
#: ``analyze_compiled``'s keys
META_KEYS = {"arch", "shape", "mesh", "chips", "kind", "lower_s", "compile_s",
             "tag"}


def _dryrun(tmp_path, arch, shape, mesh):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape, "--mesh", mesh, "--tag", "pytest", "--out",
         str(tmp_path)],
        env=env, capture_output=True, text=True, timeout=600,
    )
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    tag = "16x16" if mesh == "single" else "2x16x16"
    art = tmp_path / f"{arch}__{shape}__{tag}__pytest.json"
    return json.loads(art.read_text())


@pytest.fixture(scope="module")
def olmoe_train(tmp_path_factory):
    """The artifact of olmoe-1b-7b × ``train_4k`` × 16x16 (one child
    process for the module's tests)."""
    return _dryrun(tmp_path_factory.mktemp("olmoe_dryrun"), "olmoe-1b-7b",
                   "train_4k", "single")


@pytest.fixture(scope="module")
def gemma27_decode(tmp_path_factory):
    """The artifact of gemma2-27b × ``decode_32k`` × 16x16."""
    return _dryrun(tmp_path_factory.mktemp("gemma27_dryrun"), "gemma2-27b",
                   "decode_32k", "single")


class _FakeMesh:
    axis_names = ("data", "model")
    shape = {"data": 16, "model": 16}


def _local_bytes(leaf, spec):
    n = leaf.dtype.itemsize
    for dim, entry in zip(leaf.shape, tuple(spec) + (None,) * 8):
        axes = () if entry is None else (entry,) if isinstance(entry, str) else entry
        n *= dim // math.prod(_FakeMesh.shape[a] for a in axes)
    return n


def _tree_local_bytes(tree, specs):
    is_spec = lambda x: isinstance(x, jax.sharding.PartitionSpec)
    return sum(_local_bytes(l, s) for l, s in zip(
        jax.tree.leaves(tree), jax.tree.leaves(specs, is_leaf=is_spec)))


@pytest.fixture(scope="module")
def reference_keys():
    """``analyze_compiled``'s keys, from the reference's analysis of a
    small decode step compiled on its 1 × 1 mesh."""
    cfg = dataclasses.replace(ref_config("whisper-tiny").reduced(),
                              vocab_size=128)
    shape = RefShape("d", seq_len=32, global_batch=2, kind="decode")
    mesh = ref_test_mesh((1, 1), ("data", "model"))
    fn, in_sh, out_sh, args, donate = ref_decode_step(cfg, shape, mesh)
    compiled = jax.jit(fn, in_shardings=in_sh, out_shardings=out_sh,
                       donate_argnums=donate).lower(*args).compile()
    res = analyze_compiled(compiled, cfg, shape, mesh)
    return set(res) | META_KEYS, set(res["memory_analysis"])


@pytest.mark.parametrize("mesh", ["single", "multi"])
def test_dryrun_cell_on_production_mesh(tmp_path, mesh, reference_keys):
    d = _dryrun(tmp_path, "whisper-tiny", "decode_32k", mesh)
    keys, mem_keys = reference_keys
    assert set(d) == keys
    assert set(d["memory_analysis"]) == mem_keys
    assert d["chips"] == (256 if mesh == "single" else 512)
    assert d["mesh"] == ("16x16" if mesh == "single" else "2x16x16")
    assert d["fits_hbm"] is True
    assert d["unknown_trip_whiles"] == 0
    assert d["dominant_term"] in ("compute", "memory", "collective")
    assert d["model_flops_global"] == model_flops(ref_config("whisper-tiny"),
                                                  ref_shape("decode_32k"))
    assert d["flops_per_device"] > 0 and d["bytes_accessed_per_device"] > 0


def test_dryrun_argument_bytes_are_the_local_shards(olmoe_train, monkeypatch):
    d = olmoe_train
    assert d["chips"] == 256 and d["kind"] == "train"
    assert d["model_flops_global"] == model_flops(ref_config("olmoe-1b-7b"),
                                                  ref_shape("train_4k"))

    monkeypatch.setattr(R.ShardingRules, "nd", lambda self, spec: spec)
    cfg, shape = ref_config("olmoe-1b-7b"), ref_shape("train_4k")
    rules = R.make_rules(_FakeMesh(), shape)
    p = ref_abstract_params(cfg)
    params = _tree_local_bytes(p, R.param_shardings(rules, p, cfg))
    b = ref_abstract_batch(cfg, shape, True)
    bspecs = R.batch_shardings(rules, b)
    batch = sum(_local_bytes(b[k], bspecs[k]) for k in b)
    want = 3 * params + 4 + batch  # f32 params, μ, ν; the int32 step
    assert d["memory_analysis"]["argument_bytes"] == want
    assert d["memory_analysis"]["alias_bytes"] == 3 * params


def test_dryrun_serving_argument_bytes_are_the_local_shards(gemma27_decode,
                                                           monkeypatch):
    """Rank 0's decode step of gemma2-27b × ``decode_32k`` takes its shards
    under the reference's specs: the parameters (f32; no batch axis splits
    them when serving), its 8 sequences' tokens, the caches (bf16: the
    rank's one KV head over every slot) and the int32 position; the
    updated caches alias the donated ones."""
    d = gemma27_decode
    assert d["chips"] == 256 and d["kind"] == "decode"
    monkeypatch.setattr(R.ShardingRules, "nd", lambda self, spec: spec)
    cfg, shape = ref_config("gemma2-27b"), ref_shape("decode_32k")
    rules = R.make_rules(_FakeMesh(), shape)
    p, toks, caches, _ = ref_abstract_decode_args(cfg, shape)
    params = _tree_local_bytes(p, R.param_shardings(rules, p, cfg))
    cache = _tree_local_bytes(caches, R.cache_shardings(rules, caches))
    tokens = _local_bytes(toks, R.P(rules.batch_if(shape.global_batch), None))
    assert d["memory_analysis"]["argument_bytes"] == params + tokens + cache + 4
    assert d["memory_analysis"]["alias_bytes"] == cache


def test_dryrun_serving_cell_fits_the_card(gemma27_decode):
    d = gemma27_decode
    assert d["fits_hbm"] is True
    assert d["per_device_bytes"] <= 80e9
    assert d["useful_flops_ratio"] >= 0.4
    assert d["collectives"]["ops"]["all-reduce"]["count"] > 0


def test_dryrun_tensor_parallel_step_fits_the_card(olmoe_train):
    d = olmoe_train
    assert d["fits_hbm"] is True
    assert d["per_device_bytes"] <= 14.5e9
    assert d["useful_flops_ratio"] >= 0.4
    assert d["collectives"]["ops"]["reduce-scatter"]["count"] > 0
