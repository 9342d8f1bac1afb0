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
FLOPs on ``model_flops`` (the reference's 0.797).  whisper-tiny ×
``train_4k`` and × ``prefill_32k`` × 16 × 16, whose 6 heads cannot split
over ``model``'s 16 ranks and whose attention splits over query positions
instead: the dry run counts their heaviest rank, rank 15 (its block's
causal keys reach the sequence's end), which holds at most twice the
reference's bytes a rank and spends at least 0.75 of the reference's
useful ratio, on both meshes for ``train_4k``; whisper-tiny ×
``decode_32k`` holds no more bytes and no lower a useful ratio than
before that split.  Where query heads split unevenly (starcoder2's 24 and
llava's 56 over 16) the dry run counts a rank with the largest block,
rank 1: starcoder2-3b × ``train_4k`` × 16 × 16 counts that rank's pinned
bytes and FLOPs.  mamba2-370m × ``train_4k`` × 16 × 16, whose ranks each
project their share of the fused ``in_proj`` columns, counts within 5% of
the reference's FLOPs, at least 0.59 useful and no more bytes than the
reference; gemma2-9b × ``train_4k`` × 16 × 16 holds at most 1.3 times the
reference's temporaries.  The pytest process imports no
``repro.launch.dryrun`` and starts no process group."""

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


#: the reference's dry run (``python -m repro.launch.dryrun``, on the CPU)
#: of whisper-tiny's cells: (per_device_bytes, useful_flops_ratio)
REF_WHISPER = {("train_4k", "single"): (2_116_514_376, 0.36126),
               ("train_4k", "multi"): (1_117_417_992, 0.36126),
               ("prefill_32k", "single"): (1_087_980_816, 0.04271)}
#: the reference's dry run of mamba2-370m × ``train_4k`` × 16 × 16:
#: (flops_per_device, per_device_bytes)
REF_MAMBA = (14_522_089_734_144, 2_983_848_080)
#: the reference's dry run of gemma2-9b × ``train_4k`` × 16 × 16: temp_bytes
REF_GEMMA2_TEMP = 8_115_550_488
#: the port's dry run of starcoder2-3b × ``train_4k`` × 16 × 16, its
#: counted rank 1: (per_device_bytes, flops_per_device, useful_flops_ratio)
STARCODER2_RANK1 = (6_246_518_800, 139_981_574_111_232, 0.53188)
#: the port's dry run of whisper-tiny × ``decode_32k`` × 16 × 16 before
#: its attention split over query positions: (per_device_bytes,
#: useful_flops_ratio)
WHISPER_DECODE_BEFORE = (234_714_216, 0.179891)


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


def test_dryrun_counts_the_heaviest_rank():
    """Rank 15 where the query heads are fewer than ``model``'s 16 ranks
    (whisper); a rank with the largest block of query heads where they
    split unevenly (starcoder2's 24, llava's 56: rank 1, whose block
    ``TensorParallel.block`` makes one head larger than rank 0's); else
    rank 0 (even blocks; mamba2 has no attention)."""
    from repro_torch.configs import cells, get_config
    from repro_torch.launch.dryrun import MODEL_RANKS, counted_rank

    ranks = {a: counted_rank(get_config(a)) for a, _ in cells()}
    assert ranks.pop("whisper-tiny") == 15
    for arch in ("starcoder2-3b", "llava-next-34b"):
        heads = get_config(arch).n_heads
        blocks = [(r + 1) * heads // MODEL_RANKS - r * heads // MODEL_RANKS
                  for r in range(MODEL_RANKS)]
        rank = ranks.pop(arch)
        assert blocks[rank] == max(blocks) > blocks[0] and rank == 1
    assert set(ranks.values()) == {0}


@pytest.mark.parametrize("shape,mesh", list(REF_WHISPER))
def test_dryrun_whisper_splits_queries_within_twice_the_reference(
        tmp_path, shape, mesh):
    d = _dryrun(tmp_path, "whisper-tiny", shape, mesh)
    ref_bytes, ref_useful = REF_WHISPER[shape, mesh]
    assert d["per_device_bytes"] <= 2 * ref_bytes
    assert d["useful_flops_ratio"] >= 0.75 * ref_useful
    assert d["collectives"]["ops"]["all-gather"]["count"] > 0


def test_dryrun_whisper_decode_no_worse(tmp_path):
    d = _dryrun(tmp_path, "whisper-tiny", "decode_32k", "single")
    before_bytes, before_useful = WHISPER_DECODE_BEFORE
    assert d["per_device_bytes"] <= before_bytes
    assert d["useful_flops_ratio"] >= before_useful


def test_dryrun_other_cells_count_as_before(tmp_path):
    """starcoder2-3b's 24 heads split unevenly over ``model``: its cell
    counts rank 1 (2 heads; rank 0 has 1), whose bytes and FLOPs are
    pinned as the count stands with bf16 products counted as the card runs
    them and CUDA's softmax backward buffer held."""
    d = _dryrun(tmp_path, "starcoder2-3b", "train_4k", "single")
    assert d["per_device_bytes"] == STARCODER2_RANK1[0]
    assert d["flops_per_device"] == STARCODER2_RANK1[1]
    assert abs(d["useful_flops_ratio"] - STARCODER2_RANK1[2]) < 5e-6


def test_dryrun_mamba_projects_its_share(tmp_path):
    """Each rank projects its heads' z, x and dt columns and its block of
    the B / C columns (274 of 4,384), as the reference's spec splits
    ``in_proj``, not the whole group's B / C: FLOPs within 5% of the
    reference's, at least 0.59 of them useful (the reference's 0.623), no
    more bytes a rank than the reference's."""
    d = _dryrun(tmp_path, "mamba2-370m", "train_4k", "single")
    ref_flops, ref_bytes = REF_MAMBA
    assert abs(d["flops_per_device"] / ref_flops - 1) <= 0.05
    assert d["useful_flops_ratio"] >= 0.59
    assert d["per_device_bytes"] <= ref_bytes


def test_dryrun_gemma2_temporaries_near_the_reference(tmp_path):
    """gemma2-9b's step keeps one whole-sequence copy per gather (not one
    per consumer) and one f32 tensor per attention chunk for the capped
    softmax: at most 1.3 times the reference's temporaries."""
    d = _dryrun(tmp_path, "gemma2-9b", "train_4k", "single")
    assert d["memory_analysis"]["temp_bytes"] <= 1.3 * REF_GEMMA2_TEMP
