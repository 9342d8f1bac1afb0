"""The LM half of the port's sharding rules (``repro_torch.sharding.spec``)
against the JAX package's: ``make_rules`` and every leaf's spec —
parameters, batch and caches — for every config at full size, every shape,
on stand-in meshes of (16, 16) and (2, 16, 16) positions (as
``tests/test_sharding_roofline.py`` builds them: only ``shape`` and
``axis_names``) and on the 1 × 1 mesh, equal entry for entry.  The port's
unit leaves have no stacked leading dimension, so each is compared with
the reference's spec past its first entry.  Abstract shapes come from
``jax.eval_shape`` on one side and ``meta`` tensors on the other.

The translation to DTensor placements and each rank's local shape run in
a child process on a fake process group (``tests/torch_fake_mesh.py``):
the pytest process starts no process group and builds no ``DeviceMesh``."""

import json
import os
import subprocess
import sys

import jax
import pytest

import repro.sharding.spec as R
from repro.configs import ARCHS as REF_ARCHS
from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get_config as ref_config
from repro.launch.mesh import make_test_mesh as ref_test_mesh
from repro.launch.steps import abstract_params as ref_abstract_params
from repro.launch.steps import _abstract_batch as ref_abstract_batch
from repro.models import init_caches as ref_init_caches

import repro_torch.sharding.spec as T
from repro_torch.configs import ARCHS, SHAPES, get_config
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.launch.steps import _abstract_batch, abstract_params
from repro_torch.models import init_caches
from repro_torch.models.convert import named_from_tree

HERE = os.path.dirname(os.path.abspath(__file__))


class FakeMesh:
    axis_names = ("data", "model")
    shape = {"data": 16, "model": 16}


class FakeMultiMesh:
    axis_names = ("pod", "data", "model")
    shape = {"pod": 2, "data": 16, "model": 16}


class FakeOneMesh:
    axis_names = ("data", "model")
    shape = {"data": 1, "model": 1}


MESHES = {"16x16": FakeMesh, "2x16x16": FakeMultiMesh, "1x1": FakeOneMesh}


def _norm(spec):
    """Each entry as a tuple of axis names (``None`` → ``()``; the
    reference's ``PartitionSpec`` turns a 1-tuple into its name)."""
    out = []
    for e in spec:
        out.append(() if e is None else (e,) if isinstance(e, str) else tuple(e))
    return tuple(out)


@pytest.fixture
def ref_specs(monkeypatch):
    """The reference's rules return bare specs (its ``nd`` needs a real
    mesh; the stand-ins have only a shape and names)."""
    monkeypatch.setattr(R.ShardingRules, "nd", lambda self, spec: spec)


def _ref_leaves(tree):
    """{port-style name of a stacked leaf (unit index dropped): spec}"""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]:
        keys = [str(getattr(p, "key", getattr(p, "idx", ""))) for p in path]
        out[".".join(keys)] = leaf
    return out


def _port_stacked(name):
    parts = name.split(".")
    if parts[0] in ("units", "enc_units"):
        return ".".join([parts[0]] + parts[2:])
    return name


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("shape", list(SHAPES))
def test_make_rules_equals_reference(shape, mesh_name):
    mesh = MESHES[mesh_name]()
    want = R.make_rules(mesh, REF_SHAPES[shape])
    got = T.make_rules(mesh, SHAPES[shape])
    for f in ("batch_axes", "model_axis", "seq_axes", "fsdp_axes"):
        assert getattr(got, f) == getattr(want, f), f
    for dim in (1, 2, 16, 24, 51865, 49152, 4096):
        assert got.model_if(dim) == want.model_if(dim)
        assert got.batch_if(dim) == want.batch_if(dim)
        assert got.fsdp_if(dim) == want.fsdp_if(dim)


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_and_batch_specs_equal_reference(arch, shape, ref_specs):
    assert set(ARCHS) == set(REF_ARCHS)
    ref_p = ref_abstract_params(ref_config(arch))
    port_p = abstract_params(get_config(arch))
    ref_b = ref_abstract_batch(ref_config(arch), REF_SHAPES[shape], True)
    port_b = _abstract_batch(get_config(arch), SHAPES[shape], True)
    for mesh_cls in MESHES.values():
        mesh = mesh_cls()
        rr = R.make_rules(mesh, REF_SHAPES[shape])
        tr = T.make_rules(mesh, SHAPES[shape])
        cfg = get_config(arch)
        want = _ref_leaves(R.param_shardings(rr, ref_p, ref_config(arch)))
        got = T.param_shardings(tr, port_p, cfg)
        assert len(got) == sum(
            cfg.n_units if n.startswith("units") else
            cfg.n_enc_layers if n.startswith("enc_units") else 1
            for n in want)
        for name, sh in got.items():
            stacked = _port_stacked(name)
            spec = _norm(want[stacked])
            if stacked != name:
                spec = spec[1:]
            assert _norm(sh.spec) == spec, (mesh_cls.__name__, name)
            assert len(sh.spec) == port_p.get_parameter(name).dim()
        want_b = R.batch_shardings(rr, ref_b)
        got_b = T.batch_shardings(tr, port_b)
        assert set(got_b) == set(want_b)
        for k in want_b:
            assert _norm(got_b[k].spec) == _norm(want_b[k]), k


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_cache_specs_equal_reference(arch, shape, ref_specs):
    s = SHAPES[shape]
    rc = ref_config(arch)
    ref_c = jax.eval_shape(lambda: ref_init_caches(rc, s.global_batch, s.seq_len))
    port_c = init_caches(get_config(arch), s.global_batch, s.seq_len,
                         device="meta")
    for mesh_cls in MESHES.values():
        mesh = mesh_cls()
        want = _ref_leaves(R.cache_shardings(R.make_rules(mesh, REF_SHAPES[shape]),
                                             ref_c))
        got = T.cache_shardings(T.make_rules(mesh, SHAPES[shape]), port_c)
        n = 0
        for u, unit in enumerate(got):
            for e, entry in unit.items():
                flat = ({f"{e}.self.{k}": v for k, v in entry["self"].items()}
                        if "self" in entry else {})
                flat.update({f"{e}.{k}": v for k, v in entry.items()
                             if k != "self"})
                for name, sh in flat.items():
                    assert _norm(sh.spec) == _norm(want[name])[1:], (
                        mesh_cls.__name__, u, name)
                    n += 1
        assert n == len(want) * get_config(arch).n_units


def test_whisper_vocab_long_context_and_expert_parallel(ref_specs):
    """The named corner cases: whisper's 51,865 vocab does not divide 16
    (the embedding falls back), ``long_500k``'s batch of 1 shards the cache
    sequence (context parallelism, with ``model`` folded in where the KV
    heads do not divide), ``moe_ep`` puts the experts on ``model``."""
    mesh = FakeMesh()
    w = T.param_shardings(T.make_rules(mesh, SHAPES["train_4k"]),
                          abstract_params(get_config("whisper-tiny")),
                          get_config("whisper-tiny"))
    assert _norm(w["embed"].spec) == ((), ("model",))  # D over model instead
    r = T.make_rules(mesh, SHAPES["long_500k"])
    assert r.batch_axes == () and r.seq_axes == ("data",)
    # gemma2-27b's 16 KV heads split over model; gemma2-9b's 8 do not
    c = T.cache_shardings(r, init_caches(get_config("gemma2-27b"), 1, 524_288,
                                         device="meta"))
    assert _norm(c[0]["e1"]["k"].spec) == ((), ("data",), ("model",), ())
    c = T.cache_shardings(r, init_caches(get_config("gemma2-9b"), 1, 524_288,
                                         device="meta"))
    assert _norm(c[0]["e1"]["k"].spec) == ((), ("data", "model"), (), ())
    o = T.param_shardings(T.make_rules(mesh, SHAPES["train_4k"]),
                          abstract_params(get_config("olmoe-1b-7b")),
                          get_config("olmoe-1b-7b"))
    assert _norm(o["units.0.e0.moe.w_up"].spec) == (("model",), ("data",), ())
    assert _norm(o["units.0.e0.moe.w_down"].spec) == (("model",), (), ("data",))


def test_rules_on_the_one_position_meshes():
    """The port's 1 × 1 test mesh (no process group) gives the reference's
    1 × 1 rules, and every spec's local shape is the whole tensor."""
    mesh = make_test_mesh((1, 1), device_type="cpu")
    ref_mesh = ref_test_mesh((1, 1), ("data", "model"))
    for shape in SHAPES:
        got = T.make_rules(mesh, SHAPES[shape])
        want = R.make_rules(ref_mesh, REF_SHAPES[shape])
        assert (got.batch_axes, got.model_axis, got.seq_axes, got.fsdp_axes) == (
            want.batch_axes, want.model_axis, want.seq_axes, want.fsdp_axes)
    p = abstract_params(get_config("olmoe-1b-7b"))
    sh = T.param_shardings(T.make_rules(mesh, SHAPES["train_4k"]), p)
    for name, s in sh.items():
        assert s.local_shape(p.get_parameter(name).shape) == tuple(
            p.get_parameter(name).shape)


def test_specs_out_of_mesh_order_are_refused():
    s = T.NamedSharding(FakeMultiMesh(), T.P(("data", "pod"), None))
    with pytest.raises(ValueError, match="order"):
        s.placements()


CELLS = [("olmoe-1b-7b", "train_4k", "16x16"),
         ("mixtral-8x7b", "train_4k", "2x16x16"),
         ("whisper-tiny", "decode_32k", "2x16x16"),
         ("gemma2-9b", "long_500k", "16x16"),
         ("llava-next-34b", "prefill_32k", "16x16")]


@pytest.mark.parametrize("arch, shape, mesh", CELLS)
def test_placements_give_the_local_shards(arch, shape, mesh, tmp_path):
    """In a child process on a fake group of 256 / 512 ranks: every
    parameter's, batch leaf's and cache's placements on the production
    ``DeviceMesh`` give DTensor a local shard equal to the global shape
    divided by the product of its axes' sizes (``local_shape``), and the
    placements hold ``Shard`` exactly on the spec's axes."""
    out = tmp_path / "shards.json"
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "..", "src"),
               OMP_NUM_THREADS="1")
    run = subprocess.run(
        [sys.executable, os.path.join(HERE, "torch_fake_mesh.py"), arch,
         shape, mesh, str(out)],
        env=env, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stdout[-2000:] + run.stderr[-3000:]
    res = json.loads(out.read_text())
    assert res["leaves"] > 0 and res["split"] > 0
    assert res["mismatches"] == [], res["mismatches"][:5]
