"""The sharded prefill and decode steps (``launch.steps.make_prefill_step``
/ ``make_decode_step`` on a (2, 2) ``("data", "model")`` mesh of four gloo
ranks, in one child process: ``tests/torch_lm_ranks.py OUT serve``), the
ranks' shards reassembled, for each case of ``SERVE_CASES`` — reduced, cut
so that it takes the cache layout named beside it: the KV heads over
``model``, the cache's slots over ``model``, whole caches (whisper's cross
caches of 15 frames), mamba's state and conv channels, the long-context
layouts (one sequence: the slots over ``data``, with ``model`` folded in
where the KV heads do not divide):

* against the JAX package's steps on a 1 × 1 mesh, the same weights
  (``tree_from_named``) and inputs: the prefill's logits and caches, and
  two decode steps' logits and the caches after them, from the same
  starting caches.  f32 cases: logits within 1e-4 (``REF_TOL``, the f32
  tolerance of ``test_torch_launch_steps.py``), caches within one bf16 ulp
  (``CACHE_TOL``: the reference's prefill stores bf16) after prefill and
  1e-4 after decode.  The bf16 cases (bf16 compute and caches, the steps'
  default) run the split slots' partial attention and log-sum-exp
  combine, which sums in f32 where the whole-slot path rounds its
  probabilities to bf16: logits within ``BF16_ATOL`` and caches within
  ``BF16_CACHE_TOL``.  Measured on these cases: the (2, 2) logits ≤
  0.0070 from the reference's, the port's one-position steps' ≤ 0.0059;
  the caches ≤ 0.0073 and ≤ 0.0078 (the bf16 activations that k and v are
  made from round differently in the two packages, by up to one bf16 ulp
  at 1.0), so the tolerances are about twice to three times that.  They
  guard the bf16 path's precision; its logic the f32 cases guard (a
  combine that skips the rescale to the common max moves the f32 cases'
  logits by 0.002-0.011, below bf16's noise here, and fails them at
  1e-4);
* the f32 cases (f32 caches) against the port's one-position steps, within
  1e-5.  The decode positions put the new token's slot in the first and in
  the second rank's block of a global cache and of a local layer's ring,
  after the ring has wrapped;
* no rank's step holds, at its peak, as many bytes as the whole model and
  the whole caches.

The pytest process starts no process group and builds no ``DeviceMesh``:
the one-position steps run on the port's plain 1 × 1 ``Mesh``."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.configs.base import ShapeConfig as RefShape
from repro.launch.mesh import make_test_mesh as ref_test_mesh
from repro.launch.steps import make_decode_step as ref_decode_step
from repro.launch.steps import make_prefill_step as ref_prefill_step

from repro_torch.launch.mesh import make_test_mesh
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models.convert import tree_from_named

import torch_lm_ranks as L
from test_torch_models import one_torch_thread  # noqa: F401

HERE = os.path.dirname(os.path.abspath(__file__))
TOL = dict(atol=1e-5, rtol=1e-5)
REF_TOL = dict(atol=1e-4, rtol=1e-4)
#: one bf16 ulp: a cache value either package rounds to bf16 the other way
CACHE_TOL = dict(atol=1e-4, rtol=2.0**-7)
BF16_ATOL = 2e-2
#: two bf16 ulps at 1.0, and one of the value
BF16_CACHE_TOL = dict(atol=2.0**-6, rtol=2.0**-7)
F32_CASES = [c for c in L.SERVE_CASES if not c.endswith("-bf16")]


@pytest.fixture(scope="module")
def serve_outputs(tmp_path_factory):
    out = tmp_path_factory.mktemp("serve_ranks")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.path.join(HERE, "..", "src"))
    run = subprocess.run([sys.executable, os.path.join(HERE, "torch_lm_ranks.py"),
                          str(out), "serve"], env=env, capture_output=True,
                         text=True, timeout=300)
    assert run.returncode == 0, run.stdout[-2000:] + run.stderr[-3000:]
    return out


def _mesh():
    return make_test_mesh((1, 1), device_type="cpu")


def _torch(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


@pytest.mark.parametrize(
    "case", [c for c in F32_CASES if not c.startswith("long-")])
def test_prefill_step_on_2x2_equals_one_position(case, serve_outputs):
    cfg = L.serve_config(case)
    pshape, _ = L.serve_shapes(case)
    full, _, _ = L.serve_inputs(cfg, pshape.global_batch)
    fn, _, _, _, _ = make_prefill_step(cfg, pshape, _mesh(),
                                       _cache_dtype=torch.float32)
    caches, logits = fn(L.init_model(cfg), _torch(full))
    got = np.load(serve_outputs / f"serve_{case}.npz")
    np.testing.assert_allclose(got["prefill:logits"], logits.numpy(), **TOL)
    flat = L.flat_caches(caches)
    assert {k for k in got.files if k.startswith("prefill:u")} == {
        f"prefill:{n}" for n in flat}
    for name, want in flat.items():
        np.testing.assert_allclose(got[f"prefill:{name}"], want.numpy(),
                                   err_msg=f"{case} {name}", **TOL)


@pytest.mark.parametrize("case", F32_CASES)
def test_decode_steps_on_2x2_equal_one_position(case, serve_outputs):
    cfg = L.serve_config(case)
    _, dshape = L.serve_shapes(case)
    _, short, toks = L.serve_inputs(cfg, dshape.global_batch)
    model = L.init_model(cfg)
    caches = L.decode_start(cfg, model, short)
    fn, _, _, _, _ = make_decode_step(cfg, dshape, _mesh())
    got = np.load(serve_outputs / f"serve_{case}.npz")
    for i, pos in enumerate(L.DECODE_POS):
        logits, caches = fn(model, torch.from_numpy(toks[i]), caches, pos)
        np.testing.assert_allclose(got[f"decode{i}:logits"], logits.numpy(),
                                   err_msg=f"{case} step {i}", **TOL)
    for name, want in L.flat_caches(caches).items():
        np.testing.assert_allclose(got[f"decode:{name}"], want.numpy(),
                                   err_msg=f"{case} {name}", **TOL)


# ---------------------------------------------------------------------------
# Against the reference
# ---------------------------------------------------------------------------


def _ref_twin(case):
    """The reference's config and shapes of a case, and its weight tree:
    the port's seeded parameters, restacked."""
    rc = L.serve_config(case, ref_config)
    pshape, dshape = L.serve_shapes(case)
    shapes = [RefShape(s.name, seq_len=s.seq_len, global_batch=s.global_batch,
                       kind=s.kind) for s in (pshape, dshape)]
    named = {n: p.detach().numpy()
             for n, p in L.init_model(L.serve_config(case)).named_parameters()}
    return rc, shapes, tree_from_named(L.serve_config(case), named)


def _ref_tols(case):
    """(logits, caches after prefill, caches after decode) tolerances."""
    if case.endswith("-bf16"):
        return dict(atol=BF16_ATOL, rtol=0), BF16_CACHE_TOL, BF16_CACHE_TOL
    return REF_TOL, CACHE_TOL, REF_TOL


def _jnp(t):
    dt = jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32
    return jnp.asarray(t.float().numpy(), dt)


def _stacked(caches):
    """The reference's stacked caches from the port's list of units."""
    return jax.tree.map(lambda *xs: jnp.stack(xs),
                        *[jax.tree.map(_jnp, unit) for unit in caches])


def _assert_as_reference(got, tag, ref_caches, tol, case):
    """The reassembled caches ``got[f"{tag}:u<u>.<e>.<leaf>"]`` against
    the reference's stacked ones."""
    names = [k for k in got.files if k.startswith(f"{tag}:u")]
    assert names
    for key in names:
        u, *path = key.split(":", 1)[1].split(".")
        want = ref_caches
        for part in path:
            want = want[part]
        np.testing.assert_allclose(
            got[key], np.asarray(want[int(u[1:])], np.float32),
            err_msg=f"{case} {key}", **tol)


@pytest.mark.parametrize(
    "case", [c for c in L.SERVE_CASES if not c.startswith("long-")])
def test_prefill_step_on_2x2_matches_reference(case, serve_outputs):
    rc, (rs, _), tree = _ref_twin(case)
    full, _, _ = L.serve_inputs(L.serve_config(case), rs.global_batch)
    fn, in_sh, out_sh, _, _ = ref_prefill_step(rc, rs, _ref_mesh())
    caches, logits = jax.jit(fn, in_shardings=in_sh, out_shardings=out_sh)(
        jax.tree.map(jnp.asarray, tree),
        {k: jnp.asarray(v) for k, v in full.items()})
    got = np.load(serve_outputs / f"serve_{case}.npz")
    l_tol, c_tol, _ = _ref_tols(case)
    np.testing.assert_allclose(got["prefill:logits"], np.asarray(logits),
                               err_msg=case, **l_tol)
    _assert_as_reference(got, "prefill", caches, c_tol, case)


@pytest.mark.parametrize("case", list(L.SERVE_CASES))
def test_decode_steps_on_2x2_match_reference(case, serve_outputs):
    """From the caches the port's plain prefill of the short prompt gave
    the child, the reference's decode steps at the same positions."""
    cfg = L.serve_config(case)
    rc, (_, rs), tree = _ref_twin(case)
    _, short, toks = L.serve_inputs(cfg, rs.global_batch)
    caches = _stacked(L.decode_start(cfg, L.init_model(cfg), short))
    fn, in_sh, out_sh, _, _ = ref_decode_step(rc, rs, _ref_mesh())
    step = jax.jit(fn, in_shardings=in_sh, out_shardings=out_sh)
    params = jax.tree.map(jnp.asarray, tree)
    got = np.load(serve_outputs / f"serve_{case}.npz")
    l_tol, _, c_tol = _ref_tols(case)
    for i, pos in enumerate(L.DECODE_POS):
        logits, caches = step(params, jnp.asarray(toks[i]), caches,
                              jnp.int32(pos))
        np.testing.assert_allclose(got[f"decode{i}:logits"], np.asarray(logits),
                                   err_msg=f"{case} step {i}", **l_tol)
    _assert_as_reference(got, "decode", caches, c_tol, case)


def _ref_mesh():
    return ref_test_mesh((1, 1), ("data", "model"))


def test_long_context_cases_split_the_slots_over_data():
    """The long-context cases' caches rest as the reference's specs lay
    them: one sequence, fewer than the ``data`` positions, so the slots
    split over ``data``, with ``model`` folded in where the KV heads do
    not divide (the rules read only the mesh's shape)."""
    from repro_torch.models import init_caches
    from repro_torch.sharding.spec import P, cache_shardings, make_rules

    class Mesh2x2:
        axis_names = ("data", "model")
        shape = {"data": 2, "model": 2}

    for case, spec in (("long-gemma2-9b", P(None, ("data",), "model", None)),
                       ("long-gemma2-9b-kv1",
                        P(None, ("data", "model"), None, None))):
        cfg = L.serve_config(case)
        _, dshape = L.serve_shapes(case)
        rules = make_rules(Mesh2x2(), dshape)
        c_sh = cache_shardings(rules, init_caches(cfg, 1, L.SERVE_S,
                                                  device="meta"))
        assert {sh.spec for sh in L.flat_caches(c_sh).values()} == {spec}


def test_no_rank_holds_the_whole_model_and_caches(serve_outputs):
    for rank in range(L.TP_WORLD):
        peaks = json.loads((serve_outputs / f"serve_peak_{rank}.json").read_text())
        assert set(peaks) == set(L.SERVE_PEAK_CASES)
        for case, p in peaks.items():
            assert 0 < p["prefill"] < p["prefill_whole"], (rank, case, p)
            assert 0 < p["decode"] < p["decode_whole"], (rank, case, p)
