"""The sharded train step's tensor parallelism and per-unit FSDP gathers
(``repro_torch.sharding.parallel`` through ``launch.steps.
make_train_step``), on four gloo ranks of a (2, 2) ``("data", "model")``
mesh in one child process (``tests/torch_lm_ranks.py OUT tp``):

* one step of each arch of ``TP_ARCHS`` — reduced, in f32 with no
  ``cast_params_once``, cut so that each takes a different path
  (expert-parallel and F-split experts, key heads picked, gathered or
  shared, query heads that do not divide the axis, mamba mixers, a
  vocabulary that does not divide, an encoder whose sequence does not
  divide, a patch prefix, two microbatches) — equals the one-position
  step on the same weights and batch within 1e-5: the loss, the gradient
  norm and every parameter, μ and ν (the MoE archs route each data
  shard's tokens apart, as the reference does, so their cut drops no
  assignment and their shards hold alike tokens: ``torch_lm_ranks``);
* a hook on rank 0 sees the leaves of at most one unit gathered at any
  time, and the gathered gradients of at most one unit;
* on a fake group of 4 (the launcher's own process, on ``meta``), the
  bytes a rank's step allocates (``analyze_step``'s ``temp_bytes``) stay
  below the whole model's;
* whisper's attention split over query positions (``L.ROWS_CASES``: 1
  head on the (2, 2) mesh, 3 query heads over 1 KV head on a (1, 4)
  mesh, 15 encoder frames in uneven blocks, one case in bf16), on the
  reference's weights (``params_from_reference``): the step's loss,
  gradient norm and reassembled gradients against the JAX package's train
  step on a 1 × 1 mesh, the f32 cases' new parameters, μ and ν too, and
  those cases against the port's one-position step within 1e-5.

The pytest process starts no process group and builds no ``DeviceMesh``:
the one-position step runs on the port's plain 1 × 1 ``Mesh``."""

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
from repro.launch.steps import make_train_step as ref_train_step
from repro.train.optimizer import init_opt_state as ref_init_opt

from repro_torch.configs.base import ShapeConfig, TrainHParams
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.launch.steps import make_train_step
from repro_torch.models.convert import named_from_tree
from repro_torch.train.optimizer import init_opt_state

import torch_lm_ranks as L
from test_torch_models import one_torch_thread  # noqa: F401

HERE = os.path.dirname(os.path.abspath(__file__))
TOL = dict(atol=1e-5, rtol=1e-5)
#: the rows cases against the reference's step: f32 within the f32
#: tolerance of ``test_torch_launch_steps.py``; the gradients (recovered
#: from the reference's μ; measured ≤ 1.2e-8 apart, of ≤ 0.037) with the
#: absolute term scaled to their size
REF_TOL = dict(atol=1e-4, rtol=1e-4)
REF_GRAD_TOL = dict(atol=1e-7, rtol=1e-4)
#: bf16 compute against the reference's bf16 step.  Measured on
#: ``whisper-1x4-bf16``: the loss 3.8e-5 apart (of 4.86), the gradient
#: norm 1.2e-5 (of 0.686), the gradients ≤ 2.4e-4 (of ≤ 0.036): the
#: packages' bf16 activations round differently by up to one ulp.  The
#: tolerances are about four times that
BF16_LOSS_TOL = dict(atol=2e-4, rtol=0)
BF16_NORM_TOL = dict(atol=5e-5, rtol=0)
BF16_GRAD_TOL = dict(atol=1e-3, rtol=0)
ROWS_F32 = [c for c in L.ROWS_CASES if not c.endswith("-bf16")]


@pytest.fixture(scope="module")
def rows_weights():
    """{rows case: (the reference's init, its port names' arrays)}."""
    return {case: L.reference_weights(case) for case in L.ROWS_CASES}


@pytest.fixture(scope="module")
def tp_outputs(tmp_path_factory, rows_weights):
    out = tmp_path_factory.mktemp("tp_ranks")
    for case, (_, named) in rows_weights.items():
        np.savez(out / f"weights_{case}.npz", **named)
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.path.join(HERE, "..", "src"))
    run = subprocess.run([sys.executable, os.path.join(HERE, "torch_lm_ranks.py"),
                          str(out), "tp"], env=env, capture_output=True,
                         text=True, timeout=300)
    assert run.returncode == 0, run.stdout[-2000:] + run.stderr[-3000:]
    return out


@pytest.mark.parametrize("arch", list(L.TP_ARCHS))
def test_tp_train_step_equals_one_position(arch, tp_outputs):
    cfg = L.tp_config(arch)
    shape = ShapeConfig("t", seq_len=L.S, global_batch=L.B, kind="train")
    fn, _, _, _, _ = make_train_step(cfg, shape,
                                     make_test_mesh((1, 1), device_type="cpu"))
    model = L.init_model(cfg)
    batch = {k: torch.from_numpy(v) for k, v in L.tp_inputs(cfg).items()}
    p, o, loss, m = fn(model, init_opt_state(model), batch)
    got = np.load(tp_outputs / f"train_tp_{arch}.npz")
    np.testing.assert_allclose(got["loss"], loss.numpy(), **TOL)
    np.testing.assert_allclose(got["grad_norm"], m["grad_norm"].numpy(), **TOL)
    for n, t in p.named_parameters():
        for key, want in (("p", t.detach()), ("mu", o.mu[n]), ("nu", o.nu[n])):
            np.testing.assert_allclose(got[f"{key}:{n}"], want.numpy(),
                                       err_msg=f"{arch} {key} {n}", **TOL)


def test_tp_step_gathers_one_unit_at_a_time(tp_outputs):
    """olmoe's units, each gathered (and again in its backward), never
    two at once, nor two units' gradients."""
    got = json.loads((tp_outputs / "tp_gathers.json").read_text())
    cfg = L.tp_config("olmoe-1b-7b")
    assert got["units"] == cfg.microbatches * cfg.n_units == 2
    assert got["most"] == {"leaves": 1, "grads": 1}


def test_tp_step_allocates_less_than_the_whole_model(tp_outputs):
    got = json.loads((tp_outputs / "tp_analysis.json").read_text())
    mem = got["memory_analysis"]
    assert got["collectives"] > 0
    assert 0 < mem["temp_bytes"] < got["whole_model_bytes"]


# ---------------------------------------------------------------------------
# Whisper's attention split over query positions (``L.ROWS_CASES``)
# ---------------------------------------------------------------------------


def _rows_shape():
    return ShapeConfig("t", seq_len=L.S, global_batch=L.B, kind="train")


@pytest.mark.parametrize("case", ROWS_F32)
def test_rows_train_step_equals_one_position(case, tp_outputs):
    cfg = L.rows_config(case)
    fn, _, _, _, _ = make_train_step(cfg, _rows_shape(),
                                     make_test_mesh((1, 1), device_type="cpu"))
    model = L.rows_model(case, tp_outputs)
    batch = {k: torch.from_numpy(v) for k, v in L.tp_inputs(cfg).items()}
    p, o, loss, m = fn(model, init_opt_state(model), batch)
    got = np.load(tp_outputs / f"train_rows_{case}.npz")
    np.testing.assert_allclose(got["loss"], loss.numpy(), **TOL)
    np.testing.assert_allclose(got["grad_norm"], m["grad_norm"].numpy(), **TOL)
    for n, t in p.named_parameters():
        for key, want in (("p", t.detach()), ("mu", o.mu[n]), ("nu", o.nu[n])):
            np.testing.assert_allclose(got[f"{key}:{n}"], want.numpy(),
                                       err_msg=f"{case} {key} {n}", **TOL)


@pytest.mark.parametrize("case", list(L.ROWS_CASES))
def test_rows_train_step_matches_reference(case, tp_outputs, rows_weights):
    """The split step's loss, gradient norm and reassembled gradients
    against the reference's train step on a 1 × 1 mesh, on the same
    weights and batch: the reference's gradients are its μ after the one
    step, μ / ((1 − β1) · min(1, clip / (norm + 1e-9))).  The f32 cases'
    new parameters, μ and ν too."""
    rc, cfg = L.rows_config(case, ref_config), L.rows_config(case)
    tree = rows_weights[case][0]
    fn, in_sh, out_sh, _, _ = ref_train_step(
        rc, RefShape("t", seq_len=L.S, global_batch=L.B, kind="train"),
        ref_test_mesh((1, 1), ("data", "model")))
    jp = jax.tree.map(jnp.asarray, tree)
    new_p, new_o, loss, metrics = jax.jit(
        fn, in_shardings=in_sh, out_shardings=out_sh)(
        jp, ref_init_opt(jp),
        {k: jnp.asarray(v) for k, v in L.tp_inputs(cfg).items()})
    got = np.load(tp_outputs / f"train_rows_{case}.npz")
    bf16 = case.endswith("-bf16")
    norm = float(metrics["grad_norm"])
    np.testing.assert_allclose(got["loss"], float(loss),
                               **(BF16_LOSS_TOL if bf16 else REF_TOL))
    np.testing.assert_allclose(got["grad_norm"], norm,
                               **(BF16_NORM_TOL if bf16 else REF_TOL))
    hp = TrainHParams()
    share = (1 - hp.beta1) * min(1.0, hp.grad_clip / (norm + 1e-9))
    mu = named_from_tree(cfg, jax.tree.map(np.asarray, new_o.mu))
    assert {k[2:] for k in got.files if k.startswith("g:")} == set(mu)
    for n, m in mu.items():
        np.testing.assert_allclose(got[f"g:{n}"], m / share,
                                   err_msg=f"{case} gradient {n}",
                                   **(BF16_GRAD_TOL if bf16 else REF_GRAD_TOL))
    if bf16:
        return
    for key, tr in (("p", new_p), ("mu", new_o.mu), ("nu", new_o.nu)):
        for n, want in named_from_tree(cfg, jax.tree.map(np.asarray, tr)).items():
            np.testing.assert_allclose(got[f"{key}:{n}"], want,
                                       err_msg=f"{case} {key} {n}", **REF_TOL)
