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
  below the whole model's.

The pytest process starts no process group and builds no ``DeviceMesh``:
the one-position step runs on the port's plain 1 × 1 ``Mesh``."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs.base import ShapeConfig
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.launch.steps import make_train_step
from repro_torch.train.optimizer import init_opt_state

import torch_lm_ranks as L
from test_torch_models import one_torch_thread  # noqa: F401

HERE = os.path.dirname(os.path.abspath(__file__))
TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def tp_outputs(tmp_path_factory):
    out = tmp_path_factory.mktemp("tp_ranks")
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
