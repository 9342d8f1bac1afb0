"""The port's AdamW stack (``repro_torch.train.optimizer``) against the JAX
package's: the reference's own properties (``tests/test_optimizer.py``:
schedule shape, global norm, convergence on a quadratic, clipping, decay of
matrices only, state structure), and ``adamw_update`` over a reduced
model's parameters and gradients within ``rtol = 1e-6`` of the
reference's (and ``atol`` 1e-7 on parameters, 1e-9 on moments, for the
elements near zero: the clip scale's last bit follows the order of the
global norm's sum, measured ≤ 6e-11 absolute), three steps in a row,
including which leaves are decayed — the reference's *stacked* rank,
followed by the port (``stacked_rank``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models as R
import repro.train as RT
from repro.configs import get_config as ref_config
from repro.configs.base import TrainHParams as RefHParams

from repro_torch.configs import get_config
from repro_torch.configs.base import TrainHParams
from repro_torch.models.convert import (
    named_from_tree, opt_state_from_reference, opt_state_to_reference,
    params_from_reference, params_to_reference,
)
from repro_torch.train import (
    OptState,
    adamw_update,
    global_norm,
    init_opt_state,
    lr_schedule,
)
from repro_torch.train.optimizer import stacked_rank

from test_torch_models import one_torch_thread  # noqa: F401

RTOL = 1e-6


def test_lr_schedule_shape():
    hp = TrainHParams(learning_rate=1e-3, warmup_steps=10, total_steps=100)
    lrs = [float(lr_schedule(hp, torch.tensor(s, dtype=torch.int32)))
           for s in range(101)]
    assert lrs[0] == 0.0
    assert abs(lrs[10] - 1e-3) < 1e-9  # warmup peak
    assert lrs[100] < 1e-5  # cosine floor
    assert all(a <= b + 1e-12 for a, b in zip(lrs[:10], lrs[1:11]))  # rising


def test_lr_schedule_equals_reference():
    for kw in (dict(learning_rate=1e-3, warmup_steps=10, total_steps=100),
               dict(learning_rate=3e-3, warmup_steps=0, total_steps=7),
               dict(learning_rate=3e-4, warmup_steps=100, total_steps=10_000)):
        hp, rhp = TrainHParams(**kw), RefHParams(**kw)
        for s in (0, 1, 5, 10, 11, 57, 100, 101, 5000, 10_000):
            got = lr_schedule(hp, torch.tensor(s, dtype=torch.int32))
            want = RT.lr_schedule(rhp, jnp.int32(s))
            assert got.dtype == torch.float32
            np.testing.assert_allclose(float(got), float(want), rtol=RTOL)


def test_global_norm():
    tree = {"a": torch.ones(3) * 2.0, "b": torch.ones(4)}
    # sqrt(3·4 + 4·1) = 4
    assert abs(float(global_norm(tree)) - 4.0) < 1e-6


def test_adamw_converges_quadratic():
    """AdamW minimizes a convex quadratic — sanity of moments/bias corr."""
    hp = TrainHParams(
        learning_rate=0.1, warmup_steps=0, total_steps=10_000,
        weight_decay=0.0, grad_clip=1e9,
    )
    target = torch.tensor(np.random.default_rng(0).normal(size=(8, 8)),
                          dtype=torch.float32)
    params = {"w": torch.zeros((8, 8))}
    state = init_opt_state(params)
    for _ in range(300):
        g = {"w": 2 * (params["w"] - target)}
        params, state, _ = adamw_update(hp, params, g, state)
    assert float(((params["w"] - target) ** 2).sum()) < 1e-2
    assert int(state.step) == 300


def test_grad_clip_applied():
    hp = TrainHParams(learning_rate=1.0, warmup_steps=0, grad_clip=1.0,
                      weight_decay=0.0)
    params = {"w": torch.zeros(2)}
    state = init_opt_state(params)
    huge = {"w": torch.tensor([3e4, 4e4])}
    _, state2, metrics = adamw_update(hp, params, huge, state)
    assert float(metrics["grad_norm"]) == pytest.approx(5e4, rel=1e-3)
    # after clipping the effective gradient is unit norm → moments bounded
    assert float(global_norm(state2.mu)) < 0.2


def test_weight_decay_only_matrices():
    hp = TrainHParams(learning_rate=0.01, warmup_steps=0, weight_decay=0.5)
    params = {"w": torch.ones((4, 4)), "b": torch.ones(4)}
    state = init_opt_state(params)
    zero_g = {k: torch.zeros_like(v) for k, v in params.items()}
    new_p, _, _ = adamw_update(hp, params, zero_g, state)
    assert float(new_p["w"][0, 0]) < 1.0  # decayed
    assert float(new_p["b"][0]) == 1.0  # not decayed


def test_opt_state_structure_matches_params():
    params = {"a": torch.zeros((3, 3)), "nested.b": torch.zeros(2)}
    st = init_opt_state(params)
    assert set(st.mu) == set(st.nu) == set(params)
    assert all(st.mu[k].dtype == torch.float32 for k in params)
    assert st.mu["a"] is not st.nu["a"]
    assert int(st.step) == 0 and st.step.dtype == torch.int32


def _reduced(arch):
    rc = ref_config(arch).reduced()
    pc = get_config(arch).reduced()
    tree = jax.tree.map(np.asarray, R.init_params(rc, jax.random.PRNGKey(0)))
    # non-zero norm weights, so that decaying them shows
    rng = np.random.default_rng(5)
    tree = jax.tree.map(
        lambda a: a + rng.normal(size=a.shape).astype(a.dtype) * 0.1, tree)
    return rc, pc, tree


@pytest.mark.parametrize("arch", ["starcoder2-3b", "whisper-tiny"])
def test_adamw_update_equals_reference(arch):
    """Three steps over a reduced model's parameters with seeded gradients:
    parameters, moments, step and metrics within ``rtol = 1e-6`` of the
    reference's."""
    rc, pc, tree = _reduced(arch)
    kw = dict(learning_rate=3e-2, warmup_steps=2, total_steps=20,
              weight_decay=0.1, grad_clip=1.0)
    hp, rhp = TrainHParams(**kw), RefHParams(**kw)
    model = params_from_reference(pc, tree)
    state = init_opt_state(model)
    ref_params = jax.tree.map(jnp.asarray, tree)
    ref_state = RT.init_opt_state(ref_params)
    rng = np.random.default_rng(11)
    for _ in range(3):
        grads_tree = jax.tree.map(
            lambda a: rng.normal(size=a.shape).astype(np.float32), tree)
        ref_params, ref_state, ref_metrics = RT.adamw_update(
            rhp, ref_params, jax.tree.map(jnp.asarray, grads_tree), ref_state)
        grads = {n: torch.tensor(a)
                 for n, a in named_from_tree(pc, grads_tree).items()}
        model, state, metrics = adamw_update(hp, model, grads, state)
    for key in ("lr", "grad_norm"):
        np.testing.assert_allclose(float(metrics[key]),
                                   float(ref_metrics[key]), rtol=RTOL)
    assert int(state.step) == int(ref_state.step) == 3
    want = named_from_tree(pc, jax.tree.map(np.asarray, ref_params))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name], rtol=RTOL,
                                   atol=1e-7, err_msg=name)
    for ours, theirs in ((state.mu, ref_state.mu), (state.nu, ref_state.nu)):
        want = named_from_tree(pc, jax.tree.map(np.asarray, theirs))
        for name, t in ours.items():
            np.testing.assert_allclose(t.numpy(), want[name], rtol=RTOL,
                                       atol=1e-9, err_msg=name)


def test_decay_follows_the_reference_stacked_rank():
    """With zero gradients only the decay moves a leaf.  The reference
    decays every leaf whose *stacked* array has ``ndim >= 2``: the units'
    norm weights ((n_units, D)) but not ``final_norm`` ((D,)).  The port
    decays the same leaves, which a per-unit ``p.ndim`` test would not."""
    rc, pc, tree = _reduced("starcoder2-3b")
    kw = dict(learning_rate=1e-2, warmup_steps=0, total_steps=10,
              weight_decay=0.5)
    ref_params = jax.tree.map(jnp.asarray, tree)
    ref_new, _, _ = RT.adamw_update(
        RefHParams(**kw), ref_params,
        jax.tree.map(jnp.zeros_like, ref_params),
        RT.init_opt_state(ref_params))
    ref_moved = {
        n for n, a in named_from_tree(
            pc, jax.tree.map(np.asarray, ref_new)).items()
        if not np.array_equal(a, named_from_tree(pc, tree)[n])}
    model = params_from_reference(pc, tree)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    zeros = {n: torch.zeros_like(p) for n, p in model.named_parameters()}
    adamw_update(TrainHParams(**kw), model, zeros, init_opt_state(model))
    moved = {n for n, p in model.named_parameters()
             if not torch.equal(p.detach(), before[n])}
    assert moved == ref_moved
    assert "units.0.e0.ln1" in moved and "final_norm" not in moved
    assert stacked_rank("units.0.e0.ln1", before["units.0.e0.ln1"]) == 2
    assert before["units.0.e0.ln1"].dim() == 1  # per-unit rank would skip it


def test_opt_state_crosses_both_ways():
    """``OptState`` to the reference's structure and back, bit for bit; the
    reference's ``adamw_update`` accepts the converted state."""
    rc, pc, tree = _reduced("jamba-v0.1-52b")
    model = params_from_reference(pc, tree)
    rng = np.random.default_rng(3)
    state = OptState(
        torch.tensor(7, dtype=torch.int32),
        {n: torch.tensor(rng.normal(size=p.shape), dtype=torch.float32)
         for n, p in model.named_parameters()},
        {n: torch.tensor(rng.random(p.shape), dtype=torch.float32)
         for n, p in model.named_parameters()})
    ref_state = RT.OptState(*opt_state_to_reference(pc, state))
    assert int(ref_state.step) == 7
    back = opt_state_from_reference(pc, ref_state)
    assert int(back.step) == 7 and back.step.dtype == torch.int32
    for ours, theirs in ((state.mu, back.mu), (state.nu, back.nu)):
        for name, t in ours.items():
            assert torch.equal(t, theirs[name]), name
    assert jax.tree_util.tree_structure(ref_state.mu) == \
        jax.tree_util.tree_structure(tree)
    ref_params = params_to_reference(pc, model)
    for name, a in named_from_tree(pc, ref_params).items():
        np.testing.assert_array_equal(a, named_from_tree(pc, tree)[name])
    RT.adamw_update(RefHParams(), jax.tree.map(jnp.asarray, ref_params),
                    jax.tree.map(jnp.asarray, ref_params),
                    jax.tree.map(jnp.asarray, ref_state))
