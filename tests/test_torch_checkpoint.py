"""The port's checkpoints (``repro_torch.checkpoint.CheckpointManager``):
the reference's own properties (``tests/test_checkpoint.py``: round trip,
async wait, retention, restoring a given step, no partial checkpoints, a
missing checkpoint raising), ``restore(device=...)`` in place of the
reference's elastic ``shardings=``, and checkpoints crossing between the
packages bit for bit in both directions: the reference's ``(params,
OptState)`` of a reduced model restored by the port, the port's restored
by the reference (``template=``).

The reference's manager runs here with ``async_writes=False``: its async
writer is a daemon thread with no exit.  The port's writer exits when no
save is pending and ``wait()`` joins it; an autouse fixture fails a test
that leaves a thread behind.
"""

import json
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models as R
import repro.train as RT
from repro.checkpoint import CheckpointManager as RefManager
from repro.configs import get_config as ref_config

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.models.convert import (
    named_from_tree, opt_state_from_reference, opt_state_to_reference,
    params_from_reference, params_to_reference, tree_from_named,
)
from repro_torch.models.model import DecoderLM
from repro_torch.train import OptState, init_opt_state


@pytest.fixture(autouse=True)
def _leaves_no_thread():
    before = set(threading.enumerate())
    yield
    left = [t.name for t in threading.enumerate()
            if t not in before and t.is_alive()]
    assert not left, f"threads left running: {left}"


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "params": {"w": torch.tensor(rng.normal(size=(8, 4)),
                                     dtype=torch.float32)},
        "opt": (torch.tensor(7, dtype=torch.int32),
                {"mu": torch.tensor(rng.normal(size=(8, 4)))}),
    }


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def test_roundtrip_sync(tmp_path):
    m = CheckpointManager(str(tmp_path), async_writes=False)
    t = _tree()
    m.save(10, t, metadata={"next_step": 10})
    restored, meta = m.restore(template=t)
    assert meta["next_step"] == 10
    assert isinstance(restored["opt"], tuple)
    for a, b in zip(_leaves(t), _leaves(restored)):
        assert isinstance(b, np.ndarray) and b.dtype == a.numpy().dtype
        np.testing.assert_array_equal(a.numpy(), b)


def test_async_waits(tmp_path):
    m = CheckpointManager(str(tmp_path), async_writes=True)
    for s in (1, 2, 3):
        m.save(s, _tree(s))
    m.wait()
    assert m.all_steps() == [1, 2, 3]
    m.wait()  # idempotent, with no writer left
    m.save(4, _tree(4))  # a save after wait() starts a writer again
    m.wait()
    assert m.all_steps() == [2, 3, 4]


def test_async_snapshot_is_taken_at_save(tmp_path):
    """A tensor updated in place right after ``save`` is written with the
    value it had at the save (the trainer updates its state in place)."""
    m = CheckpointManager(str(tmp_path), async_writes=True)
    w = torch.zeros(1000)
    for s in range(1, 6):
        w.fill_(float(s))
        m.save(s, {"w": w})
        w.fill_(-1.0)
    m.wait()
    for s in (3, 4, 5):
        restored, _ = m.restore(s, template={"w": None})
        assert (restored["w"] == s).all()


def test_async_write_error_surfaces_in_wait(tmp_path):
    """A write that fails on the writer thread raises from ``wait()``
    (a file where the step's temporary directory goes)."""
    m = CheckpointManager(str(tmp_path), async_writes=True)
    m.save(1, {"w": torch.ones(2)})
    m.wait()
    (tmp_path / "tmp-2").write_text("in the way")
    m.save(2, {"w": torch.ones(2)})
    with pytest.raises(OSError):
        m.wait()
    assert m.all_steps() == [1]


def test_retention(tmp_path):
    m = CheckpointManager(str(tmp_path), keep=2, async_writes=False)
    for s in range(5):
        m.save(s, _tree(s))
    assert m.all_steps() == [3, 4]


def test_latest_and_restore_specific(tmp_path):
    m = CheckpointManager(str(tmp_path), async_writes=False)
    m.save(1, _tree(1))
    m.save(2, _tree(2))
    assert m.latest_step() == 2
    t1, _ = m.restore(1, template=_tree(1))
    np.testing.assert_array_equal(t1["params"]["w"],
                                  _tree(1)["params"]["w"].numpy())


def test_no_partial_checkpoints(tmp_path):
    """tmp- dirs are never left as valid steps (atomic rename)."""
    m = CheckpointManager(str(tmp_path), async_writes=False)
    m.save(5, _tree())
    names = os.listdir(tmp_path)
    assert "step-5" in names
    assert not any(n.startswith("tmp-") for n in names)


def test_restore_places_leaves_on_a_device(tmp_path):
    """``restore(device=...)``, the port's counterpart of the reference's
    elastic ``shardings=``: tensors on the target device."""
    m = CheckpointManager(str(tmp_path), async_writes=False)
    t = {"w": torch.arange(16.0).reshape(4, 4)}
    m.save(1, t)
    restored, _ = m.restore(template=t, device="cpu")
    assert isinstance(restored["w"], torch.Tensor)
    assert restored["w"].device.type == "cpu"
    assert torch.equal(restored["w"], t["w"])
    with pytest.raises(ValueError, match="template"):
        m.restore()


def test_missing_checkpoint_raises(tmp_path):
    m = CheckpointManager(str(tmp_path), async_writes=False)
    with pytest.raises(FileNotFoundError):
        m.restore(template={})


def _reference_state(arch="jamba-v0.1-52b"):
    """A reduced model's reference (params, OptState) with non-trivial
    moments and step."""
    rc = ref_config(arch).reduced()
    params = R.init_params(rc, jax.random.PRNGKey(0))
    rng = np.random.default_rng(9)
    noise = lambda a: jnp.asarray(  # noqa: E731
        rng.normal(size=a.shape).astype(np.float32))
    opt = RT.OptState(jnp.int32(5), jax.tree.map(noise, params),
                      jax.tree.map(lambda a: jnp.abs(noise(a)), params))
    return params, opt


def _template(pc):
    skeleton = tree_from_named(
        pc, dict(DecoderLM(pc, None, "meta").named_parameters()))
    return (skeleton, OptState(0, skeleton, skeleton))


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    params, opt = _reference_state()
    RefManager(str(tmp_path), async_writes=False).save(
        5, (params, opt), metadata={"next_step": 5, "loss": 1.5})
    pc = get_config("jamba-v0.1-52b").reduced()
    (p_tree, o_tree), meta = CheckpointManager(str(tmp_path)).restore(
        template=_template(pc))
    assert meta == {"next_step": 5, "loss": 1.5}
    model = params_from_reference(pc, p_tree)
    state = opt_state_from_reference(pc, o_tree)
    want = named_from_tree(pc, jax.tree.map(np.asarray, params))
    for name, p in model.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), want[name])
    assert int(state.step) == 5
    for ours, theirs in ((state.mu, opt.mu), (state.nu, opt.nu)):
        want = named_from_tree(pc, jax.tree.map(np.asarray, theirs))
        for name, t in ours.items():
            np.testing.assert_array_equal(t.numpy(), want[name])


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    pc = get_config("jamba-v0.1-52b").reduced()
    rc = ref_config("jamba-v0.1-52b").reduced()
    model = DecoderLM(pc, torch.Generator().manual_seed(3), "cpu")
    state = init_opt_state(model)
    rng = np.random.default_rng(1)
    for t in list(state.mu.values()) + list(state.nu.values()):
        t.copy_(torch.tensor(rng.random(t.shape)))
    state = OptState(torch.tensor(11, dtype=torch.int32), state.mu, state.nu)
    m = CheckpointManager(str(tmp_path))
    m.save(11, (params_to_reference(pc, model),
                opt_state_to_reference(pc, state)),
           metadata={"next_step": 11})
    m.wait()
    with open(tmp_path / "step-11" / "manifest.json") as f:
        manifest = json.load(f)
    template = jax.eval_shape(lambda: (
        R.init_params(rc, jax.random.PRNGKey(0)),
        RT.init_opt_state(R.init_params(rc, jax.random.PRNGKey(0)))))
    (params, opt), meta = RefManager(str(tmp_path), async_writes=False) \
        .restore(template=template)
    assert meta == {"next_step": 11} and int(opt.step) == 11
    assert set(manifest["leaves"]) == {
        "::".join(str(getattr(k, "key", getattr(k, "name", getattr(
            k, "idx", k)))) for k in path)
        for path, _ in jax.tree_util.tree_flatten_with_path(template)[0]}
    got = named_from_tree(pc, params)
    for name, p in model.named_parameters():
        np.testing.assert_array_equal(got[name], p.detach().numpy())
    for ours, theirs in ((state.mu, opt.mu), (state.nu, opt.nu)):
        got = named_from_tree(pc, theirs)
        for name, t in ours.items():
            np.testing.assert_array_equal(got[name], t.numpy())


def test_writer_thread_exits(tmp_path):
    """The writer starts with a save and is gone after ``wait()``."""
    m = CheckpointManager(str(tmp_path))
    m.save(1, _tree())
    writer = m._thread
    m.wait()
    assert writer is not None and writer.name == "checkpoint-writer"
    assert not writer.is_alive()
    assert not m._running and m.all_steps() == [1]
